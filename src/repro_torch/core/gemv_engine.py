"""IMAGine — the paper's GEMV engine, as a program over the PIM array.

Counterpart of `repro.core.gemv_engine`, with the register file on a
torch device (the card unless the caller passes device="cpu").

System architecture (paper Fig. 3): a 2-D array of GEMV tiles (here the
tile boundary is dissolved into one logical R x C block array — tiles are
a floorplanning construct), a controller that decodes 30-bit instructions,
and a column of shift registers reading out the west edge.

Mapping of y = W @ x, W in Z^{M x D}:

  * output row r is computed by block-row (r mod R) during pass (r // R);
  * the D columns are striped contiguously over the `C*k` PE lanes of a
    block row: lane (c, i) owns columns [(c*k+i)*e, (c*k+i+1)*e);
  * each lane serially MACs its `e` resident weights against the (pre-
    broadcast) x slice — bit-serial Booth radix-2, `acc_bits` accumulator;
  * in-block FOLD (log2 k levels) then east->west HOP (log2 C levels)
    reduce the lane partials to block-column 0 — the eqn (1)/(2) dataflow;
  * SHIFTOUT drains one output element per block row per pass.

Cycle accounting comes from the ISA cost model (isa.cycle_cost); the
closed-form `analytic_cycles` below must agree exactly with the executed
program — this is the model plotted in Fig. 7.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

from .isa import Instr, Op, OP_PARAMS_LOAD_CYCLES
from .pim_array import ArrayGeometry, PimArray


@dataclasses.dataclass(frozen=True)
class ImagineConfig:
    rows: int = 4
    cols: int = 4
    lanes: int = 16
    depth: int = 1024
    n_bits: int = 8
    acc_bits: int = 32  # paper uses 32-bit accumulation (Table IX)

    @property
    def geometry(self) -> ArrayGeometry:
        return ArrayGeometry(self.rows, self.cols, self.lanes, self.depth)

    @property
    def lanes_per_row(self) -> int:
        return self.cols * self.lanes


@dataclasses.dataclass
class GemvPlan:
    """Static schedule for one (M, D) GEMV."""

    m: int
    d: int
    e: int        # elements per lane
    passes: int   # output rows per block-row
    addr_w0: int  # weight region base
    addr_x0: int  # x region base
    addr_acc: int

    def addr_w(self, p: int, t: int, n_bits: int) -> int:
        return self.addr_w0 + (p * self.e + t) * n_bits

    def addr_x(self, t: int, n_bits: int) -> int:
        return self.addr_x0 + t * n_bits


class ImagineGemv:
    """Builds + executes GEMV programs; the cycle-accurate IMAGine model."""

    def __init__(self, config: ImagineConfig, device="cuda"):
        self.cfg = config
        self.array = PimArray(config.geometry, device)
        self.array.n_bits = config.n_bits
        self.array.acc_bits = config.acc_bits

    # -- planning -----------------------------------------------------------

    def plan(self, m: int, d: int) -> GemvPlan:
        cfg = self.cfg
        e = max(1, math.ceil(d / cfg.lanes_per_row))
        passes = math.ceil(m / cfg.rows)
        addr_w0 = 0
        addr_x0 = passes * e * cfg.n_bits
        addr_acc = addr_x0 + e * cfg.n_bits
        need = addr_acc + cfg.acc_bits
        if need > cfg.depth:
            raise ValueError(
                f"GEMV {m}x{d} does not fit the register file: needs {need} "
                f"bits/lane > depth {cfg.depth} (e={e}, passes={passes})"
            )
        return GemvPlan(m, d, e, passes, addr_w0, addr_x0, addr_acc)

    # -- data placement (host DMA; weights are PIM-resident) ----------------

    def load_matrix(self, w, plan: GemvPlan) -> None:
        """Place W: output row pp*R + rr, column (cc*k + ii)*e + t goes to
        block (rr, cc), lane ii, pass-major weight slot pp*e + t; every
        other slot is 0. One reshape of the zero-padded [passes*R,
        C*k*e] matrix builds the words[R, C, k, passes*e] layout."""
        cfg = self.cfg
        r, c, k, e, p = cfg.rows, cfg.cols, cfg.lanes, plan.e, plan.passes
        padded = torch.zeros((p * r, c * k * e), dtype=torch.int64,
                             device=self.array.device)
        padded[: plan.m, : plan.d] = self._int64(w)
        words = padded.reshape(p, r, c, k, e).permute(1, 2, 3, 0, 4)
        self.array.host_write_block(words.reshape(r, c, k, p * e),
                                    plan.addr_w0, cfg.n_bits)

    def load_vector(self, x, plan: GemvPlan) -> None:
        """Place x: column (cc*k + ii)*e + t goes to lane ii of block
        column cc, slot t, in every block row."""
        cfg = self.cfg
        r, c, k, e = cfg.rows, cfg.cols, cfg.lanes, plan.e
        padded = torch.zeros(c * k * e, dtype=torch.int64,
                             device=self.array.device)
        padded[: plan.d] = self._int64(x)
        words = padded.reshape(c, k, e).expand(r, c, k, e)
        self.array.host_write_block(words, plan.addr_x0, cfg.n_bits)
        # bit-serial broadcast through the input registers + fanout tree
        self.array.cycles += self.vector_load_cycles(plan)

    def vector_load_cycles(self, plan: GemvPlan) -> int:
        """x slices stream to all lanes in parallel, one bit per cycle."""
        return plan.e * self.cfg.n_bits

    def _int64(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.int64,
                               device=self.array.device)

    # -- program ------------------------------------------------------------

    def build_pass_program(self, plan: GemvPlan, p: int) -> List[Instr]:
        cfg = self.cfg
        prog: List[Instr] = [
            Instr(Op.SETPREC, imm=min(cfg.n_bits, 31)),
            Instr(Op.SELALL),
            Instr(Op.SETPTR, addr1=plan.addr_acc),
            # clear accumulator: acc <- acc - acc
            Instr(Op.SUB, addr1=plan.addr_acc, addr2=plan.addr_acc),
        ]
        for t in range(plan.e):
            prog.append(
                Instr(Op.MACC, addr1=plan.addr_w(p, t, cfg.n_bits),
                      addr2=plan.addr_x(t, cfg.n_bits))
            )
        for level in range(int(math.log2(cfg.lanes))):
            prog.append(Instr(Op.FOLD, imm=level))
        for level in range(int(math.log2(cfg.cols))):
            prog.append(Instr(Op.HOP, imm=level))
        prog.append(Instr(Op.SHIFTOUT, imm=cfg.rows))
        return prog

    def run_gemv(self, w, x) -> Tuple[torch.Tensor, int]:
        """Execute y = W @ x bit-serially. W [M, D] and x [D] are integer
        numpy arrays or tensors; returns (y, cycles), y an int64 tensor on
        the array's device in output order."""
        m, d = w.shape
        plan = self.plan(m, d)
        w, x = self._int64(w), self._int64(x)
        _check_range(w, self.cfg.n_bits, "W")
        _check_range(x, self.cfg.n_bits, "x")
        self.array.cycles = 0
        self.array.out_buffer.clear()
        self.load_matrix(w, plan)
        start = self.array.cycles
        self.load_vector(x, plan)
        for p in range(plan.passes):
            self.array.execute(self.build_pass_program(plan, p))
        y_rows = torch.stack(self.array.out_buffer, dim=0)  # [passes, R]
        # interleave: pass p, row r -> output p*R + r
        y = y_rows.reshape(plan.passes * self.cfg.rows)[:m]
        return y, self.array.cycles - start

    # -- closed-form cycle model (Fig. 7 / §V-F) -----------------------------

    def analytic_cycles(self, m: int, d: int) -> int:
        plan = self.plan(m, d)
        per_pass = self._pass_cycles(plan)
        return self.vector_load_cycles(plan) + plan.passes * per_pass

    def _pass_cycles(self, plan: GemvPlan) -> int:
        cfg = self.cfg
        n, a = cfg.n_bits, cfg.acc_bits
        cyc = 3  # SETPREC + SELALL + SETPTR
        cyc += 2 * a + OP_PARAMS_LOAD_CYCLES  # accumulator clear (SUB)
        cyc += plan.e * (4 * n * (n + 1) + OP_PARAMS_LOAD_CYCLES)  # MACCs
        cyc += int(math.log2(cfg.lanes)) * (a + 4 + OP_PARAMS_LOAD_CYCLES)
        for level in range(int(math.log2(cfg.cols))):
            cyc += (a + 4) + (1 << level) + OP_PARAMS_LOAD_CYCLES
        cyc += cfg.rows + OP_PARAMS_LOAD_CYCLES  # SHIFTOUT
        return cyc

    def reduction_cycles(self, m: int, d: int) -> int:
        """Cycles outside the multiplication stage (the §V-G definition)
        for the whole GEMV — what eqn (1) is fitted against."""
        cfg = self.cfg
        plan = self.plan(m, d)
        total = self.analytic_cycles(m, d)
        mult = plan.passes * plan.e * (4 * cfg.n_bits * (cfg.n_bits + 1) + OP_PARAMS_LOAD_CYCLES)
        return total - mult


def reduction_model_cycles(n_acc: int, p: int, k: int = 16) -> float:
    """Closed-form IMAGine reduction latency for `p` array partial sums at
    accumulation width `n_acc` — the latency_fn handed to
    gold_standard.fit_reduction_model to reproduce Table IX.

    FOLD level: (n_acc + 4) + 1 param-load; HOP level h adds 2^h movement.
    """
    cyc = math.log2(k) * (n_acc + 4 + OP_PARAMS_LOAD_CYCLES)
    levels = int(math.log2(p)) if p > 1 else 0
    for h in range(levels):
        cyc += (n_acc + 4) + (1 << h) + OP_PARAMS_LOAD_CYCLES
    return cyc


def _check_range(arr: torch.Tensor, n_bits: int, name: str) -> None:
    """One host sync: the operand's min and max."""
    lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1
    low, high = torch.stack(torch.aminmax(arr)).tolist()
    if low < lo or high > hi:
        raise ValueError(f"{name} values out of {n_bits}-bit signed range")
