"""Bit-exact simulator of the IMAGine PIM array, on a torch device.

Counterpart of `repro.core.pim_array`: a 2-D array of PiCaSO-IM blocks,
each one RAMB18 = `k` bit-serial PE lanes with a `depth`-bit register
file per lane. Arithmetic runs the way the hardware runs it —
bit-serially, one full-adder step per bit with a ripple carry, Booth
radix-2 partial products on two's-complement bit vectors — vectorised
over every lane of the array at once, so results are exact for any
operand width (no host integer-width shortcut).

State layout: rf[R, C, k, depth] torch.uint8, one bit per register-file
cell, little-endian within a word, two's complement for signed words;
enable[R, C] bool. Both live on the array's device: the card unless the
caller passes device="cpu". At the paper's U55 geometry (126 x 32 x 16,
depth 1024) the register file is 66,060,288 bytes.

Inside the primitives an operand is held bit-first, [w, ...lanes], so
each full-adder step reads and writes one contiguous plane of lanes.
The per-bit loops issue tensor ops only: no value returns to the host
inside them, and SHIFTOUT keeps its words on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..models.common import resolve_device
from .isa import Instr, Op, cycle_cost


@dataclasses.dataclass
class ArrayGeometry:
    rows: int           # block rows (R)
    cols: int           # block columns (C)
    lanes: int = 16     # PEs per block (k) — one RAMB18 = 16 bitlines
    depth: int = 1024   # register-file bits per lane

    @property
    def n_pe(self) -> int:
        return self.rows * self.cols * self.lanes

    @property
    def lanes_per_row(self) -> int:
        return self.cols * self.lanes


class PimArray:
    """Bit-exact PIM array with an instruction-level execution engine."""

    def __init__(self, geom: ArrayGeometry, device="cuda"):
        if geom.lanes & (geom.lanes - 1):
            raise ValueError("lanes must be a power of two (fold network)")
        if geom.cols & (geom.cols - 1):
            raise ValueError("cols must be a power of two (hop network)")
        self.geom = geom
        self.device = resolve_device(device)
        self.rf = torch.zeros((geom.rows, geom.cols, geom.lanes, geom.depth),
                              dtype=torch.uint8, device=self.device)
        self.enable = torch.ones((geom.rows, geom.cols), dtype=torch.bool,
                                 device=self.device)
        self.ptr = 0
        self.n_bits = 8
        self.acc_bits = 24
        self.cycles = 0
        self.instr_count = 0
        #: one int64 [R] tensor per SHIFTOUT, left on the device
        self.out_buffer: List[torch.Tensor] = []

    # -- host-side DMA (not part of the cycle-counted GEMV program) --------

    def host_write(self, row: int, col: int, lane: int, addr: int, value: int,
                   nbits: int) -> None:
        self.rf[row, col, lane, addr: addr + nbits] = _int_to_bits(
            value, nbits, self.device)

    def host_write_block(self, values, addr: int, nbits: int) -> None:
        """values[R, C, k, words] — bulk two's-complement write."""
        values = torch.as_tensor(values, dtype=torch.int64, device=self.device)
        r, c, k, w = values.shape
        bits = _ints_to_bits(values, nbits)  # [R, C, k, w, nbits]
        self.rf[:r, :c, :k, addr: addr + w * nbits] = bits.reshape(
            r, c, k, w * nbits)

    def host_read(self, row: int, col: int, lane: int, addr: int,
                  nbits: int) -> int:
        return _bits_to_int(self.rf[row, col, lane, addr: addr + nbits])

    def read_words(self, addr: int, nbits: int) -> torch.Tensor:
        """Signed words at `addr` for every lane -> int64 [R, C, k]."""
        return _words(self.rf[:, :, :, addr: addr + nbits], nbits)

    # -- bit-serial primitives (vectorized across all lanes) ---------------

    def _masked_store(self, addr: int, bits: torch.Tensor) -> None:
        """Store bits [R,C,k,w] at addr, gated by the block-enable mask."""
        w = bits.shape[-1]
        region = self.rf[:, :, :, addr: addr + w]
        region.copy_(torch.where(self.enable[:, :, None, None], bits, region))

    def _serial_add(self, a: torch.Tensor, b: torch.Tensor, width: int,
                    sub: bool = False) -> torch.Tensor:
        """Ripple bit-serial add/sub of little-endian bit tensors.

        a, b: [..., wa], [..., wb] two's complement; result [..., width].
        Exactly the dataflow of the PE's 1-bit full adder walking the RF.
        """
        a = _bit_first(_sign_extend_bits(a, width))
        b = _bit_first(_sign_extend_bits(b, width))
        carry = torch.full(a.shape[1:], int(sub), dtype=torch.uint8,
                           device=a.device)
        if sub:
            b = b ^ 1
        out = torch.empty_like(a)
        _ripple(out, a, b, carry)
        return out.movedim(0, -1)

    def _booth_multiply(self, a: torch.Tensor, b: torch.Tensor, n: int,
                        width: int) -> torch.Tensor:
        """Booth radix-2 signed multiply of n-bit operands -> `width` bits.

        For each pair (b_i, b_{i-1}): 01 -> +a<<i, 10 -> -a<<i. Shifts are
        realized by bit-aligned serial adds — the same partial-product walk
        the PE performs. One serial add per step: a subtract adds the
        complemented partial product with a carry in, and a step with
        neither digit adds zero. The partial product's low i bits are 0
        (or, complemented, 1s that carry the +1 through unchanged bits),
        so the walk starts at bit i with carry-in `minus`: bit for bit
        what the full-width add and subtract of the reference give.
        """
        a_ext = _bit_first(_sign_extend_bits(a, width))   # [width, ...]
        b = b.movedim(-1, 0)                              # [n, ...]
        acc = torch.zeros(a_ext.shape, dtype=torch.uint8, device=a.device)
        prev = torch.zeros(a_ext.shape[1:], dtype=torch.uint8, device=a.device)
        # with i >= width the shifted multiplicand has no bit left in range
        for i in range(min(n, width)):
            bi = b[i]
            plus = prev & (bi ^ 1)    # 01 -> add
            minus = bi & (prev ^ 1)   # 10 -> subtract
            addend = (a_ext[: width - i] & (plus | minus)) ^ minus
            _ripple(acc[i:], acc[i:], addend, minus)
            prev = bi
        # The loop covers the full Booth recoding: with the virtual
        # b_{-1} = 0 start, sum(digit_i * 2^i) equals the two's-complement
        # value of b including the negative MSB weight.
        return acc.movedim(0, -1)

    # -- instruction execution ---------------------------------------------

    def execute(self, program: Sequence[Instr]) -> int:
        """Run a program; returns cycles consumed (adds to self.cycles)."""
        start = self.cycles
        for instr in program:
            self._step(instr)
            self.cycles += cycle_cost(instr, self.n_bits, self.acc_bits)
            self.instr_count += 1
            if instr.op == Op.END:
                break
        return self.cycles - start

    def _step(self, instr: Instr) -> None:
        op = instr.op
        g = self.geom
        if op in (Op.NOP, Op.END):
            return
        if op == Op.SETPTR:
            self.ptr = instr.addr1
        elif op == Op.SELBLK:
            self.enable.fill_(False)
            flat = instr.imm
            self.enable[flat // g.cols, flat % g.cols] = True
        elif op == Op.SELROW:
            self.enable.fill_(False)
            self.enable[instr.imm, :] = True
        elif op == Op.SELALL:
            self.enable.fill_(True)
        elif op == Op.SETPREC:
            self.n_bits = instr.imm if instr.imm > 0 else 32
        elif op == Op.BCAST:
            val = _int_to_bits(instr.addr1 | (instr.addr2 << 10), self.n_bits,
                               self.device)
            self._masked_store(self.ptr, val.expand(
                g.rows, g.cols, g.lanes, self.n_bits))
        elif op in (Op.ADD, Op.SUB):
            a = self.rf[:, :, :, instr.addr1: instr.addr1 + self.acc_bits]
            b = self.rf[:, :, :, instr.addr2: instr.addr2 + self.acc_bits]
            res = self._serial_add(a, b, self.acc_bits, sub=(op == Op.SUB))
            self._masked_store(self.ptr, res)
        elif op == Op.MULT:
            a = self.rf[:, :, :, instr.addr1: instr.addr1 + self.n_bits]
            b = self.rf[:, :, :, instr.addr2: instr.addr2 + self.n_bits]
            res = self._booth_multiply(a, b, self.n_bits, self.acc_bits)
            self._masked_store(self.ptr, res)
        elif op == Op.MACC:
            a = self.rf[:, :, :, instr.addr1: instr.addr1 + self.n_bits]
            b = self.rf[:, :, :, instr.addr2: instr.addr2 + self.n_bits]
            prod = self._booth_multiply(a, b, self.n_bits, self.acc_bits)
            acc = self.rf[:, :, :, self.ptr: self.ptr + self.acc_bits]
            res = self._serial_add(acc, prod, self.acc_bits)
            self._masked_store(self.ptr, res)
        elif op == Op.FOLD:
            self._fold(instr.imm)
        elif op == Op.HOP:
            self._hop(instr.imm)
        elif op == Op.SHIFTOUT:
            self._shiftout()
        else:  # pragma: no cover - enum is closed
            raise NotImplementedError(op)

    def _fold(self, level: int) -> None:
        """In-block reduction step: lane i += lane (i + 2^level) for lanes
        aligned to 2^(level+1) — PiCaSO's zero-copy OpMux folding. Gated
        by the block-enable mask."""
        w = self.acc_bits
        pairs = _level_pairs(self.geom.lanes, level)
        if pairs is None:
            return
        dst, src = pairs
        acc = self.rf[:, :, :, self.ptr: self.ptr + w]
        summed = self._serial_add(acc[:, :, dst], acc[:, :, src], w)
        cur = self.rf[:, :, dst, self.ptr: self.ptr + w]
        cur.copy_(torch.where(self.enable[:, :, None, None], summed, cur))

    def _hop(self, level: int) -> None:
        """Array-level binary-hopping step across block columns: block col
        j += block col (j + 2^level), lane-0 accumulators, east -> west.
        Like the reference, it writes every block row whatever the
        enable mask says."""
        w = self.acc_bits
        pairs = _level_pairs(self.geom.cols, level)
        if pairs is None:
            return
        dst, src = pairs
        acc = self.rf[:, :, 0, self.ptr: self.ptr + w]  # [R, C, w]
        summed = self._serial_add(acc[:, dst], acc[:, src], w)
        self.rf[:, dst, 0, self.ptr: self.ptr + w] = summed

    def _shiftout(self) -> None:
        """Column shift registers: read the west-most lane-0 accumulator of
        each block row into the output FIFO."""
        w = self.acc_bits
        self.out_buffer.append(_words(self.rf[:, 0, 0, self.ptr: self.ptr + w],
                                      w))


# ---------------------------------------------------------------------------
# bit-serial helpers
# ---------------------------------------------------------------------------

def _ripple(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            carry: torch.Tensor) -> None:
    """out[j] = bit j of a + b + carry, one full-adder step per bit, over
    bit-first [w, ...] tensors. `out` may be `a` itself: bit j is read
    before it is written."""
    for j in range(a.shape[0]):
        t = a[j] + b[j] + carry
        torch.bitwise_and(t, 1, out=out[j])
        carry = t >> 1


def _level_pairs(n: int, level: int) -> Optional[tuple]:
    """Destinations 0, 2s, 4s, ... and sources s, 3s, ... (s = 2^level)
    of one reduction level over `n` lanes or columns, as strided slices,
    so the result writes straight into the register file; None when the
    level has no source left."""
    stride = 1 << level
    src = slice(stride, n, 2 * stride)
    count = len(range(n)[src])
    if not count:
        return None
    return slice(0, 2 * stride * count, 2 * stride), src


def _bit_first(bits: torch.Tensor) -> torch.Tensor:
    return bits.movedim(-1, 0).contiguous()


def _words(bits: torch.Tensor, nbits: int) -> torch.Tensor:
    """Signed int64 value of the little-endian bit vectors bits[..., nbits]."""
    bits = bits.to(torch.int64)
    weights = 1 << torch.arange(nbits, dtype=torch.int64, device=bits.device)
    mag = (bits * weights).sum(dim=-1)
    sign = bits[..., -1]
    return mag - (sign << nbits)


def _int_to_bits(value: int, nbits: int, device) -> torch.Tensor:
    value = int(value) & ((1 << nbits) - 1)
    return torch.tensor([(value >> i) & 1 for i in range(nbits)],
                        dtype=torch.uint8, device=device)


def _ints_to_bits(values: torch.Tensor, nbits: int) -> torch.Tensor:
    vals = values.to(torch.int64) & ((1 << nbits) - 1)
    shifts = torch.arange(nbits, dtype=torch.int64, device=values.device)
    bits = vals[..., None] >> shifts
    bits &= 1   # in place: one int64 transient of the words' bits, not two
    return bits.to(torch.uint8)


def _bits_to_int(bits: torch.Tensor) -> int:
    bits = bits.tolist()
    mag = sum(bit << i for i, bit in enumerate(bits))
    if bits[-1]:
        mag -= 1 << len(bits)
    return mag


def _sign_extend_bits(bits: torch.Tensor, width: int) -> torch.Tensor:
    w = bits.shape[-1]
    if w >= width:
        return bits[..., :width]
    sign = bits[..., -1:]
    ext = sign.expand(bits.shape[:-1] + (width - w,))
    return torch.cat([bits, ext], dim=-1)
