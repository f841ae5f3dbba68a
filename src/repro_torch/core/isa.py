"""IMAGine 30-bit instruction set (paper §IV-C): a copy of
`repro.core.isa`, which is pure Python.

The tile controller receives a 30-bit instruction and drives it with either
the single-cycle or the multi-cycle control path (a 2-state FSM picks one).
Multi-cycle instructions pay +1 cycle to load parameters from the
Op-Params module.

Encoding (30 bits):

    [29:25] opcode (5b) | [24:15] addr1 (10b) | [14:5] addr2 (10b) | [4:0] imm (5b)

Addresses are bit addresses into the per-PE register file (depth <= 1024).
The destination address comes from the pointer register (the third
simultaneous address PiCaSO-IM added over PiCaSO-F).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

INSTR_BITS = 30
ADDR_BITS = 10
IMM_BITS = 5
OPCODE_BITS = 5

ADDR_MASK = (1 << ADDR_BITS) - 1
IMM_MASK = (1 << IMM_BITS) - 1
OPCODE_MASK = (1 << OPCODE_BITS) - 1


class Op(enum.IntEnum):
    """Opcodes. Values are stable — they are part of the encoding."""

    NOP = 0
    SETPTR = 1    # ptr <- addr1                              (single-cycle)
    SELBLK = 2    # enable blocks with block_id == imm        (single-cycle)
    SELROW = 3    # enable block-row imm                      (single-cycle)
    SELALL = 4    # enable all blocks                         (single-cycle)
    SETPREC = 5   # operand precision N <- imm (bits)         (single-cycle)
    BCAST = 6     # write immediate operand bit-serially at ptr (multi-cycle)
    ADD = 7       # [ptr] <- [addr1] + [addr2]                (multi-cycle)
    SUB = 8       # [ptr] <- [addr1] - [addr2]                (multi-cycle)
    MULT = 9      # [ptr] <- [addr1] * [addr2] (Booth r2)     (multi-cycle)
    MACC = 10     # [ptr] <- [ptr] + [addr1]*[addr2]          (multi-cycle)
    FOLD = 11     # in-block lane reduce, level imm           (multi-cycle)
    HOP = 12      # array-level block-column reduce, level imm (multi-cycle)
    SHIFTOUT = 13 # shift west column into output registers   (multi-cycle)
    END = 14      # end of program                            (single-cycle)


SINGLE_CYCLE = {Op.NOP, Op.SETPTR, Op.SELBLK, Op.SELROW, Op.SELALL, Op.SETPREC, Op.END}

#: extra cycle to fetch parameters from the Op-Params module (paper §IV-C)
OP_PARAMS_LOAD_CYCLES = 1


@dataclasses.dataclass(frozen=True)
class Instr:
    op: Op
    addr1: int = 0
    addr2: int = 0
    imm: int = 0

    def encode(self) -> int:
        if not (0 <= self.addr1 <= ADDR_MASK and 0 <= self.addr2 <= ADDR_MASK):
            raise ValueError(f"address out of range: {self}")
        if not 0 <= self.imm <= IMM_MASK:
            raise ValueError(f"imm out of range: {self}")
        return (
            (int(self.op) & OPCODE_MASK) << 25
            | (self.addr1 & ADDR_MASK) << 15
            | (self.addr2 & ADDR_MASK) << 5
            | (self.imm & IMM_MASK)
        )

    @staticmethod
    def decode(word: int) -> "Instr":
        if not 0 <= word < (1 << INSTR_BITS):
            raise ValueError(f"not a {INSTR_BITS}-bit word: {word}")
        return Instr(
            op=Op((word >> 25) & OPCODE_MASK),
            addr1=(word >> 15) & ADDR_MASK,
            addr2=(word >> 5) & ADDR_MASK,
            imm=word & IMM_MASK,
        )

    @property
    def is_single_cycle(self) -> bool:
        return self.op in SINGLE_CYCLE


def cycle_cost(instr: Instr, n_bits: int, acc_bits: int, k: int = 16) -> int:
    """Cycle cost charged by the tile controller for one instruction.

    Bit-serial cost model (see DESIGN.md §3 / latency_models.py):
      ADD/SUB   2 cycles per bit (read + write phases of the overlay RF)
      MULT/MACC Booth radix-2: 4*N*(N+1)  (calibrated to the paper's TOPS)
      FOLD      one in-block reduction level: acc_bits + 4   (PiCaSO hop)
      HOP       one array level h: (acc_bits + 4) + 2**h movement cycles
      BCAST     one bit per cycle: n_bits
      SHIFTOUT  one element per cycle per row: imm = row count
    """
    if instr.is_single_cycle:
        return 1
    n, a = n_bits, acc_bits
    base = {
        Op.BCAST: n,
        Op.ADD: 2 * a,
        Op.SUB: 2 * a,
        Op.MULT: 4 * n * (n + 1),
        Op.MACC: 4 * n * (n + 1),
        Op.FOLD: a + 4,
        Op.HOP: (a + 4) + (1 << instr.imm),
        Op.SHIFTOUT: max(1, instr.imm),
    }[instr.op]
    return base + OP_PARAMS_LOAD_CYCLES


def assemble(instrs) -> list:
    """Encode a program to 30-bit words (round-trippable via decode)."""
    return [i.encode() for i in instrs]
