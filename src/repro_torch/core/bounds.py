"""Lane budgets and chain-length bounds for packed operations.

Port of `repro/core/bounds.py` (pure Python, copied: the port imports
nothing of `repro`).  This module re-derives the paper's Eq. 2 chain-length bound for arbitrary
accumulator/lane widths so the same formula serves both

* the FPGA DSP configuration of the paper (48-bit ALU, 18-bit low product
  lane on the 27x18 multiplier) -- used in tests to reproduce the paper's
  published N <= 7 bound for signed 8-bit MAD chains, and
* the 32-bit integer lane (int32 accumulators) -- a TPU VPU lane in the
  reference, a CUDA core's 32-bit integer register on the H100 -- which is
  what the SILVIA passes actually use.

Eq. 2 (paper):                        N <= floor((2^(L-1) - 1) / (2^(m-1) * 2^(n-1)))   if signed
                                      N <= floor((2^L - 1) / ((2^m - 1) * (2^n - 1)))   otherwise
where L is the bit width reserved for the low product lane, m the width of
the packed (per-lane) operand and n the width of the shared operand.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

# ---------------------------------------------------------------------------
# Hardware descriptions
# ---------------------------------------------------------------------------

# The paper's target: AMD UltraScale DSP48E2 (27x18 multiplier, 48-bit ALU).
FPGA_DSP48E2 = dict(mult_bits=45, alu_bits=48, low_lane_bits=18)

# The port's target: a 32-bit integer lane.  Sub-32-bit integer arithmetic
# runs in 32-bit registers on the card as in the TPU's VPU, so one 32-bit
# lane op is the unit the packing amortizes -- the analogue of one DSP
# slice.
I32_LANE = dict(mult_bits=32, alu_bits=32, low_lane_bits=16)


@dataclasses.dataclass(frozen=True)
class LaneBudget:
    """A concrete packed-operation configuration."""

    name: str
    n_lanes: int          # how many logical ops per unit op
    lane_bits: int        # width of each packed lane
    operand_bits: int     # max width of packable operands
    signed: bool


# SILVIAAdd modes.  The paper's DSP SIMD modes are four12/two24 on the 48-bit
# ALU; rescaled to the 32-bit lane they become four8/two16.
ADD_MODES = {
    # 32-bit-lane modes (used by the pass).
    "four8": LaneBudget("four8", n_lanes=4, lane_bits=8, operand_bits=8, signed=True),
    "two16": LaneBudget("two16", n_lanes=2, lane_bits=16, operand_bits=16, signed=True),
    # Paper's original FPGA modes (kept for parity tests / documentation).
    "four12": LaneBudget("four12", n_lanes=4, lane_bits=12, operand_bits=12, signed=True),
    "two24": LaneBudget("two24", n_lanes=2, lane_bits=24, operand_bits=24, signed=True),
}


def eq2_max_chain(m: int, n: int, low_lane_bits: int, signed: bool = True) -> int:
    """Paper Eq. 2: max number of MADs accumulated per packed unit before the
    low product lane overflows into the high lane.

    m: bit width of the per-lane packed operands (a_i / b_i)
    n: bit width of the shared operand (c_i)
    low_lane_bits: bits reserved for the low product lane (paper: 18)
    """
    if signed:
        return (2 ** (low_lane_bits - 1) - 1) // (2 ** (m - 1) * 2 ** (n - 1))
    return (2 ** low_lane_bits - 1) // ((2 ** m - 1) * (2 ** n - 1))


def muladd2_max_chain(m: int = 8, n: int = 8, *, target: dict = I32_LANE,
                      signed: bool = True) -> int:
    """Chain bound for factor-2 MAD packing on the given target.

    On the paper's DSP (L=18, m=n=8, signed) this returns 7 -- the figure
    quoted in paper section 2.2.  On the i32 lane (L=16) the same
    operands give N=1 (pack the multiply only; accumulate outside), while
    4-bit packed operands (m=4) give N=31, enabling genuine in-lane chains
    for the w4a8 serving path.
    """
    return max(1, eq2_max_chain(m, n, target["low_lane_bits"], signed))


def mul4_layout(target: dict = I32_LANE) -> dict:
    """Bit layout for factor-4 4-bit multiplication packing (paper sec. 2.3).

    The paper maps three zero-padded 4-bit operands plus the 3 MSBs of the
    fourth onto the 27-bit multiplier port; the fourth product is patched with
    `(a3 & 1) * b` in LUTs (Eq. 4).  On a 32-bit integer lane the same layout
    uses 8-bit product lanes at offsets 0/8/16/24, with lane 3 carrying
    a3[3:1] so its partial product (<= 2^3 * 2^3 * 2^24 = 2^30) cannot
    overflow the 32-bit register.
    """
    assert target["mult_bits"] >= 32
    return dict(lane_bits=8, offsets=(0, 8, 16, 24), msb_lane=3, msb_shift=1)


def add_mode_for_width(width: int, prefer_i32: bool = True) -> LaneBudget | None:
    """Pick the SIMD-add mode for an operand width (None if unpackable)."""
    modes = ("four8", "two16") if prefer_i32 else ("four12", "two24")
    for name in modes:
        if width <= ADD_MODES[name].operand_bits:
            return ADD_MODES[name]
    return None


Signedness = Literal["signed", "unsigned"]
