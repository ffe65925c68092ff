"""Packed-operation primitives of the SILVIA passes.

Port of `repro/core/prims.py`.  These play the role of the paper's
`call @silvia_*` functions (Fig. 4c): a tuple of narrow scalar-per-lane
operations is replaced by ONE call to a packed implementation.

* `packed_add`, `packed_muladd`, `packed_mul4` are plain functions.  A
  rewritten graph calls them from a `call_function` node (followed by
  `operator.getitem` nodes for the results); each binds through the
  lowering registry (`kernels/registry.py`) -- the paper's sec. 3.3
  placeholder -> technology-library binding: the Hopper kernels for CUDA
  operands, the plain versions for CPU ones.  Each call counts as ONE
  functional unit for the Ops/Unit metric; `packed_op_counts` reads the
  number of logical narrow ops it computes off the node.
* `width_hint` is the analogue of the HLS frontend's width-minimization
  metadata: an identity that declares "this tensor's values fit in
  `width` bits".  It is a `torch.library` custom op
  (`repro_torch::silvia_width_hint`) with a fake implementation, so it
  survives `make_fx` tracing as a graph node the width analysis reads; a
  plain Python function would be traced through and vanish.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import registry


# ---------------------------------------------------------------------------
# silvia_width_hint: value-range metadata
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::silvia_width_hint", mutates_args=())
def _width_hint_op(x: torch.Tensor, width: int,
                   signed: bool) -> torch.Tensor:
    # a custom op may not return its input: a copy keeps the identity
    return x.clone()


@_width_hint_op.register_fake
def _width_hint_fake(x, width, signed):
    return torch.empty_like(x)


WIDTH_HINT = torch.ops.repro_torch.silvia_width_hint.default


def width_hint(x, width: int, signed: bool = True):
    """Declare that `x` (an integer tensor) only holds `width`-bit
    values."""
    return _width_hint_op(x, int(width), bool(signed))


# ---------------------------------------------------------------------------
# the packed units
# ---------------------------------------------------------------------------

def _dtype(name):
    return getattr(torch, name)


def packed_add(xs: Sequence, ys: Sequence, *, mode: str, lane_bits: int,
               sub: bool, out_dtypes: Sequence[str]):
    """k lane-wise additions (or subtractions) in one SIMD unit
    (SILVIAAdd); returns k tensors of the given dtypes."""
    outs = registry.dispatch("simd_add", list(xs), list(ys), sub=sub,
                             lane_bits=lane_bits)
    return [o.to(_dtype(d)) for o, d in zip(outs, out_dtypes)]


def packed_muladd(a: Sequence, b: Sequence, c: Sequence, *, out_dtype: str):
    """p_a = sum_i a_i*c_i ; p_b = sum_i b_i*c_i (paper Eq. 1)."""
    if not len(a) == len(b) == len(c):
        raise ValueError(f"packed_muladd: chains of length {len(a)}, "
                         f"{len(b)}, {len(c)}")
    p_a, p_b = registry.dispatch("muladd2", list(a), list(b), list(c))
    return [p_a.to(_dtype(out_dtype)), p_b.to(_dtype(out_dtype))]


def packed_mul4(a: Sequence, b, *, out_dtypes: Sequence[str]):
    """p_i = a_i * b, i in 0..3 (paper Eq. 3), on signed 4-bit operands."""
    if len(a) != 4:
        raise ValueError(f"packed_mul4 needs 4 operands, got {len(a)}")
    outs = registry.dispatch("mul4", list(a), b)
    return [o.to(_dtype(d)) for o, d in zip(outs, out_dtypes)]


# ---------------------------------------------------------------------------
# op-count metadata: logical narrow ops computed per packed unit
# ---------------------------------------------------------------------------

PACKED_PRIMS = {packed_add, packed_muladd, packed_mul4}


def packed_op_counts(node) -> dict:
    """{'mul': m, 'add': a} logical narrow op counts of a packed node (a
    `call_function` node whose target is one of PACKED_PRIMS)."""
    fn = node.target
    if fn is packed_add:
        return {"mul": 0, "add": len(node.args[0])}
    if fn is packed_muladd:
        n = len(node.args[0])
        return {"mul": 2 * n, "add": 2 * (n - 1)}
    if fn is packed_mul4:
        return {"mul": 4, "add": 0}
    raise ValueError(f"not a packed primitive: {fn}")
