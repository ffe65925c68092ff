"""SILVIAAdd: pack independent narrow additions/subtractions into one
SIMD lane op (paper sec. 2.1 / 3).

Port of `repro/core/silvia_add.py`.
Paper modes (48-bit DSP ALU): four12 / two24.
32-bit lane modes:            four8 / two16 (see core/bounds.py).

Legality: the packed lanes compute wrapped `lane_bits` two's-complement
sums.  A candidate is exact iff (a) its result provably fits the lane
(max signed operand width + 1 <= lane_bits), or (b) the original op already
wraps at the lane width (out dtype bits == lane_bits), mirroring the
paper's "operands up to 12/24 bits" constraint.
"""
from __future__ import annotations

from repro_torch.core import bounds, ir, prims
from repro_torch.core.silvia import SILVIA, BBContext, Candidate, Tuple_

_ADD_PRIMS = {"add": False, "sub": True}


class SILVIAAdd(SILVIA):
    name = "silvia_add"

    def __init__(self, op_size: int = 8, inst: str = "both"):
        if op_size not in (8, 16):
            raise ValueError("32-bit lane modes: four8 (8) / two16 (16)")
        self.mode = bounds.ADD_MODES["four8" if op_size == 8 else "two16"]
        self.inst = inst

    # -- candidate identification (paper sec. 3.1) --------------------------
    def get_candidates(self, ctx: BBContext):
        cands = []
        lane = self.mode.lane_bits
        for i, it in enumerate(ctx.eqns):
            if it.name not in _ADD_PRIMS or it.effects:
                continue
            if self.inst != "both" and it.name != self.inst:
                continue
            out = it.outvars[0]
            dt = ir.dtype_of(out)
            if not ir.is_int_dtype(dt):
                continue
            x, y = it.operands
            wx = ctx.widths.width_of(x)
            wy = ctx.widths.width_of(y)
            exact = max(wx.signed_bits, wy.signed_bits) + 1 <= lane
            wraps = ir.dtype_bits(dt) == lane
            if not (exact or wraps):
                continue
            cands.append(Candidate(
                root=i, covered=frozenset([i]),
                reads=(wx.value_src, wy.value_src),
                root_vars=(out,),
                meta=dict(sub=_ADD_PRIMS[it.name], shape=ir.shape_of(out),
                          out_dtype=str(dt).removeprefix("torch."))))
        return cands

    # -- operation-specific tuple validity (paper sec. 3.2.2) ---------------
    def can_pack(self, tup: Tuple_, cand: Candidate, ctx: BBContext) -> bool:
        m0 = tup.cands[0].meta
        return (m0["sub"] == cand.meta["sub"]
                and m0["shape"] == cand.meta["shape"])

    def is_tuple_full(self, tup: Tuple_) -> bool:
        return len(tup.cands) == self.mode.n_lanes

    def tuple_viable(self, tup: Tuple_) -> bool:
        return len(tup.cands) >= 2

    # -- tuple packing (paper sec. 3.3) --------------------------------------
    def pack_tuple(self, tup: Tuple_, ctx: BBContext) -> ir.PackedItem:
        cands = tup.cands
        k = len(cands)
        roots = [c.root_vars[0] for c in cands]
        kwargs = dict(mode=self.mode.name, lane_bits=self.mode.lane_bits,
                      sub=cands[0].meta["sub"],
                      out_dtypes=tuple(c.meta["out_dtype"] for c in cands))

        def emit(graph, invals):
            node = ir.call(graph, prims.packed_add,
                           (invals[:k], invals[k:]), kwargs)
            return ir.unpack(graph, node, roots)

        return ir.PackedItem(
            emit=emit, in_vars=[c.reads[0] for c in cands]
            + [c.reads[1] for c in cands],
            out_vars=roots)
