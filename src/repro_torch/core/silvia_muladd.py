"""SILVIAMuladd: pack shared-operand multiply-and-add trees (paper sec.
2.2, 2.3, 3).

Port of `repro/core/silvia_muladd.py`.

Factor-2 (SILVIAMuladd): two MAD trees `p_a = sum a_i*c_i`,
`p_b = sum b_i*c_i` sharing the c_i operands pack onto one unit (wp486).
A degenerate tree of a single multiplication is a valid candidate too,
so mul-only packing falls out for free (paper sec. 3.1).  Chains longer
than the Eq. 2 bound split into balanced segments summed by an external
adder tree (paper sec. 3.3).

Factor-4 (SILVIAMul4): four <=4-bit multiplications by one shared factor
pack onto one unit (paper sec. 2.3).

The units compute in signed lanes, so every operand is fitted on its
two's-complement width (`Width.signed_bits`): an unsigned 8-bit value
does not fit an 8-bit lane.  The reference fits on `bits` alone and
packs such operands into wrong results (ROADMAP C-ref3).

`make_fx` does not merge repeated expressions: `t.to(torch.int32)`
written twice is two `_to_copy` nodes over one source.  The shared
operand is therefore matched on the width analysis' `match_src`, which
looks through widening conversions to the source node, and a literal
(a Python scalar, or an `aten.scalar_tensor` node such as the 0 of
`torch.where(s, w, 0)`) is matched by value.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import bounds, ir, prims
from repro_torch.core.silvia import SILVIA, BBContext, Candidate, Tuple_


def _key_of(src) -> Any:
    """Hashable identity key for a shared-operand source."""
    if ir.is_literal(src):
        return ("lit", type(src.value).__name__, src.value)
    item_name = getattr(src, "target", None)
    if item_name is torch.ops.aten.scalar_tensor.default:
        return ("lit", str(ir.dtype_of(src)), src.args[0])
    return src


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


@dataclasses.dataclass
class Leaf:
    mul_idx: int
    ops: tuple   # per operand: (signed_bits, value_src, match_key)
    shape: tuple


@dataclasses.dataclass
class Tree:
    root_idx: int
    eqns: frozenset
    leaves: list        # of Leaf
    root_var: Any
    out_dtype: str
    shape: tuple


def _collect_trees(ctx: BBContext, m_bits: int, c_bits: int) -> list[Tree]:
    """Find maximal add-trees whose leaves are narrow multiplications
    (paper sec. 3.1, getCandidates of SILVIAMuladd)."""
    use_counts = {v: len(us) for v, us in ctx.use_idxs.items()}
    info: dict[int, Tree] = {}           # item idx -> tree rooted there
    consumed_roots: set[int] = set()     # roots absorbed by a larger tree
    for i, it in enumerate(ctx.eqns):
        if it.effects or not it.outvars:
            continue
        out = it.outvars[0]
        if it.name not in ("mul", "add"):
            continue
        dt = ir.dtype_of(out)
        if not ir.is_int_dtype(dt):
            continue
        if it.name == "mul":
            x, y = it.operands
            w0 = ctx.widths.width_of(x)
            w1 = ctx.widths.width_of(y)
            # one operand within m_bits (packed lanes), the other within
            # c_bits (shared); either assignment may hold -- resolved at
            # pairing
            b0, b1 = w0.signed_bits, w1.signed_bits
            fits = ((b0 <= m_bits and b1 <= c_bits)
                    or (b1 <= m_bits and b0 <= c_bits))
            if not fits:
                continue
            leaf = Leaf(
                mul_idx=i,
                ops=((b0, w0.value_src, _key_of(w0.match_src)),
                     (b1, w1.value_src, _key_of(w1.match_src))),
                shape=ir.shape_of(out))
            info[i] = Tree(i, frozenset([i]), [leaf], out, _dtype_name(dt),
                           ir.shape_of(out))
        else:
            subs = []
            ok = True
            for v in it.operands:
                if ir.is_literal(v):
                    ok = False
                    break
                d = ctx.def_idx.get(v)
                if d is None or d not in info or use_counts.get(v, 0) != 1:
                    ok = False
                    break
                subs.append(d)
            if not ok or len(set(subs)) != 2:
                continue
            t0, t1 = info[subs[0]], info[subs[1]]
            info[i] = Tree(i, t0.eqns | t1.eqns | frozenset([i]),
                           t0.leaves + t1.leaves, out, _dtype_name(dt),
                           ir.shape_of(out))
            consumed_roots |= {subs[0], subs[1]}
    return [t for i, t in info.items() if i not in consumed_roots]


def _match_leaves(t1: Tree, t2: Tree, m_bits: int, c_bits: int):
    """Pair leaves of two trees by a shared operand (paper Eq. 1): returns
    [(a_src, b_src, c_src)] per pair or None.  Greedy bipartite match on
    shared-operand identity."""
    if len(t1.leaves) != len(t2.leaves):
        return None
    used = [False] * len(t2.leaves)
    pairs = []
    for l1 in t1.leaves:
        found = False
        for j, l2 in enumerate(t2.leaves):
            if used[j]:
                continue
            # choose which operand is shared: same match key, fits c_bits;
            # the remaining operands must fit m_bits
            for s1 in (0, 1):
                for s2 in (0, 1):
                    cw1, csrc1, ck1 = l1.ops[s1]
                    cw2, _, ck2 = l2.ops[s2]
                    aw, asrc, _ = l1.ops[1 - s1]
                    bw, bsrc, _ = l2.ops[1 - s2]
                    if (ck1 == ck2 and cw1 <= c_bits and cw2 <= c_bits
                            and aw <= m_bits and bw <= m_bits):
                        pairs.append((asrc, bsrc, csrc1))
                        used[j] = True
                        found = True
                        break
                if found:
                    break
            if found:
                break
        if not found:
            return None
    return pairs


class SILVIAMuladd(SILVIA):
    """Factor-2 shared-operand MAD packing (paper sec. 2.2)."""

    name = "silvia_muladd"

    def __init__(self, m_bits: int = 8, c_bits: int = 8,
                 max_chain_len: int | None = None):
        self.m_bits = m_bits
        self.c_bits = c_bits
        self.n_max = bounds.muladd2_max_chain(m_bits, c_bits)
        if max_chain_len is not None:      # the paper's MAX_CHAIN_LEN
            self.n_max = min(self.n_max, max_chain_len)

    def get_candidates(self, ctx: BBContext):
        cands = []
        for t in _collect_trees(ctx, self.m_bits, self.c_bits):
            reads = []
            for leaf in t.leaves:
                reads.extend([leaf.ops[0][1], leaf.ops[1][1]])
            cands.append(Candidate(
                root=t.root_idx, covered=t.eqns, reads=tuple(reads),
                root_vars=(t.root_var,), meta=t))
        return cands

    def can_pack(self, tup: Tuple_, cand: Candidate, ctx: BBContext) -> bool:
        t1: Tree = tup.cands[0].meta
        t2: Tree = cand.meta
        if t1.shape != t2.shape or t1.out_dtype != t2.out_dtype:
            return False
        return _match_leaves(t1, t2, self.m_bits, self.c_bits) is not None

    def is_tuple_full(self, tup: Tuple_) -> bool:
        return len(tup.cands) == 2

    def tuple_viable(self, tup: Tuple_) -> bool:
        return False   # a lone MAD tree stays as is (resource sharing, 3.5.2)

    def pack_tuple(self, tup: Tuple_, ctx: BBContext) -> ir.PackedItem:
        t1: Tree = tup.cands[0].meta
        t2: Tree = tup.cands[1].meta
        pairs = _match_leaves(t1, t2, self.m_bits, self.c_bits)
        n = len(pairs)
        kwargs = dict(out_dtype=t1.out_dtype)
        roots = [t1.root_var, t2.root_var]
        # Eq. 2 split: balanced segments, external adder tree (sec. 3.3)
        n_seg = -(-n // self.n_max)
        seg_len = -(-n // n_seg)

        def emit(graph, invals):
            a, b, c = invals[:n], invals[n:2 * n], invals[2 * n:]
            parts = []
            for s in range(0, n, seg_len):
                e = min(s + seg_len, n)
                node = ir.call(graph, prims.packed_muladd,
                               (a[s:e], b[s:e], c[s:e]), kwargs)
                parts.append(ir.unpack(graph, node, roots))
            outs = []
            for lane, root in enumerate(roots):
                acc = parts[0][lane]
                for p in parts[1:]:
                    acc = ir.call(graph, torch.ops.aten.add.Tensor,
                                  (acc, p[lane]), like=root)
                outs.append(acc)
            return outs

        return ir.PackedItem(
            emit=emit, in_vars=[p[0] for p in pairs] + [p[1] for p in pairs]
            + [p[2] for p in pairs],
            out_vars=roots)


class SILVIAMul4(SILVIA):
    """Factor-4 4-bit multiplication packing (paper sec. 2.3)."""

    name = "silvia_mul4"

    def get_candidates(self, ctx: BBContext):
        cands = []
        for t in _collect_trees(ctx, m_bits=4, c_bits=4):
            if len(t.leaves) != 1:     # mul-only packing
                continue
            leaf = t.leaves[0]
            cands.append(Candidate(
                root=t.root_idx, covered=t.eqns,
                reads=(leaf.ops[0][1], leaf.ops[1][1]),
                root_vars=(t.root_var,), meta=t))
        return cands

    def _shared_key(self, tup: Tuple_):
        """Shared-operand keys compatible with every member so far."""
        keys = None
        for c in tup.cands:
            leaf = c.meta.leaves[0]
            ks = {leaf.ops[0][2], leaf.ops[1][2]}
            keys = ks if keys is None else keys & ks
        return keys or set()

    def can_pack(self, tup: Tuple_, cand: Candidate, ctx: BBContext) -> bool:
        t1: Tree = tup.cands[0].meta
        t2: Tree = cand.meta
        if t1.shape != t2.shape or t1.out_dtype != t2.out_dtype:
            return False
        leaf = t2.leaves[0]
        return bool(self._shared_key(tup) & {leaf.ops[0][2], leaf.ops[1][2]})

    def is_tuple_full(self, tup: Tuple_) -> bool:
        return len(tup.cands) == 4

    def tuple_viable(self, tup: Tuple_) -> bool:
        return len(tup.cands) == 4

    def pack_tuple(self, tup: Tuple_, ctx: BBContext) -> ir.PackedItem:
        shared = sorted(self._shared_key(tup), key=str)[0]
        a_srcs, b_src = [], None
        for c in tup.cands:
            leaf = c.meta.leaves[0]
            if leaf.ops[0][2] == shared:
                ci, ai = leaf.ops[0], leaf.ops[1]
            else:
                ci, ai = leaf.ops[1], leaf.ops[0]
            a_srcs.append(ai[1])
            if b_src is None:
                b_src = ci[1]
        roots = [c.root_vars[0] for c in tup.cands]
        kwargs = dict(out_dtypes=tuple(c.meta.out_dtype for c in tup.cands))

        def emit(graph, invals):
            node = ir.call(graph, prims.packed_mul4, (invals[:4], invals[4]),
                           kwargs)
            return ir.unpack(graph, node, roots)

        return ir.PackedItem(emit=emit, in_vars=a_srcs + [b_src],
                             out_vars=roots)
