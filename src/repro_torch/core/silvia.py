"""SILVIA base transformation pass -- paper Algorithm 1 on fx graph BBs.

Port of `repro/core/silvia.py`:

    C   <- getCandidates(BB)
    BB* <- BB
    for c in C: BB* <- moveUsesALAP(c, BB*)      # here: one global ALAP pass
    T   <- getTuples(C)                          # legality + canPack + full
    for T in T: BB* <- replaceTuple(T, packTuple(T), BB*)
    (then dead-code elimination)

Derived passes override `get_candidates`, `can_pack`, `is_tuple_full` and
`pack_tuple`, mirroring the paper's class structure (sec. 3).

One departure from the reference, in `get_tuples`: the reference checks
only DIRECT def-use between a candidate and a tuple's members, so two
tuples each holding a member that depends on the other can both form,
and packing them builds a cycle.  Here a candidate joins a tuple only if
the graph with every tuple of two or more members contracted into one
node -- what the packed graph will be -- stays acyclic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from torch import fx

from repro_torch.core import ddg, ir


@dataclasses.dataclass
class Candidate:
    """A packable pattern rooted at one item.

    covered:   indices of ALL items consumed by packing this candidate
               (a single add for SILVIAAdd; a whole MAD tree for
               SILVIAMuladd).
    reads:     nodes (or Consts) the packed implementation will read
               (narrow value sources -- the original converts become dead).
    root_vars: nodes whose uses must be rewired to the packed results.
    meta:      pass-specific payload (widths, leaves, shared operands ...).
    """
    root: int
    covered: frozenset
    reads: tuple
    root_vars: tuple
    meta: Any = None


@dataclasses.dataclass
class Tuple_:
    cands: list
    last_def: int      # max position of any read's definition
    first_use: int     # min position of any external use of any root var
    defs: set = dataclasses.field(default_factory=set)   # nodes defined by
    reads: set = dataclasses.field(default_factory=set)  # covered items


class BBContext:
    """Analysis state for one basic block (one traced graph).

    `eqns` is a schedule of ITEMS (ir.EqnItem / ir.PackedItem): a packing
    rewrite splices packed items in via `patch()` and the analysis state
    (def/use, widths) is repaired locally, so one context survives the
    whole pass pipeline and the rewritten graph is emitted once at the
    end."""

    def __init__(self, gm: fx.GraphModule):
        self.gm = gm
        self.outvars = ir.outvars_of(gm)
        self.inputs = ir.inputs_of(gm)
        self.eqns = ir.alap_schedule(ir.items_of(gm), self.outvars)
        self.def_idx, self.use_idxs = ir.defs_uses(self.eqns, self.outvars)
        self.widths = ir.WidthAnalysis(self.eqns, self.outvars)
        self.patches = 0        # in-place packing rewrites applied

    @property
    def dirty(self) -> bool:
        """True when the schedule diverged from the graph and the caller
        must emit_graph(gm, ctx.eqns) to materialize it."""
        return self.patches > 0

    def patch(self, items: list) -> None:
        """Splice a rewritten (packed + DCE'd) item schedule in without
        re-emitting the graph: re-ALAP over the items, rebuild the def/use
        maps, and rebind the width analysis pruning only memo entries
        whose nodes died."""
        self.eqns = ir.alap_schedule(items, self.outvars)
        self.def_idx, self.use_idxs = ir.defs_uses(self.eqns, self.outvars)
        self.widths.rebind(self.eqns, self.outvars,
                           set(self.def_idx) | set(self.inputs))
        self.patches += 1

    def pos_of_def(self, v) -> int:
        """Schedule position of v's defining item (-1 for inputs)."""
        if ir.is_literal(v):
            return -1
        return self.def_idx.get(v, -1)

    def last_def(self, reads: Sequence) -> int:
        return max([self.pos_of_def(v) for v in reads], default=-1)

    def first_external_use(self, root_vars: Sequence,
                           covered: frozenset) -> int:
        first = ir.OUT_SENTINEL
        for v in root_vars:
            for u in self.use_idxs.get(v, []):
                if u == ir.OUT_SENTINEL or u not in covered:
                    first = min(first, u)
        return first

    def interval(self, cand: Candidate) -> tuple[int, int]:
        return (self.last_def(cand.reads),
                self.first_external_use(cand.root_vars, cand.covered))


class _Contraction:
    """Acyclicity of the item graph with groups of items contracted into
    one node each: a group (a tuple about to be packed) is one packed call
    that reads its candidates' `reads` and defines their root nodes."""

    def __init__(self, ctx: BBContext):
        self.ctx = ctx
        self.preds = ir.dependency_edges(ctx.eqns, ctx.def_idx)

    def acyclic(self, groups: list[tuple[frozenset, set]]) -> bool:
        n = len(self.preds)
        rep = {}
        for g, (covered, _) in enumerate(groups):
            for i in covered:
                rep[i] = n + g
        preds = {}
        for i, ps in enumerate(self.preds):
            if i not in rep:
                preds[i] = {rep.get(p, p) for p in ps}
        for g, (_, reads) in enumerate(groups):
            preds[n + g] = {rep.get(p, p) for p in
                            (self.ctx.pos_of_def(v) for v in reads)
                            if p >= 0}
        consumers: dict[int, list[int]] = {k: [] for k in preds}
        indeg = {k: 0 for k in preds}
        for k, ps in preds.items():
            for p in ps:
                consumers[p].append(k)
                indeg[k] += 1
        stack = [k for k, d in indeg.items() if d == 0]
        seen = 0
        while stack:
            k = stack.pop()
            seen += 1
            for c in consumers[k]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    stack.append(c)
        return seen == len(preds)


class SILVIA:
    """Base pass.  run() applies Algorithm 1 to one traced graph."""

    name = "silvia"
    # paper sec. 3.5.1 leaves II-aware tuple filtering to future work;
    # filter_ii=True drops tuples whose super-node would create a new
    # critical cycle in a loop body (needs the enclosing scan's
    # loop_info, which the pass pipeline supplies)
    filter_ii = False

    # -- hooks for derived passes (paper sec. 3: blue functions) ------------
    def get_candidates(self, ctx: BBContext) -> list[Candidate]:
        raise NotImplementedError

    def can_pack(self, tup: Tuple_, cand: Candidate, ctx: BBContext) -> bool:
        return True

    def is_tuple_full(self, tup: Tuple_) -> bool:
        raise NotImplementedError

    def tuple_viable(self, tup: Tuple_) -> bool:
        """Is a (possibly partial) tuple worth packing?  Default: >= 2."""
        return len(tup.cands) >= 2

    def pack_tuple(self, tup: Tuple_, ctx: BBContext) -> ir.PackedItem:
        raise NotImplementedError

    # -- Algorithm 1 ---------------------------------------------------------
    def get_tuples(self, cands: list[Candidate],
                   ctx: BBContext) -> list[Tuple_]:
        """Greedy in-schedule-order grouping under (a) independence +
        (b) insertion-point existence + (c) operation-specific constraints.

        Interval intersection (last_def < first_use pairwise-merged) and
        no direct def->use between members give the paper's independence
        (sec. 3.2.1); the contraction check keeps the tuples jointly
        packable (module docstring)."""
        open_tuples: list[Tuple_] = []
        closed: list[Tuple_] = []
        used_eqns: set[int] = set()
        contraction = _Contraction(ctx)

        def defs_of(cand: Candidate) -> set:
            return {v for i in cand.covered for v in ctx.eqns[i].outvars}

        def reads_of(cand: Candidate) -> set:
            return {v for v in cand.reads if not ir.is_literal(v)}

        def group(tup: Tuple_, extra: Candidate | None = None):
            cands = tup.cands + ([extra] if extra is not None else [])
            return (frozenset().union(*[c.covered for c in cands]),
                    set().union(*[reads_of(c) for c in cands]))

        def joint_ok(tup: Tuple_, cand: Candidate) -> bool:
            groups = [group(t) for t in open_tuples + closed
                      if t is not tup and len(t.cands) >= 2]
            return contraction.acyclic(groups + [group(tup, cand)])

        for cand in sorted(cands, key=lambda c: c.root):
            if cand.covered & used_eqns:
                continue
            last_def, first_use = ctx.interval(cand)
            if last_def >= first_use:
                continue  # no room even alone (pre-ALAP Fig. 4a situation)
            c_defs, c_reads = defs_of(cand), reads_of(cand)
            placed = False
            for tup in open_tuples:
                new_ld = max(tup.last_def, last_def)
                new_fu = min(tup.first_use, first_use)
                if new_ld >= new_fu:
                    continue  # no common insertion point
                if (c_reads & tup.defs) or (tup.reads & c_defs):
                    continue  # direct dependence, paper condition (a)
                if not self.can_pack(tup, cand, ctx):
                    continue
                if not joint_ok(tup, cand):
                    continue
                tup.cands.append(cand)
                tup.last_def, tup.first_use = new_ld, new_fu
                tup.defs |= c_defs
                tup.reads |= c_reads
                used_eqns |= cand.covered
                placed = True
                if self.is_tuple_full(tup):
                    open_tuples.remove(tup)
                    closed.append(tup)
                break
            if not placed:
                tup = Tuple_([cand], last_def, first_use, c_defs, c_reads)
                used_eqns |= cand.covered
                open_tuples.append(tup)
        closed.extend(t for t in open_tuples if self.tuple_viable(t))
        return closed

    def run_ctx(self, ctx: BBContext, loop_info=None) -> dict:
        """Apply Algorithm 1 against a shared BBContext, rewriting IN
        PLACE via ctx.patch(); the caller checks ctx.dirty to decide
        whether to emit.  Returns the stats dict.

        loop_info: (num_carry, num_xs, num_additional) when this BB is a
        scan body -- enables the II-aware tuple filter (sec. 3.5.1)."""
        cands = self.get_candidates(ctx)
        stats = {"candidates": len(cands), "tuples": 0, "packed_ops": 0,
                 "ii_dropped": 0}
        if not cands:
            return stats
        tuples = self.get_tuples(cands, ctx)
        if tuples and self.filter_ii and loop_info is not None:
            tuples, stats["ii_dropped"] = self._filter_ii_tuples(
                tuples, ctx, loop_info)
        if not tuples:
            return stats
        stats["tuples"] = len(tuples)
        stats["packed_ops"] = sum(len(t.cands) for t in tuples)
        # replaceTuple: splice packed items in at a valid insertion point,
        # drop covered items, then DCE.
        consumed: set[int] = set()
        inserts: dict[int, list[ir.PackedItem]] = {}
        for tup in tuples:
            item = self.pack_tuple(tup, ctx)
            pos = tup.first_use if tup.first_use != ir.OUT_SENTINEL \
                else len(ctx.eqns)
            inserts.setdefault(pos, []).append(item)
            for c in tup.cands:
                consumed |= c.covered
        items: list = []
        for i, it in enumerate(ctx.eqns):
            items.extend(inserts.get(i, []))
            if i not in consumed:
                items.append(it)
        items.extend(inserts.get(len(ctx.eqns), []))
        ctx.patch(ir.dce_items(items, ctx.outvars))
        return stats

    def _filter_ii_tuples(self, tuples, ctx: BBContext, loop_info):
        """Drop tuples whose packed super-node raises II_min (Fig. 5).

        The DDG is built over the ALAP schedule (ctx.eqns), unit
        latencies, with distance-1 edges from each carry output to the
        uses of its carry input."""
        num_carry = loop_info[0]
        g = ddg.DDG([1] * len(ctx.eqns),
                    ddg.loop_edges(ctx.eqns, ctx.def_idx, ctx.use_idxs,
                                   ctx.gm, num_carry))
        base_ii = g.ii_min()
        kept, dropped = [], 0
        for tup in tuples:
            group = sorted(set().union(*[c.covered for c in tup.cands]))
            if g.with_merged(group).ii_min() > base_ii:
                dropped += 1
            else:
                kept.append(tup)
        return kept, dropped
