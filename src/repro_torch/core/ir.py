"""Basic-block model over ATen-level `torch.fx` graphs for the SILVIA
passes.

Port of `repro/core/ir.py`, with a `make_fx` graph in the jaxpr's place.
`torch.fx.experimental.proxy_tensor.make_fx` traces a function into a
straight-line graph of ATen primitives whose nodes carry their dtype and
shape in `node.meta["val"]`, as a jaxpr's avals do, so a traced graph IS
a basic block.  This module provides what Algorithm 1 needs on it:

* the schedule-item representation: `EqnItem` wraps one `call_function`
  node (`name` is the jaxpr primitive it corresponds to, see `prim_name`),
  `PackedItem` a packed call that replaces a tuple of candidates;
  Python-scalar operands are `Const` literals,
* def-use chains (`defs_uses`), ALAP scheduling (`alap_schedule`, the
  generalization of the paper's `moveUsesALAP`), dead-code elimination
  over items (`dce_items`, paper sec. 3.4),
* width inference (`WidthAnalysis`): bit widths traced through widening
  `_to_copy`, broadcasts and `silvia_width_hint` nodes,
* `emit_graph`, which rebuilds a GraphModule from a transformed item
  schedule (the paper's BB -> BB* rewrite).

A control-flow higher-order op (`torch.ops.higher_order.scan`, `cond`,
`while_loop`) keeps each body as a sub-GraphModule that a `get_attr`
node names; the pass pipeline treats every body as a BB of its own.

ATen node -> jaxpr primitive (`prim_name`):

    aten._to_copy                  convert_element_type
    aten.mul / add / sub           mul / add / sub (add/sub only alpha=1)
    aten.unsqueeze / expand, and   broadcast_in_dim
      a view that only adds or
      drops unit dims (and their
      functionalized `_copy` forms,
      which a HOP body holds)
    aten.bitwise_and               and
    repro_torch::silvia_width_hint silvia_width_hint
    aten.scalar_tensor             a literal (constant node)

Width does not pass through indexing (`aten.select`, `slice`), as it
does not through the reference's slice and squeeze.  It does pass
through a view that only adds or drops unit dims, which `make_fx` may
emit for what the reference traces as `broadcast_in_dim`; the
reference's `reshape` stops it, so a program that reshapes to add a
unit dim can pack here and not there.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Sequence

import torch
from torch import fx

from repro_torch.core import prims

aten = torch.ops.aten


@dataclasses.dataclass(frozen=True)
class Const:
    """A literal operand: a Python scalar in a node's arguments."""
    value: Any


def is_literal(v) -> bool:
    return isinstance(v, Const)


# ---------------------------------------------------------------------------
# node helpers: jaxpr primitive names, dtypes, operands
# ---------------------------------------------------------------------------

_PRIMS = {
    aten._to_copy.default: "convert_element_type",
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.add.Tensor: "add", aten.add.Scalar: "add",
    aten.sub.Tensor: "sub", aten.sub.Scalar: "sub",
    aten.unsqueeze.default: "broadcast_in_dim",
    aten.expand.default: "broadcast_in_dim",
    aten.unsqueeze_copy.default: "broadcast_in_dim",
    aten.expand_copy.default: "broadcast_in_dim",
    aten.bitwise_and.Scalar: "and", aten.bitwise_and.Tensor: "and",
    prims.WIDTH_HINT: "silvia_width_hint",
    aten.scalar_tensor.default: "scalar_tensor",
}


def val_of(node: fx.Node):
    """The example value (a fake tensor) a traced node carries."""
    return node.meta.get("val")


def dtype_of(node: fx.Node):
    return val_of(node).dtype


def shape_of(node: fx.Node) -> tuple:
    return tuple(val_of(node).shape)


def _unit_dims_only(node: fx.Node) -> bool:
    """A view that only inserts or removes size-1 dims."""
    src = node.args[0]
    strip = lambda s: [d for d in s if d != 1]
    return strip(shape_of(src)) == strip(shape_of(node))


# views that are a broadcast when they only add or drop unit dims; under
# `torch.func.functionalize` a HOP body holds the `_copy` form.  A squeeze
# stops width, as the reference's does, at the top level and in a body.
_UNIT_VIEWS = {aten.view.default, aten.view_copy.default}


def prim_name(node: fx.Node) -> str:
    name = _PRIMS.get(node.target)
    if name in ("add", "sub") and node.kwargs.get("alpha", 1) != 1:
        return str(node.target)
    if name is None and node.target in _UNIT_VIEWS \
            and _unit_dims_only(node):
        return "broadcast_in_dim"
    return name if name is not None else str(node.target)


def is_int_dtype(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


_INT_BITS = {torch.int8: 8, torch.uint8: 8, torch.int16: 16,
             torch.uint16: 16, torch.int32: 32, torch.uint32: 32,
             torch.int64: 64, torch.uint64: 64, torch.bool: 1}
_UNSIGNED = {torch.uint8, torch.uint16, torch.uint32, torch.uint64}


def dtype_bits(dtype) -> int | None:
    return _INT_BITS.get(dtype)


# ---------------------------------------------------------------------------
# schedule items
# ---------------------------------------------------------------------------

class EqnItem:
    """One `call_function` node of the traced graph."""

    def __init__(self, node: fx.Node):
        self.node = node
        self.name = prim_name(node)
        ins: list = []
        fx.node.map_arg((node.args, node.kwargs), ins.append)
        self.invars = ins                 # Node inputs, in argument order
        self.outvars = [node]
        self.effects = node.is_impure()

    @property
    def operands(self) -> list:
        """The positional tensor operands, Python scalars as Const."""
        n = 2 if self.name in ("mul", "add", "sub", "and") else 1
        return [a if isinstance(a, fx.Node) else Const(a)
                for a in self.node.args[:n]]


@dataclasses.dataclass
class PackedItem:
    """A packed-operation call replacing a tuple of candidates.

    emit(graph, invals) -> list of new nodes, one per out_var (the
    original candidates' root nodes, so downstream uses are rewired for
    free).  Its name matches no packable pattern, so a later pass never
    tries to re-pack it."""
    emit: Callable[[fx.Graph, list], list]
    in_vars: list           # Nodes / Consts the packed call reads
    out_vars: list          # original root nodes its results replace
    name: str = "silvia_packed"
    effects: bool = False

    @property
    def invars(self):
        return [v for v in self.in_vars if not is_literal(v)]

    @property
    def outvars(self):
        return self.out_vars


def items_of(gm: fx.GraphModule) -> list:
    return [EqnItem(n) for n in gm.graph.nodes if n.op == "call_function"]


def inputs_of(gm: fx.GraphModule) -> list:
    """The BB's inputs: placeholders and constant attributes."""
    return [n for n in gm.graph.nodes if n.op in ("placeholder", "get_attr")]


def attr_of(gm: fx.GraphModule, target: str):
    """The attribute a `get_attr` node names (a dotted path)."""
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def output_node(gm: fx.GraphModule) -> fx.Node:
    return next(n for n in reversed(gm.graph.nodes) if n.op == "output")


def outvars_of(gm: fx.GraphModule) -> list:
    found: list = []
    fx.node.map_arg(output_node(gm).args, found.append)
    return found


def output_leaves(gm: fx.GraphModule) -> list:
    """The graph's outputs in order, one per returned value (a Node, or a
    Python value the graph returns as is)."""
    leaves: list = []
    for a in output_node(gm).args:
        leaves.extend(a if isinstance(a, (list, tuple)) else [a])
    return leaves


def placeholders_of(gm: fx.GraphModule) -> list:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def call(graph: fx.Graph, target, args, kwargs=None, *, like=None):
    """A call_function node carrying `like`'s example value (dtype and
    shape) in its meta, so the op count and a later pass can read it."""
    node = graph.call_function(target, tuple(args), kwargs or {})
    if like is not None:
        node.meta["val"] = val_of(like)
    return node


def unpack(graph: fx.Graph, packed: fx.Node, like: Sequence) -> list:
    """`operator.getitem` nodes for the results of a packed call."""
    return [call(graph, operator.getitem, (packed, i), like=v)
            for i, v in enumerate(like)]


# ---------------------------------------------------------------------------
# def-use chains
# ---------------------------------------------------------------------------

OUT_SENTINEL = 1 << 60  # "position" of the BB's outputs


def defs_uses(items: Sequence, outvars: Sequence):
    """(def_idx, use_idxs): node -> defining item index / list of using
    item indices.  Uses by the BB outputs appear as OUT_SENTINEL."""
    def_idx: dict[Any, int] = {}
    use_idxs: dict[Any, list[int]] = {}
    for i, it in enumerate(items):
        for v in it.invars:
            use_idxs.setdefault(v, []).append(i)
        for v in it.outvars:
            def_idx[v] = i
    for v in outvars:
        use_idxs.setdefault(v, []).append(OUT_SENTINEL)
    return def_idx, use_idxs


def dependency_edges(items: Sequence, def_idx: dict) -> list[set[int]]:
    """preds[i] = item indices that must precede item i: the definitions
    of its inputs, and the previous item with effects if it has any (the
    analogue of the paper's conservative treatment of calls that may alias
    memory)."""
    preds: list[set[int]] = [set() for _ in items]
    prev_effectful = None
    for i, it in enumerate(items):
        for v in it.invars:
            if v in def_idx:
                preds[i].add(def_idx[v])
        if it.effects:
            if prev_effectful is not None:
                preds[i].add(prev_effectful)
            prev_effectful = i
    return preds


# ---------------------------------------------------------------------------
# ALAP scheduling (generalized moveUsesALAP)
# ---------------------------------------------------------------------------

def alap_schedule(items: Sequence, outvars: Sequence) -> list:
    """Reorder items so each is placed as late as possible while
    preserving data dependencies; items with effects keep their relative
    order.  Stable: ties resolve to the original order."""
    n = len(items)
    if n == 0:
        return list(items)
    def_idx, _ = defs_uses(items, outvars)
    consumers: list[set[int]] = [set() for _ in range(n)]
    for i, ps in enumerate(dependency_edges(items, def_idx)):
        for p in ps:
            consumers[p].add(i)
    # ALAP level: each item sits at min(consumer levels) - 1; items used
    # only by the BB outputs sit at level n.  A stable sort by (level,
    # original index) realizes the latest legal schedule.
    level = [n] * n
    for i in reversed(_topo_order(consumers, n)):
        for j in consumers[i]:
            level[i] = min(level[i], level[j] - 1)
    idx = sorted(range(n), key=lambda i: (level[i], i))
    return [items[i] for i in idx]


def _topo_order(consumers, n):
    indeg = [0] * n
    for i in range(n):
        for j in consumers[i]:
            indeg[j] += 1
    stack = [i for i in range(n) if indeg[i] == 0]
    out = []
    while stack:
        i = stack.pop()
        out.append(i)
        for j in consumers[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                stack.append(j)
    if len(out) != n:
        raise RuntimeError("dependency cycle in the item schedule")
    return out


# ---------------------------------------------------------------------------
# width inference
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Width:
    bits: int
    signed: bool
    value_src: Any   # node (or Const) holding the same VALUES, narrowest
    match_src: Any   # node for shared-operand identity (through broadcasts)

    @property
    def signed_bits(self) -> int:
        """Bits of a two's-complement lane that holds every value: an
        unsigned b-bit value needs b + 1."""
        return self.bits if self.signed else self.bits + 1


def literal_width(val) -> tuple[int, bool]:
    if isinstance(val, bool):
        return 1, False
    if isinstance(val, int):
        mag = val if val >= 0 else -val - 1
        return mag.bit_length() + 1, True
    return 64, True


class WidthAnalysis:
    """Lazy width inference over a BB's items."""

    def __init__(self, items: Sequence, outvars: Sequence):
        self.def_idx, _ = defs_uses(items, outvars)
        self.items = items
        self._memo: dict[Any, Width] = {}

    def width_of(self, v) -> Width:
        if is_literal(v):
            bits, signed = literal_width(v.value)
            return Width(bits, signed, v, v)
        if v in self._memo:
            return self._memo[v]
        w = self._compute(v)
        self._memo[v] = w
        return w

    def rebind(self, items: Sequence, outvars: Sequence, avail: set) -> None:
        """Re-point the analysis at a PATCHED item schedule (a packing
        rewrite of the same BB) without discarding the memo.  Packing is
        value-preserving and keeps the root nodes, so a memoized width
        stays correct while the nodes it references are live: entries
        whose subject or value/match source was DCE'd away are pruned (a
        later pass must not read a node that no longer has a
        definition)."""
        self.items = items
        self.def_idx, _ = defs_uses(items, outvars)

        def live(v):
            return is_literal(v) or v in avail

        self._memo = {v: w for v, w in self._memo.items()
                      if v in avail and live(w.value_src)
                      and live(w.match_src)}

    def _leaf(self, v) -> Width:
        dt = dtype_of(v)
        b = dtype_bits(dt)
        signed = dt not in _UNSIGNED if b is not None else True
        return Width(b if b is not None else 999, signed, v, v)

    def _compute(self, v) -> Width:
        i = self.def_idx.get(v)
        if i is None or not isinstance(self.items[i], EqnItem):
            return self._leaf(v)
        it = self.items[i]
        name = it.name
        if name == "scalar_tensor":           # a literal held in a node
            bits, signed = literal_width(it.node.args[0])
            return Width(bits, signed, v, v)
        if name == "convert_element_type":
            inw = self.width_of(it.operands[0])
            out_bits = dtype_bits(dtype_of(v))
            # keep the source only where the target type holds every
            # source value: a same-width cast that changes signedness
            # (int8 -1 -> uint8 255) does not preserve values (C-ref4)
            if out_bits is not None and (
                    out_bits >= inw.signed_bits
                    if dtype_of(v) not in _UNSIGNED
                    else not inw.signed and out_bits >= inw.bits):
                return Width(inw.bits, inw.signed, inw.value_src,
                             inw.match_src)
            return self._leaf(v)
        if name == "silvia_width_hint":
            src = it.operands[0]
            inw = self.width_of(src)
            width, signed = it.node.args[1], it.node.args[2]
            return Width(min(width, inw.bits), signed, src, inw.match_src)
        if name == "broadcast_in_dim":
            inw = self.width_of(it.operands[0])
            # a broadcast replicates values: identity for matching, but the
            # VALUE source is the broadcast node itself (shape matters)
            return Width(inw.bits, inw.signed, v, inw.match_src)
        if name == "and":
            a, b = it.operands
            for x, c in ((a, b), (b, a)):
                if is_literal(c) and isinstance(c.value, int) \
                        and not isinstance(c.value, bool) and c.value >= 0:
                    inw = self.width_of(x)
                    return Width(min(inw.bits, c.value.bit_length()),
                                 False, v, v)
            return self._leaf(v)
        return self._leaf(v)


# ---------------------------------------------------------------------------
# DCE + emit
# ---------------------------------------------------------------------------

def dce_items(items: list, outvars: Sequence) -> list:
    """Backward liveness over schedule items (paper sec. 3.4 DCE)."""
    live = set(outvars)
    keep = [False] * len(items)
    for i in range(len(items) - 1, -1, -1):
        it = items[i]
        if it.effects or any(v in live for v in it.outvars):
            keep[i] = True
            live.update(it.invars)
    return [it for i, it in enumerate(items) if keep[i]]


def emit_graph(gm: fx.GraphModule, items: list) -> fx.GraphModule:
    """Rebuild a GraphModule from a transformed item schedule (BB -> BB*):
    the inputs and the output of `gm`, the items in schedule order.  Every
    `get_attr` node is an input, so each attribute it names (a HOP body,
    rewritten or not, or a constant) is carried into the new module."""
    graph = fx.Graph()
    env: dict = {}
    copy = lambda n: graph.node_copy(n, lambda a: env[a])
    for node in inputs_of(gm):
        env[node] = copy(node)
    for it in items:
        if isinstance(it, EqnItem):
            env[it.node] = copy(it.node)
        else:
            invals = [v.value if is_literal(v) else env[v]
                      for v in it.in_vars]
            for ov, o in zip(it.out_vars, it.emit(graph, invals)):
                env[ov] = o
    copy(output_node(gm))
    return fx.GraphModule(gm, graph)
