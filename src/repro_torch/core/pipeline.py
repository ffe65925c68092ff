"""SILVIA pass manager -- the analogue of the paper's
`SILVIA::csynth_design` Tcl drop-in (Fig. 6): an ordered list of pass
configs applied between the "frontend" (`make_fx` tracing) and the
"backend" (the rewritten GraphModule, run eagerly), with recursion into
the bodies of control-flow higher-order ops (each body is its own basic
block).

Port of `repro/core/pipeline.py`.

    passes = [PassConfig(op="muladd"), PassConfig(op="add", op_size=8)]
    fast_fn = optimize(fn, passes)          # same signature as fn

mirrors the paper's

    set SILVIA::PASSES [list [dict create OP "muladd"] \\
                             [dict create OP "add" OP_SIZE 12]]
    SILVIA::csynth_design

Recursion: `make_fx` keeps the body of `torch.ops.higher_order.scan`,
`cond` and `while_loop` as a sub-GraphModule named by a `get_attr` node
(the counterparts of the reference's scan / cond / while sub-jaxprs).
The reference also enters `pjit`, `closed_call`, `remat` and
`custom_vjp_call`; their torch counterparts (nested functions,
`torch.utils.checkpoint` off autograd) leave no node under `make_fx`:
their ops are inlined into the graph around them.

The paper's headline property is that SILVIA is a zero-cost drop-in: the
passes run once at synthesis time.  Here that is a trace cache in
`optimize()`: tracing and the rewrite happen once per input signature
(pytree structure + each tensor's shape, dtype and device); later calls
run the cached GraphModule.  All passes share one analysis context per
BB (`BBContext`): a packing rewrite patches it in place and the
rewritten BB is emitted once, after the whole pipeline.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Sequence

import torch
from torch import fx
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from repro_torch.core import ir
from repro_torch.core.silvia import SILVIA, BBContext
from repro_torch.core.silvia_add import SILVIAAdd
from repro_torch.core.silvia_muladd import SILVIAMul4, SILVIAMuladd


@dataclasses.dataclass(frozen=True)
class PassConfig:
    """One entry of SILVIA::PASSES (paper Fig. 6)."""
    op: str                       # "add" | "muladd" | "mul4"
    op_size: int | None = None    # SILVIAAdd lane operand size (8 | 16)
    inst: str = "both"            # SILVIAAdd: "add" | "sub" | "both"
    max_chain_len: int | None = None   # SILVIAMuladd MAX_CHAIN_LEN
    m_bits: int = 8               # SILVIAMuladd packed-lane operand size
    c_bits: int = 8               # SILVIAMuladd shared operand size
    # paper 3.5.1 future work: drop tuples that raise II_min in loop bodies
    filter_ii: bool = False

    def instantiate(self) -> SILVIA:
        if self.op == "add":
            p = SILVIAAdd(op_size=self.op_size or 8, inst=self.inst)
        elif self.op == "muladd":
            p = SILVIAMuladd(m_bits=self.m_bits, c_bits=self.c_bits,
                             max_chain_len=self.max_chain_len)
        elif self.op == "mul4":
            p = SILVIAMul4()
        else:
            raise ValueError(f"unknown SILVIA pass op: {self.op}")
        p.filter_ii = self.filter_ii
        return p


DEFAULT_PASSES = (
    PassConfig(op="muladd"),
    PassConfig(op="mul4"),
    PassConfig(op="add", op_size=8),
    PassConfig(op="add", op_size=16),
)


def _pass_objs(passes) -> list[SILVIA]:
    return [p.instantiate() if isinstance(p, PassConfig) else p
            for p in passes]


# Higher-order ops whose bodies are optimized as separate BBs.
_RECURSE_HOPS = {"scan", "cond", "while_loop"}


def _hop_name(node: fx.Node) -> str | None:
    if node.op == "call_function" and isinstance(
            node.target, torch._ops.HigherOrderOperator):
        return node.target.name()
    return None


def _bodies(gm: fx.GraphModule, node: fx.Node) -> list:
    """(argument position, sub-GraphModule) of every body a recursed HOP
    node takes (scan: its combine graph; cond: both branches;
    while_loop: its cond and body graphs)."""
    if _hop_name(node) not in _RECURSE_HOPS:
        return []
    subs = [(i, ir.attr_of(gm, a.target)) for i, a in enumerate(node.args)
            if isinstance(a, fx.Node) and a.op == "get_attr"]
    return [(i, sub) for i, sub in subs if isinstance(sub, fx.GraphModule)]


def _loop_info(node: fx.Node):
    """(num_carry, num_xs, num_additional) of a `scan` node (its args are
    combine graph, init, xs, additional_inputs); None for other ops."""
    if _hop_name(node) != "scan":
        return None
    _, init, xs, extra = node.args[:4]
    return (len(init), len(xs), len(extra))


def _with_bodies(gm: fx.GraphModule, bodies: dict) -> fx.GraphModule:
    """A copy of gm whose HOP nodes take the given bodies
    ({(node, argument position): GraphModule}).  HOP nodes that name one
    body take its one rewrite; two different rewrites of one body -- two scans splitting its
    inputs into carry, xs and additional inputs differently -- raise."""
    root = {n.target: ir.attr_of(gm, n.target) for n in gm.graph.nodes
            if n.op == "get_attr"}
    new_bodies: dict = {}
    for (node, i), body in bodies.items():
        target = node.args[i].target
        if new_bodies.setdefault(target, body) is not body:
            raise ValueError(f"body {target} is rewritten two ways by the "
                             "HOP nodes that share it")
    root.update(new_bodies)
    graph, env = fx.Graph(), {}
    for node in gm.graph.nodes:
        env[node] = graph.node_copy(node, lambda a: env[a])
    return fx.GraphModule(root, graph)


def optimize_graph(gm: fx.GraphModule, passes: Sequence[SILVIA],
                   stats: list | None = None,
                   loop_info=None) -> fx.GraphModule:
    """Apply the pass list to a traced graph, recursing into HOP bodies.

    The bodies are rewritten first (a body that two HOP nodes name, once),
    then every pass runs on this graph against ONE analysis context, and
    the rewritten graph is emitted once at the end (the same object comes
    back when nothing packed here or below).

    loop_info: (num_carry, num_xs, num_additional) when `gm` is a scan
    body -- unlocks the II-aware tuple filter of passes with
    filter_ii=True.  stats: a list each pass appends its stats dict to."""
    # 1. the inner BBs first
    bodies, done, changed = {}, {}, False
    for node in gm.graph.nodes:
        inner = _loop_info(node)
        for i, sub in _bodies(gm, node):
            key = (id(sub), inner)
            if key not in done:
                done[key] = optimize_graph(sub, passes, stats, inner)
            bodies[(node, i)] = done[key]
            changed |= done[key] is not sub
    if changed:
        gm = _with_bodies(gm, bodies)
    # 2. each pass on this BB against ONE shared analysis context,
    #    patched in place by a packing rewrite; emitted once at the end
    ctx = BBContext(gm)
    for p in passes:
        st = p.run_ctx(ctx, loop_info=loop_info)
        if stats is not None:
            st["pass"] = p.name
            stats.append(st)
    return ir.emit_graph(gm, ctx.eqns) if ctx.dirty else gm


def trace(fn: Callable, *example_args) -> fx.GraphModule:
    """The ATen-level graph of fn on example tensors (fake tensors stand
    in for them: nothing is computed while tracing).

    The trace is functionalized: an in-place update of an input (the KV
    cache a decode step writes) becomes a pure op whose result later
    reads use, and the graph writes the input back once, at its end.
    So the graph is data flow only, like the reference's jaxpr, and a
    pass that reorders it cannot move a read across the write it must
    follow.  A real tensor the function closes over (a cached constant)
    enters the graph as a constant."""
    return make_fx(torch.func.functionalize(fn), tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*example_args)


def optimized_graph(fn, *example_args, passes=DEFAULT_PASSES,
                    stats: list | None = None) -> fx.GraphModule:
    """Trace fn on example tensors and return its SILVIA-optimized graph
    (for inspection, op counting and tests)."""
    return optimize_graph(trace(fn, *example_args), _pass_objs(passes),
                          stats)


def _leaf_key(x) -> Any:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (int, float, bool, str, bytes, type(None))):
        return ("py", type(x), x)
    return ("id", id(x))


@dataclasses.dataclass
class _TraceEntry:
    gm: fx.GraphModule
    out_spec: Any
    rewrite_ms: float


def optimize(fn, passes: Sequence[PassConfig | SILVIA] = DEFAULT_PASSES):
    """Return a drop-in replacement for `fn` whose traced graph has been
    rewritten by the SILVIA passes.

    fn takes and returns pytrees of tensors.  Tensor leaves become the
    graph's inputs; any other leaf is a constant of the trace and part of
    the cache key.  Tracing and the rewrite happen ONCE per input
    signature (pytree structure + each tensor's shape, dtype and device);
    later calls with the same signature run the cached GraphModule
    eagerly.

    The wrapper exposes:
      wrapped.cache_info()  -> dict with trace_hits / trace_misses /
                               traces and the cumulative rewrite wall
                               time (ms),
      wrapped.cache_clear() -> drop all cached traces."""
    pass_objs = _pass_objs(passes)
    cache: dict[Any, _TraceEntry] = {}
    counters = {"trace_hits": 0, "trace_misses": 0, "rewrite_ms": 0.0}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        flat, in_spec = pytree.tree_flatten((args, kwargs))
        key = (in_spec, tuple(_leaf_key(x) for x in flat))
        entry = cache.get(key)
        tensors = [x for x in flat if isinstance(x, torch.Tensor)]
        if entry is None:
            counters["trace_misses"] += 1
            out_spec = []

            def flat_fn(*ts):
                it = iter(ts)
                leaves = [next(it) if isinstance(x, torch.Tensor) else x
                          for x in flat]
                a, k = pytree.tree_unflatten(leaves, in_spec)
                outs, spec = pytree.tree_flatten(fn(*a, **k))
                out_spec.append(spec)
                return outs

            t0 = time.perf_counter()
            gm = optimize_graph(trace(flat_fn, *tensors), pass_objs)
            rewrite_ms = (time.perf_counter() - t0) * 1e3
            counters["rewrite_ms"] += rewrite_ms
            entry = cache[key] = _TraceEntry(gm, out_spec[0], rewrite_ms)
        else:
            counters["trace_hits"] += 1
        return pytree.tree_unflatten(list(entry.gm(*tensors)),
                                     entry.out_spec)

    def cache_info() -> dict:
        return {**counters, "traces": len(cache)}

    def cache_clear():
        cache.clear()
        counters.update(trace_hits=0, trace_misses=0, rewrite_ms=0.0)

    wrapped.cache_info = cache_info
    wrapped.cache_clear = cache_clear
    return wrapped
