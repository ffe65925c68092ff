"""SILVIA pass manager -- the analogue of the paper's
`SILVIA::csynth_design` Tcl drop-in (Fig. 6): an ordered list of pass
configs applied between the "frontend" (`make_fx` tracing) and the
"backend" (the rewritten GraphModule, run eagerly).

Port of `repro/core/pipeline.py`, for straight-line programs: a traced
graph is one basic block (recursion into sub-graphs and loop bodies is
not ported yet).

    passes = [PassConfig(op="muladd"), PassConfig(op="add", op_size=8)]
    fast_fn = optimize(fn, passes)          # same signature as fn

mirrors the paper's

    set SILVIA::PASSES [list [dict create OP "muladd"] \\
                             [dict create OP "add" OP_SIZE 12]]
    SILVIA::csynth_design

The paper's headline property is that SILVIA is a zero-cost drop-in: the
passes run once at synthesis time.  Here that is a trace cache in
`optimize()`: tracing and the rewrite happen once per input signature
(pytree structure + each tensor's shape, dtype and device); later calls
run the cached GraphModule.  All passes share one analysis context per
graph (`BBContext`): a packing rewrite patches it in place and the
rewritten graph is emitted once, after the whole pipeline.
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
    m_bits: int = 8               # SILVIAMuladd packed-lane operand size

    def instantiate(self) -> SILVIA:
        if self.op == "add":
            return SILVIAAdd(op_size=self.op_size or 8, inst=self.inst)
        if self.op == "muladd":
            return SILVIAMuladd(m_bits=self.m_bits)
        if self.op == "mul4":
            return SILVIAMul4()
        raise ValueError(f"unknown SILVIA pass op: {self.op}")


DEFAULT_PASSES = (
    PassConfig(op="muladd"),
    PassConfig(op="mul4"),
    PassConfig(op="add", op_size=8),
    PassConfig(op="add", op_size=16),
)


def _pass_objs(passes) -> list[SILVIA]:
    return [p.instantiate() if isinstance(p, PassConfig) else p
            for p in passes]


def optimize_graph(gm: fx.GraphModule,
                   passes: Sequence[SILVIA]) -> fx.GraphModule:
    """Apply the pass list to a traced graph, all passes against ONE
    analysis context; the rewritten graph is emitted once at the end (the
    same object comes back when nothing packed)."""
    ctx = BBContext(gm)
    for p in passes:
        p.run_ctx(ctx)
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


def optimized_graph(fn, *example_args,
                    passes=DEFAULT_PASSES) -> fx.GraphModule:
    """Trace fn on example tensors and return its SILVIA-optimized graph
    (for inspection, op counting and tests)."""
    return optimize_graph(trace(fn, *example_args), _pass_objs(passes))


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
