"""Lowering registry for the port's packed ops.

Port of `repro/kernels/registry.py`: the five packed ops, each with two
lowerings, and the per-op canonicalizing adapters.

    op                lowering     what runs
    ----------------  -----------  ---------------------------------------
    simd_add          hopper-cuda  csrc/simd_add.cu (simd_add.py)
    muladd2           hopper-cuda  csrc/muladd2.cu (muladd2.py)
    mul4              hopper-cuda  csrc/mul4.cu, full32 layout (mul4.py)
    quant_matmul      hopper-cuda  csrc/quant_matmul.cu (quant_matmul.py)
    packed_w4_matmul  hopper-cuda  csrc/packed_w4_matmul.cu
                                   (packed_matmul.py)
    every op          ref          plain PyTorch version (ref.py)

`dispatch(op, *args, **kw)` first canonicalizes the operands through the
op's adapter (broadcast / stack / cast), so every lowering sees one
layout:

    simd_add          xs, ys: k-tuples broadcast to one shape, lane dtype
    muladd2           a, b, c: stacked (n, ...) int8
    mul4              a: stacked (4, ...) int8; b: (...) int8
    quant_matmul      x_q [M,K] int8, w_q [K,N] int8, scales f32
    packed_w4_matmul  x_q [M,K] int8, w_packed [K,N//2] int8, scales f32
                      (either GEMM expert-stacked: x_q [E,M,K], possibly
                      an expanded [M,K] of expert stride 0, w [E,K,*],
                      x_scale [E,M,1], w_scale [E,1,N], passed through
                      as they are: one launch, or one plain batched call)

Resolution, per call: a forced id wins (innermost `force()` block, then
the ``REPRO_TORCH_LOWERING`` env var); otherwise a CUDA operand takes
`hopper-cuda` and a CPU operand `ref`.  So on a CUDA tensor dispatch
launches the kernel or raises, and takes `ref` only when the caller
forced it.  The env var is the port's own: `REPRO_LOWERING` belongs to
the JAX registry, which raises on ids it does not know, and both
registries load in one test process.

    REPRO_TORCH_LOWERING='*=ref'                   every op on the plain
    REPRO_TORCH_LOWERING='quant_matmul=ref'        one op
"""
from __future__ import annotations

import collections
import contextlib
import os
import re
import threading
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.kernels import (mul4, muladd2, packed_matmul, quant_matmul,
                                 ref, simd_add)

OPS = ("simd_add", "muladd2", "mul4", "quant_matmul", "packed_w4_matmul")
LOWERINGS = ("hopper-cuda", "ref")
ENV_VAR = "REPRO_TORCH_LOWERING"

_TABLE = {
    "simd_add": {"hopper-cuda": simd_add.simd_add,
                 "ref": lambda xs, ys, *, lane_bits, sub:
                     ref.simd_add_ref(xs, ys, sub=sub, lane_bits=lane_bits)},
    "muladd2": {"hopper-cuda": muladd2.muladd2,
                "ref": muladd2.muladd2_plain},
    "mul4": {"hopper-cuda": mul4.mul4_full32, "ref": mul4.mul4_plain},
    "quant_matmul": {"hopper-cuda": quant_matmul.quant_matmul,
                     "ref": ref.quant_matmul_ref},
    "packed_w4_matmul": {"hopper-cuda": packed_matmul.packed_w4_matmul,
                         "ref": ref.packed_w4_matmul_ref},
}

_tls = threading.local()
_DISPATCH_COUNTS: Dict[str, int] = {op: 0 for op in OPS}


def _force_stack() -> List[Dict[str, str]]:
    stack = getattr(_tls, "force_stack", None)
    if stack is None:
        stack = _tls.force_stack = []
    return stack


def _check_ids(layer: Dict[str, str], where: str) -> Dict[str, str]:
    for op, lid in layer.items():
        if op != "*" and op not in OPS:
            raise ValueError(f"{where}: unknown op {op!r} (known: "
                             f"{', '.join(OPS)} or '*')")
        if lid not in LOWERINGS:
            raise ValueError(f"{where}: unknown lowering {lid!r} for {op} "
                             f"(known: {', '.join(LOWERINGS)})")
    return layer


def _parse_env() -> Dict[str, str]:
    spec = os.environ.get(ENV_VAR, "")
    forced: Dict[str, str] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"{ENV_VAR} entry {item!r} is not <op>=<id>")
        op, lid = (s.strip() for s in item.split("=", 1))
        forced[op] = lid
    return _check_ids(forced, ENV_VAR)


def forced_id(op: str) -> Optional[str]:
    for layer in reversed(_force_stack()):
        lid = layer.get(op, layer.get("*"))
        if lid is not None:
            return lid
    env = _parse_env()
    return env.get(op, env.get("*"))


@contextlib.contextmanager
def force(default: Optional[str] = None, **by_op: str):
    """Force lowering selection inside a block (tests, the chip smoke's
    plain-version rerun):

        with registry.force("ref"): ...                  # every op
        with registry.force(quant_matmul="ref"): ...     # one op

    Contexts nest; the inner one wins per op."""
    layer = dict(by_op)
    if default is not None:
        layer["*"] = default
    stack = _force_stack()
    stack.append(_check_ids(layer, "force()"))
    try:
        yield
    finally:
        stack.pop()


def resolve(op: str, device) -> str:
    """The lowering id that serves `op` for operands on `device`."""
    if op not in _TABLE:
        raise KeyError(f"unknown op {op!r} (known: {OPS})")
    lid = forced_id(op)
    if lid is not None:
        return lid
    return "hopper-cuda" if torch.device(device).type == "cuda" else "ref"


def census_str(device) -> str:
    """The active {op: lowering} census as one printable line."""
    return ", ".join(f"{op}={resolve(op, device)}" for op in OPS)


def fingerprint(device) -> tuple:
    """Hashable summary of the active resolution for operands on
    `device`: two runs under different forced lowerings never share it."""
    return tuple((op, resolve(op, device)) for op in OPS)


def dispatch_counts() -> Dict[str, int]:
    """Calls per op since the last reset (eager PyTorch: one per run)."""
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counts() -> None:
    for op in OPS:
        _DISPATCH_COUNTS[op] = 0


# every kernel wrapper's launch counter
LAUNCH_COUNTERS = (simd_add.LAUNCHES, muladd2.LAUNCHES, mul4.LAUNCHES,
                   mul4.SPLIT_LAUNCHES, quant_matmul.LAUNCHES,
                   quant_matmul.SMALL_M_LAUNCHES, packed_matmul.LAUNCHES,
                   packed_matmul.SMALL_M_LAUNCHES)


# A torch.profiler session on the card loses its FIRST N device kernel
# events, N growing through the process by about one every 2-3 sessions
# and not by waiting (scripts/profiler_loss.py).  A profile_window opens
# with PROLOGUE launches of the spin kernel (`torch.cuda._sleep`), which
# take the loss; window_events takes them out again and raises if the
# whole prologue was lost (the block's own first kernels may then be).
PROLOGUE = 2000
PROLOGUE_SYMBOL = r"\bspin_kernel\b"


@contextlib.contextmanager
def profile_window():
    """torch.profiler (CPU and CUDA activities) over the block, opened by
    PROLOGUE spin-kernel launches and a synchronize; read the block's
    device kernels with `window_events`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROLOGUE):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof


class DeviceKernel(NamedTuple):
    """One device kernel of a profile: its name as `key_averages()` keys
    it (demangled), its launches and their summed device time (us)."""
    key: str
    count: int
    device_time_us: float


def window_events(prof) -> list:
    """The device kernels a profile_window saw, [DeviceKernel] by name,
    the prologue's taken out.  Counted from the profiler's raw events,
    the names demangled as `key_averages()` demangles them, not through
    `key_averages()`: that parses every host and device event into a
    Python object first, ~20 times as long (on the card ~50 s for the
    ~0.4 M kernels of a generate of qwen2-vl-72b's 80 layers).  Raises
    unless the profiler saw between 1 and PROLOGUE prologue launches:
    with none seen, the loss may have reached the block's own
    kernels."""
    counts, times = collections.Counter(), collections.Counter()
    cuda = torch._C._autograd.DeviceType.CUDA   # an enum compare, no str
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            name = e.name()
            counts[name] += 1
            times[name] += e.duration_ns()
    merged = collections.defaultdict(lambda: [0, 0])
    for name, n in counts.items():
        key = torch._C._demangle(name) if len(name) > 1 else name
        merged[key][0] += n
        merged[key][1] += times[name]
    events = [DeviceKernel(k, n, ns / 1e3) for k, (n, ns) in merged.items()]
    seen = sum(e.count for e in events
               if re.search(PROLOGUE_SYMBOL, e.key))
    if not 0 < seen <= PROLOGUE:
        raise RuntimeError(f"profile window: {seen} of its {PROLOGUE} "
                           "prologue kernels seen; the profiler may have "
                           "lost the block's first kernels")
    return [e for e in events if not re.search(PROLOGUE_SYMBOL, e.key)]


def profiled_launches(kernels: Dict[str, int]) -> Dict[str, int]:
    """Launches per wrapper counter among device kernels a profile saw,
    {kernel name as the profiler gives it: launches} (say, from
    `torch.profiler`'s `key_averages()`).  A replay of a captured CUDA
    graph launches its kernels without their wrappers, so this, and not
    the wrappers' counters, is what counts a replayed run's launches."""
    return {c.name: sum(n for key, n in kernels.items()
                        if re.search(c.symbol, key))
            for c in LAUNCH_COUNTERS}


# ---------------------------------------------------------------------------
# per-op canonicalization adapters (shared by every lowering)
# ---------------------------------------------------------------------------

def _device_of(operands) -> torch.device:
    for x in operands:
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("a packed op needs at least one tensor operand")


def _broadcast(operands, dtype):
    """Every operand (tensor or Python scalar) broadcast to the common
    shape and cast to `dtype` (wrapping, like the reference's astype)."""
    dev = _device_of(operands)
    ts = [x if isinstance(x, torch.Tensor) else torch.tensor(x, device=dev)
          for x in operands]
    shape = torch.broadcast_shapes(*[t.shape for t in ts])
    return [t.to(dtype).expand(shape) for t in ts]


def _adapt_simd_add(xs, ys, *, lane_bits: int = 8, sub: bool = False):
    dt = torch.int8 if lane_bits == 8 else torch.int16
    ops = _broadcast([*xs, *ys], dt)
    k = len(xs)
    return (ops[:k], ops[k:]), {"lane_bits": lane_bits, "sub": sub}


def _adapt_muladd2(a, b, c):
    n = len(a)
    ops = _broadcast([*a, *b, *c], torch.int8)
    return (torch.stack(ops[:n]), torch.stack(ops[n:2 * n]),
            torch.stack(ops[2 * n:])), {}


def _adapt_mul4(a, b):
    ops = _broadcast([*a, b], torch.int8)
    return (torch.stack(ops[:4]), ops[4].contiguous()), {}


def _adapt_matmul(x_q, w, x_scale, w_scale, *, out_dtype=torch.float32):
    if w.ndim == 3 and (x_q.ndim != 3 or x_q.shape[0] != w.shape[0]):
        raise ValueError(f"expert-stacked GEMM: x_q {tuple(x_q.shape)} "
                         f"against w {tuple(w.shape)} (x_q [E,M,K] wanted)")
    return (x_q, w, x_scale, w_scale), {"out_dtype": out_dtype}


_ADAPTERS = {
    "simd_add": _adapt_simd_add,
    "muladd2": _adapt_muladd2,
    "mul4": _adapt_mul4,
    "quant_matmul": _adapt_matmul,
    "packed_w4_matmul": _adapt_matmul,
}


def dispatch(op: str, *args, **kwargs):
    """Canonicalize the operands through the op's adapter, resolve the
    lowering from their device, run it.  The single entry point every
    packed-op call site binds through (core/prims.py, quant/qtensor.py).

    simd_add returns k int32 tensors, muladd2 (p_a, p_b) int32, mul4 four
    int32 tensors, the GEMMs out_dtype [M,N] ([E,M,N] expert-stacked)."""
    if op not in _ADAPTERS:
        raise KeyError(f"unknown op {op!r} (known: {OPS})")
    cargs, ckwargs = _ADAPTERS[op](*args, **kwargs)
    first = cargs[0][0] if op == "simd_add" else cargs[0]
    fn = _TABLE[op][resolve(op, first.device)]
    _DISPATCH_COUNTS[op] += 1
    return fn(*cargs, **ckwargs)
