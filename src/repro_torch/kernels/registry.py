"""Lowering registry for the port's packed GEMM ops.

Slim port of `repro/kernels/registry.py`: the two serving-path ops, each
with two lowerings.

    op                lowering     what runs
    ----------------  -----------  ---------------------------------------
    quant_matmul      hopper-cuda  csrc/quant_matmul.cu (quant_matmul.py)
                      ref          plain PyTorch version (ref.py)
    packed_w4_matmul  hopper-cuda  csrc/packed_w4_matmul.cu
                                   (packed_matmul.py)
                      ref          plain PyTorch version (ref.py)

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

import contextlib
import os
import threading
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import packed_matmul, quant_matmul, ref

OPS = ("quant_matmul", "packed_w4_matmul")
LOWERINGS = ("hopper-cuda", "ref")
ENV_VAR = "REPRO_TORCH_LOWERING"

_TABLE = {
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


def dispatch_counts() -> Dict[str, int]:
    """Calls per op since the last reset (eager PyTorch: one per run)."""
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counts() -> None:
    for op in OPS:
        _DISPATCH_COUNTS[op] = 0


def dispatch(op: str, x_q, w, x_scale, w_scale, *, out_dtype=torch.float32):
    """Run `op` on its resolved lowering: x_q [M,K] int8, w the stored
    weight ([K,N] int8 or [K,N//2] packed words), f32 scales [M,1] / [1,N];
    returns out_dtype [M,N]."""
    fn = _TABLE[op][resolve(op, x_q.device)]
    _DISPATCH_COUNTS[op] += 1
    return fn(x_q, w, x_scale, w_scale, out_dtype=out_dtype)
