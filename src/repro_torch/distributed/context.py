"""Ambient distribution context (port of `repro/distributed/context.py`).

Model code is mesh-agnostic; the launcher installs a mesh and its axis
roles here, and the serve engine reads them at construction to build
its sharded steps.  Two scopes live here:

* `mesh_scope(mesh, dp_axes, model_axis)` -- the launcher-level roles.
  `ServeEngine` reads it at CONSTRUCTION (the scope needs to be active
  only then: the engine keeps the mesh and re-enters its own tensor-
  parallel scope around every model call).
* `tp_scope(axis, size, attn, ssm, mesh=...)` -- serve-time tensor
  parallelism, entered by the engine around each call into the model
  (and held while a CUDA graph captures one).  Attention and SSD mixers
  read it (`tp_current()`) to compute only this rank's heads and
  all-gather them before the merged projections; the per-family flags
  say which mixers shard (head counts must divide the axis;
  models/slot_state.py `tp_plan`).  The reference reads its scope while
  `jit` traces; the port's model code reads it at every eager call, and
  a captured graph keeps what the capture saw.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

_MESH = None
_DP_AXES: tuple = ()
_MODEL_AXIS: Optional[str] = None


@contextlib.contextmanager
def mesh_scope(mesh, dp_axes: tuple, model_axis: str):
    global _MESH, _DP_AXES, _MODEL_AXIS
    prev = (_MESH, _DP_AXES, _MODEL_AXIS)
    _MESH, _DP_AXES, _MODEL_AXIS = mesh, tuple(dp_axes), model_axis
    try:
        yield
    finally:
        _MESH, _DP_AXES, _MODEL_AXIS = prev


def current():
    """Returns (mesh, dp_axes, model_axis) or None."""
    if _MESH is None:
        return None
    return _MESH, _DP_AXES, _MODEL_AXIS


@dataclasses.dataclass(frozen=True)
class TPContext:
    """Serve-time tensor parallelism over one mesh axis.

    axis:  mesh axis name the head / state dims are sharded over.
    size:  number of shards on that axis.
    attn:  attention mixers compute local heads (wq / wk / wv column
           slices, all_gather of head outputs before wo) -- requires
           n_heads % size == 0 and n_kv % size == 0.
    ssm:   SSD mixers keep their [B, H, P, N] state local and all_gather
           the per-head outputs before the gated norm -- requires
           ssm_heads % size == 0 (projections / conv stay replicated).
    mesh:  the launch.mesh.Mesh whose `axis` group gathers (the
           reference's collectives name the axis inside shard_map).
    """
    axis: str
    size: int
    attn: bool = False
    ssm: bool = False
    mesh: object = None

    @property
    def index(self) -> int:
        """This rank's shard along the axis (`jax.lax.axis_index`)."""
        return self.mesh.axis_index(self.axis)

    def all_gather(self, t, dim: int):
        """Shard-major concat along `dim` (`all_gather(tiled=True)`)."""
        return self.mesh.all_gather(t, self.axis, dim)


_TP: Optional[TPContext] = None


@contextlib.contextmanager
def tp_scope(axis: str, size: int, *, attn: bool = False, ssm: bool = False,
             mesh=None):
    global _TP
    prev = _TP
    _TP = TPContext(axis, size, attn, ssm, mesh) \
        if (attn or ssm) and size > 1 else None
    try:
        yield
    finally:
        _TP = prev


def tp_current() -> Optional[TPContext]:
    return _TP
