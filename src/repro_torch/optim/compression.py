"""int8 gradient compression with error feedback (port of
`repro/optim/compression.py`).

Each float leaf is quantized symmetrically per leaf to int8 (scale =
amax / 127 + 1e-12, round half to even); the quantization residual is
returned as the error-feedback buffer that the next step's gradients
add, which makes the compression unbiased over time (Seide et al. /
EF-SGD).  Bit for bit the reference's eager ops.  The data-parallel
mean of the compressed gradients, `compressed_psum`, needs a mesh axis:
it is training's multi-rank half (ROADMAP A12).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.optim.adamw import is_float


def compress_grads(grads, err=None):
    """Returns (q_tree, scale_tree, new_err_tree); float leaves become int8
    + a float32 scalar scale, other leaves pass through with scale 1."""
    flat_g, spec = pytree.tree_flatten(grads)
    flat_e = pytree.tree_leaves(err) if err is not None \
        else [None] * len(flat_g)
    qs, ss, es = [], [], []
    for g, e in zip(flat_g, flat_e):
        dev = g.device if isinstance(g, torch.Tensor) else None
        if not is_float(g):
            qs.append(g)
            ss.append(torch.tensor(1.0, dtype=torch.float32, device=dev))
            es.append(torch.tensor(0.0, dtype=torch.float32, device=dev))
            continue
        gf = g.to(torch.float32) + (0.0 if e is None else e)
        amax = gf.abs().max()
        scale = amax / 127.0 + 1e-12
        q = torch.clamp(torch.round(gf / scale), -128, 127).to(torch.int8)
        qs.append(q)
        ss.append(scale)
        es.append(gf - q.to(torch.float32) * scale)     # error feedback
    unf = lambda xs: pytree.tree_unflatten(xs, spec)        # noqa: E731
    return unf(qs), unf(ss), unf(es)


def decompress_grads(q_tree, scale_tree):
    flat_q, spec = pytree.tree_flatten(q_tree)
    flat_s = pytree.tree_leaves(scale_tree)
    out = [q.to(torch.float32) * s if q.dtype == torch.int8 else q
           for q, s in zip(flat_q, flat_s)]
    return pytree.tree_unflatten(out, spec)


def compressed_psum(q_tree, scale_tree, axis_name: str):
    """Mean-reduce compressed gradients across a mesh axis: not ported."""
    raise NotImplementedError(
        f"compressed_psum over mesh axis {axis_name!r}: the data-parallel "
        "reduction over a mesh is training's multi-rank half "
        "(ROADMAP A12)")
