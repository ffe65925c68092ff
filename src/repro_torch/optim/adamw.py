"""AdamW with a configurable state dtype and global-norm clipping (port of
`repro/optim/adamw.py`).

Plain functions on dicts of tensors, as the reference's on pytrees: the
moments mirror the params tree (None at a non-float leaf), and
`adamw_update` returns new trees.  The leaves are flattened with
`torch.utils._pytree` with every dict's keys sorted, the order in which
`jax.tree_util` flattens a dict, so the global norm sums the leaves in
the reference's order.  Updates run under `torch.no_grad()`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"     # "bfloat16" halves m/v bytes


def is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype in FLOAT_DTYPES


def sorted_tree(tree):
    """`tree` with every dict's keys in sorted order (jax.tree_util's
    flattening order; torch's pytree keeps insertion order)."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def leaves(tree) -> list:
    """The tree's leaves in the reference's order (None leaves kept)."""
    return pytree.tree_leaves(sorted_tree(tree), is_leaf=lambda x: x is None)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)

    def zeros_like(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device) \
            if is_float(p) else None

    dev = next((x.device for x in leaves(params)
                if isinstance(x, torch.Tensor)), torch.device("cpu"))
    return {"m": pytree.tree_map(zeros_like, params),
            "v": pytree.tree_map(zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the float leaves, in tree order, of each
    leaf's float32 sum of squares (the reference's Python `sum`, from 0)."""
    total = 0
    for x in leaves(tree):
        if is_float(x):
            total = total + x.to(torch.float32).square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics {grad_norm, clip_scale});
    the new trees' dicts have their keys in sorted order.

    One global-norm clip over the float gradients; bias corrections from
    the float32 step; decoupled weight decay on every leaf of ndim >= 2
    (the stacked [L, d] norm scales too, as in the reference); each new
    value cast back to its parameter's dtype, the moments to
    state_dtype."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=stepf.device)
    sdt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        if not is_float(p) or g is None:
            return p, m, v
        g = g.to(torch.float32) * scale
        mf = m.to(torch.float32) * b1 + (1 - b1) * g
        vf = v.to(torch.float32) * b2 + (1 - b2) * g.square()
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if p.ndim >= 2:   # decoupled weight decay on matrices only
            update = update + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * update).to(p.dtype)
        return new_p, mf.to(sdt), vf.to(sdt)

    # every tree flattened in sorted-key order, so trees built in another
    # key order (a restored checkpoint's) still pair leaf with leaf
    _, spec = pytree.tree_flatten(sorted_tree(params),
                                  is_leaf=lambda x: x is None)
    out = [upd(*t) for t in zip(leaves(params), leaves(grads),
                                leaves(state["m"]), leaves(state["v"]))]
    new_p, new_m, new_v = (pytree.tree_unflatten([o[i] for o in out], spec)
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, {
        "grad_norm": gnorm, "clip_scale": scale}
