"""Shared model components: RMSNorm, LayerNorm and rotary embeddings.

Port of `repro/models/common.py`: standard RoPE, and qwen2-vl's M-RoPE
(`m_rope_sections`) over 3-row positions.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake


# Batch invariance.  The serve engine promises that a request's bits do
# not depend on its batch mates, so every reduction on the decode path
# must sum a row in an order that does not change with the number of
# rows in the call.  On the CPU each row is reduced alone already.  On
# CUDA it is not: ATen's reduce kernel takes its block shape, and with it
# a row's summation order, from the number of rows (Reduce.cuh's
# `setReduceConfig`: block height min(2^floor(log2 rows), 512 / block
# width), block width min(32, 2^floor(log2 d')) with d' = d / 4 for
# vectorized rows of d > 128), `torch.cumsum` scans a lone row with cub
# and two or more with its own kernel, and cuBLAS picks a batched
# product's algorithm from its batch and sizes.  So each such reduction
# is a `row_sum`, `row_mean` or `row_cumsum`: `row_reduce` gives the
# kernel enough rows that its launch shape no longer depends on how many
# there are, and a masked key axis, whose length differs between the
# static path and the engine, is summed in a tree (`tail_sum_`).  The
# pinned row count rests on ATen's heuristic, checked on torch 2.11
# (CUDA 12.8) by scripts/batch_invariance.py at every served width and
# gated by chip_smoke.py phase 13: a torch upgrade must pass both again.


def min_rows(d: int) -> int:
    """The fewest rows of length d for which ATen's reduce launches one
    block shape whatever the row count (the block height saturates:
    16 rows when a block row spans a warp, more for rows under 32)."""
    lane = d // 4 if d > 128 else d
    return max(16, 512 // min(32, 1 << (max(lane, 1).bit_length() - 1)))


def row_reduce(fn, x, pin=None):
    """fn(x) for an `fn` that reduces or scans x [..., d] row by row along
    its last axis and keeps the leading axis (`r.sum(-1, keepdim=True)`,
    `r.cumsum(-1)`), with each row's result independent of how many rows
    share the call.  Where `pin` (default: x on CUDA), fn sees x's rows
    as one [n, d] matrix of at least `min_rows(d)` rows, zero rows
    padding a short one; otherwise fn(x) as it is."""
    if not (x.is_cuda if pin is None else pin):
        return fn(x)
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    n = rows.shape[0]
    if n < min_rows(d):
        rows = torch.nn.functional.pad(rows, (0, 0, 0, min_rows(d) - n))
    out = fn(rows)[:n]
    return out.reshape(x.shape[:-1] + out.shape[1:])


def row_mean(x, pin=None):
    """x.mean(-1, keepdim=True), batch-invariant (`row_reduce`)."""
    return row_reduce(lambda r: r.mean(dim=-1, keepdim=True), x, pin)


def row_sum(x, pin=None):
    """x.sum(-1), batch-invariant (`row_reduce`)."""
    return row_reduce(lambda r: r.sum(dim=-1, keepdim=True), x,
                      pin)[..., 0]


def tail_sum_(x, dim: int):
    """x.sum(dim), invariant to the batch and to zeros appended along
    `dim` (a masked key axis, whose length is the static path's
    cache_len or the engine's bucket), on every device: a halving tree,
    element i meeting element i + h for h = half the next power of two
    (an absent partner counts as zero), by elementwise adds.  Sums in
    place: x, a temporary of the caller's, is consumed."""
    n = x.shape[dim]
    h = (1 << max(n - 1, 0).bit_length()) // 2
    if h:
        x.narrow(dim, 0, n - h).add_(x.narrow(dim, h, n - h))
    while h > 1:
        x = x.narrow(dim, 0, h)
        h //= 2
        x.narrow(dim, 0, h).add_(x.narrow(dim, h, h))
    return x.narrow(dim, 0, 1).squeeze(dim)


def row_cumsum(x, pin=None):
    """x.cumsum(-1), batch-invariant (`row_reduce`)."""
    return row_reduce(lambda r: r.cumsum(dim=-1), x, pin)


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = row_mean(xf.square())
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """As the reference's: statistics in float32, the variance the mean of
    the squared deviations (written out, as jnp.var computes it, not
    F.layer_norm's fused form), `y * w + b` in float32, one cast."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def norm_apply(x, params, kind: str, eps: float):
    if kind == "rmsnorm":
        return rms_norm(x, params["w"], eps)
    if kind != "layernorm":
        raise ValueError(f"unknown norm {kind!r} (rmsnorm | layernorm)")
    return layer_norm(x, params["w"], params["b"], eps)


def rope_freqs(head_dim: int, theta: float):
    """[D/2] float32 inverse frequencies, computed with numpy exactly as the
    reference does."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


_FREQS: dict = {}


def _freqs_on(head_dim: int, theta: float, device: torch.device):
    """rope_freqs on `device`, cached per device: a fresh host-to-device
    copy on every call would stall the decode loop once per layer, and
    is illegal while a CUDA graph captures.  Only a real tensor is
    cached: called first under fake tracing (`core.optimize`), the copy
    yields a fake tensor, which later real calls must not be served."""
    key = (head_dim, theta, torch.device(device))
    t = _FREQS.get(key)
    if t is None:
        t = torch.from_numpy(rope_freqs(head_dim, theta)).to(device)
        if not is_fake(t):
            _FREQS[key] = t
    return t


def apply_rope(x, positions, theta: float = 10000.0,
               m_rope_sections=None):
    """x: [B, S, H, D]; positions: [B, S] (standard), or [3, B, S] under
    m_rope_sections (M-RoPE: the temporal, height and width position
    rows of qwen2-vl).  Half-split (not interleaved) rotation in float32,
    cast back to x's dtype.

    M-RoPE splits the D/2 frequency slots into three contiguous
    sections, each section's angles from its own row of positions, as
    the reference computes them (each row cast to float32 times its
    slice of the float32 frequencies, then concatenated): three equal
    rows give standard RoPE's angles, bit for bit."""
    d = x.shape[-1]
    freqs = _freqs_on(d, theta, x.device)                          # [D/2]
    if m_rope_sections is None:
        ang = positions[..., None].to(torch.float32) * freqs       # [B,S,D/2]
    else:
        if sum(m_rope_sections) != d // 2 or positions.shape[0] != 3:
            raise ValueError(f"M-RoPE sections {m_rope_sections} over D/2 = "
                             f"{d // 2}, positions {tuple(positions.shape)}"
                             " (want [3, B, S])")
        parts, off = [], 0
        for row, n in zip(positions, m_rope_sections):
            parts.append(row[..., None].to(torch.float32)
                         * freqs[off:off + n])
            off += n
        ang = torch.cat(parts, dim=-1)                             # [B,S,D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
