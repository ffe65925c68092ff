"""Shared model components: RMSNorm, LayerNorm and rotary embeddings.

Port of `repro/models/common.py`: standard RoPE, and qwen2-vl's M-RoPE
(`m_rope_sections`) over 3-row positions.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
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
