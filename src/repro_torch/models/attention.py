"""Grouped-query attention with RoPE and a KV cache.

Port of `repro/models/attention.py` without tensor parallelism: the
prefill path `attn_full` (no `attn_q_chunk` chunking yet) and the decode
path `attn_decode` with the `active` slot mask, over a bf16 KV cache
(the int8 KV cache waits).  Written as plain PyTorch mirroring the
reference's numerics -- scores and softmax in float32, masks at -1e30,
weights cast to v's dtype -- with no fused SDPA.

KV cache: {k, v: [B, S_max, KV, D]}.  Unlike the reference, which
returns a new cache from a functional update (donated buffers under
jit), the port writes the new rows IN PLACE at each row's position --
a deliberate departure that keeps one static cache buffer for the whole
generation.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.quant.qtensor import qmatmul

_NEG = -1e30


def _project_q(p, x, cfg: ModelConfig):
    q = qmatmul(x, p["wq"])
    b, s, _ = q.shape
    return q.reshape(b, s, cfg.n_heads, cfg.head_dim)


def _project_kv(p, x, cfg: ModelConfig):
    k = qmatmul(x, p["wk"])
    v = qmatmul(x, p["wv"])
    b, s, _ = k.shape
    return (k.reshape(b, s, cfg.n_kv, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv, cfg.head_dim))


def _gqa_scores(q, k):
    """q: [B,S,H,D], k: [B,T,KV,D] -> float32 scores [B,KV,G,S,T]; head h
    uses kv head h // G (G = H // KV)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, h // kv, d)
    return torch.einsum("bskgd,btkd->bkgst", q.to(torch.float32),
                        k.to(torch.float32))


def _gqa_out(w, v):
    """w: [B,KV,G,S,T], v: [B,T,KV,D] -> [B,S,H*D] in v's dtype (float32
    accumulation, one rounding)."""
    b, kv, g, s, t = w.shape
    o = torch.einsum("bkgst,btkd->bskgd", w.to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(b, s, kv * g * o.shape[-1]).to(v.dtype)


def attn_full(p, x, cfg: ModelConfig, positions=None, cache=None):
    """Causal self-attention over the full sequence (prefill).

    positions: [B,S] int (default arange).  cache: optional layer cache
    {k, v: [B, S_max, KV, D]}; the sequence's keys and values are written
    into its first S positions in place.  Returns [B,S,d]."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    scores = _gqa_scores(q, k) * (1.0 / math.sqrt(cfg.head_dim))
    mask = positions[:, None, None, :, None] >= \
        positions[:, None, None, None, :]
    scores = scores.masked_fill(~mask, _NEG)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = qmatmul(_gqa_out(w, v), p["wo"])
    if cache is not None:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    return out


def attn_decode(p, x_t, cache, pos, cfg: ModelConfig, active=None):
    """Decode C new tokens against the cache: x_t [B, C, d]; pos [B] int
    position of the FIRST new token per row; active: optional [B] bool
    slot mask -- inactive rows leave their cache untouched.

    Token c of row b is written (in place) at cache position pos[b]+c and
    attends causally to positions <= pos[b]+c.  Returns [B, C, d]."""
    b, c = x_t.shape[:2]
    qpos = pos[:, None] + torch.arange(c, device=pos.device,
                                       dtype=pos.dtype)          # [B,C]
    q = _project_q(p, x_t, cfg)
    k_t, v_t = _project_kv(p, x_t, cfg)
    q = common.apply_rope(q, qpos, cfg.rope_theta)
    k_t = common.apply_rope(k_t, qpos, cfg.rope_theta)
    rows = torch.arange(b, device=x_t.device)
    if active is not None:
        rows = rows[active]
    # per-row insert at pos..pos+C-1, active rows only
    cache["k"][rows[:, None], qpos[rows]] = k_t[rows]
    cache["v"][rows[:, None], qpos[rows]] = v_t[rows]
    k, v = cache["k"], cache["v"]
    scores = _gqa_scores(q, k) * (1.0 / math.sqrt(cfg.head_dim))
    t = k.shape[1]
    valid = torch.arange(t, device=x_t.device)[None, None, :] <= \
        qpos[:, :, None]                                         # [B,C,T]
    scores = scores.masked_fill(~valid[:, None, None, :, :], _NEG)
    w = torch.softmax(scores, dim=-1).to(x_t.dtype)
    return qmatmul(_gqa_out(w, v), p["wo"])


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device):
    if cfg.serve_kv_dtype != "bfloat16":
        raise NotImplementedError(
            f"serve_kv_dtype={cfg.serve_kv_dtype!r} is not ported yet")
    shape = (batch, s_max, cfg.n_kv, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
