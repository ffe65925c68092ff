"""Grouped-query attention with RoPE and a KV cache.

Port of `repro/models/attention.py` without tensor parallelism: the
prefill path `attn_full` (causal, with the `attn_q_chunk` query
chunking, or bidirectional with per-row key lengths: the encoder's),
the decode path `attn_decode` with the `active` slot mask, over a bf16
or an int8 KV cache, with the optional q/k/v biases (`qkv_bias`), and
the cross-attention `attn_cross` (decoder over the encoder's memory,
masked by the rows' encoder lengths).  With cfg.learned_pos (whisper)
no rotary embedding is applied; with cfg.m_rope_sections (qwen2-vl)
the prefill's positions are [3, B, S] (temporal, height, width): each
row rotates its section of the frequencies, and the causal mask reads
the temporal row alone, as the reference's does, so the patches of one
image (one temporal position) attend to each other both ways.
Written as plain PyTorch mirroring the reference's numerics -- scores
and softmax in float32, masks at -1e30, weights cast to v's dtype --
with no fused SDPA.

KV cache: {k, v: [B, S_max, KV, D]}, in cfg.dtype; with
serve_kv_dtype="int8", k and v are int8 with per-position float32 scales
{k_s, v_s: [B, S_max, KV]} (`_kv_quantize`).  Unlike the reference,
which returns a new cache from a functional update (donated buffers
under jit), the port writes the new rows IN PLACE at each row's
position -- a deliberate departure that keeps one static cache buffer
for the whole generation.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.quant.qtensor import qmatmul
from repro_torch.quant.quantize import quantize_compiled

_NEG = -1e30


def _project_q(p, x, cfg: ModelConfig):
    q = qmatmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    b, s, _ = q.shape
    return q.reshape(b, s, cfg.n_heads, cfg.head_dim)


def _project_kv(p, x, cfg: ModelConfig):
    k = qmatmul(x, p["wk"])
    v = qmatmul(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    b, s, _ = k.shape
    return (k.reshape(b, s, cfg.n_kv, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv, cfg.head_dim))


def _gqa_scores(q, k):
    """q: [B,S,H,D], k: [B,T,KV,D] -> float32 scores [B,KV,G,S,T]; head h
    uses kv head h // G (G = H // KV).

    A decode step (S = 1) takes each score as the products' row sum over
    D (`common.row_sum`), in an order that depends neither on the batch
    nor on T: cuBLAS's batched product for the einsum picks its
    algorithm from both, and the serve engine's rows (B = its batch
    bucket, T = its cache bucket) must equal the static path's (B = 1,
    T = cache_len) bit for bit (ROADMAP C10)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, h // kv, d).to(torch.float32)
    if s == 1:
        prod = q.permute(0, 2, 3, 1, 4) \
            * k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
        return common.row_sum(prod)[:, :, :, None, :]     # [B,KV,G,1,T]
    return torch.einsum("bskgd,btkd->bkgst", q, k.to(torch.float32))


def _gqa_out(w, v):
    """w: [B,KV,G,S,T], v: [B,T,KV,D] -> [B,S,H*D] in v's dtype (float32
    accumulation, one rounding).  A decode step sums the products over T
    in a tree that neither the batch nor zero weights appended to T (the
    masked positions up to a longer cache) change (`_gqa_scores`)."""
    b, kv, g, s, t = w.shape
    dtype, w, v = v.dtype, w.to(torch.float32), v.to(torch.float32)
    if s == 1:
        prod = w[:, :, :, 0, :, None] * v.permute(0, 2, 1, 3)[:, :, None]
        o = common.tail_sum_(prod, dim=-2)                # [B,KV,G,D]
    else:
        o = torch.einsum("bkgst,btkd->bskgd", w, v)
    return o.reshape(b, s, kv * g * o.shape[-1]).to(dtype)


def _kv_quantize(t):
    """Per-position symmetric int8 quantization of a [B,S,KV,D] tensor
    over D: (int8 values, [B,S,KV] float32 scales).  As the reference:
    scale = amax / 127 + 1e-8 on the float32 values, round half to even
    (|t / scale| <= 127 by construction).  The reference's serving path
    runs it under jit, so the scale is the compiled float32 form
    (`quantize_compiled`: one FMA), bit for bit with the jitted
    reference's."""
    q, scale = quantize_compiled(t.to(torch.float32).reshape(
        -1, t.shape[-1]))
    return q.reshape(t.shape), scale.reshape(t.shape[:-1])


def _kv_dequant(q, scale, dtype):
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _attend(q, k, v, cfg: ModelConfig, dtype, qpos=None, kpos=None,
            valid=None):
    """GQA of q [B,S,H,D] over k, v [B,T,KV,D]: [B,S,H*D] in v's dtype;
    softmax weights in `dtype`.  Causal where qpos [B,S] and kpos [B,T]
    are given (key t is seen where kpos <= qpos); keys off `valid` [B,T]
    bool are masked.  A masked score is -1e30, so a row with no key left
    gets a uniform, finite softmax."""
    scores = _gqa_scores(q, k) * (1.0 / math.sqrt(cfg.head_dim))
    if qpos is not None:
        mask = qpos[:, None, None, :, None] >= kpos[:, None, None, None, :]
        scores = scores.masked_fill(~mask, _NEG)
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, None, None, :], _NEG)
    return _gqa_out(torch.softmax(scores, dim=-1).to(dtype), v)


def _valid(lengths, t: int, device):
    """[B, t] bool: position < the row's length."""
    return torch.arange(t, device=device)[None, :] < lengths[:, None]


def _attn_chunked(q, k, v, srcpos, cfg: ModelConfig, q_chunk: int):
    """Causal attention with the query dim cut in chunks of q_chunk: only
    a [B, KV, G, q_chunk, T] score block is live at a time (the
    reference scans over the chunks; a Python loop here).  srcpos: the
    [B, S] positions the mask compares (M-RoPE: the temporal row)."""
    return torch.cat([
        _attend(q[:, c:c + q_chunk], k, v, cfg, v.dtype,
                srcpos[:, c:c + q_chunk], srcpos)
        for c in range(0, q.shape[1], q_chunk)], dim=1)


def attn_full(p, x, cfg: ModelConfig, positions=None, cache=None,
              causal: bool = True, kv_lengths=None):
    """Self-attention over the full sequence (prefill; the encoder).

    positions: [B,S] int, or [3,B,S] under cfg.m_rope_sections (the
    causal mask then reads positions[0], the temporal row, as the
    reference's does); default arange (on every row).  cache: optional
    layer cache (`init_cache`); the sequence's keys and values are
    written into its
    first S positions in place.  The sequence attends over its own
    unquantized keys and values: only what goes into an int8 cache is
    quantized.  causal=False with kv_lengths [B] (the encoder's real
    frames per row): keys at positions >= kv_lengths[b] are masked out
    of row b's softmax, so a right-padded row attends as it would
    unpadded.  With cfg.attn_q_chunk = c, causal, and S > c a multiple
    of c, the queries run in chunks of c (`_attn_chunked`), as the
    reference's (which then ignores kv_lengths).  Returns [B,S,d]."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(
            (b, s) if cfg.m_rope_sections is None else (3, b, s))
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    if not cfg.learned_pos:     # whisper-style models: absolute embeddings
        q = common.apply_rope(q, positions, cfg.rope_theta,
                              cfg.m_rope_sections)
        k = common.apply_rope(k, positions, cfg.rope_theta,
                              cfg.m_rope_sections)
    srcpos = positions if positions.ndim == 2 else positions[0]
    chunk = cfg.attn_q_chunk
    if chunk and causal and s > chunk and s % chunk == 0:
        o = _attn_chunked(q, k, v, srcpos, cfg, chunk)
    else:
        valid = None if kv_lengths is None else \
            _valid(kv_lengths, s, x.device)
        qpos, kpos = (srcpos, srcpos) if causal else (None, None)
        o = _attend(q, k, v, cfg, x.dtype, qpos, kpos, valid)
    out = qmatmul(o, p["wo"])
    if cache is not None:
        _write_prefill(cache, k, v)
    return out


def _write_prefill(cache, k, v):
    """The prompt's keys and values into positions [0, S) of the cache.
    The reference quantizes the zero-padded [B, S_max] page, so an int8
    cache's positions past S hold 0 (as `init_cache` leaves them) with a
    scale of 0 / 127 + 1e-8, not 0: the port writes the same scale."""
    s = k.shape[1]
    if "k_s" not in cache:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        return
    for name, t in (("k", k), ("v", v)):
        q, scale = _kv_quantize(t)
        cache[name][:, :s] = q
        cache[f"{name}_s"][:, :s] = scale
        cache[f"{name}_s"][:, s:] = 1e-8


def _cache_insert(cache, name: str, new, at, active):
    """new [B,C,KV,D] into cache[name] at the indices `at` (per row:
    C positions), in place; into an int8 cache quantized per position,
    its scales into cache[name + "_s"].  Every row computes its write;
    a row off `active` ([B] bool, or None: all on) writes back what it
    held, as the reference's `_mask_inactive` keeps its old rows: static
    shapes, no boolean indexing, so the write can be captured in a CUDA
    graph."""
    def put(t, value):
        if active is not None:
            keep = active.reshape((-1,) + (1,) * (value.ndim - 1))
            value = torch.where(keep, value, t[at])
        t[at] = value

    if f"{name}_s" in cache:
        new, scale = _kv_quantize(new)
        put(cache[f"{name}_s"], scale)
    put(cache[name], new)


def attn_decode(p, x_t, cache, pos, cfg: ModelConfig, active=None):
    """Decode C new tokens against the cache: x_t [B, C, d]; pos [B] int
    position of the FIRST new token per row; active: optional [B] bool
    slot mask -- inactive rows leave their cache untouched (they write
    back what they held: `_cache_insert`).

    Token c of row b is written (in place) at cache position pos[b]+c
    (the start clamped to S_max - C, as XLA clamps it) and attends
    causally to positions <= pos[b]+c.  An int8 cache takes the
    new rows quantized, scales too, and is then dequantized whole for
    the attention: a token attends over its own dequantized key, as in
    the reference.  Under cfg.m_rope_sections the rotation takes the
    cache position on all three rows, as the reference's decode does.
    Returns [B, C, d]."""
    b, c = x_t.shape[:2]
    qpos = pos[:, None] + torch.arange(c, device=pos.device,
                                       dtype=pos.dtype)          # [B,C]
    posq = qpos if cfg.m_rope_sections is None else qpos.expand(3, b, c)
    q = _project_q(p, x_t, cfg)
    k_t, v_t = _project_kv(p, x_t, cfg)
    if not cfg.learned_pos:
        q = common.apply_rope(q, posq, cfg.rope_theta, cfg.m_rope_sections)
        k_t = common.apply_rope(k_t, posq, cfg.rope_theta,
                                cfg.m_rope_sections)
    # the write starts at pos clamped to [0, S_max - C], as XLA clamps
    # the start of the reference's dynamic_update_slice: a slot that
    # finished mid-segment and runs on past the cache overwrites only its
    # own last rows, which no later request reads unwritten
    t_max = cache["k"].shape[1]
    start = torch.clamp(pos, 0, t_max - c)
    at = (torch.arange(b, device=x_t.device)[:, None],
          start[:, None] + torch.arange(c, device=pos.device,
                                        dtype=pos.dtype))
    _cache_insert(cache, "k", k_t, at, active)
    _cache_insert(cache, "v", v_t, at, active)
    if "k_s" in cache:
        k = _kv_dequant(cache["k"], cache["k_s"], x_t.dtype)
        v = _kv_dequant(cache["v"], cache["v_s"], x_t.dtype)
    else:
        k, v = cache["k"], cache["v"]
    kpos = torch.arange(k.shape[1], device=x_t.device).expand(b, -1)
    return qmatmul(_attend(q, k, v, cfg, x_t.dtype, qpos, kpos), p["wo"])


def attn_cross(p, x, memory, cfg: ModelConfig, mem_kv=None,
               enc_lengths=None):
    """Cross-attention of the decoder's x [B,S,d] over the encoder's
    memory [B,S_enc,d]: [B,S,d].  With mem_kv {k, v: [B,T,KV,D], len:
    [B]} (the cross K/V the prefill projected, right-padded to T), the
    memory's projection is skipped and `len` masks the padded tail
    unless enc_lengths [B] is given.  Memory positions >= a row's length
    get a softmax weight of exactly 0; a row of length 0 gets a uniform,
    finite softmax (never NaN).  The K/V is only read."""
    q = _project_q(p, x, cfg)
    if mem_kv is None:
        k, v = _project_kv(p, memory, cfg)
    else:
        k, v = mem_kv["k"], mem_kv["v"]
        if enc_lengths is None:
            enc_lengths = mem_kv.get("len")
    valid = None if enc_lengths is None else \
        _valid(enc_lengths, k.shape[1], x.device)
    return qmatmul(_attend(q, k, v, cfg, x.dtype, valid=valid), p["wo"])


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device):
    shape = (batch, s_max, cfg.n_kv, cfg.head_dim)
    if cfg.serve_kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
                "v_s": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)}
    if cfg.serve_kv_dtype != "bfloat16":
        raise ValueError(f"unknown serve_kv_dtype {cfg.serve_kv_dtype!r} "
                         "(bfloat16 | int8)")
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
