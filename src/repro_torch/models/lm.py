"""Top-level language model: init / prefill / decode for the dense, moe
and ssm families.

Port of `repro/models/lm.py`.  The reference stacks layer params on a
leading axis and runs the stack under `jax.lax.scan`; the port keeps the
same stacked layout (so params convert leaf for leaf) and runs a Python
loop over per-layer slices.  The KV cache is stacked the same way,
{k, v: [L, B, S_max, KV, D]}, and updated in place (see
models/attention.py); with serve_kv_dtype="int8" it also holds the
per-position scales {k_s, v_s: [L, B, S_max, KV]}.  The ssm family's
cache is its recurrent state instead, {ssm: [L, B, H, P, N] float32,
conv: [L, B, W-1, ch]} (models/ssm.py), updated in place the same way.
Each layer runs the block of its family (`blocks.BLOCK_FNS`, as the
reference's `BLOCK_FNS`).
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as device_lib
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, common, mlp, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.quant.qtensor import qmatmul


def _check_family(cfg: ModelConfig):
    if cfg.family not in blocks.BLOCK_FNS:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(blocks.BLOCK_FNS)})")


def _layer(tree, i: int):
    """Layer i's slice of the stacked block params (QTensor leaves slice
    q and scale together)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Random params with the reference's shapes and scales, drawn from a
    seeded torch.Generator on `device` (the numbers differ from the
    reference's jax.random draws; parity tests convert the reference's
    params instead, see convert.py).

    dense weights: N(0, 1) / sqrt(d_in) in float32, cast to cfg.dtype;
    embed: N(0, 1) * 0.02; norm weights: ones (float32); with
    cfg.qkv_bias the stacked q/k/v biases bq [L, q_dim], bk and bv
    [L, kv_dim]: zeros in cfg.dtype, as the reference's.  The moe family
    has `moe` (`mlp.init_moe`: the float32 router [L, d, E] and the
    experts [L, E, K, N]) in place of `mlp`, and with dense_residual a
    dense `dense` MLP beside it.  The ssm family's block is {ln: {w},
    ssm: `ssm.init_ssm`} (no attention, no MLP); mamba2 ties its head
    to the embedding."""
    _check_family(cfg)
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    n, d = cfg.n_layers, cfg.d_model

    def normal(shape, scale, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    def dense(d_in, d_out):
        return normal((n, d_in, d_out), 1.0 / math.sqrt(d_in))

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    p = {"embed": normal((cfg.vocab, d), 0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, cfg.vocab), 1.0 / math.sqrt(d))
    p["final_norm"] = {"w": ones(d)}
    if cfg.family == "ssm":
        p["blocks"] = {"ln": {"w": ones(n, d)},
                       "ssm": ssm.init_ssm(normal, cfg, n, dev)}
        return p
    attn = {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
            "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}
    if cfg.qkv_bias:
        for key, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                           ("bv", cfg.kv_dim)):
            attn[key] = torch.zeros((n, width), dtype=dt, device=dev)

    def dense_mlp():
        return {"wi": dense(d, cfg.d_ff), "wg": dense(d, cfg.d_ff),
                "wo": dense(cfg.d_ff, d)}

    p["blocks"] = {"ln1": {"w": ones(n, d)}, "attn": attn,
                   "ln2": {"w": ones(n, d)}}
    if cfg.family == "moe":
        p["blocks"]["moe"] = mlp.init_moe(normal, cfg, n)
        if cfg.moe.dense_residual:
            p["blocks"]["dense"] = dense_mlp()
    else:
        p["blocks"]["mlp"] = dense_mlp()
    return p


def _lm_head(p, x, cfg: ModelConfig):
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return qmatmul(x, w).to(torch.float32)


def _embed(p, tokens, cfg: ModelConfig):
    return p["embed"][tokens.long()]


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device):
    """Stacked per-layer cache: the KV cache {k, v: [L, B, S_max, KV, D]},
    and the scales {k_s, v_s: [L, B, S_max, KV]} of an int8 cache; for
    the ssm family the recurrent state {ssm: [L, B, H, P, N] float32,
    conv: [L, B, W-1, ch] cfg.dtype} (no KV, s_max unused)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        one = ssm.init_ssm_state(cfg, batch, device=device)
    else:
        one = attn_mod.init_cache(cfg, batch, s_max, device=device)
    return {k: torch.zeros((cfg.n_layers,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device) for k, t in one.items()}


def prefill(params, inputs, cfg: ModelConfig, cache_len: int,
            positions=None, last_positions=None):
    """Run the prompt, return (last-position logits [B,1,V] f32, cache).

    inputs: [B,S] int tokens.  last_positions: optional [B] int -- per-row
    index of the last REAL prompt token (right-padded ragged batches).
    Default: the final column.  Every block gets the rows' real lengths
    (S, or last_positions + 1): attention masks the padding causally,
    but an SSM state is sequential, and its padded steps must be
    identity updates (models/ssm.py)."""
    _check_family(cfg)
    x = _embed(params, inputs, cfg)
    b, s = x.shape[:2]
    if last_positions is None:
        lengths = torch.full((b,), s, dtype=torch.int64, device=x.device)
    else:
        lengths = last_positions.to(device=x.device, dtype=torch.int64) + 1
    cache = init_cache(cfg, b, cache_len, device=x.device)
    block = blocks.BLOCK_FNS[cfg.family]
    for i in range(cfg.n_layers):
        layer_cache = {k: t[i] for k, t in cache.items()}
        x = block(_layer(params["blocks"], i), x, cfg, mode="prefill",
                  cache=layer_cache, positions=positions, lengths=lengths)
    x = common.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if last_positions is None:
        x_last = x[:, -1:, :]
    else:
        rows = torch.arange(b, device=x.device)
        x_last = x[rows, last_positions.long()][:, None, :]
    return _lm_head(params, x_last, cfg), cache


def decode_step(params, token_t, cache, pos, cfg: ModelConfig, active=None):
    """token_t: [B,C] int; pos: [B] int position of the first new token per
    row; active: optional [B] bool slot mask -- inactive rows compute but
    do not write their cache.

    Returns (logits [B,C,V] f32, cache).  The cache is updated IN PLACE
    and returned for symmetry with the reference's functional update."""
    _check_family(cfg)
    x = _embed(params, token_t, cfg)
    block = blocks.BLOCK_FNS[cfg.family]
    for i in range(cfg.n_layers):
        layer_cache = {k: t[i] for k, t in cache.items()}
        x = block(_layer(params["blocks"], i), x, cfg, mode="decode",
                  cache=layer_cache, pos=pos, active=active)
    x = common.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _lm_head(params, x, cfg), cache
