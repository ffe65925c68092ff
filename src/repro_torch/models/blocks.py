"""Residual blocks (port of `repro/models/blocks.py`): the dense unit,
pre-norm attention + pre-norm MLP."""
from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.config import ModelConfig


def _norm(cfg, x, p):
    return common.norm_apply(x, p, cfg.norm, cfg.norm_eps)


def dense_block(p, x, cfg: ModelConfig, *, mode="prefill", cache=None,
                pos=None, positions=None, active=None):
    """One dense layer.  mode "prefill" runs full causal attention (and
    fills `cache` in place when given); mode "decode" attends the new
    tokens against `cache`, updated in place.  Returns the new hidden
    state (the reference also returns the new cache and an aux loss; here
    the cache is mutated in place and dense blocks have no aux loss)."""
    h = _norm(cfg, x, p["ln1"])
    if mode == "decode":
        a = attn.attn_decode(p["attn"], h, cache, pos, cfg, active=active)
    elif mode == "prefill":
        a = attn.attn_full(p["attn"], h, cfg, positions, cache=cache)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + a
    return x + mlp.mlp(p["mlp"], _norm(cfg, x, p["ln2"]), cfg)
