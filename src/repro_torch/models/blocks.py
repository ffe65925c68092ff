"""Residual blocks (port of `repro/models/blocks.py`): the dense unit
(pre-norm attention + pre-norm MLP), the moe unit (pre-norm attention
+ MoE, with arctic's parallel dense FFN, the "dense residual") and the
ssm unit (pre-norm Mamba2 SSD mixer, no MLP).

`BLOCK_FNS` maps a family to its block, as the reference's
`repro/models/lm.py:25` does; `lm` runs the stack through it."""
from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, ssm
from repro_torch.models.config import ModelConfig


def _norm(cfg, x, p):
    return common.norm_apply(x, p, cfg.norm, cfg.norm_eps)


def _attend(p, x, cfg, mode, cache, pos, positions, active):
    h = _norm(cfg, x, p["ln1"])
    if mode == "decode":
        return attn.attn_decode(p["attn"], h, cache, pos, cfg, active=active)
    if mode == "prefill":
        return attn.attn_full(p["attn"], h, cfg, positions, cache=cache)
    raise ValueError(f"unknown mode {mode!r}")


def dense_block(p, x, cfg: ModelConfig, *, mode="prefill", cache=None,
                pos=None, positions=None, active=None, lengths=None):
    """One dense layer.  mode "prefill" runs full causal attention (and
    fills `cache` in place when given); mode "decode" attends the new
    tokens against `cache`, updated in place.  Returns the new hidden
    state (the reference also returns the new cache and an aux loss; here
    the cache is mutated in place and dense blocks have no aux loss).
    `lengths` (the prefill's real tokens per row) is for the ssm unit:
    causal attention needs no lengths."""
    x = x + _attend(p, x, cfg, mode, cache, pos, positions, active)
    return x + mlp.mlp(p["mlp"], _norm(cfg, x, p["ln2"]), cfg)


def moe_block(p, x, cfg: ModelConfig, *, mode="prefill", cache=None,
              pos=None, positions=None, active=None, lengths=None):
    """One moe layer (arctic / granite), modes as dense_block's.  The MoE
    routes per token (dropless), so a row's tokens are independent of
    its batch mates and padding; arctic adds a dense MLP on the same
    normed input.  Returns the new hidden state: the reference's aux loss
    is dropped by its prefill / decode, and not computed here."""
    x = x + _attend(p, x, cfg, mode, cache, pos, positions, active)
    h2 = _norm(cfg, x, p["ln2"])
    y, _ = mlp.moe(p["moe"], h2, cfg, per_token=True, want_aux=False)
    if "dense" in p:                      # arctic: parallel dense residual
        y = y + mlp.mlp(p["dense"], h2, cfg)
    return x + y


def ssm_block(p, x, cfg: ModelConfig, *, mode="prefill", cache=None,
              pos=None, positions=None, active=None, lengths=None):
    """One mamba2 layer: pre-norm `ln`, the SSD mixer, the residual.  mode
    "prefill" runs `ssd_forward` on the fixed chunk grid with `lengths`
    ([B] real tokens per row) and writes the final state into `cache`
    ({ssm, conv}) in place; mode "decode" steps the state in `cache` in
    place (`active` masks its update)."""
    h = _norm(cfg, x, p["ln"])
    if mode == "decode":
        y, _ = ssm.ssd_decode(p["ssm"], h, cache, cfg, active=active)
    elif mode == "prefill":
        y, state = ssm.ssd_forward(p["ssm"], h, cfg, lengths,
                                   return_state=True)
        for k, t in state.items():
            cache[k].copy_(t)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return x + y


BLOCK_FNS = {"dense": dense_block, "moe": moe_block, "ssm": ssm_block}
