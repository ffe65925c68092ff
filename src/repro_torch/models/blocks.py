"""Residual blocks (port of `repro/models/blocks.py`): the dense unit
(pre-norm attention + pre-norm MLP; also the vlm family's), the moe
unit (pre-norm attention + MoE, with arctic's parallel dense FFN, the
"dense residual"), the ssm unit (pre-norm Mamba2 SSD mixer, no MLP),
the hybrid unit (jamba's super-block: `period` layers of mixer + FFN),
and whisper's encoder and decoder units (`enc_block`: bidirectional
self-attention + GELU MLP; `dec_block`: causal self-attention,
cross-attention over the encoder's memory, GELU MLP).

`BLOCK_FNS` maps a family to the block its prefill and decode run over
the cache, as the reference's `repro/models/lm.py:25` does (encdec: the
decoder's; `lm.encode` runs `enc_block`); `lm` runs the stack through
it."""
from __future__ import annotations

import collections

from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, ssm
from repro_torch.models.config import ModelConfig


def tree_idx(tree, i):
    """Slice i of the leading axis of every leaf (QTensor leaves slice q
    and scale together): a scan unit's params, or a hybrid sub-layer's."""
    if isinstance(tree, dict):
        return {k: tree_idx(v, i) for k, v in tree.items()}
    return tree[i]


def hybrid_layout(cfg: ModelConfig) -> list:
    """Each layer of a hybrid scan unit as (mixer, ffn), in order: mixer
    "attn" at `attn_index`, else "mamba" (an SSD mixer); ffn "moe" when
    i % interleave == interleave - 1, else "dense" (jamba's unit of 8:
    one attention, seven mixers, four MoE and four dense FFNs).  The
    params tree (`lm.param_specs`), `hybrid_block` and the launch counts
    read it."""
    hp, m = cfg.hybrid, cfg.moe
    return [("attn" if i == hp.attn_index else "mamba",
             "moe" if i % m.interleave == m.interleave - 1 else "dense")
            for i in range(hp.period)]


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


def hybrid_block(p, x, cfg: ModelConfig, *, mode="prefill", cache=None,
                 pos=None, positions=None, active=None, lengths=None):
    """One jamba super-block (a scan unit): `period` layers, each a mixer
    and an FFN, each with its pre-norm and residual.  Layer `attn_index`
    mixes by attention (`attn_ln`, `attn`), the others by an SSD mixer
    (`mamba_ln`, `mamba`, as ssm_block); layer i's FFN is the MoE
    (per-token routing) when i % interleave == interleave - 1, else the
    dense SwiGLU MLP (`dense`), after `ffn_ln` i.  `cache` is the unit's
    slice of the flat hybrid cache, {ssm, conv: [period-1, B, ...]} and
    the attention's {k, v (, k_s, v_s)}, updated in place: the prefill
    fills it (the mixers on the fixed chunk grid with `lengths`), a
    decode step steps it (masked by `active`).  Modes as dense_block's;
    the reference's aux loss is dropped, as its prefill / decode drop it."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    kv = {k: t for k, t in cache.items() if k not in ("ssm", "conv")}
    n = collections.Counter()        # layers of each kind so far
    for i, (mixer, ffn) in enumerate(hybrid_layout(cfg)):
        if mixer == "attn":
            h = _norm(cfg, x, p["attn_ln"])
            if mode == "decode":
                x = x + attn.attn_decode(p["attn"], h, kv, pos, cfg,
                                         active=active)
            else:
                x = x + attn.attn_full(p["attn"], h, cfg, positions,
                                       cache=kv)
        else:
            j = n["mamba"]
            layer = {"ln": tree_idx(p["mamba_ln"], j),
                     "ssm": tree_idx(p["mamba"], j)}
            state = {k: cache[k][j] for k in ("ssm", "conv")}
            x = ssm_block(layer, x, cfg, mode=mode, cache=state,
                          active=active, lengths=lengths)
        h2 = _norm(cfg, x, tree_idx(p["ffn_ln"], i))
        if ffn == "moe":
            y, _ = mlp.moe(tree_idx(p["moe"], n["moe"]), h2, cfg,
                           per_token=True, want_aux=False)
        else:
            y = mlp.mlp(tree_idx(p["dense"], n["dense"]), h2, cfg)
        n.update((mixer, ffn))
        x = x + y
    return x


def enc_block(p, x, cfg: ModelConfig, lengths=None):
    """One encoder layer: pre-norm bidirectional self-attention, then the
    pre-norm MLP.  lengths: optional [B] real frames per row; the padded
    frames are masked out of the attention, so a right-padded row's real
    positions come out as they would unpadded."""
    x = x + attn.attn_full(p["attn"], _norm(cfg, x, p["ln1"]), cfg,
                           causal=False, kv_lengths=lengths)
    return x + mlp.mlp(p["mlp"], _norm(cfg, x, p["ln2"]), cfg)


CROSS = ("cross_k", "cross_v", "cross_len")


def dec_block(p, x, cfg: ModelConfig, *, memory=None, mode="prefill",
              cache=None, pos=None, active=None, enc_lengths=None):
    """One decoder layer over its slice of the flat encdec cache: the
    self-attention's {k, v (, k_s, v_s)} and the cross-attention's
    {cross_k, cross_v: [B, T, KV, D], cross_len: [B] int32}.

    mode "prefill": causal self-attention over x, its keys and values
    written into the self cache in place; the memory [B, S_enc, d]
    projected to the cross K/V, written into cross_k / cross_v's first
    S_enc positions (a page wider than S_enc keeps the zeros `init_cache`
    gave it: right padding) with cross_len = enc_lengths (default
    S_enc).  mode
    "decode": the new tokens attend against the self cache, written in
    place (`active` masks the write), and read the cross K/V, which the
    step never writes.  Both attend over the cross K/V masked by
    enc_lengths, else cross_len.  Returns the new hidden state."""
    h = _norm(cfg, x, p["ln1"])
    self_c = {k: t for k, t in cache.items() if k not in CROSS}
    if mode == "decode":
        a = attn.attn_decode(p["self"], h, self_c, pos, cfg, active=active)
    elif mode == "prefill":
        a = attn.attn_full(p["self"], h, cfg, cache=self_c)
        k, v = attn._project_kv(p["cross"], memory, cfg)
        s_enc = k.shape[1]
        cache["cross_k"][:, :s_enc] = k
        cache["cross_v"][:, :s_enc] = v
        if enc_lengths is None:
            cache["cross_len"].fill_(s_enc)
        else:
            cache["cross_len"].copy_(enc_lengths)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + a
    mem_kv = {"k": cache["cross_k"], "v": cache["cross_v"],
              "len": cache["cross_len"]}
    x = x + attn.attn_cross(p["cross"], _norm(cfg, x, p["ln2"]), memory,
                            cfg, mem_kv=mem_kv, enc_lengths=enc_lengths)
    return x + mlp.mlp(p["mlp"], _norm(cfg, x, p["ln3"]), cfg)


# vlm (qwen2-vl) runs the dense unit: its M-RoPE lives in the attention
BLOCK_FNS = {"dense": dense_block, "vlm": dense_block, "moe": moe_block,
             "ssm": ssm_block, "hybrid": hybrid_block, "encdec": dec_block}
