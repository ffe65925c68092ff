"""Top-level language model: init / forward / prefill / decode for the
dense, moe, ssm, hybrid, encdec and vlm families.

Port of `repro/models/lm.py`.  The reference stacks layer params on a
leading axis and runs the stack under `jax.lax.scan`; the port keeps the
same stacked layout (so params convert leaf for leaf) and runs a Python
loop over the scan units' slices (`n_scan_units`: a layer, or one of the
hybrid family's super-blocks of `period` layers).  The KV cache is
stacked the same way, {k, v: [L, B, S_max, KV, D]}, and updated in place
(see models/attention.py); with serve_kv_dtype="int8" it also holds the
per-position scales {k_s, v_s: [L, B, S_max, KV]}.  The ssm family's
cache is its recurrent state instead, {ssm: [L, B, H, P, N] float32,
conv: [L, B, W-1, ch]} (models/ssm.py), updated in place the same way.
The hybrid family's cache is both, kept flat: {ssm, conv: [U, period-1,
B, ...]} for each unit's mixers and {k, v: [U, B, S_max, KV, D]} for its
attention layer (the reference nests them as {"mamba": {ssm, conv},
"attn": {k, v}}).  The encdec family (whisper) runs two stacks: the
encoder over precomputed frame embeddings (`encode`), then the decoder,
whose flat cache holds each layer's self-attention KV {k, v: [Ld, B,
S_max, KV, D]} and the cross K/V of the encoder's memory {cross_k,
cross_v: [Ld, B, S_enc, KV, D], cross_len: [Ld, B] int32} (the
reference nests them as {"self": {k, v}, "cross": {k, v, len}}).  The
vlm family (qwen2-vl) is the dense family with M-RoPE: its tree and
cache are the dense ones, its prefill takes token ids or the vision
frontend's precomputed patch embeddings [B, S, d] (the frontend is a
stub, as in the reference) with [3, B, S] positions.  Each unit runs
the block of its family (`blocks.BLOCK_FNS`, as the reference's
`BLOCK_FNS`).  Training's `forward` / `encdec_forward` run the blocks
in mode "train" (no cache; the MoE by capacity, the SSD on its adaptive
grid) and return (logits, aux); each unit may run under
`torch.utils.checkpoint` (remat), as the reference's scan body under
`jax.checkpoint`.
"""
from __future__ import annotations

import collections
import functools
import itertools
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, common, mlp, slot_state, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.quant.qtensor import qmatmul


def _check_family(cfg: ModelConfig):
    if cfg.family not in blocks.BLOCK_FNS:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(blocks.BLOCK_FNS)})")


def n_scan_units(cfg: ModelConfig) -> int:
    """Slices of the stacked block params: one per layer, or one per
    hybrid super-block of `period` layers (encdec: the encoder's layers;
    the decoder's are `n_dec_layers`)."""
    if cfg.family == "hybrid":
        assert cfg.n_layers % cfg.hybrid.period == 0
        return cfg.n_layers // cfg.hybrid.period
    return cfg.n_layers


def n_dec_layers(cfg: ModelConfig) -> int:
    """The encdec family's decoder layers (default: n_layers)."""
    return cfg.n_decoder_layers or cfg.n_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Draw(NamedTuple):
    """A leaf of random weights: N(0, 1) * scale drawn in float32, cast to
    dtype.  `draw_slices` draws it one [K, N] matrix at a time."""
    shape: tuple
    scale: float
    dtype: torch.dtype


def draw_slices(spec: Draw, gen: torch.Generator, device):
    """(index, matrix) for each [K, N] matrix of the leaf, its leading
    indices in row-major order, each drawn by its own `torch.randn` call
    from `gen` (a leaf of at most two axes is one matrix, index ())."""
    lead = spec.shape[:-2]
    for idx in itertools.product(*(range(n) for n in lead)):
        # no name holds the float32 draw: it is freed once cast
        yield idx, torch.randn(spec.shape[len(lead):], generator=gen,
                               device=device, dtype=torch.float32).mul_(
            spec.scale).to(spec.dtype)


def materialize(path, spec: Draw, slices, device):
    """The default `build` of `init_params`: the whole leaf in its
    dtype, written a matrix at a time (a one-matrix leaf is its draw,
    not copied)."""
    if len(spec.shape) <= 2:
        return next(slices)[1]
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for idx, w in slices:
        out[idx] = w
    return out


def param_specs(cfg: ModelConfig, device, max_seq: int = 4096):
    """The params tree with a `Draw` at each random leaf and the constant
    leaves (norm weights, biases, the ssm family's A_log, D, dt_bias,
    conv bias) as tensors on `device`.

    Stacked block leaves lead with the scan units, [L, ...] (a hybrid
    sub-layer's with [U, n, ...]); dense weights are N(0, 1) / sqrt(d_in)
    in cfg.dtype; embed: N(0, 1) * 0.02; norm weights: ones (float32);
    with cfg.qkv_bias the stacked q/k/v biases bq [L, q_dim], bk and bv
    [L, kv_dim]: zeros in cfg.dtype, as the reference's.  The moe
    family has `moe` (`mlp.init_moe`: the float32 router [L, d, E] and
    the experts [L, E, K, N]) in place of `mlp`, and with dense_residual
    a dense `dense` MLP beside it.  The ssm family's block is {ln: {w},
    ssm: `ssm.init_ssm`} (no attention, no MLP); mamba2 ties its head to
    the embedding.  The hybrid family's unit is the reference's
    `init_hybrid_block`: `mamba` and `mamba_ln` [U, period-1, ...], `attn`
    and `attn_ln` [U, ...], `moe` [U, n_moe, ...], `dense` [U, n_dense,
    ...] and the FFNs' norms `ffn_ln` [U, period, d].  With learned_pos,
    `pos_embed` [max_seq, d] (N(0, 1) * 0.02, as embed).  The encdec
    family's stacks are `enc` [L, ...] ({ln1, attn, ln2, mlp}) with
    `enc_norm` and `enc_pos` [max_seq, d], and `dec` [Ld, ...] ({ln1,
    self, ln2, cross, ln3, mlp}); its MLP is the GELU one, {wi, bi, wo,
    bo} (biases zeros in cfg.dtype); a layernorm is {w: ones, b: zeros}
    (float32)."""
    dt = getattr(torch, cfg.dtype)
    d, u = cfg.d_model, n_scan_units(cfg)

    def normal(shape, scale, dtype=dt):
        return Draw(tuple(shape), scale, dtype)

    def dense(lead, d_in, d_out):
        return normal(lead + (d_in, d_out), 1.0 / math.sqrt(d_in))

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def norm(*lead):
        p = {"w": ones(*lead, d)}
        if cfg.norm == "layernorm":
            p["b"] = torch.zeros(lead + (d,), dtype=torch.float32,
                                 device=device)
        return p

    def attention(lead):
        p = {"wq": dense(lead, d, cfg.q_dim), "wk": dense(lead, d, cfg.kv_dim),
             "wv": dense(lead, d, cfg.kv_dim), "wo": dense(lead, cfg.q_dim, d)}
        if cfg.qkv_bias:
            for key, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                               ("bv", cfg.kv_dim)):
                p[key] = torch.zeros(lead + (width,), dtype=dt, device=device)
        return p

    def dense_mlp(lead):
        if cfg.activation == "gelu":
            return {"wi": dense(lead, d, cfg.d_ff),
                    "bi": torch.zeros(lead + (cfg.d_ff,), dtype=dt,
                                      device=device),
                    "wo": dense(lead, cfg.d_ff, d),
                    "bo": torch.zeros(lead + (d,), dtype=dt, device=device)}
        return {"wi": dense(lead, d, cfg.d_ff), "wg": dense(lead, d, cfg.d_ff),
                "wo": dense(lead, cfg.d_ff, d)}

    p = {"embed": normal((cfg.vocab, d), 0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense((), d, cfg.vocab)
    p["final_norm"] = norm()
    if cfg.learned_pos:
        p["pos_embed"] = normal((max_seq, d), 0.02)
    if cfg.family == "encdec":
        nd = (n_dec_layers(cfg),)
        p["enc"] = {"ln1": norm(u), "attn": attention((u,)), "ln2": norm(u),
                    "mlp": dense_mlp((u,))}
        p["enc_norm"] = norm()
        p["enc_pos"] = normal((max_seq, d), 0.02)
        p["dec"] = {"ln1": norm(*nd), "self": attention(nd),
                    "ln2": norm(*nd), "cross": attention(nd),
                    "ln3": norm(*nd), "mlp": dense_mlp(nd)}
    elif cfg.family == "ssm":
        p["blocks"] = {"ln": norm(u),
                       "ssm": ssm.init_ssm(normal, cfg, (u,), device)}
    elif cfg.family == "hybrid":
        layout = blocks.hybrid_layout(cfg)
        n = collections.Counter(kind for layer in layout for kind in layer)
        p["blocks"] = {
            "mamba": ssm.init_ssm(normal, cfg, (u, n["mamba"]), device),
            "mamba_ln": norm(u, n["mamba"]),
            "attn": attention((u,)), "attn_ln": norm(u),
            "moe": mlp.init_moe(normal, cfg, (u, n["moe"])),
            "dense": dense_mlp((u, n["dense"])),
            "ffn_ln": norm(u, len(layout))}
    else:
        p["blocks"] = {"ln1": norm(u), "attn": attention((u,)),
                       "ln2": norm(u)}
        if cfg.family == "moe":
            p["blocks"]["moe"] = mlp.init_moe(normal, cfg, (u,))
            if cfg.moe.dense_residual:
                p["blocks"]["dense"] = dense_mlp((u,))
        else:
            p["blocks"]["mlp"] = dense_mlp((u,))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                build=materialize, max_seq: int = 4096):
    """Random params with the reference's tree, shapes and scales
    (`param_specs`), drawn from a torch.Generator seeded with `seed` on
    `device` (the numbers differ from the reference's jax.random draws;
    parity tests convert the reference's params instead, see convert.py).

    The random leaves are drawn in the tree's order, each one [K, N]
    matrix at a time (`draw_slices`), and `build(path, spec, slices,
    device)` makes each leaf from its slices (default: the whole leaf,
    `materialize`).  `launch/serve.py::build_params` passes a `build`
    that quantizes each matrix as it is drawn, so no whole leaf of
    float weights exists, and gets the same weights bit for bit.
    max_seq: rows of the learned position tables (as the reference's)."""
    _check_family(cfg)
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if isinstance(node, Draw):
            return build(path, node, draw_slices(node, gen, dev), dev)
        return node

    return walk((), param_specs(cfg, dev, max_seq))


def _lm_head(p, x, cfg: ModelConfig):
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return qmatmul(x, w).to(torch.float32)


def _embed(p, tokens_or_embeds, cfg: ModelConfig):
    """Token ids [B, S] looked up in the embedding, or a frontend stub's
    precomputed embeddings [B, S, d] (float) cast to cfg.dtype."""
    if tokens_or_embeds.is_floating_point():
        return tokens_or_embeds.to(getattr(torch, cfg.dtype))
    return p["embed"][tokens_or_embeds.long()]


# ---------------------------------------------------------------------------
# decoder-only forward (train)
# ---------------------------------------------------------------------------

def _run_units(units, x, fn, remat: bool):
    """Apply fn(unit_params, x) -> (x, aux) over the units in order,
    summing the float32 aux from 0 as the reference's scan carry does;
    with remat each unit runs under a non-reentrant checkpoint (its
    activations recomputed in the backward)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in units:
        if remat:
            x, a = checkpoint(fn, unit, x, use_reentrant=False)
        else:
            x, a = fn(unit, x)
        aux = aux + a
    return x, aux


def forward(params, inputs, cfg: ModelConfig, *, remat: bool = True,
            positions=None):
    """Training's forward (reference lm.py:92): inputs [B,S] int tokens or
    [B,S,d] float stub embeddings (vlm; [3,B,S] arange positions unless
    given) -> (logits [B,S,V] float32, aux float32 scalar: the sum of
    the MoE layers' load-balancing losses).  encdec: inputs (features
    [B,S_enc,d], dec_tokens [B,S]), `encdec_forward`.  The stacked
    params are unbound per unit once (`blocks.unstack`) and the units
    run in a loop, each under `torch.utils.checkpoint` with remat."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return encdec_forward(params, inputs, cfg, remat=remat)
    x = _embed(params, inputs, cfg)
    b, s = x.shape[:2]
    if cfg.learned_pos:
        x = x + params["pos_embed"][None, :s, :]
    if cfg.m_rope_sections is not None and positions is None:
        positions = torch.arange(s, device=x.device).expand(3, b, s)
    block = functools.partial(_train_block, blocks.BLOCK_FNS[cfg.family],
                              cfg=cfg, positions=positions)
    x, aux = _run_units(blocks.unstack(params["blocks"], n_scan_units(cfg)),
                        x, block, remat)
    x = common.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _lm_head(params, x, cfg), aux


def _train_block(block, unit, x, *, cfg, positions=None, memory=None):
    if memory is not None:
        return block(unit, x, cfg, memory=memory, mode="train")
    return block(unit, x, cfg, mode="train", positions=positions)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, s_max: int, *, device,
               s_enc: int | None = None):
    """Stacked per-unit cache: the KV cache {k, v: [L, B, S_max, KV, D]},
    and the scales {k_s, v_s: [L, B, S_max, KV]} of an int8 cache; for
    the ssm family the recurrent state {ssm: [L, B, H, P, N] float32,
    conv: [L, B, W-1, ch] cfg.dtype} (no KV, s_max unused); for the
    hybrid family both, flat: the mixers' {ssm, conv: [U, period-1, B,
    ...]} and the attention layer's {k, v: [U, B, S_max, KV, D]}; for the
    encdec family, over its Ld decoder layers, the self-attention's KV
    cache and the cross K/V {cross_k, cross_v: [Ld, B, s_enc (default
    S_max), KV, D] cfg.dtype, cross_len: [Ld, B] int32}, flat.  Under
    serve-time tensor parallelism KV and H count this rank's heads
    (attention.init_cache, ssm.init_ssm_state)."""
    _check_family(cfg)
    u = n_dec_layers(cfg) if cfg.family == "encdec" else n_scan_units(cfg)
    lead = {}
    if cfg.family in ("ssm", "hybrid"):
        n = (u,) if cfg.family == "ssm" else (u, cfg.hybrid.period - 1)
        lead.update({k: (n, t) for k, t in ssm.init_ssm_state(
            cfg, batch, device=device).items()})
    if cfg.family != "ssm":
        lead.update({k: ((u,), t) for k, t in attn_mod.init_cache(
            cfg, batch, s_max, device=device).items()})
    if cfg.family == "encdec":
        kv = torch.empty((batch, s_enc or s_max, attn_mod.init_cache(
            cfg, 1, 1, device="meta")["k"].shape[2], cfg.head_dim),
                         dtype=getattr(torch, cfg.dtype), device=device)
        lead.update({"cross_k": ((u,), kv), "cross_v": ((u,), kv),
                     "cross_len": ((u,), torch.empty(
                         (batch,), dtype=torch.int32, device=device))})
    return {k: torch.zeros(n + tuple(t.shape), dtype=t.dtype,
                           device=t.device) for k, (n, t) in lead.items()}


def _last_logits(params, x, cfg: ModelConfig, last_positions):
    """The final norm and the head at each row's last real position (the
    final column by default): [B, 1, V] float32."""
    x = common.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if last_positions is None:
        x_last = x[:, -1:, :]
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, last_positions.long()][:, None, :]
    return _lm_head(params, x_last, cfg)


def prefill(params, inputs, cfg: ModelConfig, cache_len: int,
            positions=None, last_positions=None, enc_lengths=None,
            enc_pad=None):
    """Run the prompt, return (last-position logits [B,1,V] f32, cache).

    inputs: [B,S] int tokens, or [B,S,d] float stub embeddings (the vlm
    family's image prompts); for encdec (features [B,S_enc,d],
    dec_tokens [B,S]), with enc_lengths / enc_pad (`encdec_prefill`).
    positions: [B,S], or [3,B,S] under cfg.m_rope_sections (default:
    arange, the same on all three rows there).
    last_positions: optional [B] int -- per-row index of the last REAL
    prompt token (right-padded ragged batches).  Default: the final
    column.  Every block gets the rows' real lengths (S, or
    last_positions + 1): attention masks the padding causally, but an
    SSM state is sequential, and its padded steps must be identity
    updates (models/ssm.py)."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return encdec_prefill(params, inputs, cfg, cache_len,
                              last_positions=last_positions,
                              enc_lengths=enc_lengths, enc_pad=enc_pad)
    x = _embed(params, inputs, cfg)
    b, s = x.shape[:2]
    if cfg.m_rope_sections is not None and positions is None:
        positions = torch.arange(s, device=x.device).expand(3, b, s)
    if last_positions is None:
        lengths = torch.full((b,), s, dtype=torch.int64, device=x.device)
    else:
        lengths = last_positions.to(device=x.device, dtype=torch.int64) + 1
    cache = init_cache(cfg, b, cache_len, device=x.device)
    block = blocks.BLOCK_FNS[cfg.family]
    for i in range(n_scan_units(cfg)):
        layer_cache = {k: t[i] for k, t in cache.items()}
        x = block(blocks.tree_idx(params["blocks"], i), x, cfg, mode="prefill",
                  cache=layer_cache, positions=positions, lengths=lengths)
    return _last_logits(params, x, cfg, last_positions), cache


def decode_step(params, token_t, cache, pos, cfg: ModelConfig, active=None):
    """token_t: [B,C] int (or [B,C,d] stub embeddings); pos: [B] int
    position of the first new token per row; active: optional [B] bool
    slot mask -- inactive rows compute but do not write their cache.

    Returns (logits [B,C,V] f32, cache).  The cache is updated IN PLACE
    and returned for symmetry with the reference's functional update."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return encdec_decode_step(params, token_t, cache, pos, cfg,
                                  active=active)
    x = _embed(params, token_t, cfg)
    block = blocks.BLOCK_FNS[cfg.family]
    for i in range(n_scan_units(cfg)):
        layer_cache = {k: t[i] for k, t in cache.items()}
        x = block(blocks.tree_idx(params["blocks"], i), x, cfg, mode="decode",
                  cache=layer_cache, pos=pos, active=active)
    x = common.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _lm_head(params, x, cfg), cache


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------

def encode(params, embeds, cfg: ModelConfig, lengths=None,
           train: bool = False):
    """The encoder over frame embeddings [B, S_enc, d] (the audio
    frontend's output; the frontend is a stub, as in the reference):
    cast to cfg.dtype, plus `enc_pos`, the encoder layers, `enc_norm`.
    lengths: optional [B] real frames per row; the padded frames are
    masked out of every self-attention, so the real positions of a
    right-padded batch come out as they would unpadded.  train:
    training's forward (the attention's plain form, the layer params
    unbound once: `blocks.unstack`)."""
    x = embeds.to(getattr(torch, cfg.dtype))
    x = x + params["enc_pos"][None, :x.shape[1], :]
    u = n_scan_units(cfg)
    units = blocks.unstack(params["enc"], u) if train else \
        (blocks.tree_idx(params["enc"], i) for i in range(u))
    for unit in units:
        x = blocks.enc_block(unit, x, cfg, lengths=lengths, train=train)
    return common.norm_apply(x, params["enc_norm"], cfg.norm, cfg.norm_eps)


def encdec_forward(params, inputs, cfg: ModelConfig, *, remat: bool = True):
    """Training's encoder-decoder forward (reference lm.py:255): inputs
    (audio embeddings [B, S_enc, d], dec_tokens [B, S]).  The encoder
    runs whole (not rematerialized, as in the reference), then the
    decoder layers over its memory, each under a checkpoint with remat.
    Returns (logits [B, S, V] float32, aux 0)."""
    audio, dec_tokens = inputs
    memory = encode(params, audio, cfg, train=True)
    x = _embed(params, dec_tokens, cfg)
    x = x + params["pos_embed"][None, :x.shape[1], :]
    block = functools.partial(_train_block, blocks.dec_block, cfg=cfg,
                              memory=memory)
    x, aux = _run_units(blocks.unstack(params["dec"], n_dec_layers(cfg)), x,
                        block, remat)
    x = common.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _lm_head(params, x, cfg), aux


def encdec_prefill(params, inputs, cfg: ModelConfig, cache_len: int,
                   last_positions=None, enc_lengths=None, enc_pad=None):
    """inputs: (features [B, S_enc, d], dec_tokens [B, S]).  Encodes the
    features (enc_lengths: [B] real frames per row), runs the decoder
    over the tokens (plus `pos_embed`), filling each decoder layer's self
    KV and the cross K/V of the memory, right-padded to enc_pad columns
    where enc_pad > S_enc (`blocks.dec_block`).  Returns (the last
    positions' logits [B, 1, V] f32, the flat cache)."""
    audio, dec_tokens = inputs
    memory = encode(params, audio, cfg, lengths=enc_lengths)
    x = _embed(params, dec_tokens, cfg)
    b, s = x.shape[:2]
    x = x + params["pos_embed"][None, :s, :]
    cache = init_cache(cfg, b, cache_len, device=x.device,
                       s_enc=max(enc_pad or 0, memory.shape[1]))
    block = blocks.BLOCK_FNS[cfg.family]
    for i in range(n_dec_layers(cfg)):
        layer_cache = {k: t[i] for k, t in cache.items()}
        x = block(blocks.tree_idx(params["dec"], i), x, cfg, memory=memory,
                  mode="prefill", cache=layer_cache, enc_lengths=enc_lengths)
    return _last_logits(params, x, cfg, last_positions), cache


def encdec_decode_step(params, token_t, cache, pos, cfg: ModelConfig,
                       active=None):
    """token_t: [B, C] int, each row's tokens at position pos [B] (the
    reference adds pos_embed[pos] to all C); the self KV is written in
    place (masked by `active`), the cross K/V only read.  Returns (logits
    [B, C, V] f32, cache)."""
    x = _embed(params, token_t, cfg)
    x = x + params["pos_embed"][pos.long()][:, None, :]
    block = blocks.BLOCK_FNS[cfg.family]
    for i in range(n_dec_layers(cfg)):
        layer_cache = {k: t[i] for k, t in cache.items()}
        x = block(blocks.tree_idx(params["dec"], i), x, cfg, mode="decode",
                  cache=layer_cache, pos=pos, active=active)
    x = common.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _lm_head(params, x, cfg), cache


# ---------------------------------------------------------------------------
# the embed method (serve `embed`)
# ---------------------------------------------------------------------------

def embed_pool(params, inputs, cfg: ModelConfig, last_positions=None,
               enc_lengths=None):
    """Final-hidden-state embedding of a prompt (reference lm.py:319-366):
    run the stack as prefill does -- the MoE routing per token, the SSM's
    padded steps as identity updates, the encoder over masked frames,
    vlm's 3-row arange positions -- then take the float32 mean of the
    post-final-norm hidden states over each row's real positions.

    No cache is written.  The pool's sum runs in `common.tail_sum_`'s
    tree over the sequence axis, which zeros appended to it (the prompt
    bucket's masked padding) do not change, on every device, and whose
    rows are independent: a request's vector is bit-identical whatever
    its batch mates or padding (ROADMAP C10's rule for the reference's
    `xf.sum(axis=1)`).  inputs, last_positions and enc_lengths as
    `prefill`'s.  Returns [B, d_model] float32."""
    _check_family(cfg)
    if cfg.family == "encdec":
        audio, dec_tokens = inputs
        memory = encode(params, audio, cfg, lengths=enc_lengths)
        x = _embed(params, dec_tokens, cfg)
        x = x + params["pos_embed"][None, :x.shape[1], :]
        for i in range(n_dec_layers(cfg)):
            x = blocks.dec_block(blocks.tree_idx(params["dec"], i), x, cfg,
                                 memory=memory, mode="prefill",
                                 enc_lengths=enc_lengths)
    else:
        x = _embed(params, inputs, cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(3, b, s) \
            if cfg.m_rope_sections is not None else None
        lengths = torch.full((b,), s, dtype=torch.int64, device=x.device) \
            if last_positions is None else \
            last_positions.to(device=x.device, dtype=torch.int64) + 1
        block = blocks.BLOCK_FNS[cfg.family]
        for i in range(n_scan_units(cfg)):
            x = block(blocks.tree_idx(params["blocks"], i), x, cfg,
                      mode="prefill", positions=positions, lengths=lengths)
    x = common.norm_apply(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    b, s = x.shape[:2]
    lengths = torch.full((b,), s, dtype=torch.int64, device=x.device) \
        if last_positions is None else \
        last_positions.to(device=x.device, dtype=torch.int64) + 1
    mask = torch.arange(s, device=x.device)[None, :] < lengths[:, None]
    xf = x.to(torch.float32) * mask[:, :, None].to(torch.float32)
    return common.tail_sum_(xf, 1) / lengths[:, None].to(torch.float32)


# ---------------------------------------------------------------------------
# slot-state registry (models/slot_state.py)
# ---------------------------------------------------------------------------
# The serve engine builds, slices, scatters and compacts per-slot decode
# state through these registrations, as the reference's lm.py:384-392;
# the axis layout is probed from init_cache.  Chunked prefill is for the
# pure-KV families only: SSM / hybrid state updates are sequential, and
# encdec prefill must run the encoder, so feeding their prompts C tokens
# at a time through the decode path would change the reduction order (or
# skip the encoder).  The encdec family's state is probed with s_enc =
# the engine's enc_len: its cross K/V and cross_len are constant-size
# leaves, reset on admit.
for _fam in ("dense", "vlm", "moe"):
    slot_state.register(_fam, init_cache)
for _fam in ("ssm", "hybrid", "encdec"):
    slot_state.register(_fam, init_cache, prefill_chunkable=False)
