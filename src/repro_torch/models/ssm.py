"""Mamba2 SSD (state-space duality) mixer: the chunked prefill form and
the constant-memory single-token decode (arXiv:2405.21060).

Port of `repro/models/ssm.py`.  Per chunk of Q tokens, a quadratic
intra-chunk term (attention-like) plus the contribution of the state
carried in from the chunks before:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D * x_t

The reference's `lax.scan` over chunks is a Python loop here, so only
one chunk's [B, H, Q, Q] quadratic term is live at a time (168 MB each
for `cb` and the decay matrix at mamba2-2.7b's full width, B=8).  Only
`ssd_forward` with `lengths` (the reference's `lm.prefill` always
passes it) fixes the chunk grid at `chunk` and turns every padded
position into an identity step; without (`lengths=None`, training's
`lm.forward`) the grid adapts to the sequence: chunks of min(chunk, L),
the last one padded with identity steps.

The state per layer is {ssm: [B, H, P, N] float32, conv: [B, W-1, ch]
in cfg.dtype}.  `ssd_decode` updates it IN PLACE (one static buffer in
the captured decode graph, as the KV cache is) and returns it for
symmetry with the reference's functional update.

Numerics mirror the reference op for op: the conv's shift-and-add chain
and silu in the activation dtype (silu as x * sigmoid(x), as
`jax.nn.silu` writes it), softplus as logaddexp(x, 0) (`jax.nn.softplus`; not
`F.softplus`, which switches formula above 20), the SSD algebra and the
gated RMSNorm in float32, cast to the input's dtype before out_proj.
The three- and four-operand einsums of the reference are written as
pairwise products, none building a 5-D intermediate.

Under serve-time tensor parallelism (`_ssm_tp`) the [B, H, P, N] state
and the SSD algebra are local to this rank's block of heads, and the
per-head outputs are all-gathered before the gated norm; the in / out
projections and the depthwise conv stay replicated (the conv window
mixes per-head x channels with the group-shared B / C channels, so its
state cannot partition over heads).  The collective is an exact concat:
bit-identical to the single-device path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dctx
from repro_torch.models import common
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.quant.qtensor import qmatmul


def _ssm_tp():
    """The active serve-time tensor-parallel context for SSD mixers, or
    None (distributed/context.py)."""
    tp = dctx.tp_current()
    return tp if tp is not None and tp.ssm else None


def _tp_heads(n_heads: int):
    """(tp, first local head, local head count): (None, 0, n_heads) with
    no SSD tensor parallelism."""
    tp = _ssm_tp()
    if tp is None:
        return None, 0, n_heads
    hl = n_heads // tp.size
    return tp, tp.index * hl, hl


def dims(cfg: ModelConfig):
    s = cfg.ssm or SSMConfig()
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, n_heads, conv_ch


def init_ssm(normal, cfg: ModelConfig, lead: tuple, device):
    """The reference's init_ssm for a stack of mixers of leading shape
    `lead` ((L,) layers, or a hybrid's (U, period-1)), drawn by
    `normal(shape, scale, dtype)` (float32 draws, cast to dtype):
    in_proj [*lead, d, 2*d_inner + 2*G*N + H] at 1/sqrt(d) and out_proj
    [*lead, d_inner, d] at 1/sqrt(d_inner) in cfg.dtype; the conv's taps
    [*lead, W, ch] at 0.2 and its bias (zeros) in cfg.dtype; A_log and
    dt_bias zeros, D and the gated norm's weight ones, in float32."""
    s, d_inner, n_heads, conv_ch = dims(cfg)
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    lead = tuple(lead)

    def const(value, *shape, dtype=torch.float32):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    return {
        "in_proj": normal(lead + (d, d_in_proj), 1.0 / math.sqrt(d)),
        "conv_w": normal(lead + (s.conv_width, conv_ch), 0.2),
        "conv_b": const(0.0, conv_ch, dtype=dt),
        "A_log": const(0.0, n_heads),
        "D": const(1.0, n_heads),
        "dt_bias": const(0.0, n_heads),
        "norm_w": const(1.0, d_inner),
        "out_proj": normal(lead + (d_inner, d), 1.0 / math.sqrt(d_inner)),
    }


def _silu(x):
    """jax.nn.silu as it is written, x * sigmoid(x), in x's dtype.  XLA's
    bf16 sigmoid differs from torch's by up to one bf16 step (C1), which
    this form halves against F.silu (measured: 28% against 37% of random
    bf16 inputs off by one step)."""
    return x * torch.sigmoid(x)


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _split_proj(zxbcdt, cfg: ModelConfig):
    s, d_inner, n_heads, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, n_heads], dim=-1)


def _causal_conv(xbc, conv_w, conv_b, width: int):
    """Depthwise causal conv via explicit shifts (width is small).
    xbc: [B, L, ch]; conv_w: [W, ch]; conv_b: [ch]."""
    out = xbc * conv_w[-1]
    for i in range(1, width):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :-i, :]
        out = out + shifted * conv_w[-1 - i]
    return _silu(out + conv_b)


def _segsum_decay(da_cs):
    """L[i, j] = exp(da_cs[i] - da_cs[j]) for i >= j else 0.
    da_cs: [B, Q, H] -> [B, H, Q, Q].  The differences above the diagonal
    are set to -inf before the exp (the reference takes exp of them and
    drops them after, by a where): the same values, and no inf whose
    gradient, times the where's zero, is NaN in training."""
    q = da_cs.shape[-2]
    cs = da_cs.transpose(1, 2)                               # [B,H,Q]
    # built in [B,H,i,j] order (the reference builds [B,i,j,H] and moves
    # the axis): the same differences, and the mask and exp on a
    # contiguous tensor
    diff = cs[:, :, :, None] - cs[:, :, None, :]             # [B,H,i,j]
    mask = torch.ones((q, q), dtype=torch.bool,
                      device=da_cs.device).tril()
    return torch.exp(diff.masked_fill(~mask, -math.inf))


def _chunk_step(state, xq, bq, cq, dtq, a, rep: int, heads=None):
    """One chunk: state [B, H, P, N] f32; xq [B, Q, H, P], bq / cq
    [B, Q, G, N], dtq [B, Q, H] (0 at padded steps).  Returns (the state
    after the chunk, y [B, Q, H, P]).  heads: (first, count) of the
    group-repeated B / C heads this rank keeps (tensor parallelism);
    xq, dtq, a and the state are then those heads' already."""
    bh = torch.repeat_interleave(bq, rep, dim=2)             # [B,Q,H,N]
    chh = torch.repeat_interleave(cq, rep, dim=2)
    if heads is not None:
        bh, chh = bh.narrow(2, *heads), chh.narrow(2, *heads)
    da_cs = torch.cumsum(dtq * a, dim=1)                     # [B,Q,H]
    lmat = _segsum_decay(da_cs)                              # [B,H,Q,Q]
    cb = torch.einsum("bihn,bjhn->bhij", chh, bh)
    xdt = xq * dtq[..., None]                                # [B,Q,H,P]
    y_diag = torch.einsum("bhij,bjhp->bihp", cb * lmat, xdt)
    del cb, lmat
    decay_in = torch.exp(da_cs)                              # [B,Q,H]
    y_off = torch.einsum("bqhn,bhpn->bqhp", chh, state) \
        * decay_in[..., None]
    decay_states = torch.exp(da_cs[:, -1:, :] - da_cs)       # [B,Q,H]
    states = torch.einsum("bqhn,bqhp->bhpn", bh,
                          xdt * decay_states[..., None])
    chunk_decay = torch.exp(da_cs[:, -1, :])                 # [B,H]
    return chunk_decay[:, :, None, None] * state + states, y_diag + y_off


def ssd_forward(p, x_in, cfg: ModelConfig, lengths=None,
                return_state=False):
    """x_in: [B, L, d_model] -> [B, L, d_model] (+ the final {ssm, conv}
    state with return_state).

    lengths: [B] int, the per-row count of REAL tokens (right-padded
    ragged batches).  The sequence is padded to a multiple of s.chunk
    (the fixed grid), and every position t >= lengths[b] is an identity
    step (dt = 0: decay 1, zero update), so a row's final state is the
    state after its real prompt, as if it ran unpadded.  The conv state
    is the last W-1 REAL pre-conv inputs of each row (left zeros for a
    row shorter than the window, as a fresh stream has).

    lengths=None (training): the adaptive grid of the reference, chunks
    of q = min(s.chunk, L) (a short sequence does not pay the full
    [B, H, chunk, chunk] intra-chunk term), the sequence padded to a
    multiple of q with identity steps past L."""
    s, d_inner, n_heads, conv_ch = dims(cfg)
    b, l_real, _ = x_in.shape
    q = s.chunk if lengths is not None else min(s.chunk, l_real)
    l = -(-l_real // q) * q           # pad to a chunk multiple
    if l != l_real:
        x_in = F.pad(x_in, (0, 0, 0, l - l_real))
    nc = l // q
    g, n, pd = s.n_groups, s.d_state, s.headdim

    zxbcdt = qmatmul(x_in, p["in_proj"])
    z, xbc_pre, dtr = _split_proj(zxbcdt, cfg)
    xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"], s.conv_width)
    x, bmat, cmat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)

    a = -torch.exp(p["A_log"])                               # [H]
    dt = _softplus(dtr.to(torch.float32) + p["dt_bias"])     # [B,L,H]
    lens = None if lengths is None else \
        lengths.to(device=x_in.device, dtype=torch.int64)
    if lens is not None or l != l_real:
        # identity steps past each row's real length (past L alone when
        # only the adaptive grid padded the sequence)
        valid = torch.arange(l, device=x_in.device)[None, :, None] \
            < (l_real if lens is None else lens[:, None, None])
        dt = torch.where(valid, dt, 0.0)

    xf = x.to(torch.float32).reshape(b, l, n_heads, pd)
    bm = bmat.to(torch.float32).reshape(b, l, g, n)
    cm = cmat.to(torch.float32).reshape(b, l, g, n)
    dcoef = p["D"]
    tp, h0, hl = _tp_heads(n_heads)
    heads = None
    if tp is not None:
        # this rank's head block (the projections and conv ran
        # replicated): the state and the SSD algebra are local
        heads = (h0, hl)
        xf, dt = xf.narrow(2, h0, hl), dt.narrow(2, h0, hl)
        a, dcoef = a.narrow(0, h0, hl), dcoef.narrow(0, h0, hl)
    state = torch.zeros((b, hl, pd, n), dtype=torch.float32,
                        device=x_in.device)
    ys = []
    for c in range(nc):
        t = slice(c * q, (c + 1) * q)
        state, y_c = _chunk_step(state, xf[:, t], bm[:, t], cm[:, t],
                                 dt[:, t], a, n_heads // g, heads)
        ys.append(y_c)
    y = torch.cat(ys, dim=1) + dcoef[None, None, :, None] * xf
    if tp is not None:
        y = tp.all_gather(y, 2)                              # [B,L,H,P]
    y = y.reshape(b, l, d_inner)
    # gated rmsnorm then out projection
    y = y * _silu(z.to(torch.float32))
    y = common.rms_norm(y, p["norm_w"], cfg.norm_eps).to(x_in.dtype)
    out = qmatmul(y, p["out_proj"])
    if l != l_real:
        out = out[:, :l_real, :]
    if not return_state:
        return out
    w = s.conv_width - 1
    if lens is None:
        lens = torch.full((b,), l_real, dtype=torch.int64,
                          device=x_in.device)
    padded = F.pad(xbc_pre, (0, 0, w, 0))
    idx = lens[:, None] + torch.arange(w, device=x_in.device)[None, :]
    conv_state = torch.gather(padded, 1,
                              idx[:, :, None].expand(b, w, conv_ch))
    return out, {"ssm": state, "conv": conv_state}


def init_ssm_state(cfg: ModelConfig, batch: int, *, device):
    """{ssm: [batch, H, P, N] float32, conv: [batch, W-1, ch]}; H is this
    rank's heads under tensor parallelism."""
    s, d_inner, n_heads, conv_ch = dims(cfg)
    hl = _tp_heads(n_heads)[2]
    return {
        "ssm": torch.zeros((batch, hl, s.headdim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def ssd_decode(p, x_t, state, cfg: ModelConfig, active=None):
    """Single-token decode.  x_t: [B, 1, d_model]; state: {ssm, conv}
    (init_ssm_state / ssd_forward), updated IN PLACE.  active: optional
    [B] bool slot mask -- inactive rows compute but keep their {ssm,
    conv} state bit-identical.  Returns (y_t [B, 1, d_model], state)."""
    s, d_inner, n_heads, conv_ch = dims(cfg)
    b = x_t.shape[0]
    g, n, pd = s.n_groups, s.d_state, s.headdim

    zxbcdt = qmatmul(x_t, p["in_proj"])                     # [B,1,*]
    z, xbc_new, dtr = _split_proj(zxbcdt, cfg)
    # conv over [cached, new]: the window's products summed in float32
    # and rounded once (the reference's einsum), then the bias
    buf = torch.cat([state["conv"], xbc_new], dim=1)         # [B,W,ch]
    conv_out = torch.einsum("bwc,wc->bc", buf.to(torch.float32),
                            p["conv_w"].to(torch.float32)).to(buf.dtype)
    xbc = _silu(conv_out + p["conv_b"])[:, None, :]          # [B,1,ch]
    new_conv = buf[:, 1:, :]

    x, bmat, cmat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    rep = n_heads // g
    xf = x.to(torch.float32).reshape(b, n_heads, pd)
    bh = torch.repeat_interleave(bmat.to(torch.float32).reshape(b, g, n),
                                 rep, dim=1)                 # [B,H,N]
    chh = torch.repeat_interleave(cmat.to(torch.float32).reshape(b, g, n),
                                  rep, dim=1)
    dt = _softplus(dtr.to(torch.float32).reshape(b, n_heads)
                   + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    dcoef = p["D"]
    tp, h0, hl = _tp_heads(n_heads)
    if tp is not None:
        # the local head block: the projections and conv above ran
        # replicated; only the state update and the per-head output shard
        xf, bh, chh, dt = (t.narrow(1, h0, hl) for t in (xf, bh, chh, dt))
        a, dcoef = a.narrow(0, h0, hl), dcoef.narrow(0, h0, hl)
    da = torch.exp(dt * a)                                   # [B,H]
    upd = (dt[:, :, None] * xf)[..., None] * bh[:, :, None, :]
    new_ssm = da[:, :, None, None] * state["ssm"] + upd      # [B,H,P,N]
    if active is not None:
        new_ssm = torch.where(active[:, None, None, None], new_ssm,
                              state["ssm"])
        new_conv = torch.where(active[:, None, None], new_conv,
                               state["conv"])
    # C . h over N as products and a batch-invariant row sum: cuBLAS's
    # batched product for this einsum sums in another order for one row
    # than for a batch of them, and the serve engine's rows must not
    # depend on their batch mates (measured on the card: ~3% of the
    # outputs differ between B=1 and B=2..8)
    y = common.row_sum(chh[:, :, None, :] * new_ssm)        # [B,H,P]
    y = y + dcoef[None, :, None] * xf
    if tp is not None:
        y = tp.all_gather(y, 1)                              # [B,H,P]
    y = y.reshape(b, 1, d_inner)
    y = y * _silu(z.to(torch.float32))
    y = common.rms_norm(y, p["norm_w"], cfg.norm_eps).to(x_t.dtype)
    out = qmatmul(y, p["out_proj"])
    state["ssm"].copy_(new_ssm)
    state["conv"].copy_(new_conv)
    return out, state
