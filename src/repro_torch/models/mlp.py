"""Feed-forward layers (port of `repro/models/mlp.py`): the dense SwiGLU
and GELU MLPs and the top-k mixture of experts, its serving path and
training's capacity dispatch.

MoE serving (`moe(per_token=True)`, the reference's prefill / decode
path) routes every token dropless through a dense one-hot combine: every
expert runs on every token and each token keeps its top-k, so a token's
output depends on that token alone.  The expert products are three
expert-stacked GEMMs ([E, K, N] weights), each ONE kernel launch for all
E experts (`qmatmul`); the x of wi / wg is one x broadcast to every
expert, passed with expert stride 0.  Every shape is static and nothing
reads a device value on the host (topk, scatter, no boolean indexing),
so the step can be captured in a CUDA graph.

Training (`per_token=False`) dispatches by capacity, as the
reference's `_dispatch_combine`: assignments sorted by expert (stable),
each one's rank within its expert, the first `cap` of each expert kept
(`cap = int(capacity_factor * k * T / E) + 1`), the kept tokens placed
in an [E * cap, d] buffer, the expert FFN over it, and each token's
kept outputs summed back weighted by its routing weights -- over all
tokens at once ("global"), or within fixed token groups ("grouped",
`dispatch_groups`).  Every scatter here has unique destinations (a
dropped assignment writes to a spare row that is cut off), and the
combine sums a token's k outputs in a fixed order, so the forward and
its backward are deterministic on the card: no float atomics add two
values into one place.  `moe_shard_map` (the explicitly collective
dispatch over a mesh) is training's multi-rank half (ROADMAP A12): under
a `mesh_scope` the "shard_map" dispatch of float weights raises; with no
mesh it runs the global dispatch, as the reference's does outside a mesh
context."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dctx
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.quant.qtensor import QTensor, qmatmul


def _in_dtypes(c: float) -> dict:
    """c rounded to each floating dtype, as a Python float (exact in it)."""
    return {dt: torch.tensor(c, dtype=torch.float64).to(dt).item()
            for dt in (torch.float32, torch.bfloat16, torch.float16)}


# computed once here: a traced step (core.optimize) must not make tensors
_SQRT_2_OVER_PI = _in_dtypes(math.sqrt(2.0 / math.pi))
_GELU_CUBIC = _in_dtypes(0.044715)


def gelu(x):
    """jax.nn.gelu's default, the tanh form (torch's default is the erf
    form): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))), the
    constants rounded to x's dtype as jax rounds them (sqrt(2/pi) cast to
    it, 0.044715 weakly typed), x^3 as x * x * x."""
    inner = _SQRT_2_OVER_PI[x.dtype] * (x + _GELU_CUBIC[x.dtype]
                                        * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp(p, x, cfg: ModelConfig):
    """SwiGLU: qmatmul(silu(x wg) * (x wi), wo); GELU (whisper):
    qmatmul(gelu(x wi + bi), wo) + bo, the biases in cfg.dtype."""
    if cfg.activation == "swiglu":
        return qmatmul(F.silu(qmatmul(x, p["wg"])) * qmatmul(x, p["wi"]),
                       p["wo"])
    if cfg.activation != "gelu":
        raise ValueError(f"unknown activation {cfg.activation!r} "
                         "(swiglu | gelu)")
    return qmatmul(gelu(qmatmul(x, p["wi"]) + p["bi"]), p["wo"]) + p["bo"]


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def init_moe(normal, cfg: ModelConfig, lead: tuple):
    """The reference's init_moe for a stack of MoE layers of leading shape
    `lead` ((L,) layers, or a hybrid's (U, n_moe)), drawn by
    `normal(shape, scale, dtype)` (float32 draws, cast to dtype): the
    router [*lead, d, E] float32 (`dense_init`, 1/sqrt(d)); wi and wg
    [*lead, E, d, d_ff_expert] at 1/sqrt(d), wo [*lead, E, d_ff_expert,
    d] at 1/sqrt(d_ff_expert), in cfg.dtype."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    dt = getattr(torch, cfg.dtype)
    lead = tuple(lead)
    return {
        "router": normal(lead + (d, e), 1.0 / math.sqrt(d), torch.float32),
        "wi": normal(lead + (e, d, f), 1.0 / math.sqrt(d), dt),
        "wg": normal(lead + (e, d, f), 1.0 / math.sqrt(d), dt),
        "wo": normal(lead + (e, f, d), 1.0 / math.sqrt(f), dt),
    }


def _emm(xe, w):
    """Expert-batched matmul ([E,C,*] x [E,*,*]), QTensor-aware: one
    GEMM launch for all experts, or a plain einsum of a float weight."""
    if isinstance(w, QTensor):
        return qmatmul(xe, w)
    return torch.einsum("ecd,edf->ecf", xe, w)


def _dispatch_combine(xt, top_e, top_p, p, cfg: ModelConfig, cap: int):
    """Sort-based capacity dispatch within each of G token groups.

    xt: [G, T, d]; top_e / top_p: [G, T, k] (a token's k experts are
    distinct).  Returns [G, T, d] in xt's dtype.

    Per group, as the reference's: the T*k assignments sorted by expert
    (stable: a token's earlier assignment first among equals), each
    one's rank within its expert (its index minus its expert's first,
    by `searchsorted`), kept when rank < cap; a kept assignment's token
    goes to row expert * cap + rank of the [E * cap, d] buffer, the
    expert FFN runs over the buffer's [E, cap, d] view, and each kept
    row's output, times its routing weight, returns to its token.

    Deterministic forms of the reference's scatter-adds: the buffer is
    a scatter with unique destinations (a dropped assignment goes to
    the spare row E * cap, cut off after), the outputs are gathered
    from the buffer with a zero spare row, and a token's k outputs are
    summed in the order the reference's scatter-add meets them (its
    experts ascending), one add at a time in xt's dtype."""
    m: MoEConfig = cfg.moe
    g, t, d = xt.shape
    e, k = m.n_experts, m.top_k
    n = t * k
    dev = xt.device
    flat_e = top_e.reshape(g, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)       # [G, T*k]
    se = flat_e.gather(1, order)
    sp = top_p.reshape(g, n).gather(1, order)
    grp_start = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(g, e).contiguous())
    slot = torch.arange(n, device=dev) - grp_start.gather(1, se)
    keep = slot < cap
    dest = torch.where(keep, se * cap + slot, e * cap)       # spare: E*cap
    rows = lambda i: i[..., None].expand(g, n, d)            # noqa: E731
    # each token's row k times (an expand: its gradient is a sum over
    # the k copies, with no atomics), then in sorted order
    src = xt[:, :, None].expand(g, t, k, d).reshape(g, n, d) \
        .gather(1, rows(order)) * keep[..., None].to(xt.dtype)
    buf = torch.zeros((g, e * cap + 1, d), dtype=xt.dtype, device=dev)
    buf = buf.scatter(1, rows(dest), src)
    # the expert FFN over every group's [cap, d] rows of each expert
    ein = buf[:, :e * cap].reshape(g, e, cap, d).transpose(0, 1) \
        .reshape(e, g * cap, d)
    h = F.silu(_emm(ein, p["wg"])) * _emm(ein, p["wi"])
    eout = _emm(h, p["wo"]).reshape(e, g, cap, d).transpose(0, 1) \
        .reshape(g, e * cap, d)
    eout = F.pad(eout, (0, 0, 0, 1))                         # the spare row
    contrib = eout.gather(1, rows(dest)) \
        * (sp * keep).to(xt.dtype)[..., None]                # sorted order
    # back to (token, j) order, then a token's k by ascending expert
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=dev).expand(g, n).contiguous())
    per_tok = contrib.gather(1, rows(inv)).reshape(g, t, k, d)
    by_expert = top_e.argsort(dim=-1)[..., None].expand(g, t, k, d)
    per_tok = per_tok.gather(2, by_expert)
    y = torch.zeros((g, t, d), dtype=xt.dtype, device=dev)
    for j in range(k):
        y = y + per_tok[:, :, j]
    return y


def _route(xt, p, m: MoEConfig, want_aux: bool, ordered: bool):
    """Router: float32 logits, softmax, top-k renormalized, and the
    Switch-style aux loss E * sum(mean prob x top-1 share) (None unless
    want_aux).  ordered: ties among the top-k taken lower expert first,
    as `lax.top_k` takes them (a stable descending sort; `torch.topk`
    does not document its tie order)."""
    logits = xt.to(torch.float32) @ p["router"]              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    if ordered:
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[:, :m.top_k], top_e[:, :m.top_k]
    else:
        top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    aux = None
    if want_aux:
        me = probs.mean(dim=0)
        ce = torch.zeros_like(probs).scatter_(1, top_e[:, :1], 1.0).mean(
            dim=0)
        aux = m.n_experts * (me * ce).sum()
    return top_p, top_e, aux


def moe_shard_map(p, x, cfg: ModelConfig, mesh, dp_axes, model_axis):
    """The explicitly collective MoE dispatch over a mesh (the
    reference's shard_map: experts block-assigned to model shards, a
    sum over the model axis to combine): not ported."""
    raise NotImplementedError(
        f"moe_shard_map over mesh {dict(mesh.shape)}: the sharded MoE "
        f"dispatch is training's multi-rank half (ROADMAP A12)")


def moe(p, x, cfg: ModelConfig, per_token: bool = False, *,
        want_aux: bool = True):
    """x: [B, S, d] -> ([B, S, d], aux_loss scalar float32).

    per_token=True (serving: prefill / decode) is the reference's path:
    router logits in float32, softmax, top-k renormalized, the gate a
    scatter of the top-k weights, all experts on all tokens, and the
    gate-weighted combine.  per_token=False (training) is the capacity
    dispatch (`_dispatch_combine`) over all B*S tokens, or with
    dispatch "grouped" over `dispatch_groups` groups of consecutive
    tokens when they divide B*S, each group with its own capacity.
    aux is the Switch-style load-balancing loss, E * sum(mean prob x
    top-1 share); want_aux=False skips it and returns None (serving
    drops it, as XLA drops the reference's unused aux)."""
    m: MoEConfig = cfg.moe
    if not per_token and m.dispatch == "shard_map" \
            and not isinstance(p["wi"], QTensor) and dctx.current():
        moe_shard_map(p, x, cfg, *dctx.current())
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    if not per_token:
        top_p, top_e, aux = _route(xt, p, m, want_aux, ordered=True)
        k, e = m.top_k, m.n_experts
        groups = m.dispatch_groups
        if m.dispatch == "grouped" and t >= groups > 1 and t % groups == 0:
            # GShard-style: capacity bookkeeping within each token group
            tg = t // groups
            cap = int(m.capacity_factor * k * tg / e) + 1
            yt = _dispatch_combine(xt.reshape(groups, tg, d),
                                   top_e.reshape(groups, tg, k),
                                   top_p.reshape(groups, tg, k), p, cfg, cap)
        else:
            cap = int(m.capacity_factor * k * t / e) + 1
            yt = _dispatch_combine(xt[None], top_e[None], top_p[None], p,
                                   cfg, cap)
        return yt.reshape(b, s, d), aux

    e = m.n_experts
    top_p, top_e, aux = _route(xt, p, m, want_aux, ordered=False)
    # gate[t, e] = routing weight iff e is one of t's top-k (distinct)
    gate = torch.zeros((t, e), dtype=xt.dtype, device=xt.device).scatter(
        1, top_e, top_p.to(xt.dtype))
    xe = xt.unsqueeze(0).expand(e, t, d)
    h = F.silu(_emm(xe, p["wg"])) * _emm(xe, p["wi"])
    eout = _emm(h, p["wo"])                                  # [E, T, d]
    yt = torch.einsum("etd,te->td", eout, gate)
    return yt.reshape(b, s, d), aux
