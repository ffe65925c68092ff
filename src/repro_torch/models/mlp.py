"""Feed-forward layers (port of `repro/models/mlp.py`): the dense SwiGLU
and GELU MLPs and the top-k mixture of experts' serving path.

MoE serving (`moe(per_token=True)`, the reference's prefill / decode
path) routes every token dropless through a dense one-hot combine: every
expert runs on every token and each token keeps its top-k, so a token's
output depends on that token alone.  The expert products are three
expert-stacked GEMMs ([E, K, N] weights), each ONE kernel launch for all
E experts (`qmatmul`); the x of wi / wg is one x broadcast to every
expert, passed with expert stride 0.  Every shape is static and nothing
reads a device value on the host (topk, scatter, no boolean indexing),
so the step can be captured in a CUDA graph.

The capacity dispatch of training (`per_token=False`: the reference's
`_dispatch_combine`, grouped dispatch and `moe_shard_map`) is not
ported: it comes with `lm.forward` and training (ROADMAP queue A items
4.6 and 8) and with distributed (item 7)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def moe(p, x, cfg: ModelConfig, per_token: bool = False, *,
        want_aux: bool = True):
    """x: [B, S, d] -> ([B, S, d], aux_loss scalar float32).

    per_token=True (serving: prefill / decode) is the reference's path:
    router logits in float32, softmax, top-k renormalized, the gate a
    scatter of the top-k weights, all experts on all tokens, and the
    gate-weighted combine.  aux is the Switch-style load-balancing loss,
    E * sum(mean prob x top-1 share); want_aux=False skips it and returns
    None (serving drops it, as XLA drops the reference's unused aux)."""
    m: MoEConfig = cfg.moe
    if not per_token:
        raise NotImplementedError(
            "moe(per_token=False): the capacity dispatch (_dispatch_combine, "
            "grouped dispatch, moe_shard_map) is not ported; it comes with "
            "lm.forward and training (ROADMAP queue A items 4.6 and 8) and "
            "distributed (item 7)")
    b, s, d = x.shape
    t, e = b * s, m.n_experts
    xt = x.reshape(t, d)
    logits = xt.to(torch.float32) @ p["router"]              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    aux = None
    if want_aux:
        me = probs.mean(dim=0)
        ce = torch.zeros_like(probs).scatter_(1, top_e[:, :1], 1.0).mean(
            dim=0)
        aux = e * (me * ce).sum()
    # gate[t, e] = routing weight iff e is one of t's top-k (distinct)
    gate = torch.zeros((t, e), dtype=xt.dtype, device=xt.device).scatter(
        1, top_e, top_p.to(xt.dtype))
    xe = xt.unsqueeze(0).expand(e, t, d)
    h = F.silu(_emm(xe, p["wg"])) * _emm(xe, p["wi"])
    eout = _emm(h, p["wo"])                                  # [E, T, d]
    yt = torch.einsum("etd,te->td", eout, gate)
    return yt.reshape(b, s, d), aux
