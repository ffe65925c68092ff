"""Train / serve step construction for every architecture family (port of
`repro/training/step.py`).

`make_train_step(cfg, train_cfg)` returns a function
    step(params, opt_state, batch) -> (params, opt_state, metrics)
with optional microbatched gradient accumulation (float32 gradients
summed over `microbatches` splits of the batch and averaged, as the
reference's `lax.scan` does) and AdamW.  The gradients come from
autograd over `loss_fn`; params are plain tensors (no requires_grad),
new trees are returned.

`make_serve_fns(cfg)` returns (prefill_fn, decode_fn) for the serving
cells.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.optim.adamw import is_float


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # gradient accumulation factor
    z_loss: float = 1e-4           # logit normalizer regularization
    aux_loss_weight: float = 0.01  # MoE load balancing
    remat: bool = True
    schedule_total: int = 10000
    schedule_warmup: int = 200


def loss_fn(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """batch: {tokens: [B, S+1]} (decoder-only) or
    {audio: [B,Se,d], tokens: [B, Sd+1]} (encdec) or
    {embeds: [B,S,d], labels: [B,S]} (vlm stub).
    Returns (total loss, {loss: NLL, z_loss, aux_loss}), float32 scalars:
    the NLL over float32 logits by logsumexp, z_loss * mean(lse^2), and
    aux_loss_weight * the MoE aux in the total."""
    if cfg.family == "encdec":
        inputs = (batch["audio"], batch["tokens"][:, :-1])
        labels = batch["tokens"][:, 1:]
        logits, aux = lm.forward(params, inputs, cfg, remat=tcfg.remat)
    elif "embeds" in batch:
        logits, aux = lm.forward(params, batch["embeds"], cfg,
                                 remat=tcfg.remat)
        labels = batch["labels"]
    else:
        tokens = batch["tokens"]
        logits, aux = lm.forward(params, tokens[:, :-1], cfg,
                                 remat=tcfg.remat)
        labels = tokens[:, 1:]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - ll).mean()
    zl = tcfg.z_loss * lse.square().mean()
    total = nll + zl + tcfg.aux_loss_weight * aux
    return total, {"loss": nll, "z_loss": zl, "aux_loss": aux}


def _grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """(metrics, grads): the gradient of loss_fn's total at each float
    leaf of params (zeros where the loss does not reach it, as jax.grad
    gives), in the leaf's dtype; None at a non-float leaf."""
    flat, spec = pytree.tree_flatten(params)
    wrt = [p.detach().requires_grad_() if is_float(p) else p for p in flat]
    with torch.enable_grad():
        total, metrics = loss_fn(pytree.tree_unflatten(wrt, spec), batch,
                                 cfg, tcfg)
        floats = [p for p in wrt if is_float(p)]
        got = iter(torch.autograd.grad(total, floats, allow_unused=True,
                                       materialize_grads=True))
    grads = [next(got) if is_float(p) else None for p in wrt]
    return ({k: v.detach() for k, v in metrics.items()},
            pytree.tree_unflatten(grads, spec))


def _split_microbatches(batch, n: int) -> list:
    return [{k: t.reshape(n, t.shape[0] // n, *t.shape[1:])[i]
             for k, t in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    def step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            gsum = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            msum = None
            for mb in _split_microbatches(batch, tcfg.microbatches):
                metrics, grads = _grads(params, mb, cfg, tcfg)
                gsum = pytree.tree_map(
                    lambda a, g: a + g.to(torch.float32), gsum, grads)
                msum = metrics if msum is None else \
                    {k: msum[k] + v for k, v in metrics.items()}
            grads = pytree.tree_map(lambda g: g / tcfg.microbatches, gsum)
            metrics = {k: v / tcfg.microbatches for k, v in msum.items()}
        else:
            metrics, grads = _grads(params, batch, cfg, tcfg)
        lr_scale = warmup_cosine(opt_state["step"],
                                 warmup=tcfg.schedule_warmup,
                                 total=tcfg.schedule_total)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, tcfg.optimizer, lr_scale)
        metrics = dict(metrics, **opt_metrics, lr_scale=lr_scale)
        return params, opt_state, metrics

    return step


def make_serve_fns(cfg: ModelConfig):
    """(prefill_fn, decode_fn) with signatures matching the shape cells."""

    def prefill_fn(params, inputs, cache_len):
        return lm.prefill(params, inputs, cfg, cache_len=cache_len)

    def decode_fn(params, token_t, cache, pos):
        return lm.decode_step(params, token_t, cache, pos, cfg)

    return prefill_fn, decode_fn
