#!/usr/bin/env python3
"""Whether the mixers' float math gives a head the same bits on a tensor-
parallel shard as in the whole layout.

    python3 scripts/tp_invariance.py            # on the card
    python3 scripts/tp_invariance.py --device cpu

Mesh serving's tensor parallelism (launch/engine.py) computes a shard's
block of heads and all-gathers the outputs; its streams equal the
unsharded engine's only if every head's result does not depend on how
many heads share the call.  Printed as one JSON line of counts of
output elements that differ (0 is invariant):

* `attention`: `attention._attend` of a shard's heads, under its
  tensor-parallel scope, against the same heads of the whole layout, at
  every head layout and tensor-parallel
  size the engine can take (`slot_state.tp_plan`) of the attention
  families: a prefill of S = 16-128 causal positions (one batched
  product per score and output; `scores` counts the float32 scores
  alone) and a decode step over a cache of 32-256 positions, B = 1, 2,
  4 and 8;
* `attention_einsum` (not gated): the same prefill cases' score product
  as one einsum over the shard's KV heads alone (what the port computed
  before ROADMAP C16; it now takes the whole layout's KV heads,
  `attention._tp_whole_kv`);
* `ssd`: `ssm.ssd_forward` (a prompt of 2 chunks) and 4 `ssm.ssd_decode`
  steps of the SSD mixers' widths (mamba2-2.7b, jamba) at each viable
  size: every shard's run under a tensor-parallel scope whose gather is
  simulated in one process (each shard's run recorded, then replayed
  with the recorded blocks gathered), its output and state against the
  unsharded run, B = 1 and 8.

Exits 1 if a gated count is not 0.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import context as dctx  # noqa: E402
from repro_torch.models import attention, slot_state, ssm  # noqa: E402

ATTN_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "yi-6b", "command-r-35b",
              "qwen2-vl-72b", "granite-moe-1b-a400m", "jamba-v0.1-52b",
              "whisper-small")
SSD_ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b")


def _diff(a, b) -> int:
    return int((a != b).sum().item())


def _sizes(cfg, what: str) -> list:
    return [m for m in (2, 3, 4, 8)
            if getattr(slot_state.tp_plan(cfg, m), what)]


def _shard(size: int, j: int):
    """Shard j's attention tensor-parallel scope (no gather is reached:
    `_attend` computes the shard's heads)."""
    mesh = _SimMesh(size)
    mesh.j = j
    return dctx.tp_scope("model", size, attn=True, mesh=mesh)


def attention_cases(dev, gen) -> tuple:
    port, einsum = {}, {}
    for arch in ATTN_ARCHS:
        cfg = configs.get_config(arch)
        h, kv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
        dt = getattr(torch, cfg.dtype)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        for size in _sizes(cfg, "attn"):
            hl, kl = h // size, kv // size
            n = {"prefill": 0, "scores": 0, "decode": 0}
            n_e = 0
            for b in (1, 2, 4, 8):
                for s in (16, 48, 128):
                    q, k, v = rnd(b, s, h, d), rnd(b, s, kv, d), \
                        rnd(b, s, kv, d)
                    pos = torch.arange(s, device=dev).expand(b, s)
                    full = attention._attend(q, k, v, cfg, dt, pos, pos)
                    sc_port = attention._gqa_scores(q, k)
                    sc = torch.einsum(
                        "bskgd,btkd->bkgst",
                        q.reshape(b, s, kv, h // kv, d).float(), k.float())
                    for j in range(size):
                        qj = q[:, :, j * hl:(j + 1) * hl].contiguous()
                        kj = k[:, :, j * kl:(j + 1) * kl].contiguous()
                        vj = v[:, :, j * kl:(j + 1) * kl].contiguous()
                        with _shard(size, j):
                            loc = attention._attend(qj, kj, vj, cfg, dt,
                                                    pos, pos)
                            n["scores"] += _diff(
                                attention._gqa_scores(qj, kj),
                                sc_port[:, j * kl:(j + 1) * kl])
                        n["prefill"] += _diff(
                            loc, full[:, :, j * hl * d:(j + 1) * hl * d])
                        sj = torch.einsum(
                            "bskgd,btkd->bkgst",
                            qj.reshape(b, s, kl, h // kv, d).float(),
                            kj.float())
                        n_e += _diff(sj, sc[:, j * kl:(j + 1) * kl])
                for t in (32, 256):
                    q, k, v = rnd(b, 1, h, d), rnd(b, t, kv, d), \
                        rnd(b, t, kv, d)
                    qpos = torch.full((b, 1), t - 1, device=dev)
                    kpos = torch.arange(t, device=dev).expand(b, t)
                    full = attention._attend(q, k, v, cfg, dt, qpos, kpos)
                    for j in range(size):
                        with _shard(size, j):
                            loc = attention._attend(
                                q[:, :, j * hl:(j + 1) * hl].contiguous(),
                                k[:, :, j * kl:(j + 1) * kl].contiguous(),
                                v[:, :, j * kl:(j + 1) * kl].contiguous(),
                                cfg, dt, qpos, kpos)
                        n["decode"] += _diff(
                            loc, full[:, :, j * hl * d:(j + 1) * hl * d])
            port[f"{arch} tp{size}"] = n
            einsum[f"{arch} tp{size}"] = n_e
    return port, einsum


class _SimMesh:
    """A tensor-parallel group of `size` shards simulated in one process:
    shard j's run records each gathered block (`record`), then a second
    pass of every shard gathers the recorded blocks of all shards
    (`replay`), which is what the ranks' all-gathers return."""

    def __init__(self, size: int):
        self.size, self.j, self.calls, self.blocks = size, 0, 0, {}

    def axis_index(self, axis) -> int:
        return self.j

    def all_gather(self, t, axis, dim: int):
        i = self.calls
        self.calls += 1
        if self.mode == "record":
            self.blocks[(self.j, i)] = t.clone()
            return torch.cat([t] * self.size, dim=dim)
        return torch.cat([self.blocks[(jj, i)] for jj in range(self.size)],
                         dim=dim)


def _ssd_params(cfg, dev, gen):
    dt = getattr(torch, cfg.dtype)

    def normal(shape, scale, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)
    return ssm.init_ssm(normal, cfg, (), dev)


def _run_sharded(size, fn):
    """fn() under every shard of a simulated group; the outputs of the
    replay pass (every shard's gathered outputs are the same tensors)."""
    mesh = _SimMesh(size)
    outs = []
    for mode in ("record", "replay"):
        mesh.mode = mode
        for j in range(size):
            mesh.j, mesh.calls = j, 0
            with dctx.tp_scope("model", size, ssm=True, mesh=mesh):
                out = fn()
            if mode == "replay":
                outs.append(out)
    return outs


def ssd_cases(dev, gen) -> dict:
    out = {}
    for arch in SSD_ARCHS:
        cfg = configs.get_config(arch)
        if cfg.ssm is None:
            continue
        s, d_inner, n_heads, conv_ch = ssm.dims(cfg)
        p = _ssd_params(cfg, dev, gen)
        dt = getattr(torch, cfg.dtype)
        for size in _sizes(cfg, "ssm"):
            n = {"prefill": 0, "decode": 0}
            for b in (1, 8):
                x = torch.randn((b, 2 * s.chunk, cfg.d_model), generator=gen,
                                device=dev).to(dt)
                lens = torch.full((b,), 2 * s.chunk - 3, device=dev)
                y, st = ssm.ssd_forward(p, x, cfg, lens, return_state=True)
                hl = n_heads // size
                for j, (yj, sj) in enumerate(_run_sharded(
                        size, lambda: ssm.ssd_forward(p, x, cfg, lens,
                                                      return_state=True))):
                    n["prefill"] += _diff(yj, y) + _diff(
                        sj["ssm"], st["ssm"][:, j * hl:(j + 1) * hl]) + \
                        _diff(sj["conv"], st["conv"])
                states = [{k: v[:, j * hl:(j + 1) * hl].clone()
                           if k == "ssm" else v.clone()
                           for k, v in st.items()} for j in range(size)]
                for _ in range(4):
                    xt = torch.randn((b, 1, cfg.d_model), generator=gen,
                                     device=dev).to(dt)
                    yf, _ = ssm.ssd_decode(p, xt, st, cfg)

                    def step():
                        j = dctx.tp_current().index
                        return ssm.ssd_decode(p, xt, {
                            k: v.clone() for k, v in states[j].items()},
                            cfg)
                    res = _run_sharded(size, step)
                    for j, (yj, sj) in enumerate(res):
                        n["decode"] += _diff(yj, yf) + _diff(
                            sj["ssm"], st["ssm"][:, j * hl:(j + 1) * hl])
                        states[j] = sj
            out[f"{arch} tp{size}"] = n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    att, ein = attention_cases(dev, gen)
    res = {"attention": att, "attention_einsum": ein,
           "ssd": ssd_cases(dev, gen)}
    print(json.dumps(res))
    bad = [(k, c) for part in ("attention", "ssd")
           for c, n in res[part].items() for k, v in n.items() if v]
    if bad:
        print(f"not invariant: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
