#!/usr/bin/env python3
"""Which reductions on the serving path change their order with the batch.

    python3 scripts/batch_invariance.py            # on the card
    python3 scripts/batch_invariance.py --device cpu

The serve engine promises that a request's tokens do not depend on its
batch mates: row 0 computed alone (the static path's B=1) must equal row
0 computed in a batch of 2, 4, 8 or 16 (the engine's batch buckets), a
prefill row must not depend on how many rows and padded positions share
its call, and a decode step over the engine's cache-length bucket t_b
must equal one over the static path's cache_len (the positions past the
row's own masked).  Printed as one JSON line, each a count of output
elements that differ (0 is invariant):

* `batch`: PyTorch's own forms at smollm-135m's and mamba2-2.7b's widths
  (`torch.mean`, `torch.cumsum`, the SSD einsums: the ones that are
  not invariant on the card show here), and the port's forms at every
  width of every architecture the engine serves (`common.rms_norm` over
  d_model and an SSM's d_inner, `common.row_sum` over the SSD decode
  contraction's [H, P, N], `common.row_cumsum` over the vocabulary);
* `prefill`: RMSNorm of a row's first L positions alone against the
  same positions in a bucketed batch of 8;
* `attention`: `attention._attend` per architecture's head layout: a
  decode step over cache_len alone against t_b in a batch, a 1500-key
  cache against 2048, and a prefill of L positions alone against the
  prompt bucket in a batch of 8;
* `models`: a prefill and 7 decode steps of one architecture per
  registered family at full width and a few layers, row 0 alone against
  row 0 in a batch of 8 at the engine's bucketed shapes.

`gate(dev)` returns the result and the cases that are not invariant
among the port's forms; chip_smoke.py phase 13 fails on any.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, common, lm, slot_state  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

BATCHES = (2, 4, 8, 16)
# one architecture per registered family for the model cases, with the
# layers it keeps (a hybrid keeps one scan unit: every layer kind)
MODEL_ARCHS = {"dense": ("smollm-135m", 4, "w8a8"),
               "vlm": ("qwen2-vl-72b", 1, "w4a8"),
               "moe": ("granite-moe-1b-a400m", 2, "w8a8"),
               "ssm": ("mamba2-2.7b", 2, "w4a8"),
               "hybrid": ("jamba-v0.1-52b", 8, "w4a8")}


def _diff(a, b) -> int:
    return int((a != b).sum().item())


def served_configs() -> dict:
    """{arch: full-width config} of every architecture whose family the
    engine serves (`slot_state.families()`)."""
    fams = slot_state.families()
    return {a: c for a in configs.ARCHS
            if (c := configs.get_config(a)).family in fams}


def _port_cases(dev) -> dict:
    """The port's batch-sensitive reductions at every served width:
    {name: (fn, per-row shapes)}."""
    cases = {}
    for arch, cfg in served_configs().items():
        widths = {cfg.d_model}
        if cfg.ssm is not None:
            s, d_inner, n_heads, _ = ssm.dims(cfg)
            widths.add(d_inner)
            cases[f"row_sum [H, P, N] = [{n_heads}, {s.headdim}, "
                  f"{s.d_state}] (SSD decode)"] = (
                lambda c, h: common.row_sum(c[:, :, None, :] * h),
                [(n_heads, s.d_state), (n_heads, s.headdim, s.d_state)])
        for d in widths:
            w = torch.ones(d, device=dev)
            cases[f"rms_norm decode [B, 1, {d}]"] = (
                lambda x, w=w: common.rms_norm(x.bfloat16(), w), [(1, d)])
            cases[f"rms_norm prefill [B, 48, {d}]"] = (
                lambda x, w=w: common.rms_norm(x.bfloat16(), w), [(48, d)])
        cases[f"row_cumsum over V = {cfg.vocab}"] = (
            lambda x: common.row_cumsum(torch.softmax(x, -1)),
            [(cfg.vocab,)])
    return cases


def _torch_cases(dev) -> dict:
    """PyTorch's own forms, for comparison."""
    H, P, N, Q, V = 80, 64, 128, 256, 49152        # mamba2, smollm vocab
    return {
        "torch.mean of squares [B, 576]":
            (lambda x: x.square().mean(-1), [(576,)]),
        "torch.cumsum over V": (lambda x: torch.cumsum(
            torch.softmax(x, -1), -1), [(V,)]),
        "softmax over V": (lambda x: torch.softmax(x, -1), [(V,)]),
        "ssd decode einsum bhn,bhpn->bhp":
            (lambda c, s: torch.einsum("bhn,bhpn->bhp", c, s),
             [(H, N), (H, P, N)]),
        "ssd conv bwc,wc->bc": (lambda b: torch.einsum(
            "bwc,wc->bc", b, torch.ones(4, 5376, device=dev)), [(4, 5376)]),
        "ssd prefill cumsum over Q": (lambda x: torch.cumsum(x, 1),
                                      [(Q, H)]),
        "ssd prefill bihn,bjhn->bhij": (lambda c, b: torch.einsum(
            "bihn,bjhn->bhij", c, b), [(Q, H, N)] * 2),
        "ssd prefill bhij,bjhp->bihp": (lambda a, x: torch.einsum(
            "bhij,bjhp->bihp", a, x), [(H, Q, Q), (Q, H, P)]),
    }


def batch_cases(dev, draws: int, cases: dict) -> dict:
    """{case: {B: differing elements, summed over the batch's rows,
    between each row computed alone and in the batch of B}}."""
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (fn, shapes) in cases.items():
        out[name] = {}
        for b in BATCHES:
            n = 0
            for _ in range(draws):
                args = [torch.randn((b, *s), generator=g, device=dev)
                        for s in shapes]
                many = fn(*args)
                for j in range(b):
                    n += _diff(fn(*[a[j:j + 1] for a in args]),
                               many[j:j + 1])
            out[name][b] = n
    return out


def prefill_cases(dev) -> dict:
    """RMSNorm over a row's first L positions alone ([1, L, d], the
    static path's prefill of that prompt) against the same positions in
    a batch of 8 prompt-bucket rows ([8, 16, d], the engine's):
    {f"{d}/L": differing elements}."""
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for d in sorted({w for cfg in served_configs().values()
                     for w in ({cfg.d_model} | ({ssm.dims(cfg)[1]}
                                                if cfg.ssm else set()))}):
        w = torch.ones(d, device=dev)
        x = torch.randn((8, 16, d), generator=g, device=dev).bfloat16()
        many = common.rms_norm(x, w)
        for length in (1, 5, 16):
            out[f"{d}/{length}"] = sum(
                _diff(common.rms_norm(x[j:j + 1, :length], w),
                      many[j:j + 1, :length]) for j in range(8))
    return out


def attention_cases(dev, draws: int) -> dict:
    """Decode attention of each row alone over the static path's
    cache_len against the same row in a batch of B over the engine's t_b,
    garbage past cache_len (masked), per head layout of the served
    architectures: {f"{arch} {cache_len}/{B}x{t_b}": differing
    elements}."""
    g = torch.Generator(device=dev).manual_seed(1)
    out, seen = {}, set()
    for arch, cfg in served_configs().items():
        layout = (cfg.n_heads, cfg.n_kv, cfg.head_dim)
        if cfg.family == "ssm" or layout in seen:
            continue
        seen.add(layout)
        h, kv, d = layout
        for cl in (24, 100, 192):
            for b in (1, 2, 8):
                for t in (32, 128, 256):
                    if t < cl:
                        continue
                    n = 0
                    for _ in range(draws):
                        q, k, v = (torch.randn(s, generator=g, device=dev)
                                   .bfloat16() for s in
                                   ((b, 1, h, d), (b, t, kv, d),
                                    (b, t, kv, d)))
                        qp = torch.full((b, 1), cl - 1, device=dev)
                        many = attention._attend(
                            q, k, v, cfg, torch.bfloat16, qp,
                            torch.arange(t, device=dev).expand(b, -1))
                        for j in range(b):
                            one = attention._attend(
                                q[j:j + 1], k[j:j + 1, :cl],
                                v[j:j + 1, :cl], cfg, torch.bfloat16,
                                qp[:1], torch.arange(cl, device=dev)[None])
                            n += _diff(one, many[j:j + 1])
                    out[f"{arch} {cl}/{b}x{t}"] = n
        # a long cache: the softmax over T past 1024 keys
        cl, t, b = 1500, 2048, 2
        q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16() for s
                   in ((b, 1, h, d), (b, t, kv, d), (b, t, kv, d)))
        qp = torch.full((b, 1), cl - 1, device=dev)
        many = attention._attend(q, k, v, cfg, torch.bfloat16, qp,
                                 torch.arange(t, device=dev).expand(b, -1))
        one = attention._attend(q[:1], k[:1, :cl], v[:1, :cl], cfg,
                                torch.bfloat16, qp[:1],
                                torch.arange(cl, device=dev)[None])
        out[f"{arch} {cl}/{b}x{t}"] = _diff(one, many[:1])
        # prefill: a prompt of L alone against the same prompt padded to
        # the bucket S_b in a batch of 8 (causal; the first L positions)
        for length, sb in ((5, 8), (48, 64), (100, 128)):
            q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16()
                       for s in ((8, sb, h, d), (8, sb, kv, d),
                                 (8, sb, kv, d)))
            pos = torch.arange(sb, device=dev).expand(8, -1)
            many = attention._attend(q, k, v, cfg, torch.bfloat16, pos, pos)
            n = 0
            for j in range(8):
                one = attention._attend(
                    q[j:j + 1, :length], k[j:j + 1, :length],
                    v[j:j + 1, :length], cfg, torch.bfloat16,
                    pos[:1, :length], pos[:1, :length])
                n += _diff(one, many[j:j + 1, :length])
            out[f"{arch} prefill {length}/8x{sb}"] = n
    return out


def model_cases(dev) -> dict:
    """Row 0 of a prefill and 7 decode steps, alone (its exact prompt,
    cache_len prompt + 16) against a batch of 8 (the prompt bucket, the
    cache bucket 128, a mixed active mask): differing logits, for one
    architecture per registered family (MODEL_ARCHS; full width and a
    few layers on the card, the reduced config on the CPU)."""
    out = {}
    for fam in sorted({c.family for c in served_configs().values()}):
        arch, layers, fmt = MODEL_ARCHS[fam]
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers) \
            if dev.type == "cuda" else configs.get_reduced_config(arch)
        params = serve.build_params(cfg, fmt, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (8, 64), generator=g,
                                device=dev)
        lens = torch.tensor([48, 64, 3, 5, 63, 7, 9, 11], device=dev)
        l1, c1 = lm.prefill(params, prompts[:1, :48], cfg, cache_len=64)
        l8, c8 = lm.prefill(params, prompts, cfg, cache_len=128,
                            last_positions=lens - 1)
        n_pre, n_dec = _diff(l1[0], l8[0]), 0        # [1, V] each
        t1 = l1[:, -1].argmax(-1)[:, None]
        t8 = l8[:, -1].argmax(-1)[:, None]
        act = torch.tensor([1, 1, 0, 1, 0, 1, 1, 1], device=dev).bool()
        for i in range(7):
            d1, _ = lm.decode_step(params, t1, c1, lens[:1] + i, cfg)
            d8, _ = lm.decode_step(params, t8, c8, lens + i, cfg, active=act)
            n_dec += _diff(d1[0], d8[0])
            t1 = d1[:, -1].argmax(-1)[:, None]
            t8 = d8[:, -1].argmax(-1)[:, None]
            t8[0] = t1[0]
        out[f"{arch} {layers}L {fmt}"] = {"prefill_logits": n_pre,
                                          "decode_logits": n_dec}
        del params, c1, c8
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def gate(dev, draws: int = 2) -> tuple:
    """(result, the port's cases that differ): every count of the port's
    forms, the prefill rows, the attention and the models must be 0."""
    res = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu", "torch": torch.__version__,
           "port": batch_cases(dev, draws, _port_cases(dev)),
           "torch_forms": batch_cases(dev, draws, _torch_cases(dev)),
           "prefill": prefill_cases(dev)}
    att = attention_cases(dev, draws)
    res["attention"] = {"cases": len(att),
                        "differing": {k: n for k, n in att.items() if n}}
    res["models"] = model_cases(dev)
    bad = [k for k, v in res["port"].items() if any(v.values())]
    bad += [f"prefill {k}" for k, n in res["prefill"].items() if n]
    bad += [f"attention {k}" for k in res["attention"]["differing"]]
    bad += [f"model {k}" for k, v in res["models"].items()
            if any(v.values())]
    return res, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=4)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("batch_invariance: no CUDA device", file=sys.stderr)
        return 2
    res, bad = gate(dev, args.draws)
    res["not_invariant"] = bad
    print(json.dumps(res))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
