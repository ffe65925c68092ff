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
* `attention_s`: the attention of the engine's admission paths, whose
  queries are many (S > 1), per head layout: chunked prefill's C = 16
  queries over the prefill state's t_pre keys (t_pre 32-4096; up to 256
  on the CPU) in a batch of 8 against
  the same positions of a full prefill of the row alone (the chunkable
  families' layouts); whisper's encoder over a ragged
  row's L frames padded to its bucket eb in a batch, against the L
  frames alone; and the decoder prefill's cross-attention over the
  slot's enc_len = 1500 frames, masked to L, against L frames alone;
* `models`: a prefill and 7 decode steps of one architecture per
  registered family at full width and a few layers, row 0 alone against
  row 0 in a batch of 8 at the engine's bucketed shapes (whisper: its
  features padded to the encoder bucket and the cross K/V to enc_len),
  and the embed method's pooled vector (`lm.embed_pool`) of row 0 alone
  at its own length against row 0 in the padded batch.

`softmax_pad` (not gated) counts what `torch.softmax` alone gives a row
of L scores against the same row with masked scores appended, and
`key_blocked_s` (not gated) what the key-blocked form of the chunk step
and the encoder would give whisper's decoder in the `attention_s` cases
(ROADMAP C12).

`gate(dev)` returns the result and the cases that are not invariant
among the port's forms; chip_smoke.py phase 13 fails on any, and phase
14 on any of `attention_s`.
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
               "encdec": ("whisper-small", 2, "w4a8"),
               "vlm": ("qwen2-vl-72b", 1, "w4a8"),
               "moe": ("granite-moe-1b-a400m", 2, "w8a8"),
               "ssm": ("mamba2-2.7b", 2, "w4a8"),
               "hybrid": ("jamba-v0.1-52b", 8, "w4a8")}


# the engine's S > 1 cases: the prefill chunk, (prompt length, prefill
# state length t_pre) pairs -- t_pre is a power-of-two bucket up to the
# engine's max_cache_len, the last chunk partial -- whisper's frames and
# the slot's cross K/V width (chip_smoke.py phase 14's whisper engine).
# The CPU takes the pairs up to t_pre 256.
CHUNK = 16
CHUNK_CASES = ((20, 32), (64, 64), (100, 128), (100, 256), (500, 512),
               (1000, 1024), (2000, 2048), (4000, 4096))
CPU_T_PRE = 256
ENC_FRAMES = (200, 500, 1000, 1500)
ENC_LEN = 1500


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
            if cfg.norm == "layernorm":
                b0 = torch.zeros(d, device=dev)
                for s in (1, 5):
                    cases[f"layer_norm [B, {s}, {d}]"] = (
                        lambda x, w=w, b0=b0: common.layer_norm(
                            x.bfloat16(), w, b0), [(s, d)])
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
            fixed = cfg.family == "encdec"      # the decoder's form
            many = attention._attend(q, k, v, cfg, torch.bfloat16, pos, pos,
                                     fixed=fixed)
            n = 0
            for j in range(8):
                one = attention._attend(
                    q[j:j + 1, :length], k[j:j + 1, :length],
                    v[j:j + 1, :length], cfg, torch.bfloat16,
                    pos[:1, :length], pos[:1, :length], fixed=fixed)
                n += _diff(one, many[j:j + 1, :length])
            out[f"{arch} prefill {length}/8x{sb}"] = n
    return out


def _layouts(families=None) -> dict:
    """{(H, KV, D): (arch, cfg)}: one served architecture per attention
    head layout (of the given families)."""
    out = {}
    for arch, cfg in served_configs().items():
        if cfg.family != "ssm" and (families is None
                                    or cfg.family in families):
            out.setdefault((cfg.n_heads, cfg.n_kv, cfg.head_dim),
                           (arch, cfg))
    return out


def s_attention_cases(dev, draws: int, fixed: bool = True,
                      chunkable=("dense", "vlm", "moe")) -> dict:
    """The S > 1 attention of the engine's admission paths, each row's
    output against the row alone: {case: differing elements}.

    * `chunk`: queries [kC, (k+1)C) of a prompt of L tokens over the
      prefill state's t_pre keys (garbage past the row's own positions,
      masked causally) in a batch of 8, every chunk k, against positions
      [0, L) of a causal prefill of the L tokens alone, per layout of
      the `chunkable` families, for each (L, t_pre) of CHUNK_CASES (t_pre
      32-4096; up to CPU_T_PRE on the CPU) (the key-blocked form:
      the port's);
    * `encoder`: whisper's bidirectional encoder attention over a row's L
      frames padded to its bucket eb (`kv_lengths`) in a batch, against
      the L frames alone;
    * `cross`: the decoder prefill's 8 queries over the slot's 1500-frame
      cross K/V masked to L frames, in a batch, against 5 queries over
      the L frames alone, in the fixed-order form (`attention._attend(
      fixed=True)`, the port's) or, with fixed=False, the key-blocked
      form (`attention._key_blocked_out`).

    The chunk step and the encoder take the key-blocked form, which
    these cases hold invariant on the card and on the CPU (ROADMAP
    C12)."""
    from repro_torch.launch import scheduler
    g = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    for (h, kv, d), (arch, cfg) in _layouts(chunkable).items():
        for length, t in CHUNK_CASES:
            if dev.type != "cuda" and t > CPU_T_PRE:
                continue
            n = 0
            for _ in range(draws):
                q, k, v = randn(8, t, h, d), randn(8, t, kv, d), \
                    randn(8, t, kv, d)
                pos = torch.arange(t, device=dev)
                one = attention._attend(
                    q[:1, :length], k[:1, :length], v[:1, :length], cfg,
                    bf, pos[None, :length], pos[None, :length])
                for c0 in range(0, length, CHUNK):
                    qp = (c0 + torch.arange(CHUNK, device=dev)).expand(8, -1)
                    many = attention._attend(q[:, c0:c0 + CHUNK], k, v, cfg,
                                             bf, qp, pos.expand(8, -1))
                    m = min(CHUNK, length - c0)
                    n += _diff(one[:, c0:c0 + m], many[:1, :m])
            out[f"{arch} chunk {length}/8x{t}"] = n
    enc = _layouts(("encdec",))
    b = 8 if dev.type == "cuda" else 2
    for (h, kv, d), (arch, cfg) in enc.items():
        for length in ENC_FRAMES:
            eb = scheduler.bucket_pow2(length, minimum=8, maximum=ENC_LEN)
            lens = torch.randint(eb // 2 + 1, eb + 1, (b,), generator=g,
                                 device=dev)
            lens[0] = length
            q, k, v = randn(b, eb, h, d), randn(b, eb, kv, d), \
                randn(b, eb, kv, d)
            many = attention._attend(q, k, v, cfg, bf,
                                     valid=attention._valid(lens, eb, dev))
            one = attention._attend(q[:1, :length], k[:1, :length],
                                    v[:1, :length], cfg, bf)
            out[f"{arch} encoder {length}/{b}x{eb}"] = _diff(
                one, many[:1, :length])
            q, k, v = randn(b, 8, h, d), randn(b, ENC_LEN, kv, d), \
                randn(b, ENC_LEN, kv, d)
            many = attention._attend(q, k, v, cfg, bf,
                                     valid=attention._valid(lens, ENC_LEN,
                                                            dev),
                                     fixed=fixed)
            one = attention._attend(q[:1, :5], k[:1, :length],
                                    v[:1, :length], cfg, bf, fixed=fixed)
            out[f"{arch} cross {length}/{b}x{ENC_LEN}"] = _diff(
                one, many[:1, :5])
    return out


def softmax_pad_cases(dev) -> dict:
    """torch.softmax of a row of L scores against the same row with
    -1e30 scores appended up to T: {f"{L}/{T}": differing elements}
    (PyTorch's own form, for comparison)."""
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for length in (24, 200, 500, 1000, 1500):
        for t in (256, 1024, 1500, 2048):
            if t < length:
                continue
            x = torch.randn((64, t), generator=g, device=dev)
            x[:, length:] = -1e30
            out[f"{length}/{t}"] = _diff(torch.softmax(x[:, :length], -1),
                                         torch.softmax(x, -1)[:, :length])
    return out


def _encdec_model_case(params, cfg, dev) -> dict:
    """Whisper through the engine's shapes: row 0's features (L frames)
    padded to the encoder bucket in a batch of 8 with `enc_lengths`, its
    cross K/V padded to enc_len, its decoder prompt to the prompt bucket,
    against its features and prompt alone."""
    cuda = dev.type == "cuda"
    length, eb, pad, cache = (300, 512, ENC_LEN, 128) if cuda else \
        (9, 16, 24, 64)
    g = torch.Generator(device=dev).manual_seed(6)
    feats = torch.randn((8, eb, cfg.d_model), generator=g, device=dev)
    enc = torch.randint(eb // 2 + 1, eb + 1, (8,), generator=g, device=dev)
    enc[0] = length
    dec = torch.randint(0, cfg.vocab, (8, 8), generator=g, device=dev)
    lens = torch.tensor([5, 8, 3, 6, 7, 8, 4, 2], device=dev)
    l1, c1 = lm.prefill(params, (feats[:1, :length], dec[:1, :5]), cfg,
                        cache_len=5 + 16)
    l8, c8 = lm.prefill(params, (feats, dec), cfg, cache_len=cache,
                        last_positions=lens - 1, enc_lengths=enc,
                        enc_pad=pad)
    e1 = lm.embed_pool(params, (feats[:1, :length], dec[:1, :5]), cfg)
    e8 = lm.embed_pool(params, (feats, dec), cfg, last_positions=lens - 1,
                       enc_lengths=enc)
    return l1, c1, l8, c8, lens, _diff(e1[0], e8[0])


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
        if fam == "encdec" and dev.type == "cuda":
            cfg = dataclasses.replace(cfg, n_decoder_layers=layers)
        params = serve.build_params(cfg, fmt, seed=0, device=dev)
        if fam == "encdec":
            l1, c1, l8, c8, lens, n_emb = _encdec_model_case(params, cfg,
                                                             dev)
        else:
            g = torch.Generator(device=dev).manual_seed(2)
            prompts = torch.randint(0, cfg.vocab, (8, 64), generator=g,
                                    device=dev)
            lens = torch.tensor([48, 64, 3, 5, 63, 7, 9, 11], device=dev)
            l1, c1 = lm.prefill(params, prompts[:1, :48], cfg, cache_len=64)
            l8, c8 = lm.prefill(params, prompts, cfg, cache_len=128,
                                last_positions=lens - 1)
            n_emb = _diff(lm.embed_pool(params, prompts[:1, :48], cfg)[0],
                          lm.embed_pool(params, prompts, cfg,
                                        last_positions=lens - 1)[0])
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
                                          "decode_logits": n_dec,
                                          "embed": n_emb}
        del params, c1, c8
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def gate(dev, draws: int = 2, s_cases: bool = True) -> tuple:
    """(result, the port's cases that differ): every count of the port's
    forms, the prefill rows, the attention (the S > 1 cases unless
    `s_cases` is False) and the models must be 0."""
    res = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu", "torch": torch.__version__,
           "port": batch_cases(dev, draws, _port_cases(dev)),
           "torch_forms": batch_cases(dev, draws, _torch_cases(dev)),
           "prefill": prefill_cases(dev)}
    att = attention_cases(dev, draws)
    res["attention"] = {"cases": len(att),
                        "differing": {k: n for k, n in att.items() if n}}
    att_s = s_attention_cases(dev, draws) if s_cases else {}
    res["attention_s"] = {"cases": len(att_s),
                          "differing": {k: n for k, n in att_s.items()
                                        if n}}
    res["softmax_pad"] = softmax_pad_cases(dev)
    if s_cases:
        # what the key-blocked form would give the encdec decoder's S > 1
        # attention (ROADMAP C12; not gated: the port sums those in the
        # fixed order)
        ein = s_attention_cases(dev, 1, fixed=False, chunkable=("encdec",))
        res["key_blocked_s"] = {k: n for k, n in ein.items()
                                if "encoder" not in k}
    res["models"] = model_cases(dev)
    bad = [k for k, v in res["port"].items() if any(v.values())]
    bad += [f"prefill {k}" for k, n in res["prefill"].items() if n]
    bad += [f"attention {k}" for k in res["attention"]["differing"]]
    bad += [f"attention_s {k}" for k in res["attention_s"]["differing"]]
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
