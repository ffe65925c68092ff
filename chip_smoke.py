#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # from the repository root, one H100

Phases (any failure ends the run nonzero; nothing is caught and passed
over):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build both Hopper kernels from `src/repro_torch/kernels/csrc` into the
   git-ignored `build/` (one nvcc per source, started together), timed;
3. each kernel against its plain PyTorch version at every main-path
   (K, N) with decode M=8 and prefill M=1024, plus ragged shapes: the
   int32 accumulator and the f32 output must be bit-identical
   (`torch.equal`); then per-launch times of the kernel, the plain
   version and the library yardstick (`torch._int_mm`, after an unpack
   for w4a8) where the shape is legal for it;
4. greedy generation with full-width smollm-135m (30 layers, d_model 576,
   random weights from a seeded torch.Generator): B=8, prompt 128, 32 new
   tokens, under w4a8 and then w8a8.  The format's kernel must launch
   7 x 30 x 32 = 6720 times and the other kernel 0 times; a rerun with
   the plain versions forced must give identical tokens AND logits (the
   kernels are bit-exact); a reduced model must agree with its CPU run.

Then it prints the `kernels` JSON line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
repository beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense int8 tensor peak
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

MAIN_KN = [(576, 576), (576, 192), (576, 192), (576, 576),   # q k v o
           (576, 1536), (576, 1536), (1536, 576)]            # gate up down
DECODE_M, PREFILL_M = 8, 1024
RAGGED = [(3, 48, 16), (5, 48, 48), (17, 128, 128), (70, 100, 34),
          (1, 1536, 576), (129, 1000, 250)]
BATCH, PROMPT, GEN = 8, 128, 32
# the reduced model on the card against its own CPU run: bf16 roundings
# and float32 sums differ in order between the two devices, and an
# activation's int8 rounding may flip one step, which moves a logit of
# magnitude ~0.1 by ~1e-3
CPU_LOGIT_ATOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(m: int, k: int, n: int, w_bytes: int) -> tuple:
    """Least time for one GEMM call on this card: each input read once
    (x, weights, both scales), the f32 output written once, against
    2*M*K*N int8 operations at the tensor-core peak."""
    nbytes = m * k + w_bytes + 4 * m + 4 * n + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, n_iter: int) -> float:
    """Mean device time of fn(i) over n_iter calls, by CUDA events.  A
    sleep kernel queued first holds the stream while the host enqueues
    every call, so host overhead between launches is not timed."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(n_iter * 2e5))   # ~0.1 ms per call at ~2 GHz
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import common, packed_matmul, quant_matmul, ref

    gen = torch.Generator(device="cuda").manual_seed(1234)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 0.02 + 1e-3

    specs = [
        dict(name="quant_matmul", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul.py:30",
             acc=quant_matmul.quant_matmul_acc,
             out=quant_matmul.quant_matmul,
             acc_ref=ref.quant_matmul_acc_ref, out_ref=ref.quant_matmul_ref,
             wshape=lambda k, n: (k, n),
             lib=lambda x, w: torch._int_mm(x, w)),
        dict(name="packed_w4_matmul", route="cuda",
             source="src/repro_torch/kernels/csrc/packed_w4_matmul.cu",
             replaces="src/repro/kernels/packed_matmul.py:35",
             acc=packed_matmul.packed_w4_matmul_acc,
             out=packed_matmul.packed_w4_matmul,
             acc_ref=ref.packed_w4_matmul_acc_ref,
             out_ref=ref.packed_w4_matmul_ref,
             wshape=lambda k, n: (k, n // 2),
             lib=lambda x, w: torch._int_mm(x, common.unpack_w4_words(w))),
    ]
    main_shapes = [(m, k, n) for m in (DECODE_M, PREFILL_M)
                   for k, n in dict.fromkeys(MAIN_KN)]
    results = {}
    for sp in specs:
        worst = 0.0
        rows = []
        for m, k, n in main_shapes + RAGGED:
            x, w = i8(m, k), i8(*sp["wshape"](k, n))
            xs, ws = scales(m, 1), scales(1, n)
            acc_k, acc_p = sp["acc"](x, w), sp["acc_ref"](x, w)
            out_k = sp["out"](x, w, xs, ws)
            out_p = sp["out_ref"](x, w, xs, ws)
            torch.cuda.synchronize()
            if not torch.equal(acc_k, acc_p):
                bad = (acc_k != acc_p).sum().item()
                raise AssertionError(f"{sp['name']} {(m, k, n)}: int32 "
                                     f"accumulator differs in {bad} places")
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"{sp['name']} {(m, k, n)}: f32 output "
                                     "is not bit-identical to the plain "
                                     "version")
            err = (out_k - out_p).abs().max().item() if out_k.numel() else 0.
            worst = max(worst, err)
            if (m, k, n) not in main_shapes:
                continue
            # time over enough distinct weight copies to spill the 50 MB
            # L2, as the 30-layer decode loop does
            w_bytes = w.numel()
            copies = [w] + [i8(*w.shape) for _ in range(
                math.ceil(128e6 / w_bytes) - 1)]
            n_it = 200 if m == DECODE_M else 100
            t_k = device_ms(torch, lambda i: sp["out"](
                x, copies[i % len(copies)], xs, ws), n_it)
            t_p = device_ms(torch, lambda i: sp["out_ref"](
                x, copies[i % len(copies)], xs, ws), 20)
            try:
                t_l = device_ms(torch, lambda i: sp["lib"](
                    x, copies[i % len(copies)]), 50)
            except RuntimeError:   # shape not legal for torch._int_mm
                t_l = None
            b_ms, b_by = bound_ms(m, k, n, w_bytes)
            rows.append(dict(m=m, k=k, n=n, ms=t_k, plain_ms=t_p,
                             library_ms=t_l, bound_ms=b_ms, bound_by=b_by))
            del copies
            log(f"  {sp['name']:16s} M={m:5d} K={k:5d} N={n:5d}  kernel "
                f"{t_k * 1e3:9.2f} us  plain {t_p * 1e3:9.2f} us  library "
                + (f"{t_l * 1e3:9.2f} us" if t_l is not None else "  n/a")
                + f"  bound {b_ms * 1e3:7.3f} us ({b_by})")
        log(f"{sp['name']}: bit-identical to the plain version at "
            f"{len(main_shapes) + len(RAGGED)} shapes")
        results[sp["name"]] = dict(spec=sp, rows=rows, max_abs_err=worst)
    return results


def kernel_entry(name: str, res: dict, launches: int) -> dict:
    """One generate's worth of each kernel: per-launch numbers of every
    main-path shape, weighted by how often one generate launches it
    (per layer: one prefill launch at M=B*S, GEN-1 decode launches at
    M=B for each of the 7 projections)."""
    sp, rows = res["spec"], res["rows"]
    per_gen = {(r["m"], r["k"], r["n"]): 0 for r in rows}
    n_layers = 30
    for k, n in MAIN_KN:
        per_gen[(PREFILL_M, k, n)] += n_layers
        per_gen[(DECODE_M, k, n)] += n_layers * (GEN - 1)

    def total(key):
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(r[key] * per_gen[(r["m"], r["k"], r["n"])] for r in rows)

    by = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        by[r["bound_by"]] += r["bound_ms"] * per_gen[(r["m"], r["k"], r["n"])]
    return dict(
        name=name, route=sp["route"], source=sp["source"],
        replaces=sp["replaces"], launches=launches,
        max_abs_err=res["max_abs_err"], ms=total("ms"),
        plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by=max(by, key=by.get),
        library_ms=total("library_ms"),
        per=f"one generate: smollm-135m B={BATCH} prompt={PROMPT} "
            f"gen={GEN}; sums of per-launch times x launches per shape",
        shapes=rows)


def phase_generate(torch, kernel_results: dict) -> list:
    from repro_torch import configs
    from repro_torch.kernels import packed_matmul, quant_matmul, registry
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_config("smollm-135m")
    counters = {"w8a8": quant_matmul.LAUNCHES,
                "w4a8": packed_matmul.LAUNCHES}
    expect = 7 * cfg.n_layers * GEN
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    cache_len = PROMPT + GEN
    entries = []
    for fmt in ("w4a8", "w8a8"):
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        serve.generate(params, prompts[:, :8], cfg, gen=2, cache_len=16)
        torch.cuda.synchronize()

        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        toks, logits = serve.generate(params, prompts, cfg, gen=GEN,
                                      cache_len=cache_len,
                                      return_logits=True)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = {f: c.count for f, c in counters.items()}
        other = "w8a8" if fmt == "w4a8" else "w4a8"
        if counts[fmt] != expect or counts[other] != 0:
            raise AssertionError(f"{fmt}: kernel launches {counts}, expected "
                                 f"{fmt}={expect} and {other}=0")
        if tuple(toks.shape) != (BATCH, GEN) or \
                not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{fmt}: bad tokens {tuple(toks.shape)}")
        if tuple(logits.shape) != (BATCH, GEN, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{fmt}: logits not finite / misshapen")

        t0 = time.perf_counter()
        lm.prefill(params, prompts, cfg, cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        decode_ms = (total_s - prefill_s) / (GEN - 1) * 1e3
        log(f"{fmt}: generate {total_s * 1e3:.1f} ms, prefill "
            f"{prefill_s * 1e3:.1f} ms, decode {decode_ms:.2f} ms/step, "
            f"{BATCH * GEN / total_s:.1f} tok/s; kernel launches {counts}")

        before = {f: c.count for f, c in counters.items()}
        with registry.force("ref"):
            toks_p, logits_p = serve.generate(params, prompts, cfg, gen=GEN,
                                              cache_len=cache_len,
                                              return_logits=True)
        torch.cuda.synchronize()
        if {f: c.count for f, c in counters.items()} != before:
            raise AssertionError(f"{fmt}: forced plain run launched kernels")
        if not torch.equal(toks, toks_p) or not torch.equal(logits, logits_p):
            raise AssertionError(
                f"{fmt}: kernel path differs from the plain-forced path "
                f"(tokens equal: {torch.equal(toks, toks_p)}, max logit "
                f"diff {(logits - logits_p).abs().max().item()})")
        log(f"{fmt}: tokens and logits identical to the plain-forced run; "
            f"sample tokens {toks[0, :16].tolist()}")
        decode_profile(torch, params, cfg, prompts, cache_len, fmt)
        name = "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul"
        entries.append(kernel_entry(name, kernel_results[name], counts[fmt]))
        del params, logits, logits_p
        torch.cuda.empty_cache()

    # a small input against its CPU run (plain versions there)
    red = configs.get_reduced_config("smollm-135m")
    rng_prompts = torch.randint(0, red.vocab, (2, 8), generator=gen,
                                device="cuda")
    for fmt in ("w4a8", "w8a8"):
        p_gpu = serve.build_params(red, fmt, seed=0, quant_force=True,
                                   device="cuda")
        p_cpu = _to_cpu(p_gpu)     # the same weights on both devices
        lg, _ = lm.prefill(p_gpu, rng_prompts, red, cache_len=8)
        lc, _ = lm.prefill(p_cpu, rng_prompts.cpu(), red, cache_len=8)
        diff = (lg.cpu() - lc).abs().max().item()
        if not diff <= CPU_LOGIT_ATOL:
            raise AssertionError(f"reduced {fmt}: card vs CPU prefill logits "
                                 f"differ by {diff} > {CPU_LOGIT_ATOL}")
        log(f"reduced {fmt}: card vs CPU prefill logits max diff {diff:.3g}")
    return entries


def decode_profile(torch, params, cfg, prompts, cache_len, fmt,
                   steps: int = 4) -> None:
    """Where a decode step's time goes: device kernel time (profiler)
    against the host clock over a few steps, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    logits, cache = lm.prefill(params, prompts, cfg, cache_len=cache_len)
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int64, device="cuda")
    lm.decode_step(params, tok, cache, pos, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = lm.decode_step(params, tok, cache, pos + 1 + i,
                                           cfg)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # device-side kernel events only: a host op's own entry repeats the
    # device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev(e) > 0]
    dev_ms = sum(dev(e) for e in events) / 1e3 / steps
    if dev_ms <= 0:
        log(f"{fmt} decode profile: device time not measured (profiler "
            f"saw no device events); host {wall_ms:.2f} ms/step")
        return
    log(f"{fmt} decode profile (profiled, {steps} steps): host "
        f"{wall_ms:.2f} ms/step, device kernels {dev_ms:.3f} ms/step, "
        f"device busy {100 * dev_ms / wall_ms:.1f}%")
    for e in sorted(events, key=dev, reverse=True)[:8]:
        log(f"    {dev(e) / 1e3 / steps:8.3f} ms/step  {e.count // steps:5d} "
            f"calls/step  {e.key[:70]}")


def _to_cpu(tree):
    from repro_torch.quant.qtensor import QTensor
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.cpu(), tree.scale.cpu(), tree.fmt)
    return tree.cpu()


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = ("quant_matmul", "packed_w4_matmul")
    fresh = [n for n in names if not _build.library_path(n).exists()]
    _build.build(*names)
    log(f"build: {time.perf_counter() - t0:.1f} s (compiled "
        f"{fresh or 'nothing: cached'}) into {_build.BUILD_DIR}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = phase_kernels(torch)
    entries = phase_generate(torch, results)

    print(json.dumps({"kernels": entries}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
