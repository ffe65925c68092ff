#!/usr/bin/env python3
"""Prefill's host time, and the host cost of one GEMM call through the
public wrapper against a direct kernel launch, for one source tree of
the port, on the card.

    python3 scripts/prefill_ab.py [--src DIR] [--label NAME] [--reps 21] \\
        [--out FILE]                                  # repository root

`--src` is the `src` directory whose `repro_torch` is imported (default:
this checkout's).  To compare two commits, unpack the other one into a
git-ignored directory and run the script on each tree in turn, in one
call, in the order A B B A.  For smollm-135m at full width (random
weights from seed 0; B=8, prompt 128, cache 160), under w8a8 and w4a8:

* prefill: `--reps` calls of `lm.prefill` after 3 warm-up calls, each
  ending in `torch.cuda.synchronize()`, host clock: median, min, max;
* GEMM calls: at the four prefill shapes (M = 1024) and the four decode
  shapes (M = 8), host us per call of the registry's dispatch (the
  served path), of the format's wrapper (`quant_matmul.quant_matmul` /
  `packed_matmul.packed_w4_matmul`) and of its `_launch` called
  directly, 200 calls back to back ending in a synchronize, 5 rounds
  alternating the three, the median round.

Prints one JSON line; with `--out` also writes it there.  Needs a CUDA
card; builds the kernels under the tree's own `build/`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, PROMPT, GEN = 8, 128, 32
# (K, N) of the seven projections: q/o, k/v, gate/up, down
MAIN_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576)]


def host_ms(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def prefill_ms(lm, params, prompts, cfg, reps: int) -> dict:
    def one():
        lm.prefill(params, prompts, cfg, cache_len=PROMPT + GEN)
    for _ in range(3):
        one()
    times = [host_ms(one, 1) for _ in range(reps)]
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "all": times}


def gemm_us(registry, op: str, mod, wrapper, fmt: str, gen) -> list:
    rows = []
    for m in (PROMPT * BATCH, BATCH):
        for k, n in MAIN_KN:
            x = torch.randint(-128, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-128, 128, (k, n // 2 if fmt == "w4a8" else n),
                              generator=gen, device="cuda", dtype=torch.int8)
            xs = torch.rand((m, 1), generator=gen, device="cuda")
            ws = torch.rand((1, n), generator=gen, device="cuda")
            fns = {
                "dispatch": lambda: registry.dispatch(op, x, w, xs, ws),
                "wrapper": lambda: wrapper(x, w, xs, ws),
                "launch": lambda: mod._launch(x, w, xs, ws, want_acc=False,
                                              want_out=True)}
            for f in fns.values():
                f()
            rounds = {key: [] for key in fns}
            for _ in range(5):
                for key, f in fns.items():
                    rounds[key].append(host_ms(f, 200) * 5.0)   # us / call
            rows.append({"m": m, "k": k, "n": n,
                         **{f"{key}_us": statistics.median(v)
                            for key, v in rounds.items()}})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch import configs
    from repro_torch.kernels import packed_matmul, quant_matmul, registry
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_config("smollm-135m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {"label": args.label, "src": args.src, "card": smi,
           "torch": torch.__version__, "prefill_ms": {}, "gemm": {}}
    for fmt, op, mod, wrapper in (
            ("w8a8", "quant_matmul", quant_matmul, quant_matmul.quant_matmul),
            ("w4a8", "packed_w4_matmul", packed_matmul,
             packed_matmul.packed_w4_matmul)):
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        res["prefill_ms"][fmt] = prefill_ms(lm, params, prompts, cfg,
                                            args.reps)
        res["gemm"][fmt] = gemm_us(registry, op, mod, wrapper, fmt, gen)
        del params
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
