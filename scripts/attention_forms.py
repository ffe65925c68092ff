#!/usr/bin/env python3
"""The S > 1 attention's three summation forms, timed at the serve
engine's many-query shapes.

    python3 scripts/attention_forms.py [--reps 7] [--out FILE]   # card
    python3 scripts/attention_forms.py --device cpu    # a smoke run only

`attention._attend` can sum the key axis of its output product in three
forms:

* `einsum`: one product over the whole key axis (cuBLAS's batched GEMM,
  whose split of K, and so whose summation order, moves with the
  shapes; the port's form for S > 1 until the key-blocked one);
* `key_blocked` (the port's for the chunk step, full prefill and the
  encoder): one GEMM per key block of `attention.KEY_BLOCK`, the blocks
  added in `common.tail_sum_`'s tree (`attention._key_blocked_out`);
* `fixed` (`fixed=True`, the port's for whisper's decoder prefill): the
  products summed by `common.row_sum` over D and `tail_sum_` over T in
  query blocks of `attention.PRODUCT_BYTES`, an order that no shape
  moves, in scores and output alike.

This script times the three on the same inputs (bf16, random from seed
0) at:

* `chunk`: the chunk step's attention, smollm-135m's head layout (9, 3,
  64), 8 rows x 16 queries over t_pre = 256 and 4096 keys, causal;
* `prefill`: full prefill at smollm's layout, 8 rows x 128 over 128
  keys, causal (the chunk step's form is full prefill's too, for
  chunked == full);
* `encoder`: whisper-small's encoder attention (12, 12, 64), 8 rows x
  1500 frames (the static path's) and 2 rows x 512 (an engine bucket),
  bidirectional over the rows' lengths;
* `cross`: whisper's decoder prefill over the slot's 1500-frame cross
  K/V, 8 rows x 8 queries.

Each case: 2 warm-up calls, then `--reps` calls timed one by one with
CUDA events: the median ms of each form and each form's ratio to the
einsum.  Prints one JSON line (with the card's name and power limit);
with `--out` also writes it there.  On the CPU every length is cut by 8 and the times are host times
of a smoke run, not the card's.
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
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# (case, arch, rows, queries, keys, causal)
CASES = (("chunk", "smollm-135m", 8, 16, 256, True),
         ("chunk", "smollm-135m", 8, 16, 4096, True),
         ("prefill", "smollm-135m", 8, 128, 128, True),
         ("encoder", "whisper-small", 8, 1500, 1500, False),
         ("encoder", "whisper-small", 2, 512, 512, False),
         ("cross", "whisper-small", 8, 8, 1500, False))


def _ms(fn, dev, reps: int) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_case(dev, arch, b, s, t, causal, reps: int) -> dict:
    cfg = configs.get_config(arch)
    h, kv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = randn(b, s, h, d), randn(b, t, kv, d), randn(b, t, kv, d)
    kw = {}
    if causal:
        kw["kpos"] = torch.arange(t, device=dev).expand(b, -1)
        kw["qpos"] = (t - s + torch.arange(s, device=dev)).expand(b, -1)
    else:
        lens = torch.randint(t // 2 + 1, t + 1, (b,), generator=g,
                             device=dev)
        lens[0] = t
        kw["valid"] = attention._valid(lens, t, dev)
    row = {}
    blocked = attention._key_blocked_out
    for form, fixed in (("einsum", False), ("key_blocked", False),
                        ("fixed", True)):
        if form == "einsum":
            attention._key_blocked_out = _einsum_out
        try:
            row[f"{form}_ms"] = _ms(lambda: attention._attend(
                q, k, v, cfg, torch.bfloat16, fixed=fixed, **kw), dev, reps)
        finally:
            attention._key_blocked_out = blocked
    for form in ("key_blocked", "fixed"):
        row[f"{form}_over_einsum"] = row[f"{form}_ms"] / row["einsum_ms"]
    return row


def _einsum_out(w, v):
    """The output product as one einsum over the whole key axis."""
    return torch.einsum("bkgst,btkd->bskgd", w, v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cut = 1
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("attention_forms: no CUDA device", file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    else:
        cut, smi = 8, "cpu (smoke run: lengths cut by 8, host times)"
    res = {"device": smi, "torch": torch.__version__, "cases": []}
    for case, arch, b, s, t, causal in CASES:
        s, t = max(1, s // cut), max(1, t // cut)
        row = {"case": case, "arch": arch, "rows": b, "queries": s,
               "keys": t}
        row.update(time_case(dev, arch, b, s, t, causal, args.reps))
        res["cases"].append(row)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
