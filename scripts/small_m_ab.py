#!/usr/bin/env python3
"""Device time per launch of the small-M GEMM kernel
(`csrc/s8_small_m.cuh`) at smollm-135m's four decode shapes (M = 8),
with int8 and with packed int4 weights (the f32 output the served path
takes), for one source tree of the port, on the card.

    python3 scripts/small_m_ab.py [--src DIR] [--label NAME] \\
        [--rounds 5] [--out FILE]                     # repository root

`--src` is the `src` directory whose `repro_torch` is imported (default:
this checkout's); its kernels build under that tree's own `build/`.  To
compare two commits, unpack the other one into a git-ignored directory
and run the script on each tree in turn, in one call, in the order
A B B A.  Per format and (K, N): each launch is bit-identical to the
plain version first; then 200 launches over enough distinct weight
copies to spill the 50 MB L2 (as a 30-layer decode step does), timed by
CUDA events behind a sleep kernel that holds the stream while the host
enqueues them (chip_smoke.py's `device_ms`), `--rounds` rounds, the
median round and the spread, in us per launch.

Prints one JSON line; with `--out` also writes it there.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
M = 8
# (K, N) of the seven projections: q/o, k/v, gate/up, down
MAIN_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576)]


def launch_us(fn, n: int) -> float:
    """Mean device time of fn(i) over n calls (us), by CUDA events."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(n * 2e5))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import packed_matmul, quant_matmul, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    i8 = lambda *s: torch.randint(-128, 128, s, generator=gen,
                                  device="cuda", dtype=torch.int8)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {"label": args.label, "src": args.src, "card": smi,
           "torch": torch.__version__, "us": {}}
    for fmt, gemm, plain, packed in (
            ("w8a8", quant_matmul.quant_matmul, ref.quant_matmul_ref, False),
            ("w4a8", packed_matmul.packed_w4_matmul,
             ref.packed_w4_matmul_ref, True)):
        rows = []
        for k, n in MAIN_KN:
            x = i8(M, k)
            xs = torch.rand((M, 1), generator=gen, device="cuda")
            ws = torch.rand((1, n), generator=gen, device="cuda")
            copies = [i8(k, n // 2 if packed else n)]
            if not torch.equal(gemm(x, copies[0], xs, ws),
                               plain(x, copies[0], xs, ws)):
                raise AssertionError(f"{fmt} {(M, k, n)}: differs from "
                                     "the plain version")
            copies += [i8(*copies[0].shape) for _ in range(
                math.ceil(128e6 / copies[0].numel()) - 1)]
            times = [launch_us(lambda i: gemm(x, copies[i % len(copies)],
                                              xs, ws), 200)
                     for _ in range(args.rounds)]
            rows.append({"k": k, "n": n, "median_us": statistics.median(
                times), "min_us": min(times), "max_us": max(times)})
            del copies
        res["us"][fmt] = rows
    line = json.dumps(res)
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
