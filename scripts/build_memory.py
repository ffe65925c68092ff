#!/usr/bin/env python3
"""Time and device memory of `serve.build_params` (the streaming init:
each random [K, N] matrix drawn, then quantized or kept) at a config's
full width, on the card.

    python3 scripts/build_memory.py --arch command-r-35b \\
        [--quant w4a8 w8a8] [--trace] [--src DIR] [--label NAME] \\
        [--out FILE]

Per format, from seed 0, one after the other (each tree freed before the
next is built): the build's seconds, the tree's resident GiB and the
peak of allocated memory above what was allocated before the build
(`torch.cuda.max_memory_allocated`), beside the largest random matrix's
float32 draw.  With `--trace`, also each random leaf's shape and the
allocated and peak GiB once it is built, in build order.  `--src` is
the `src` directory whose `repro_torch` is imported (default: this
checkout's), so that two trees can be compared in one call.  Prints one JSON line with the card's name and power
limit; with `--out` also writes it there.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--quant", nargs="+", default=["w4a8", "w8a8"])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("build_memory: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_config(args.arch)
    largest = 0
    stack = [lm.param_specs(cfg, "meta")]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, lm.Draw):
            largest = max(largest, math.prod(node.shape[-2:]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    out = {"label": args.label, "arch": args.arch, "card": smi[0] if smi
           else None, "largest_draw_gib": 4 * largest / 2**30, "builds": {}}
    trace = []
    if args.trace:
        draw = lm.draw_slices

        def traced(spec, gen, device):
            try:
                yield from draw(spec, gen, device)
            finally:        # the leaf's builder is done with its slices
                torch.cuda.synchronize()
                trace.append([list(spec.shape),
                              torch.cuda.memory_allocated() / 2**30,
                              torch.cuda.max_memory_allocated() / 2**30])

        lm.draw_slices = traced
    for fmt in args.quant:
        trace.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = serve.build_params(cfg, fmt, seed=0, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        resident = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        out["builds"][fmt] = {"seconds": seconds,
                              "resident_gib": resident / 2**30,
                              "peak_gib": peak / 2**30,
                              "peak_over_resident_gib":
                                  (peak - resident) / 2**30}
        if args.trace:
            out["builds"][fmt]["leaves"] = [list(t) for t in trace]
        del params
    line = json.dumps(out)
    print(line)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
