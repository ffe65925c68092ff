#!/usr/bin/env python3
"""Device time per launch of the factor-4 4-bit multiply kernels
(`csrc/mul4.cu`: `mul4_split` and, as the control, `mul4_full32`),
signed, at MMM-4b's body shape [512, 2048] and at MobileNet-4b's 2^23
elements, for one source tree of the port, on the card.

    python3 scripts/mul4_ab.py [--src DIR] [--label NAME] [--rounds 5] \\
        [--out FILE]                                  # repository root

`--src` is the `src` directory whose `repro_torch` is imported (default:
this checkout's); its kernels build under that tree's own `build/`.  To
compare two commits, unpack the other one into a git-ignored directory
and run the script on each tree in turn, in one call, in the order
A B B A.

Per tree: `nvcc -Xptxas -v` of mul4.cu (registers, spills and shared
memory of every kernel in it).  Per kernel and shape: distinct operand
copies, 128 MB of them, so that launches cycling through them read from
HBM (as chip_smoke.py's `spill_copies`); every copy's launch is
bit-identical to `mul4_plain` first; then `--rounds` rounds of launches
timed by CUDA events behind a sleep kernel that holds the stream while
the host enqueues them (chip_smoke.py's `device_ms`), the median round
and the spread, in us per launch, beside the byte bound (21 bytes per
element at 3.35 TB/s).  Beside them, timed the same way, two
yardsticks of what the card's memory reaches for such traffic:
`torch.full` of the (4, e) int32 output alone (16 bytes per element
written, nothing read) and a's widening copy to int32 (4 read, 16
written).

Prints one JSON line; with `--out` also writes it there.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import statistics
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# (label, inner shape of b); a is (4, *shape)
SHAPES = [("512x2048", (512, 2048)), ("2^23", (2 ** 23,))]
LAUNCHES = {"512x2048": 200, "2^23": 50}


def demangle(sym: str) -> str:
    """mul4.cu's kernels by their template names, e.g.
    `mul4_split_kernel<true>`, from the Itanium-mangled symbol."""
    m = re.search(r"\d+(mul4\w*?kernel)I((?:Lb[01]E)+)E", sym)
    if not m:
        return sym
    args = ["true" if b == "1" else "false"
            for b in re.findall(r"Lb([01])E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas(cs, _build) -> dict:
    """{kernel: ptxas -v's registers, spills and shared memory}."""
    proc = cs.ptxas_report(_build, "mul4")
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for mul4.cu:\n{out}")
    found, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = demangle(m.group(1))
            found[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", ln)):
            found[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            found[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            found[name]["smem"] = int(sm.group(1)) if sm else 0
    return found


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
    import chip_smoke as cs
    from repro_torch.kernels import _build, mul4

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"label": args.label, "src": args.src, "card": cs.smi_line(),
           "torch": torch.__version__, "ptxas": ptxas(cs, _build), "us": {}}
    kernels = {"mul4_split": mul4.mul4_split, "mul4_full32": mul4.mul4_full32}
    for label, shape in SHAPES:
        e = math.prod(shape)
        a = torch.randint(-8, 8, (4, *shape), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-8, 8, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        copies = cs.spill_copies((a, b), LAUNCHES[label])
        for name, fn in kernels.items():
            for ops in copies:
                want = mul4.mul4_plain(*ops)
                if not all(torch.equal(g, w)
                           for g, w in zip(fn(*ops), want)):
                    raise AssertionError(f"{name} {label}: differs from "
                                         "mul4_plain")
        runs = {name: lambda i, fn=fn: fn(*copies[i % len(copies)])
                for name, fn in kernels.items()}
        # yardsticks: the wrappers' output alone, torch.full of (4, e)
        # int32 (16 bytes per element written, nothing read); and a's
        # widening copy to int32 (4 read, 16 written: 20 of the 21 bytes)
        runs["output_fill"] = lambda i: torch.full(
            (4, *shape), i, dtype=torch.int32, device="cuda")
        runs["widen_copy"] = lambda i: copies[i % len(copies)][0].to(
            torch.int32)
        times = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name, run in runs.items():
                times[name].append(1e3 * cs.device_ms(torch, run,
                                                      LAUNCHES[label]))
        for name, t in times.items():
            nbytes = {"output_fill": 16, "widen_copy": 20}.get(name, 21)
            bound_us = nbytes * e / cs.HBM_BYTES_PER_S * 1e6
            res["us"].setdefault(name, []).append(dict(
                shape=label, copies=len(copies), launches=LAUNCHES[label],
                median_us=statistics.median(t), min_us=min(t),
                max_us=max(t), rounds=t, bound_us=bound_us,
                bound_share=bound_us / statistics.median(t)))
        del copies, a, b
    line = json.dumps(res)
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
