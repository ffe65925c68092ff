#!/usr/bin/env python3
"""Time the prefill tile (`csrc/s8_tile.cuh`) against its ring depth and
its K chain, on the card, with either weight loader.

    python3 scripts/tile_sweep.py [--stages 2 3 4 6]   # repository root

Builds `csrc/quant_matmul.cu` (int8 weights, `TileW8`) and
`csrc/packed_w4_matmul.cu` (packed int4 weights, `TileW4`) once per ring
depth, with `-DS8TILE_STAGES=<n>` on the build's nvcc flags, into
`build/tile_sweep/` (all started together), gates each variant bit for
bit against the plain version, then prints per-launch times (CUDA
events, weights rotated through copies that spill the L2, as
chip_smoke.py times them) at the four prefill shapes of smollm-135m, at
N = 192 over K = 64..2304 (the per-step slope of a 48-block grid) and at
one lone block (M = N = 64), one line per shape and format.  Needs a
CUDA card; writes only under `build/`.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = [(1024, 576, 576), (1024, 576, 192), (1024, 576, 1536),
          (1024, 1536, 576)] + \
    [(1024, k, 192) for k in (64, 128, 256, 1152, 2304)] + \
    [(64, 64, 64), (64, 1536, 64)]
# format: (source, entry, stored weight columns per logical column)
FORMATS = {"w8a8": ("quant_matmul", "repro_quant_matmul", 1),
           "w4a8": ("packed_w4_matmul", "repro_packed_w4_matmul", 2)}


def build_variants(stages) -> dict:
    """{(format, STAGES): that build's tile entry}."""
    from repro_torch.kernels import _build, common
    root = _build.BUILD_DIR.parent / "tile_sweep"
    root.mkdir(parents=True, exist_ok=True)
    jobs = []
    for fmt, (src, entry, _) in FORMATS.items():
        for s in stages:
            so = root / f"{src}_S{s}.so"
            jobs.append((fmt, s, entry, so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS,
                 f"-DS8TILE_STAGES={s}", "-o", str(so),
                 str(_build.CSRC / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for fmt, s, entry, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {fmt} STAGES={s}:\n{out}")
        fns[(fmt, s)] = common.bind_in(ctypes.CDLL(str(so)), entry, 6, 5)
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[2, 3, 4, 6])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tile_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import common, ref

    print(f"card: {cs.smi_line()}", flush=True)
    fns = build_variants(args.stages)
    counter = common.LaunchCounter("tile sweep")
    gen = torch.Generator(device="cuda").manual_seed(5)
    plain = {"w8a8": ref.quant_matmul_ref, "w4a8": ref.packed_w4_matmul_ref}

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    for m, k, n in SHAPES:
        for fmt, (_, _, per) in FORMATS.items():
            x, w = i8(m, k), i8(k, n // per)
            xs = torch.rand((m, 1), generator=gen, device="cuda") * 0.02 + \
                1e-3
            ws = torch.rand((1, n), generator=gen, device="cuda") * 0.02 + \
                1e-3
            want = plain[fmt](x, w, xs, ws)
            copies = [w] + [i8(*w.shape) for _ in range(
                math.ceil(128e6 / w.numel()) - 1)]
            cells = []
            for s in args.stages:
                def call(i, fn=fns[(fmt, s)]):
                    return common.launch_gemm(
                        fn, counter, x, copies[i % len(copies)], n, xs, ws,
                        want_acc=False, want_out=True)[1]
                if not torch.equal(call(0), want):
                    raise AssertionError(f"{fmt} S{s} {(m, k, n)} differs "
                                         "from the plain version")
                us = cs.device_ms(torch, call, 100) * 1e3
                cells.append(f"S{s} {us:7.2f}")
            print(f"{fmt} M={m:5d} K={k:5d} N={n:5d} us/launch: "
                  + "  ".join(cells), flush=True)
            del copies
    print(f"card: {cs.smi_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
