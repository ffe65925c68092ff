#!/usr/bin/env python3
"""Time the w8a8 prefill tile (`csrc/s8_tile.cuh`) against its ring depth
and its K chain, on the card.

    python3 scripts/tile_sweep.py [--stages 2 3 4 6]   # repository root

Builds `csrc/quant_matmul.cu` once per ring depth, with
`-DS8TILE_STAGES=<n>` on the build's nvcc flags, into
`build/tile_sweep/` (all started together), gates each variant bit for
bit against the plain version, then prints per-launch times (CUDA
events, weights rotated through copies that spill the L2, as
chip_smoke.py times them) at the four prefill shapes of smollm-135m, at
N = 192 over K = 64..2304 (the per-step slope of a 48-block grid), at one
lone block (M = N = 64) and for the 64x64 tile of `s8_gemm.cuh` beside
them.  Needs a CUDA card; writes only under `build/`.
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


def build_variants(stages) -> dict:
    """{STAGES: that build's repro_quant_matmul}."""
    from repro_torch.kernels import _build, common
    root = _build.BUILD_DIR.parent / "tile_sweep"
    root.mkdir(parents=True, exist_ok=True)
    jobs = []
    for s in stages:
        so = root / f"quant_matmul_S{s}.so"
        jobs.append((s, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DS8TILE_STAGES={s}",
             "-o", str(so), str(_build.CSRC / "quant_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for s, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for STAGES={s}:\n{out}")
        fns[s] = common.bind_in(ctypes.CDLL(str(so)), "repro_quant_matmul",
                                6, 5)
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
    fns["tile64"] = common.bind("quant_matmul", "repro_quant_matmul_tile64",
                                6, 5)
    counter = common.LaunchCounter("tile sweep")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    for m, k, n in SHAPES:
        x, w = i8(m, k), i8(k, n)
        xs = torch.rand((m, 1), generator=gen, device="cuda") * 0.02 + 1e-3
        ws = torch.rand((1, n), generator=gen, device="cuda") * 0.02 + 1e-3
        want = ref.quant_matmul_ref(x, w, xs, ws)
        copies = [w] + [i8(k, n) for _ in range(
            math.ceil(128e6 / w.numel()) - 1)]
        cells = []
        for name, fn in fns.items():
            def call(i, fn=fn):
                return common.launch_s8_gemm(
                    fn, counter, x, copies[i % len(copies)], n, xs, ws,
                    want_acc=False, want_out=True)[1]
            if not torch.equal(call(0), want):
                raise AssertionError(f"{name} {(m, k, n)} differs from the "
                                     "plain version")
            label = f"S{name}" if isinstance(name, int) else name
            us = cs.device_ms(torch, call, 100) * 1e3
            cells.append(f"{label} {us:7.2f}")
        print(f"M={m:5d} K={k:5d} N={n:5d} us/launch: " + "  ".join(cells),
              flush=True)
        del copies
    print(f"card: {cs.smi_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
