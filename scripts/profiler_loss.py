#!/usr/bin/env python3
"""How many device kernel events a torch.profiler session loses, and
where, over many sessions in one process.

    python3 scripts/profiler_loss.py [--sessions 30] [--gap 2]

Each session launches 20 elementwise ops of distinct kernels, 500 times
each in order, and counts what the profiler saw of each.  Sessions
alternate three ways of opening: A as they are, B after a 50 ms host
pause inside the session, C after 300 launches of another kernel (a
prologue, `registry.profile_window`'s remedy).  A loss confined to the
first op (and to the prologue in C) says the session drops its first
events; a loss that B does not cure says it is counted in events, not in
time.  Prints one line per session and, last, a JSON summary.  Needs one
NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

NAMES = ["add_", "mul_", "neg_", "abs_", "sqrt_", "exp_", "log_", "sin_",
         "cos_", "tanh_", "sigmoid_", "relu_", "floor_", "ceil_", "round_",
         "trunc_", "frac_", "reciprocal_", "sign_", "square_"]
PER_OP, PROLOGUE, PAUSE_S = 500, 300, 0.05


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=30)
    ap.add_argument("--gap", type=float, default=2.0,
                    help="host seconds between sessions")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_loss: needs an NVIDIA GPU")
    x = torch.rand(256, device="cuda") + 1
    y = torch.rand(256, device="cuda")
    ops = [(n, getattr(x, n)) for n in NAMES]

    def call(n, f):
        return f(1) if n in ("add_", "mul_") else f()

    for n, f in ops:
        call(n, f)
    torch.cuda.synchronize()
    # each op's kernel key: the commonest key of a session of its own
    # (launched PER_OP times, so a loss of its first events leaves it)
    keys = {}
    for n, f in ops:
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(PER_OP):
                call(n, f)
            torch.cuda.synchronize()
        keys[n] = max((e for e in p.key_averages()
                       if str(e.device_type).endswith("CUDA")),
                      key=lambda e: e.count).key
    if len(set(keys.values())) != len(NAMES):
        raise SystemExit("profiler_loss: two ops share a kernel key")
    rows = []
    t0 = time.time()
    for session in range(args.sessions):
        mode = "ABC"[session % 3]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if mode == "B":
                time.sleep(PAUSE_S)
            if mode == "C":
                for _ in range(PROLOGUE):
                    y.zero_()
            for n, f in ops:
                for _ in range(PER_OP):
                    call(n, f)
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")}
        short = {n: PER_OP - seen.get(keys[n], 0) for n in NAMES
                 if seen.get(keys[n], 0) != PER_OP}
        other = sum(v for k, v in seen.items() if k not in keys.values())
        lost_prologue = PROLOGUE - other if mode == "C" else None
        rows.append(dict(session=session, mode=mode, lost=short,
                         lost_prologue=lost_prologue,
                         t=round(time.time() - t0, 1)))
        print(f"{session:3d} {mode} lost {short or 'none'}"
              + (f", prologue lost {lost_prologue}" if mode == "C" else "")
              + f"  {time.time() - t0:.0f} s", flush=True)
        time.sleep(args.gap)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "sessions": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
