"""Fault-tolerant training loop (port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 300 --batch 8 --seq 256 --ckpt-dir <dir> \\
        --ckpt-every 50 [--simulate-failures 120,220] [--device cpu]

Beyond the bare train loop:

* checkpoint/restart: periodic atomic checkpoints of {params, opt}
  (`checkpoint/ckpt.py`); on a failure `run` restores the latest
  committed checkpoint and resumes.  The data pipeline is a pure
  function of the step, so the token stream replays exactly, and a run
  with failures ends with the parameters of the same run without them
  (on the CPU bit for bit; on the card as far as its kernels are
  deterministic, which chip_smoke.py gates).  A checkpoint labelled s
  holds the state after s steps (its optimizer step is s) and resumes
  at step s: the reference labels a mid-run checkpoint with the step it
  has just taken and resumes by taking that step again (ROADMAP
  C-ref9);
* straggler detection: per-host step-time tracking (simulated hosts on
  one card), flags logged;
* restarts under a `RestartPolicy` (budget, backoff).

The mesh (`--mesh` other than 1x1) is training's multi-rank half,
ROADMAP A12 (elastic re-sharding, `fault.elastic_remesh`, is ported
with elastic serving).  Training is bf16 on float weights: no quantized GEMM and no
hand-written kernel lies on this path (its products are torch.matmul,
autograd supplies the backward).  The device defaults to "cuda" and is
never swapped for the CPU behind the caller's back: without a GPU, pass
`--device cpu`.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import checkpoint, configs
from repro_torch import device as device_lib
from repro_torch.data import DataConfig, make_stream
from repro_torch.distributed.fault import (FailureInjector, RestartPolicy,
                                           SimulatedFailure,
                                           StragglerDetector)
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.training import TrainConfig, make_train_step


def build(cfg, tcfg: TrainConfig, seq: int, seed: int, device):
    """(params, opt state, step fn): the port's seeded init with position
    tables of seq + 8 rows, as the reference's `build`."""
    params = lm.init_params(cfg, seed, device=device, max_seq=seq + 8)
    return params, adamw_init(params, tcfg.optimizer), \
        make_train_step(cfg, tcfg)


def _mesh_shape(spec: str) -> tuple:
    shape = tuple(int(x) for x in spec.split("x"))
    if any(n != 1 for n in shape):
        raise NotImplementedError(
            f"--mesh {spec}: sharded training over a device mesh comes with "
            "training's multi-rank half (ROADMAP A12); the port trains on one "
            "device (--mesh 1x1)")
    return shape


def run(args) -> dict:
    """Train per `args` (main()'s flags; `device` defaults to "cuda").
    Returns {final_loss, restores, history (the logged losses), step_ms
    (every step's time, the failed attempts' too), params, opt}."""
    cfg = configs.get_reduced_config(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    _mesh_shape(args.mesh)
    dev = device_lib.resolve(getattr(args, "device", "cuda"))
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        optimizer=AdamWConfig(lr=args.lr),
        schedule_warmup=min(50, args.steps // 10 + 1),
        schedule_total=args.steps)
    stream = make_stream(DataConfig(args.seq, args.batch, cfg.vocab,
                                    seed=args.seed))
    injector = FailureInjector(tuple(
        int(s) for s in args.simulate_failures.split(",") if s))
    policy = RestartPolicy(max_restarts=args.max_restarts)
    detector = StragglerDetector(n_hosts=args.sim_hosts)

    history: list[float] = []
    step_ms: list[float] = []
    n_restores = 0
    while True:
        try:
            params, opt, step_fn = build(cfg, tcfg, args.seq, args.seed, dev)
            restored, start = checkpoint.restore_checkpoint(
                args.ckpt_dir, {"params": params, "opt": opt})
            if restored is not None:
                params, opt = restored["params"], restored["opt"]
                n_restores += 1
                print(f"[restore] resumed from step {start}")
            metrics = None
            for step in range(start or 0, args.steps):
                t0 = time.perf_counter()
                injector.check(step)
                batch = {"tokens": torch.from_numpy(
                    stream.batch_at(step)).to(dev)}
                params, opt, metrics = step_fn(params, opt, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                step_ms.append(dt * 1e3)
                detector.report(step, step % args.sim_hosts, dt)
                if step % args.log_every == 0:
                    loss = float(metrics["loss"])
                    history.append(loss)
                    strag = detector.stragglers(step)
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"({dt * 1e3:.0f} ms)"
                          + (f" stragglers={strag}" if strag else ""))
                if args.ckpt_every and step and \
                        step % args.ckpt_every == 0:
                    # the reference's cadence, labelled with the steps
                    # taken: the state after step + 1 steps, resumed there
                    checkpoint.save_checkpoint(
                        args.ckpt_dir, step + 1,
                        {"params": params, "opt": opt})
                    # committed progress: the next incident backs off from
                    # the base again instead of the escalated streak
                    policy.reset()
            if args.ckpt_every:
                checkpoint.save_checkpoint(
                    args.ckpt_dir, args.steps, {"params": params, "opt": opt})
            final = float("nan") if metrics is None else \
                float(metrics["loss"])
            print(f"done: final loss {final:.4f}, restores={n_restores}, "
                  f"straggler flags={len(detector.flagged)}")
            return {"final_loss": final, "restores": n_restores,
                    "history": history, "step_ms": step_ms,
                    "params": params, "opt": opt}
        except SimulatedFailure as e:
            print(f"[failure] {e}")
            if not policy.should_restart(e):
                raise
            continue


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failures", default="")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--sim-hosts", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
