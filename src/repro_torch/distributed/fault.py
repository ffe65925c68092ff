"""Fault tolerance for long-running jobs (port of
`repro/distributed/fault.py`).

* **Failure simulation + restart policy** -- `FailureInjector` raises
  `SimulatedFailure` at chosen points, each at most once: training by
  step number (`check`), serving by dispatch site -- ``kind:index``
  strings over the engine's per-kind dispatch counters, e.g.
  ``segment:3`` / ``prefill:0`` / ``chunk:7`` (`check_site`;
  `launch/resilience.ChaosSchedule` extends it with a deterministic
  rate-based schedule parsed from $REPRO_CHAOS).  The training loop
  (`launch/train.py`) catches the failure, restores the last committed
  checkpoint and continues, under a `RestartPolicy`.
* **Heartbeats / straggler detection** -- every host reports per-step
  wall time; `StragglerDetector` flags hosts whose rolling median
  exceeds the fleet median by `threshold`x (simulated hosts on one
  card); `Heartbeat` is the controller's view of last-seen times.
* **Elastic scaling** -- `elastic_remesh` gives this rank's placement
  of a tree on a new (degraded) mesh under the sharding rules
  (distributed/elastic.py plans the mesh).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import statistics
import time
from typing import Any, Optional


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclasses.dataclass
class FailureInjector:
    """Raises `SimulatedFailure` at chosen points, each at most once."""
    fail_at_steps: tuple = ()
    failed: set = dataclasses.field(default_factory=set)
    fail_at_sites: tuple = ()

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.failed:
            self.failed.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")

    def check_site(self, site: str):
        if site in self.fail_at_sites and site not in self.failed:
            self.failed.add(site)
            raise SimulatedFailure(f"injected serving fault at {site}")


class StragglerDetector:
    """Rolling per-host step-time tracking with median-ratio flagging."""

    def __init__(self, n_hosts: int, window: int = 16,
                 threshold: float = 1.5):
        self.times = [collections.deque(maxlen=window)
                      for _ in range(n_hosts)]
        self.threshold = threshold
        self.flagged: list[tuple[int, int]] = []   # (step, host)

    def report(self, step: int, host: int, dt: float):
        self.times[host].append(dt)

    def stragglers(self, step: int) -> list[int]:
        medians = [statistics.median(t) if t else 0.0 for t in self.times]
        fleet = statistics.median([m for m in medians if m > 0] or [0.0])
        out = []
        if fleet <= 0:
            return out
        for h, m in enumerate(medians):
            if m > self.threshold * fleet:
                out.append(h)
                self.flagged.append((step, h))
        return out


@dataclasses.dataclass
class RestartPolicy:
    """Restart budget with exponential backoff and deterministic jitter.

    `restarts` counts restarts actually GRANTED (a refusal does not burn
    an attempt); `streak` counts consecutive failures since the last
    `reset()`, driving the backoff: min(backoff_s * 2**streak,
    max_backoff_s), scaled by a jitter factor in [1, 1+jitter) derived
    from a stable hash of (seed, streak) -- reproducible across runs,
    yet de-synchronized across differently-seeded hosts.  Call `reset()`
    after a success so a long-lived job's next incident starts from the
    base backoff again."""
    max_restarts: int = 10
    backoff_s: float = 0.0
    max_backoff_s: float = 30.0
    jitter: float = 0.1
    seed: int = 0
    restarts: int = 0
    streak: int = 0

    def next_backoff(self) -> float:
        """Backoff for the current streak (0.0 when backoff_s is 0)."""
        if not self.backoff_s:
            return 0.0
        base = min(self.backoff_s * (2.0 ** self.streak), self.max_backoff_s)
        h = hashlib.sha256(f"{self.seed}|{self.streak}".encode()).digest()
        frac = int.from_bytes(h[:8], "big") / 2.0 ** 64
        return base * (1.0 + self.jitter * frac)

    def should_restart(self, exc: Exception) -> bool:
        if self.restarts >= self.max_restarts:
            return False
        delay = self.next_backoff()
        self.restarts += 1
        self.streak += 1
        if delay:
            time.sleep(delay)
        return True

    def reset(self) -> None:
        """Record a success: the next failure backs off from the base."""
        self.streak = 0


def elastic_remesh(tree: Any, new_mesh, cfg=None):
    """Re-shard a tree onto a different mesh (elastic scale up/down):
    this rank's blocks of `tree` (whole tensors, or any that hold what
    this rank needs) under `sharding.param_pspecs` on `new_mesh` -- the
    rules re-derived for the new mesh, so divisibility re-validates.
    The reference's `device_put` onto the new shardings."""
    from repro_torch.distributed import sharding
    return sharding.shard_tree(tree, sharding.param_pspecs(tree, new_mesh,
                                                           cfg), new_mesh)


class Heartbeat:
    """Host liveness: controller-side view of last-seen times."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0):
        self.last_seen = {h: time.time() for h in range(n_hosts)}
        self.timeout_s = timeout_s

    def beat(self, host: int, t: Optional[float] = None):
        self.last_seen[host] = t if t is not None else time.time()

    def dead_hosts(self, now: Optional[float] = None) -> list[int]:
        now = now if now is not None else time.time()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]
