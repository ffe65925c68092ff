"""Fault injection (port of `repro/distributed/fault.py`, :32-58).

`SimulatedFailure` is the injected failure; `FailureInjector` raises it at
chosen points, each at most once.  Serving drives it by dispatch site --
``kind:index`` strings over the engine's per-kind dispatch counters, e.g.
``segment:3`` / ``prefill:0`` / ``chunk:7`` (`check_site`;
`launch/resilience.ChaosSchedule` extends it with a deterministic
rate-based schedule parsed from $REPRO_CHAOS); training drives it by
step number (`check`).

The rest of the reference module -- `StragglerDetector`, `RestartPolicy`,
`elastic_remesh` and `Heartbeat` -- serves training's restart loop
and the mesh: it is ported with ROADMAP A8 (the mesh) and A9
(training).
"""
from __future__ import annotations

import dataclasses


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
