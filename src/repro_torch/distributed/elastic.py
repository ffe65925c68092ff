"""Elastic degraded-mesh serving: survive a rank's loss, keep the tokens.

Port of `repro/distributed/elastic.py`.  SILVIA's packing passes rebind
ops onto fewer DSPs without changing a single output bit; this module
carries that invariant one level up the stack: when a serving mesh
loses ranks, the engine rebinds its slots onto the largest valid
HEALTHY sub-mesh and replays in-flight requests bit-exactly.  Three
pieces live here:

* **`DeviceHealthRegistry`** -- which of a mesh's world ranks are
  alive.  Simulated loss marks ranks dead (the reference's simulated
  devices); at scale it would be fed by `distributed.fault.Heartbeat`
  timeouts (not wired: PERF.md's open questions).
* **`DeviceLossInjector`** -- a `launch.resilience.ChaosSchedule` whose
  schedule can also KILL ranks: loss events consume the SAME counted
  dispatch-site namespace as plain faults (``segment:/prefill:/chunk:N``),
  and the loss decision for a site is a pure function of (seed, site),
  as the fault decision is, so firing one never shifts the other's
  sites.  Every rank of a mesh runs the same scheduler over the same
  site counters, so every rank raises the same `DeviceLoss` at the same
  site, and kills the same ranks: no broadcast decides a loss.
  `$REPRO_CHAOS` grows ``lose@site[=N]`` / ``lose_rate=``... arms
  (`parse`, the reference's grammar and messages).
* **the degraded-mesh planner** (`plan_shape`, `plan_degraded_mesh`) --
  maps a mesh with dead ranks to the largest valid healthy sub-mesh:
  the data extent a power of two dividing `n_slots`
  (`launch.scheduler.validate_slot_sharding`'s dp floor), the model
  extent dividing the original one, preferring extents where the
  config's tensor-parallel plan stays ACTIVE.

The reference simulates a loss on one controller: the dead devices'
shards stay readable and a new `jax.sharding.Mesh` is a new array of
devices.  The port runs one process per rank, so the sub-mesh is a new
`launch.mesh.Mesh` whose process groups the survivors create among
themselves (`launch.mesh.reform`: no call, collective or store key
waits on a rank outside it), and a rank the plan leaves out -- lost, or
healthy but unused -- gets no mesh and leaves the engine's `follow()`
loop (launch/engine.py `_degrade`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.distributed.fault import SimulatedFailure
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.resilience import ChaosSchedule, _hash_frac


class DeviceLoss(SimulatedFailure):
    """Injected loss of `n_lost` mesh ranks at a dispatch site.

    Subclasses `SimulatedFailure` so every existing recovery path (the
    engine's `_recover`, the training loop's restarts) already
    catches it; mesh-aware engines additionally re-plan their mesh."""

    def __init__(self, site: str, n_lost: int):
        super().__init__(
            f"injected loss of {n_lost} device(s) at {site}")
        self.site = site
        self.n_lost = int(n_lost)


class DeviceHealthRegistry:
    """Alive/dead bookkeeping for one mesh's world ranks.

    Deterministic by construction: `kill(n)` marks the LAST n healthy
    ranks dead (stable order = the mesh's row-major rank order), so a
    seeded chaos run reproduces the same degraded topology every time.
    At least one rank always survives: the first, world rank 0, the
    engine's leader."""

    def __init__(self, ranks: Sequence[int]):
        self._ranks = [int(r) for r in ranks]
        self._dead: List[int] = []      # world ranks, kill order

    def kill(self, n: int) -> List[int]:
        """Mark up to `n` more ranks dead; returns the ranks killed now."""
        healthy = self.healthy()
        n = max(0, min(int(n), len(healthy) - 1))
        victims = healthy[len(healthy) - n:]
        self._dead.extend(victims)
        return victims

    def healthy(self) -> List[int]:
        dead = set(self._dead)
        return [r for r in self._ranks if r not in dead]

    @property
    def dead_ids(self) -> Tuple[int, ...]:
        return tuple(self._dead)

    @property
    def n_healthy(self) -> int:
        return len(self._ranks) - len(self._dead)


@dataclasses.dataclass
class DeviceLossInjector(ChaosSchedule):
    """ChaosSchedule that can also kill counted ranks.

    `lose_at_sites` maps dispatch sites (``kind:index``, the engine's
    `_guarded` counters) to a rank count; `lose_rate`/`lose_seed` draw
    additional loss events deterministically per site (`lose_n` ranks
    each, at most `lose_max` events).  Loss is checked BEFORE the plain
    fault check on the same site string, and both decisions are pure
    functions of the site, so arming one schedule never perturbs where
    the other fires.
    """
    lose_at_sites: Tuple[Tuple[str, int], ...] = ()
    lose_rate: float = 0.0
    lose_seed: int = 0
    lose_n: int = 1
    lose_max: Optional[int] = None
    lost_sites: dict = dataclasses.field(default_factory=dict)

    def loss_at(self, site: str) -> int:
        """Ranks to kill at `site` (0 = no loss event here)."""
        for s, n in self.lose_at_sites:
            if s == site:
                return n
        if self.lose_rate > 0 and \
                _hash_frac(self.lose_seed, f"lose|{site}") < self.lose_rate:
            return self.lose_n
        return 0

    def check_site(self, site: str) -> None:
        if site not in self.failed:
            capped = self.lose_max is not None \
                and len(self.lost_sites) >= self.lose_max
            n = 0 if capped else self.loss_at(site)
            if n > 0:
                self.failed.add(site)       # at-most-once, like faults
                self.lost_sites[site] = n
                raise DeviceLoss(site, n)
        super().check_site(site)

    @classmethod
    def parse(cls, spec: str) -> "DeviceLossInjector":
        """Extend the $REPRO_CHAOS grammar with device-loss arms::

            REPRO_CHAOS='lose@segment:1=4'            # kill 4 at a site
            REPRO_CHAOS='lose_rate=0.02,lose_seed=7'  # seeded loss draws
            REPRO_CHAOS='rate=0.05,seed=3;lose@chunk:2;lose_max=1'

        Tokens starting with ``lose`` are consumed here; everything else
        keeps the base `ChaosSchedule.parse` meaning."""
        lose_sites: List[Tuple[str, int]] = []
        lose_rate, lose_seed, lose_n, lose_max = 0.0, 0, 1, None
        rest: List[str] = []
        for tok in (t.strip() for part in spec.split(";")
                    for t in part.split(",")):
            if not tok:
                continue
            if tok.startswith("lose@"):
                body = tok[len("lose@"):]
                site, _, cnt = body.partition("=")
                kind, _, idx = site.partition(":")
                if kind not in cls.SITE_KINDS or not idx.isdigit() \
                        or (cnt and not cnt.isdigit()):
                    raise ValueError(
                        f"REPRO_CHAOS: bad device-loss site {tok!r} "
                        f"(want lose@kind:index or lose@kind:index=N)")
                lose_sites.append((site, int(cnt) if cnt else 1))
            elif tok.startswith("lose_") and "=" in tok:
                k, v = tok.split("=", 1)
                if k == "lose_rate":
                    lose_rate = float(v)
                elif k == "lose_seed":
                    lose_seed = int(v)
                elif k == "lose_n":
                    lose_n = int(v)
                elif k == "lose_max":
                    lose_max = int(v)
                else:
                    raise ValueError(
                        f"REPRO_CHAOS: unknown device-loss key {k!r} "
                        f"(want lose_rate/lose_seed/lose_n/lose_max)")
            else:
                rest.append(tok)
        base = ChaosSchedule.parse(",".join(rest)) if rest \
            else ChaosSchedule()
        return cls(fail_at_sites=base.fail_at_sites, rate=base.rate,
                   seed=base.seed, max_failures=base.max_failures,
                   lose_at_sites=tuple(lose_sites), lose_rate=lose_rate,
                   lose_seed=lose_seed, lose_n=lose_n, lose_max=lose_max)

    @property
    def arms_loss(self) -> bool:
        return bool(self.lose_at_sites) or self.lose_rate > 0


# ---------------------------------------------------------------------------
# degraded-mesh planning
# ---------------------------------------------------------------------------

def plan_shape(old_shape: Tuple[int, int], n_healthy: int, n_slots: int,
               cfg=None) -> Tuple[int, int]:
    """The (data, model) extents of the largest valid sub-mesh.

    Constraints: data is a power of two dividing `n_slots` (the engine's
    slot axis must split evenly -- scheduler.validate_slot_sharding);
    model divides the ORIGINAL model extent, so every head count that
    divided before still divides (slot_state.tp_plan degrades to
    replication otherwise, never errors).  Preference order: most ranks
    used, then data extent closest to the original (keep request packing
    wide), then -- with a config -- a model extent whose TP plan stays
    ACTIVE, then the larger model extent."""
    from repro_torch.launch.scheduler import largest_valid_dp

    d0, m0 = old_shape
    if n_healthy < 1:
        raise ValueError("plan_shape: no healthy devices left")
    tp_active: frozenset = frozenset()
    if cfg is not None:
        from repro_torch.models import slot_state
        tp_active = frozenset(slot_state.tp_viable_sizes(cfg, m0))

    best = None
    m = m0
    while m >= 1:
        if m0 % m == 0:
            d = largest_valid_dp(n_slots, n_healthy // m)
            if d * m <= n_healthy:
                score = (d * m,                      # use the most ranks
                         -abs(d - d0),               # keep dp near original
                         1 if m in tp_active else 0,
                         m)
                if best is None or score > best[0]:
                    best = (score, (d, m))
        m -= 1
    assert best is not None    # m=1, d=1 always fits when n_healthy >= 1
    return best[1]


def plan_degraded_mesh(old_mesh, healthy_ranks: Sequence[int], *,
                       dp_axes: tuple, model_axis: str, n_slots: int,
                       cfg=None) -> Optional[mesh_lib.Mesh]:
    """The degraded `launch.mesh.Mesh` over the first (d x m) healthy
    world ranks, in the old mesh's order (deterministic given the same
    loss sequence).

    The new mesh keeps the old axis NAMES; when the old mesh had several
    dp axes (pod, data), the planned data extent lands on the FIRST and
    the rest collapse to 1.  Over a mesh of process groups
    (`init_mesh`'s, or an earlier re-formation's) this rank re-forms:
    the survivors create the new mesh's groups among themselves
    (`launch.mesh.reform`), and a rank outside the new mesh gets None.
    Over a bare mesh (`make_mesh`) it returns a bare mesh."""
    d0 = 1
    for a in dp_axes:
        d0 *= old_mesh.shape[a]
    m0 = old_mesh.shape[model_axis] if model_axis in old_mesh.axis_names \
        else 1
    d, m = plan_shape((d0, m0), len(healthy_ranks), n_slots, cfg)
    shape = []
    first_dp = dp_axes[0] if dp_axes else None
    for name in old_mesh.axis_names:
        if name == first_dp:
            shape.append(d)
        elif name == model_axis:
            shape.append(m)
        else:
            shape.append(1)
    ranks = [int(r) for r in healthy_ranks[:d * m]]
    if old_mesh.rank is None:
        return mesh_lib.Mesh(shape, old_mesh.axis_names, ranks=ranks)
    return mesh_lib.reform(old_mesh, shape, ranks)
