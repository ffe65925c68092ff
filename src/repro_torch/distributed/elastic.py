"""Elastic degraded-mesh serving (port of `repro/distributed/elastic.py`):
not ported.  The reference's engine survives losing devices -- a
`DeviceLoss` fault marks devices dead in a health registry, the engine
re-plans onto the largest valid healthy sub-mesh and replays in-flight
requests there.  Over `torch.distributed` a lost rank takes its process
group with it, so the port's version needs a re-formed world as well as
the re-plan; it is ROADMAP A11, and each entry point here raises naming
it, as do the engine's `_degrade`, chaos's ``lose@`` arms
(launch/resilience.py) and `fault.elastic_remesh`."""
from __future__ import annotations

_WHY = ("elastic degraded-mesh serving is not ported yet (ROADMAP A11: "
        "re-planning a mesh after a device loss)")


def plan_degraded_mesh(mesh, healthy, **kwargs):
    """The largest valid healthy sub-mesh: not ported."""
    raise NotImplementedError(f"plan_degraded_mesh: {_WHY}")


class DeviceHealthRegistry:
    """Per-device health bookkeeping: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"DeviceHealthRegistry: {_WHY}")
