"""Distributed runtime (port of `repro/distributed`): fault injection,
restart policy, straggler detection and heartbeats (`fault.py`), the
serve-time distribution context (`context.py`) and the sharding rules
(`sharding.py`) of mesh serving, and elastic degraded-mesh serving
(`elastic.py`: the loss injector, the health registry, the planner)."""
