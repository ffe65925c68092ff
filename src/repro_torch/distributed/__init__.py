"""Distributed runtime (port of `repro/distributed`): fault injection,
restart policy, straggler detection and heartbeats (`fault.py`); the
mesh, sharding and elastic paths come with ROADMAP A8."""
