"""Distributed runtime (port of `repro/distributed`): fault injection so
far (`fault.py`)."""
