"""Launchers (port of `repro/launch`): greedy serving so far."""
