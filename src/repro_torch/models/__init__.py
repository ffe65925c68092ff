"""Model zoo (port of `repro/models`): the dense family so far."""
