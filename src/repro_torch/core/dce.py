"""Standalone dead-code elimination over a traced graph (paper sec. 3.4).

Port of `repro/core/dce.py`: the SILVIA pass runs DCE over its item
schedule internally; this exposes the same liveness logic as a
graph -> graph pass."""
from __future__ import annotations

from torch import fx

from repro_torch.core import ir


def dce_graph(gm: fx.GraphModule) -> fx.GraphModule:
    items = ir.items_of(gm)
    live = ir.dce_items(items, ir.outvars_of(gm))
    if len(live) == len(items):
        return gm
    return ir.emit_graph(gm, live)
