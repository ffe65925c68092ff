"""Data-dependence graph + initiation-interval analysis (paper sec. 3.5.1).

Port of `repro/core/ddg.py`.

    II_min = max over cycles theta of ceil(latency_theta / distance_theta)

Intra-iteration edges have distance 0; loop-carried edges (a scan body's
carry outputs feeding its carry inputs of the next iteration) have
distance 1.  Packing a tuple merges its candidates into one super-node,
which can create a new critical cycle and raise II_min -- the paper's
Fig. 5 edge case.  The paper leaves handling to future work; this module
provides the analyzer plus the conservative tuple filter
(`would_increase_ii`), which the passes apply with `filter_ii=True`.

Torch's scan body orders its placeholders `[*carry, *xs,
*additional_inputs]` and its outputs `[*carry_out, *ys]` (JAX's body:
`[*consts, *carry, *xs]`), so carry i is placeholder i and output i.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from torch import fx

from repro_torch.core import ir

DEFAULT_LATENCY = 1


@dataclasses.dataclass
class DDG:
    """Nodes 0..n-1 with latencies; edges (u, v, distance)."""
    latencies: list[int]
    edges: list[tuple[int, int, int]]

    def with_merged(self, group: Sequence[int]) -> "DDG":
        """Merge `group` nodes into one super-node (a packed tuple): its
        latency is the max member latency (they execute together) and
        every member edge re-targets the super-node."""
        group_set = set(group)
        rep = min(group_set)
        remap = {}
        new_lat = []
        for i, lat in enumerate(self.latencies):
            if i in group_set and i != rep:
                continue
            remap[i] = len(new_lat)
            new_lat.append(max(self.latencies[g] for g in group_set)
                           if i == rep else lat)
        for g in group_set:
            remap[g] = remap[rep]
        new_edges = set()
        for u, v, d in self.edges:
            nu, nv = remap[u], remap[v]
            if nu == nv and d == 0:
                continue  # an edge inside the super-node disappears
            new_edges.add((nu, nv, d))
        return DDG(new_lat, sorted(new_edges))

    def ii_min(self, max_ii: int | None = None) -> int:
        """Smallest II such that no cycle violates Eq. 5: a cycle theta is
        violated iff sum(latency) - II * sum(distance) > 0, found as a
        positive-weight cycle under w(u->v) = latency(u) - II * distance
        (Bellman-Ford); II grows until none is left."""
        if not self.latencies:
            return 1
        cap = max_ii or (sum(self.latencies) + 1)
        for ii in range(1, cap + 1):
            if not self._has_positive_cycle(ii):
                return ii
        return cap

    def _has_positive_cycle(self, ii: int) -> bool:
        n = len(self.latencies)
        dist = [0.0] * n     # longest-path relaxation from all sources
        for _ in range(n):
            changed = False
            for u, v, d in self.edges:
                w = self.latencies[u] - ii * d
                if dist[u] + w > dist[v] + 1e-9:
                    dist[v] = dist[u] + w
                    changed = True
            if not changed:
                return False
        return True  # still relaxing after n rounds: a positive cycle


def loop_edges(items: Sequence, def_idx: Mapping, use_idxs: Mapping,
               body: fx.GraphModule, num_carry: int) -> list:
    """Distance-0 def->use edges between `items` (a schedule of the
    body's items) plus distance-1 edges from the item defining carry
    output i to every item using carry input i."""
    edges = []
    for i, it in enumerate(items):
        for v in it.invars:
            if v in def_idx:
                edges.append((def_idx[v], i, 0))
    outs, ins = ir.output_leaves(body), ir.placeholders_of(body)
    for ci in range(num_carry):
        d = def_idx.get(outs[ci]) if isinstance(outs[ci], fx.Node) else None
        if d is None:
            continue  # the carry passes through an input untouched
        for u in use_idxs.get(ins[ci], []):
            if u != ir.OUT_SENTINEL:
                edges.append((d, u, 1))
    return sorted(set(edges))


def ddg_from_scan_body(body: fx.GraphModule, num_carry: int,
                       latencies: Mapping[str, int] | None = None) -> DDG:
    """The DDG of a scan body over its items in graph order.
    `num_carry` is the length of the `scan` node's init list."""
    items = ir.items_of(body)
    lat_map = latencies or {}
    lats = [lat_map.get(it.name, DEFAULT_LATENCY) for it in items]
    def_idx, use_idxs = ir.defs_uses(items, ir.outvars_of(body))
    return DDG(lats, loop_edges(items, def_idx, use_idxs, body, num_carry))


def ddg_from_edges(latencies: Sequence[int],
                   edges: Sequence[tuple[int, int, int]]) -> DDG:
    return DDG(list(latencies), list(edges))


def would_increase_ii(ddg: DDG, group: Sequence[int]) -> bool:
    """True if merging `group` (packing the tuple) raises II_min (Fig. 5)."""
    return ddg.with_merged(group).ii_min() > ddg.ii_min()
