"""Ops/Unit metric -- the paper's Table 1 headline metric.

Port of `repro/core/opcount.py`.  "The operation density (Ops/Unit) is
defined as the ratio between the number of arithmetic operations and the
number of functional units computing them, at the IR level."  Here an
IR-level operation is an ATen `mul` / `add` / `sub` node of the traced
graph; a packed call (`prims.PACKED_PRIMS`) is ONE functional unit
computing k logical narrow ops.  Counting recurses into the bodies that
`get_attr` nodes name (a rolled scan body counts once, like a rolled loop
in LLVM IR), once per body node that uses one.
"""
from __future__ import annotations

import dataclasses

from torch import fx

from repro_torch.core import ir, prims

_MUL_PRIMS = {"mul"}
_ADD_PRIMS = {"add", "sub"}


@dataclasses.dataclass
class OpCount:
    mul_ops: int = 0        # logical multiplications
    add_ops: int = 0        # logical additions/subtractions
    mul_units: int = 0      # units computing multiplications
    add_units: int = 0      # units computing additions
    packed_units: int = 0   # packed units (the "DSP count" analogue)
    madd_units: int = 0     # units computing both (packed MADs)

    @property
    def mul_density(self) -> float:
        u = self.mul_units
        return self.mul_ops / u if u else 0.0

    @property
    def add_density(self) -> float:
        u = self.add_units
        return self.add_ops / u if u else 0.0

    @property
    def units(self) -> int:
        return self.mul_units + self.add_units + self.madd_units

    def merged(self, other: "OpCount") -> "OpCount":
        return OpCount(*[a + b for a, b in
                         zip(dataclasses.astuple(self),
                             dataclasses.astuple(other))])


def count_ops(gm: fx.GraphModule, int_only: bool = True) -> OpCount:
    c = OpCount()
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            sub = ir.attr_of(gm, node.target)
            if isinstance(sub, fx.GraphModule):
                for _ in node.users:
                    c = c.merged(count_ops(sub, int_only))
            continue
        if node.op != "call_function":
            continue
        if node.target in prims.PACKED_PRIMS:
            k = prims.packed_op_counts(node)
            c.packed_units += 1
            c.mul_ops += k["mul"]
            c.add_ops += k["add"]
            if k["mul"]:
                c.mul_units += 1
            if k["add"] and not k["mul"]:
                c.add_units += 1
            if k["mul"] and k["add"]:
                c.madd_units += 1
            continue
        name = ir.prim_name(node)
        if name in _MUL_PRIMS or name in _ADD_PRIMS:
            if int_only and not ir.is_int_dtype(ir.dtype_of(node)):
                continue
            if name in _MUL_PRIMS:
                c.mul_ops += 1
                c.mul_units += 1
            else:
                c.add_ops += 1
                c.add_units += 1
    return c


def density_report(before: OpCount, after: OpCount) -> dict:
    """Paper Table 1 row: Ops/Unit and unit counts, baseline vs SILVIA."""
    return {
        "ops_per_unit_mul_baseline": round(before.mul_density, 2),
        "ops_per_unit_mul_silvia": round(after.mul_density, 2),
        "ops_per_unit_add_baseline": round(before.add_density, 2),
        "ops_per_unit_add_silvia": round(after.add_density, 2),
        "units_baseline": before.units,
        "units_silvia": after.units,
        "unit_reduction": round(1 - after.units / before.units, 3)
        if before.units else 0.0,
    }
