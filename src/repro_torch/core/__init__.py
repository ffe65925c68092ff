"""SILVIA over torch.fx: automated superword-level packing passes.

Port of `repro/core`, the paper's contribution as a composable module:

    from repro_torch import core as silvia

    fast = silvia.optimize(fn, [silvia.PassConfig(op="muladd"),
                                silvia.PassConfig(op="add", op_size=8)])

`fast` traces `fn` once per input signature with `make_fx`, packs its
narrow integer operations into packed calls (`core/prims.py`) and runs
the rewritten graph eagerly; each packed call binds through the lowering
registry to a Hopper kernel on CUDA operands, to its plain version on
CPU ones.
"""
from repro_torch.core import bounds, ddg, dce, ir, opcount, prims
from repro_torch.core.pipeline import (DEFAULT_PASSES, PassConfig, optimize,
                                       optimize_graph, optimized_graph,
                                       trace)
from repro_torch.core.prims import width_hint
from repro_torch.core.silvia import SILVIA
from repro_torch.core.silvia_add import SILVIAAdd
from repro_torch.core.silvia_muladd import SILVIAMul4, SILVIAMuladd

__all__ = [
    "DEFAULT_PASSES", "PassConfig", "SILVIA", "SILVIAAdd", "SILVIAMul4",
    "SILVIAMuladd", "bounds", "ddg", "dce", "ir", "opcount", "optimize",
    "optimize_graph", "optimized_graph", "prims", "trace", "width_hint",
]
