"""Feed-forward layers (port of `repro/models/mlp.py`): the dense SwiGLU
MLP.  The GELU variant and MoE arrive with the families that use them."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.quant.qtensor import qmatmul


def mlp(p, x, cfg: ModelConfig):
    if cfg.activation != "swiglu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported yet")
    return qmatmul(F.silu(qmatmul(x, p["wg"])) * qmatmul(x, p["wi"]),
                   p["wo"])
