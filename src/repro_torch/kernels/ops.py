"""Op-level entry points over the lowering registry (port of
`repro/kernels/ops.py`, the two GEMM ops only)."""
from __future__ import annotations

import torch

from repro_torch.kernels import registry


def quant_matmul(x_q, w_q, x_scale, w_scale, *, out_dtype=torch.float32):
    return registry.dispatch("quant_matmul", x_q, w_q, x_scale, w_scale,
                             out_dtype=out_dtype)


def packed_w4_matmul(x_q, w_packed, x_scale, w_scale, *,
                     out_dtype=torch.float32):
    return registry.dispatch("packed_w4_matmul", x_q, w_packed, x_scale,
                             w_scale, out_dtype=out_dtype)
