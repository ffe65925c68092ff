"""Op-level entry points over the lowering registry (port of
`repro/kernels/ops.py`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import registry


def simd_add(xs, ys, *, lane_bits: int = 8, sub: bool = False):
    return registry.dispatch("simd_add", xs, ys, lane_bits=lane_bits,
                             sub=sub)


def muladd2(a, b, c):
    """Chain MAD: sequences a/b/c of tensors -> (p_a, p_b) int32."""
    return registry.dispatch("muladd2", a, b, c)


def mul4(a, b):
    return registry.dispatch("mul4", a, b)


def quant_matmul(x_q, w_q, x_scale, w_scale, *, out_dtype=torch.float32):
    return registry.dispatch("quant_matmul", x_q, w_q, x_scale, w_scale,
                             out_dtype=out_dtype)


def packed_w4_matmul(x_q, w_packed, x_scale, w_scale, *,
                     out_dtype=torch.float32):
    return registry.dispatch("packed_w4_matmul", x_q, w_packed, x_scale,
                             w_scale, out_dtype=out_dtype)
