"""Quantized linear layers for the serving path.

Port of `repro/quant/linear.py`.  Three weight formats, selected by
`fmt`:

  "w8a8"        int8 weights [K, N] + per-column scales; int8 dynamic
                activation quantization; the w8a8 GEMM
                (kernels/quant_matmul.py).
  "w4a8"        int4 weights packed two per int8 word [K, N//2]
                (kernels/packed_matmul.py): half the weight bytes.
  "bf16"        no quantization: bf16 operands, float32 accumulation.

`quant_linear` is shape-polymorphic over leading batch dims.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import registry
from repro_torch.quant.quantize import pack_int4, quantize


@dataclasses.dataclass
class QuantLinearParams:
    fmt: str
    w: Any              # bf16 [K,N] | int8 [K,N] | packed int8 [K,N//2]
    w_scale: Any        # f32 [1,N] (quantized formats)
    bias: Any = None


def quantize_linear_params(w, fmt: str, bias=None) -> QuantLinearParams:
    """Offline weight quantization (per-output-channel scales)."""
    if fmt == "bf16":
        return QuantLinearParams(fmt, w.to(torch.bfloat16), None, bias)
    if fmt == "w8a8":
        q, s = quantize(w, bits=8, axis=1)
        return QuantLinearParams(fmt, q, s.reshape(1, -1), bias)
    if fmt == "w4a8":
        q, s = quantize(w, bits=4, axis=1)
        return QuantLinearParams(fmt, pack_int4(q), s.reshape(1, -1), bias)
    raise ValueError(fmt)


def quant_linear(x, p: QuantLinearParams):
    """x: [..., K] float -> [..., N] float32.  The bias, if any, is added
    to the float32 result."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if p.fmt == "bf16":
        # the reference's jnp.dot(..., preferred_element_type=float32):
        # bf16 operands, products summed in float32 with no bf16 rounding
        y = x2.to(torch.bfloat16).to(torch.float32) @ p.w.to(torch.float32)
    else:
        x_q, x_s = quantize(x2, bits=8, axis=0)
        op = "quant_matmul" if p.fmt == "w8a8" else "packed_w4_matmul"
        y = registry.dispatch(op, x_q, p.w, x_s, p.w_scale)
    if p.bias is not None:
        y = y + p.bias
    return y.reshape(*lead, y.shape[-1])
