"""Symmetric integer quantization + int4 packing.

Port of `repro/quant/quantize.py`.  int8 tensors store int8 values; int4
tensors store values in [-8, 7] inside int8 words; scales are float32,
shaped for broadcast against the quantized axis.  The reference tags
int4 values with `core.prims.width_hint` for the SILVIA width analysis;
the port has no such analysis yet, so `width_hint` is a no-op marker.

The arithmetic follows the reference step for step, because activation
quantization sits on every GEMM and one flipped int8 step moves a logit.
The reference computes its scale in two forms, and the port has both:

* `quantize` is the EAGER form (op by op, as the reference quantizes its
  weights, outside jit): `amax / qmax + eps` runs in the INPUT's dtype
  (bf16 on the serving path, with eps rounded to that dtype first, as
  JAX's weak typing does) before the cast to float32.
* `quantize_compiled` is the form XLA compiles that same code to, which
  is what the reference serves for every activation (its layers run
  inside `lax.scan`, and decode under jit): float32 input,
  `fma(amax, float32(1/127), eps)` (the divide becomes a multiply by the
  reciprocal, fused with the add: one rounding); bf16 input, the divide
  rounded to bf16 and then `+ bf16(eps)` in float32 (XLA drops the bf16
  rounding of the add before the convert).

In both, `x / scale` then runs in float32 and rounding is half-to-even
(`torch.round`, never floor(x + 0.5)).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref as kref

# float32(1 / 127) and float32(1e-8), the constants of the reference's
# compiled int8 scale (`fma(amax, float32(1/127), 1e-8)`), as Python
# floats (float64): in float64 the product of a float32 amax by _INV_127
# is exact, so adding _EPS_1E8 and rounding once to float32 is the FMA
# (but for a double rounding, at odds of ~2^-29 a value)
_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))
_EPS_1E8 = float(torch.tensor(1e-8, dtype=torch.float32))


def width_hint(x, bits: int):
    """No-op marker: the value range of `x` fits in `bits` bits."""
    del bits
    return x


@functools.cache
def _eps_in(dtype: torch.dtype, eps: float) -> float:
    # a Python float added to a bf16 tensor is applied in float32 by
    # PyTorch; rounding it to the tensor's dtype first matches the
    # reference's weak-typed constant exactly
    return float(torch.tensor(eps, dtype=dtype))


def quantize(x, bits: int = 8, axis=None, eps: float = 1e-8):
    """Symmetric quantization: returns (q int8, scale f32).

    axis=None -> per-tensor scale; axis=k -> per-slice scales along k
    (scale shape keeps that axis, 1 elsewhere)."""
    qmax = 2 ** (bits - 1) - 1
    amax = _amax(x, axis)
    scale = (amax / qmax + _eps_in(x.dtype, eps)).to(torch.float32)
    # promote explicitly: PyTorch would keep a bf16 x in bf16 against a
    # 0-dim float32 scale, where the reference divides in float32
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax).to(torch.int8)
    if bits < 8:
        q = width_hint(q, bits)
    return q, scale


def _amax(x, axis):
    if axis is None:
        return x.abs().amax()
    reduce_dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    return x.abs().amax(dim=reduce_dims, keepdim=True)


def quantize_compiled(x2):
    """Per-row int8 quantization of x2 [M, K], `quantize(x2, 8, axis=0)`
    in the form the reference serves activations in: the scale as XLA
    compiles it (module docstring), bit for bit with
    `jax.jit(repro.quant.quantize.quantize)` and with `quantize` inside a
    `lax.scan`, for float32 and bf16 input.  Returns (q int8 [M, K],
    scale f32 [M, 1])."""
    amax = _amax(x2, 0)
    if x2.dtype == torch.float32:
        scale = (amax.to(torch.float64) * _INV_127 + _EPS_1E8).to(
            torch.float32)
    else:
        scale = (amax / 127).to(torch.float32) + _eps_in(x2.dtype, 1e-8)
    q = torch.clamp(torch.round(x2.to(torch.float32) / scale), -128, 127)
    return q.to(torch.int8), scale


def quantize_int4(x, axis=None):
    return quantize(x, bits=4, axis=axis)


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def pack_int4(q4):
    """[..., N] int4-valued int8 -> [..., N//2] packed int8 words."""
    return kref.pack_w4(q4)


def unpack_int4(packed):
    """[..., N//2] packed int8 words -> [..., N] int4-valued int8."""
    w32 = packed.to(torch.int32)
    even = (w32 & 0xF) - 8
    odd = w32 >> 4
    out = torch.stack([even, odd], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)
    return width_hint(out, 4)
