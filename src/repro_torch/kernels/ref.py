"""Plain PyTorch versions of the packed quantized matmuls.

Port of `repro/kernels/ref.py` (the serving-path oracles only:
`quant_matmul_ref`, `packed_w4_matmul_ref`, `pack_w4`).  These define the
semantics the Hopper kernels (`csrc/*.cu`) must reproduce bit for bit,
and they serve CPU tensors and the tests.  They stay an independent
statement of the semantics: nothing here reuses `kernels/common.py`.

Exactness on any device: an int32 matmul is not implemented on CUDA, so
the integer GEMM runs as a float64 matmul of the int8-valued operands.
Every product has |a*b| <= 2^14 and every partial sum is an integer of
magnitude <= K * 2^14, which float64 represents exactly while
K * 2^14 < 2^53, i.e. K < 2^39 -- far above any model width.  So the
float64 result, in whatever order the backend sums it, is the exact
int32 accumulator.
"""
from __future__ import annotations

import torch


def _exact_int_matmul(a, b):
    """Exact int32 [M,K] @ [K,N] of int8-valued operands (see module
    docstring for the float64 bound)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def _dequant(acc, x_scale, w_scale, out_dtype):
    # same operation order as the reference: (acc * x_scale) * w_scale
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)


def quant_matmul_acc_ref(x_q, w_q):
    """int8 x_q [M,K] @ int8 w_q [K,N] -> exact int32 [M,N]."""
    return _exact_int_matmul(x_q, w_q)


def quant_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32):
    """w8a8 matmul: dequantized result of the int8 x int8 -> int32 GEMM.

    x_scale: [M,1] or scalar, w_scale: [1,N] or scalar (float32)."""
    return _dequant(quant_matmul_acc_ref(x_q, w_q), x_scale, w_scale,
                    out_dtype)


def _unpack_words(w_packed):
    """[K, N//2] int8 words (w_even + 8) | (w_odd << 4) -> [K, N] int32."""
    w32 = w_packed.to(torch.int32)
    w_even = (w32 & 0xF) - 8           # de-bias the low nibble
    w_odd = w32 >> 4                   # arithmetic shift of the signed byte
    k, n_half = w_packed.shape
    return torch.stack([w_even, w_odd], dim=-1).reshape(k, 2 * n_half)


def packed_w4_matmul_acc_ref(x_q, w_packed):
    """int8 x_q [M,K] @ packed int4 w [K, N//2] -> exact int32 [M,N]."""
    return _exact_int_matmul(x_q, _unpack_words(w_packed))


def packed_w4_matmul_ref(x_q, w_packed, x_scale, w_scale,
                         out_dtype=torch.float32):
    """w4a8 matmul with two int4 weights packed per int8 word: columns
    2j / 2j+1 of the logical [K, N] int4 matrix live in word j."""
    return _dequant(packed_w4_matmul_acc_ref(x_q, w_packed), x_scale,
                    w_scale, out_dtype)


def pack_w4(w_int4):
    """Pack a [..., N] int4-valued (stored int8, range [-8, 7]) tensor into
    [..., N//2] int8 words: word = (w_even + 8) | (w_odd << 4)."""
    if w_int4.shape[-1] % 2:
        raise ValueError(f"pack_w4 needs an even last dim, got "
                         f"{tuple(w_int4.shape)}")
    w = w_int4.to(torch.int32)
    w_even = w[..., 0::2] + 8          # [0, 15]
    w_odd = w[..., 1::2]               # [-8, 7]
    return (w_odd * 16 + w_even).to(torch.int8)   # in [-128, 127]
