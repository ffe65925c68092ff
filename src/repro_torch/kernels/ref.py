"""Plain PyTorch versions of the packed quantized matmuls.

Port of `repro/kernels/ref.py`: the SWAR oracles (`simd_add_ref`,
`muladd2_ref`, `mul4_ref`) and the serving-path GEMM oracles
(`quant_matmul_ref`, `packed_w4_matmul_ref`, `pack_w4`).  These define
the semantics the Hopper kernels (`csrc/*.cu`) must reproduce bit for
bit, and they serve CPU tensors and the tests.  They stay an independent
statement of the semantics: nothing here reuses `kernels/common.py`.

The SWAR oracles compute in int32 on the logical (unpacked) operands,
one op per lane, like the reference.

Exactness of the GEMMs on any device: an int32 matmul is not implemented
on CUDA, so the integer GEMM runs as a float64 matmul of the int8-valued
operands.  Every product has |a*b| <= 2^14 and every partial sum is an
integer of magnitude <= K * 2^14, which float64 represents exactly while
K * 2^14 < 2^53, i.e. K < 2^39 -- far above any model width.  So the
float64 result, in whatever order the backend sums it, is the exact
integer sum; it goes to int64 exactly and then to int32 modulo 2^32.
That is the reference's int32 accumulator, which wraps once the sum
leaves the int32 range (from K = 2^17 + 1 with x = w = -128): a direct
float64 -> int32 cast would saturate there instead.

Expert-stacked operands (the MoE family: x [E,M,K], w [E,K,N] or
[E,K,N//2], x_scale [E,M,1], w_scale [E,1,N]) go through the same
statements with one leading axis more, as the reference's `jax.vmap`
maps its kernel: the float64 matmul batches over E (each expert's sums
exact as above), and the dequantization keeps its operation order.  A
stack whose float64 weight copy would pass PLAIN_EXPERT_BYTES is
multiplied one expert at a time (the same exact sums, so the same
bits): a full-width jamba expert stack is 0.94 GB of int8, 7.5 GB as
float64.  A 2-D weight past it is multiplied in column slices into one
preallocated int32 [M, N] result (each output column's sum is its own,
so the slices give the same bits, wrap included); a packed weight is
cut on word boundaries, an even number of logical columns, and each
slice unpacked alone: qwen2-vl-72b's [8192, 152064] head is 1.25 GB of
int8, 9.97 GB as float64.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _i32(x):
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# SILVIAAdd: SWAR SIMD additions / subtractions
# ---------------------------------------------------------------------------

def simd_add_ref(xs: Sequence, ys: Sequence, *, sub: bool = False,
                 lane_bits: int = 8):
    """k independent lane-wise adds (or subs): result_i == (x_i +/- y_i)
    wrapped to `lane_bits` two's complement, as int32 tensors."""
    outs = []
    lo = -(2 ** (lane_bits - 1))
    span = 2 ** lane_bits
    for x, y in zip(xs, ys):
        r = _i32(x) - _i32(y) if sub else _i32(x) + _i32(y)
        outs.append(torch.remainder(r - lo, span) + lo)
    return outs


# ---------------------------------------------------------------------------
# SILVIAMuladd factor-2: two shared-operand MAD chains per unit (wp486)
# ---------------------------------------------------------------------------

def muladd2_ref(a: Sequence, b: Sequence, c: Sequence):
    """(p_a, p_b) = (sum_i a_i * c_i, sum_i b_i * c_i) in int32 (paper
    Eq. 1); a, b, c are length-N sequences of tensors that broadcast."""
    if not (len(a) == len(b) == len(c) and len(a) >= 1):
        raise ValueError(f"muladd2_ref: chains of unequal or zero length "
                         f"({len(a)}, {len(b)}, {len(c)})")
    p_a = sum(_i32(ai) * _i32(ci) for ai, ci in zip(a, c))
    p_b = sum(_i32(bi) * _i32(ci) for bi, ci in zip(b, c))
    return p_a, p_b


# ---------------------------------------------------------------------------
# SILVIAMuladd factor-4: four 4-bit multiplications by one shared factor
# ---------------------------------------------------------------------------

def mul4_ref(a: Sequence, b):
    """p_i = a_i * b for i in 0..3 in int32 (paper Eq. 3)."""
    if len(a) != 4:
        raise ValueError(f"mul4_ref needs 4 operands, got {len(a)}")
    bb = _i32(b)
    return [_i32(ai) * bb for ai in a]


# ---------------------------------------------------------------------------
# Packed quantized matmuls (serving path)
# ---------------------------------------------------------------------------

# the float64 weight copy above which a stack is multiplied an expert at
# a time, and a 2-D weight in column slices
PLAIN_EXPERT_BYTES = 1 << 30


def _per_expert(fn, a, b):
    """fn over the leading (expert) axis of a [E, M, K] and b [E, K, *],
    one expert at a time, into one [E, M, N] int32 result."""
    first = fn(a[0], b[0])
    out = torch.empty((a.shape[0],) + tuple(first.shape),
                      dtype=first.dtype, device=first.device)
    out[0] = first
    for e in range(1, a.shape[0]):
        out[e] = fn(a[e], b[e])
    return out


def _by_columns(fn, a, b, per: int):
    """fn(a, b) for a [M, K] and a 2-D b whose float64 copy (of `per`
    logical columns per stored column) would pass PLAIN_EXPERT_BYTES:
    fn over slices of b's stored columns, each slice's float64 copy at
    most that size, into one int32 [M, per * b.shape[1]] result."""
    k, n = b.shape
    step = max(1, PLAIN_EXPERT_BYTES // (8 * per * k))
    out = torch.empty((a.shape[0], per * n), dtype=torch.int32,
                      device=a.device)
    for c in range(0, n, step):
        out[:, per * c:per * (c + step)] = fn(a, b[:, c:c + step])
    return out


def _f64_matmul(a, b):
    exact = a.to(torch.float64) @ b.to(torch.float64)
    return exact.to(torch.int64).to(torch.int32)


def _exact_int_matmul(a, b):
    """int32 [..., M,K] @ [..., K,N] of int8-valued operands, summed
    exactly and wrapped to int32 as the reference's accumulator is (see
    module docstring for the float64 bound)."""
    if 8 * b.numel() > PLAIN_EXPERT_BYTES:
        if a.ndim == 3:
            return _per_expert(_exact_int_matmul, a, b)
        if a.ndim == 2 and b.ndim == 2:
            return _by_columns(_f64_matmul, a, b, 1)
    return _f64_matmul(a, b)


def _dequant(acc, x_scale, w_scale, out_dtype):
    # same operation order as the reference: (acc * x_scale) * w_scale
    return (acc.to(torch.float32) * x_scale * w_scale).to(out_dtype)


def quant_matmul_acc_ref(x_q, w_q):
    """int8 x_q [M,K] @ int8 w_q [K,N] -> exact int32 [M,N] (or [E,M,K] @
    [E,K,N] -> [E,M,N])."""
    return _exact_int_matmul(x_q, w_q)


def quant_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype=torch.float32):
    """w8a8 matmul: dequantized result of the int8 x int8 -> int32 GEMM.

    x_scale: [M,1] or scalar, w_scale: [1,N] or scalar (float32); with
    expert-stacked operands [E,M,1] and [E,1,N]."""
    return _dequant(quant_matmul_acc_ref(x_q, w_q), x_scale, w_scale,
                    out_dtype)


def _unpack_words(w_packed):
    """[..., K, N//2] int8 words (w_even + 8) | (w_odd << 4) -> [..., K, N]
    int32."""
    w32 = w_packed.to(torch.int32)
    w_even = (w32 & 0xF) - 8           # de-bias the low nibble
    w_odd = w32 >> 4                   # arithmetic shift of the signed byte
    *lead, n_half = w_packed.shape
    return torch.stack([w_even, w_odd], dim=-1).reshape(*lead, 2 * n_half)


def packed_w4_matmul_acc_ref(x_q, w_packed):
    """int8 x_q [M,K] @ packed int4 w [K, N//2] -> exact int32 [M,N] (or
    [E,M,K] @ [E,K,N//2] -> [E,M,N]; a large stack unpacked an expert at
    a time too, a large 2-D weight a slice of words at a time)."""
    if 16 * w_packed.numel() > PLAIN_EXPERT_BYTES:
        if x_q.ndim == 3:
            return _per_expert(packed_w4_matmul_acc_ref, x_q, w_packed)
        if x_q.ndim == 2 and w_packed.ndim == 2:
            return _by_columns(
                lambda a, w: _f64_matmul(a, _unpack_words(w)), x_q,
                w_packed, 2)
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
