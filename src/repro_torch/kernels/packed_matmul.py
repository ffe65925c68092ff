"""w4a8 packed-weight GEMM: wrapper of the Hopper kernel
`csrc/packed_w4_matmul.cu`.

Port of `repro/kernels/packed_matmul.py` (`packed_w4_matmul_acc`, the
Pallas TPU kernel, and its dequantizing wrapper `packed_w4_matmul`).  Two
int4 weights live in each int8 word (`ref.pack_w4` layout), halving the
weight bytes that decode has to move; the kernel unpacks them in
registers.  On a CUDA tensor these launch the kernel (or raise); on a CPU
tensor they run the plain version `kernels/ref.py`, and only then.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common, ref

LAUNCHES = common.LaunchCounter("packed_w4_matmul")


@functools.cache
def _kernel():
    return common.bind("packed_w4_matmul", "repro_packed_w4_matmul", 6,
                       5)


def packed_w4_matmul_acc(x_q, w_packed):
    """int8 [M,K] @ packed int4 [K,N] (stored int8 [K,N//2]) -> int32."""
    if common.on_cpu(x_q, LAUNCHES):
        return ref.packed_w4_matmul_acc_ref(x_q, w_packed)
    acc, _ = common.launch_s8_gemm(_kernel(), LAUNCHES, x_q, w_packed,
                                   2 * w_packed.shape[1], None, None,
                                   want_acc=True, want_out=False)
    return acc


def packed_w4_matmul(x_q, w_packed, x_scale, w_scale, *,
                     out_dtype=torch.float32):
    """((acc.float() * x_scale) * w_scale).to(out_dtype), the dequant
    epilogue fused into the kernel (bit-identical to the plain version)."""
    if common.on_cpu(x_q, LAUNCHES):
        return ref.packed_w4_matmul_ref(x_q, w_packed, x_scale, w_scale,
                                        out_dtype)
    _, out = common.launch_s8_gemm(_kernel(), LAUNCHES, x_q, w_packed,
                                   2 * w_packed.shape[1], x_scale, w_scale,
                                   want_acc=False, want_out=True)
    return out.to(out_dtype)
