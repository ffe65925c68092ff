"""w8a8 GEMM: wrapper of the Hopper kernel `csrc/quant_matmul.cu`.

Port of `repro/kernels/quant_matmul.py` (`quant_matmul_acc`, the Pallas
TPU kernel, and its dequantizing wrapper `quant_matmul`).  On a CUDA
tensor these launch the kernel (or raise); on a CPU tensor they run the
plain version `kernels/ref.py`, and only then.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common, ref

LAUNCHES = common.LaunchCounter("quant_matmul")


@functools.cache
def _kernel():
    return common.bind("quant_matmul", "repro_quant_matmul", 6, 5)


def quant_matmul_acc(x_q, w_q):
    """int8 [M,K] @ int8 [K,N] -> int32 [M,N] accumulator."""
    if common.on_cpu(x_q, LAUNCHES):
        return ref.quant_matmul_acc_ref(x_q, w_q)
    acc, _ = common.launch_s8_gemm(_kernel(), LAUNCHES, x_q, w_q,
                                   w_q.shape[1], None, None,
                                   want_acc=True, want_out=False)
    return acc


def quant_matmul(x_q, w_q, x_scale, w_scale, *, out_dtype=torch.float32):
    """((acc.float() * x_scale) * w_scale).to(out_dtype), the dequant
    epilogue fused into the kernel (bit-identical to the plain version)."""
    if common.on_cpu(x_q, LAUNCHES):
        return ref.quant_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)
    _, out = common.launch_s8_gemm(_kernel(), LAUNCHES, x_q, w_q,
                                   w_q.shape[1], x_scale, w_scale,
                                   want_acc=False, want_out=True)
    return out.to(out_dtype)
