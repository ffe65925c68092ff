"""w4a8 packed-weight GEMM: wrapper of the Hopper kernels in
`csrc/packed_w4_matmul.cu`.

Port of `repro/kernels/packed_matmul.py` (`packed_w4_matmul_acc`, the
Pallas TPU kernel, and its dequantizing wrapper `packed_w4_matmul`).  Two
int4 weights live in each int8 word (`ref.pack_w4` layout), halving the
weight bytes that decode has to move; the kernels unpack them in
registers.  On a CUDA tensor these launch a kernel (or raise); on a CPU
tensor they run the plain version `kernels/ref.py`, and only then.

Two kernels, by the rule of `quant_matmul` on M (the rows of x):

- M <= quant_matmul.SMALL_M (16): the small-M kernel
  (`csrc/s8_small_m.cuh` with its packed-int4 loader `LoadW4Word`, entry
  `repro_packed_w4_matmul_small_m`), the column-split dp4a kernel that
  w8a8 decode runs on.
- M > 16: the prefill tile of w8a8 (`csrc/s8_tile.cuh`, entry
  `repro_packed_w4_matmul`) with its packed loader `TileW4`: the packed
  bytes staged raw through the cp.async ring and unpacked in registers
  at the fragment reads.

Expert-stacked weights ([E, K, N//2]) go to both kernels' batched
entries (`repro_packed_w4_matmul_experts`,
`repro_packed_w4_matmul_small_m_experts`), all E experts in one launch,
as in `quant_matmul`.

`LAUNCHES` counts the launches of both, `SMALL_M_LAUNCHES` those of the
small-M kernel alone; a batched launch counts once.  On CUDA, while
traced, `packed_w4_matmul` launches through the custom op
`repro_torch::packed_w4_matmul` (fake implementation: one opaque node in
a traced graph), and eagerly it launches directly, as `quant_matmul`
does.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common, quant_matmul, ref

# the kernels as the profiler names them (common.LaunchCounter)
_SMALL_M_SYMBOL = r"\bsmall_m_kernel<[^>]*LoadW4Word\b"
LAUNCHES = common.LaunchCounter(
    "packed_w4_matmul", _SMALL_M_SYMBOL + r"|\btile_kernel<[\w:]*TileW4,")
SMALL_M_LAUNCHES = common.LaunchCounter("packed_w4_matmul_small_m",
                                        _SMALL_M_SYMBOL)


@functools.cache
def _kernel():
    return common.bind("packed_w4_matmul", "repro_packed_w4_matmul", 6,
                       5)


@functools.cache
def _small_m_kernel():
    return common.bind("packed_w4_matmul", "repro_packed_w4_matmul_small_m",
                       6, 5)


@functools.cache
def _experts_kernel():
    return common.bind("packed_w4_matmul", "repro_packed_w4_matmul_experts",
                       6, 7)


@functools.cache
def _small_m_experts_kernel():
    return common.bind("packed_w4_matmul",
                       "repro_packed_w4_matmul_small_m_experts", 6, 7)


def _launch(x_q, w_packed, x_scale, w_scale, *, want_acc: bool,
            want_out: bool):
    """Launch the kernel the rule picks for x_q's rows (module doc); a
    3-D w_packed takes the batched entry of that kernel."""
    n = 2 * w_packed.shape[-1]
    experts = w_packed.ndim == 3
    if x_q.ndim >= 2 and x_q.shape[-2] <= quant_matmul.SMALL_M:
        # the kernel's 2-byte packed-w loads need only N/2 even and a
        # 2-byte aligned w; asking 4 of both operands takes the byte path
        # more often (never on the serving shapes) with one rule for both
        fn = _small_m_experts_kernel() if experts else _small_m_kernel()
        return common.launch_gemm(
            fn, LAUNCHES, x_q, w_packed, n, x_scale, w_scale,
            want_acc=want_acc, want_out=want_out, vec_bytes=4,
            also=SMALL_M_LAUNCHES)
    return common.launch_gemm(_experts_kernel() if experts else _kernel(),
                              LAUNCHES, x_q, w_packed, n, x_scale, w_scale,
                              want_acc=want_acc, want_out=want_out)


def packed_w4_matmul_acc(x_q, w_packed):
    """int8 [M,K] @ packed int4 [K,N] (stored int8 [K,N//2]) -> int32;
    expert-stacked, [E,M,K] @ [E,K,N//2] -> [E,M,N] in one launch."""
    if common.on_cpu(x_q, LAUNCHES):
        return ref.packed_w4_matmul_acc_ref(x_q, w_packed)
    acc, _ = _launch(x_q, w_packed, None, None, want_acc=True,
                     want_out=False)
    return acc


@torch.library.custom_op("repro_torch::packed_w4_matmul", mutates_args=())
def _packed_w4_matmul_op(x_q: torch.Tensor, w_packed: torch.Tensor,
                         x_scale: torch.Tensor,
                         w_scale: torch.Tensor) -> torch.Tensor:
    _, out = _launch(x_q, w_packed, x_scale, w_scale, want_acc=False,
                     want_out=True)
    return out


@_packed_w4_matmul_op.register_fake
def _packed_w4_matmul_fake(x_q, w_packed, x_scale, w_scale):
    return x_q.new_empty((*w_packed.shape[:-2], x_q.shape[-2],
                          2 * w_packed.shape[-1]), dtype=torch.float32)


def packed_w4_matmul(x_q, w_packed, x_scale, w_scale, *,
                     out_dtype=torch.float32):
    """((acc.float() * x_scale) * w_scale).to(out_dtype), the dequant
    epilogue fused into the kernel (bit-identical to the plain version)."""
    if common.on_cpu(x_q, LAUNCHES):
        return ref.packed_w4_matmul_ref(x_q, w_packed, x_scale, w_scale,
                                        out_dtype)
    if common.tracing(x_q):
        return _packed_w4_matmul_op(x_q, w_packed, x_scale,
                                    w_scale).to(out_dtype)
    _, out = _launch(x_q, w_packed, x_scale, w_scale, want_acc=False,
                     want_out=True)
    return out.to(out_dtype)
