"""w8a8 GEMM: wrapper of the Hopper kernels in `csrc/quant_matmul.cu`.

Port of `repro/kernels/quant_matmul.py` (`quant_matmul_acc`, the Pallas
TPU kernel, and its dequantizing wrapper `quant_matmul`).  On a CUDA
tensor these launch a kernel (or raise); on a CPU tensor they run the
plain version `kernels/ref.py`, and only then.

Two kernels, by a fixed rule on M (the rows of x):

- M <= SMALL_M (16): the small-M kernel (`csrc/s8_small_m.cuh`, entry
  `repro_quant_matmul_small_m`), a column-split dp4a kernel for decode.
  `torch._int_mm` refuses these rows, and a 64-row tensor-core tile
  would pad them to 64 rows and give a decode launch 3-24 blocks.
- M > 16: the prefill tile (`csrc/s8_tile.cuh`, entry
  `repro_quant_matmul`): mma.sync s8 on a cp.async ring of raw x and
  weight tiles, the weights transposed in registers.

Expert-stacked weights ([E, K, N], the MoE family's experts: the
reference runs `jax.vmap` over the pallas_call, one grid axis more) go
to both kernels' batched entries (`repro_quant_matmul_experts`,
`repro_quant_matmul_small_m_experts`): all E experts in ONE launch, by
the same rule on M, the rows of one expert.  x is [E, M, K], or an
expanded [M, K] whose expert stride is 0 (one x for every expert,
passed uncopied).

`LAUNCHES` counts the launches of both, `SMALL_M_LAUNCHES` those of the
small-M kernel alone; a batched launch counts once.

On CUDA, while traced (`core.optimize`, fake tensors), `quant_matmul`
launches through the custom op `repro_torch::quant_matmul`, which has a
fake implementation: the graph holds each launch as one opaque node, as
the reference's jaxpr holds one `pallas_call`, and nothing reaches a
data pointer while tracing.  Run eagerly, it launches directly
(`common.tracing`).  The plain version on the CPU is plain torch ops and
traces through.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common, ref

# the kernels as the profiler names them (common.LaunchCounter)
_SMALL_M_SYMBOL = r"\bsmall_m_kernel<[^>]*LoadW8Word\b"
LAUNCHES = common.LaunchCounter(
    "quant_matmul", _SMALL_M_SYMBOL + r"|\btile_kernel<[\w:]*TileW8,")
SMALL_M_LAUNCHES = common.LaunchCounter("quant_matmul_small_m",
                                        _SMALL_M_SYMBOL)

SMALL_M = 16


@functools.cache
def _kernel():
    return common.bind("quant_matmul", "repro_quant_matmul", 6, 5)


@functools.cache
def _small_m_kernel():
    return common.bind("quant_matmul", "repro_quant_matmul_small_m", 6, 5)


@functools.cache
def _experts_kernel():
    return common.bind("quant_matmul", "repro_quant_matmul_experts", 6, 7)


@functools.cache
def _small_m_experts_kernel():
    return common.bind("quant_matmul", "repro_quant_matmul_small_m_experts",
                       6, 7)


def _launch(x_q, w_q, x_scale, w_scale, *, want_acc: bool, want_out: bool):
    """Launch the kernel the rule picks for x_q's rows (module doc); a
    3-D w_q takes the batched entry of that kernel."""
    experts = w_q.ndim == 3
    if x_q.ndim >= 2 and x_q.shape[-2] <= SMALL_M:
        fn = _small_m_experts_kernel() if experts else _small_m_kernel()
        return common.launch_gemm(
            fn, LAUNCHES, x_q, w_q, w_q.shape[-1], x_scale, w_scale,
            want_acc=want_acc, want_out=want_out, vec_bytes=4,
            also=SMALL_M_LAUNCHES)
    return common.launch_gemm(_experts_kernel() if experts else _kernel(),
                              LAUNCHES, x_q, w_q, w_q.shape[-1], x_scale,
                              w_scale, want_acc=want_acc,
                              want_out=want_out)


def quant_matmul_acc(x_q, w_q):
    """int8 [M,K] @ int8 [K,N] -> int32 [M,N] accumulator; expert-stacked,
    [E,M,K] @ [E,K,N] -> [E,M,N] in one launch."""
    if common.on_cpu(x_q, LAUNCHES):
        return ref.quant_matmul_acc_ref(x_q, w_q)
    acc, _ = _launch(x_q, w_q, None, None, want_acc=True, want_out=False)
    return acc


@torch.library.custom_op("repro_torch::quant_matmul", mutates_args=())
def _quant_matmul_op(x_q: torch.Tensor, w_q: torch.Tensor,
                     x_scale: torch.Tensor,
                     w_scale: torch.Tensor) -> torch.Tensor:
    _, out = _launch(x_q, w_q, x_scale, w_scale, want_acc=False,
                     want_out=True)
    return out


@_quant_matmul_op.register_fake
def _quant_matmul_fake(x_q, w_q, x_scale, w_scale):
    return x_q.new_empty((*w_q.shape[:-2], x_q.shape[-2], w_q.shape[-1]),
                         dtype=torch.float32)


def quant_matmul(x_q, w_q, x_scale, w_scale, *, out_dtype=torch.float32):
    """((acc.float() * x_scale) * w_scale).to(out_dtype), the dequant
    epilogue fused into the kernel (bit-identical to the plain version);
    x_scale [M,1], w_scale [1,N], or [E,M,1] and [E,1,N] with
    expert-stacked weights."""
    if common.on_cpu(x_q, LAUNCHES):
        return ref.quant_matmul_ref(x_q, w_q, x_scale, w_scale, out_dtype)
    if common.tracing(x_q):
        return _quant_matmul_op(x_q, w_q, x_scale, w_scale).to(out_dtype)
    _, out = _launch(x_q, w_q, x_scale, w_scale, want_acc=False,
                     want_out=True)
    return out.to(out_dtype)
