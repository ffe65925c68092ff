"""Packed quantized GEMM kernels for Hopper, with their plain versions.

registry        per-op lowering selection (hopper-cuda / ref)
ops             op-level entry points over the registry
quant_matmul    w8a8 GEMM wrapper      -> csrc/quant_matmul.cu
packed_matmul   w4a8 GEMM wrapper      -> csrc/packed_w4_matmul.cu
ref             plain PyTorch versions (the semantics; CPU path)
common          shared launch / unpack helpers
_build          nvcc build + ctypes load of csrc/*.cu at first use
"""
