"""Packed kernels for Hopper, with their plain versions.

registry        per-op lowering selection (hopper-cuda / ref)
ops             op-level entry points over the registry
simd_add        SWAR add/sub wrapper   -> csrc/simd_add.cu
muladd2         factor-2 MAD wrapper   -> csrc/muladd2.cu
mul4            factor-4 mul wrappers  -> csrc/mul4.cu (full32, split)
quant_matmul    w8a8 GEMM wrapper      -> csrc/quant_matmul.cu
packed_matmul   w4a8 GEMM wrapper      -> csrc/packed_w4_matmul.cu
                (both: M <= 16 on csrc/s8_small_m.cuh, M > 16 on
                csrc/s8_tile.cuh, each with its weight loader)
ref             plain PyTorch versions (the semantics; CPU path)
common          shared launch / lane packing / unpack helpers
_build          nvcc build + ctypes load of csrc/*.cu at first use
"""
