"""SWAR SIMD add/sub: wrapper of the Hopper kernel `csrc/simd_add.cu`.

Port of `repro/kernels/simd_add.py` (`simd_add_packed`, the Pallas TPU
kernel, and its unpacked-operand entry point `simd_add`) -- SILVIAAdd's
packed unit.  One 32-bit word op adds four 8-bit or two 16-bit lanes
(carry-kill SWAR, see the kernel source).  Words are int32 tensors
holding the uint32 bit patterns (`common.pack_lanes`).  On a CUDA tensor
these launch the kernel (or raise); on a CPU tensor they run the plain
version, and only then.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, common, ref

LAUNCHES = common.LaunchCounter("simd_add_packed",
                                 r"\bsimd_add_kernel\b")


@functools.cache
def _kernel():
    return common.bind("simd_add", "repro_simd_add_packed", 3, 4)


def _check_lane_bits(lane_bits: int) -> None:
    if lane_bits not in (8, 16):
        raise ValueError(f"simd_add: lane_bits must be 8 or 16, got "
                         f"{lane_bits}")


def simd_add_packed_plain(x_packed, y_packed, *, lane_bits: int = 8,
                          sub: bool = False):
    """The plain version on words: unpack the lanes, the oracle's
    lane-wrapped add/sub, pack again."""
    _check_lane_bits(lane_bits)
    xs = common.unpack_lanes(x_packed, lane_bits)
    ys = common.unpack_lanes(y_packed, lane_bits)
    return common.pack_lanes(
        ref.simd_add_ref(xs, ys, sub=sub, lane_bits=lane_bits), lane_bits)


def simd_add_packed(x_packed, y_packed, *, lane_bits: int = 8,
                    sub: bool = False):
    """Lane-wise add/sub of two int32 word tensors of one shape."""
    _check_lane_bits(lane_bits)
    if common.on_cpu(x_packed, LAUNCHES):
        return simd_add_packed_plain(x_packed, y_packed,
                                     lane_bits=lane_bits, sub=sub)
    dev = common.check_cuda_operands(LAUNCHES,
                                     x_packed=(x_packed, torch.int32),
                                     y_packed=(y_packed, torch.int32))
    if x_packed.shape != y_packed.shape:
        raise ValueError(f"{LAUNCHES.name}: shapes {tuple(x_packed.shape)} "
                         f"and {tuple(y_packed.shape)} differ")
    x, y = x_packed.contiguous(), y_packed.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    vec = all(t.data_ptr() % 16 == 0 for t in (x, y, out))
    code = _kernel()(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
                     lane_bits, int(sub), int(vec),
                     torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES.launched(x, y, lane_bits=lane_bits, sub=sub)
    _build.check(code, LAUNCHES.name)
    return out


def simd_add(xs, ys, *, lane_bits: int = 8, sub: bool = False):
    """Unpacked-operand entry point: k <= 32//lane_bits narrow tensors of
    one shape per side are packed into words (unused lanes zero), added
    by the packed kernel and unpacked; returns k int32 tensors."""
    return common.simd_add_lanes(
        lambda xw, yw: simd_add_packed(xw, yw, lane_bits=lane_bits,
                                       sub=sub),
        xs, ys, lane_bits)
