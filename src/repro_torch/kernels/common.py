"""Shared helpers for the kernel wrappers.

Port of the pieces of `repro/kernels/common.py` the serving path needs:
`cdiv` and `unpack_w4_words` (the inverse of `ref.pack_w4`, the same
unpack the Hopper w4a8 kernel performs in registers).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def unpack_w4_words(wp):
    """Packed int4 words [..., N//2] int8 -> [..., N] int8 weights
    (interleaved columns; inverse of ref.pack_w4's
    word = (w_even + 8) | (w_odd << 4))."""
    w32 = wp.to(torch.int32)
    w_even = (w32 & 0xF) - 8          # de-bias low nibble -> [-8, 7]
    w_odd = w32 >> 4                  # arithmetic shift -> [-8, 7]
    inter = torch.stack([w_even, w_odd], dim=-1)
    return inter.reshape(*wp.shape[:-1], 2 * wp.shape[-1]).to(torch.int8)


class LaunchCounter:
    """Launches of one kernel wrapper: incremented exactly where the wrapper
    launches its kernel (never on the CPU path), so a run can show that it
    went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def on_cpu(t, counter: LaunchCounter) -> bool:
    """True for a CPU tensor (the wrapper then runs its plain version),
    False for a CUDA one (it launches its kernel); other devices raise."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{counter.name}: unsupported device {t.device}")
    return False


def launch_s8_gemm(fn, counter: LaunchCounter, x_q, w, n: int, x_scale,
                   w_scale, *, want_acc: bool, want_out: bool):
    """Validate operands, allocate outputs and launch one of the int8 GEMM
    kernels (`csrc/quant_matmul.cu` / `csrc/packed_w4_matmul.cu`, bound as
    `fn`) on the current stream.  `w` is the stored weight ([K,N] int8 or
    [K,N//2] packed words), `n` the logical column count.  Returns
    (acc int32 [M,n] or None, out f32 [M,n] or None)."""
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"{counter.name}: kernel launch needs CUDA tensors "
                         f"(got {dev})")
    for name, t in (("x_q", x_q), ("w", w)):
        if t.dtype != torch.int8 or t.ndim != 2 or t.device != dev:
            raise ValueError(f"{counter.name}: {name} must be a 2-D int8 "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    m, k = x_q.shape
    if w.shape[0] != k:
        raise ValueError(f"{counter.name}: K mismatch {tuple(x_q.shape)} @ "
                         f"{tuple(w.shape)}")
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError(f"{counter.name}: shape {(m, k, n)} exceeds the "
                         "kernel's int32 indexing")
    x_q, w = x_q.contiguous(), w.contiguous()
    acc = torch.empty((m, n), dtype=torch.int32, device=dev) \
        if want_acc else None
    out = torch.empty((m, n), dtype=torch.float32, device=dev) \
        if want_out else None
    xs = ws = None
    if want_out:
        for name, s in (("x_scale", x_scale), ("w_scale", w_scale)):
            if s.dtype != torch.float32 or s.device != dev:
                raise ValueError(f"{counter.name}: {name} must be float32 "
                                 f"on {dev}, got {s.dtype} on {s.device}")
        xs = x_scale.expand(m, 1).reshape(m).contiguous()
        ws = w_scale.expand(1, n).reshape(n).contiguous()
    if m == 0 or n == 0:
        return acc, out
    if k == 0:   # empty reduction: nothing to launch, the sum is 0
        for t in (acc, out):
            if t is not None:
                t.zero_()
        return acc, out
    vec_x = k % 16 == 0 and x_q.data_ptr() % 16 == 0
    vec_w = w.shape[1] % 16 == 0 and w.data_ptr() % 16 == 0
    code = fn(x_q.data_ptr(), w.data_ptr(),
              xs.data_ptr() if xs is not None else None,
              ws.data_ptr() if ws is not None else None,
              acc.data_ptr() if acc is not None else None,
              out.data_ptr() if out is not None else None,
              m, k, n, int(vec_x), int(vec_w),
              torch.cuda.current_stream(dev).cuda_stream)
    counter.count += 1
    _build.check(code, counter.name)
    return acc, out


def bind_s8_gemm(lib_name: str, symbol: str):
    """The ctypes function `symbol` of csrc/<lib_name>.cu with its argtypes
    set: every pointer and the stream as c_void_p (a bare Python int would
    be passed as a 32-bit int and cut the pointer)."""
    fn = getattr(_build.load(lib_name), symbol)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
