"""Factor-4 4-bit multiplications: wrappers of the Hopper kernels in
`csrc/mul4.cu`.

Port of `repro/kernels/mul4.py` (paper sec. 2.3), both Pallas TPU
kernels:

* `mul4_full32` -- four 4-bit a_i at offsets 0/8/16/24 of one 32-bit
  word, one multiply by the shared b, lanes recovered with sign borrows
  (the registered `mul4` lowering);
* `mul4_split` -- the paper-faithful 27-bit-port layout of Fig. 3 with
  the Eq. 4 patch of the top product (not registered, as in the
  reference).

Both compute p_i = a_i * b exactly for 4-bit operands; `signed=False`
only where every a_i and b is non-negative.  On a CUDA tensor they
launch their kernel (or raise); on a CPU tensor they run the plain
version, and only then.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build, common, ref

LAUNCHES = common.LaunchCounter("mul4_full32", r"\bmul4_kernel<false\b")
SPLIT_LAUNCHES = common.LaunchCounter("mul4_split",
                                     r"\bmul4_split_kernel<")
# elements of one vector step of each kernel (csrc/mul4.cu: full32's
# swar::PER_THREAD, split's GROUP)
VEC_ELEMS = {"repro_mul4_full32": 16, "repro_mul4_split": 4}


@functools.cache
def _kernel(symbol: str):
    return common.bind("mul4", symbol, 3, 3)


def mul4_plain(a, b):
    """The plain version: the oracle over the four stacked a rows."""
    return ref.mul4_ref(a.unbind(0), b)


def vector_path(symbol: str, e: int, ptrs) -> bool:
    """The kernel's `vec` flag: e a multiple of its vector step and every
    pointer (a, b, out) 16-byte aligned."""
    return e % VEC_ELEMS[symbol] == 0 and all(p % 16 == 0 for p in ptrs)


def _run(symbol, counter, a, b, signed):
    if a.ndim < 1 or a.shape[0] != 4 or a.shape[1:] != b.shape:
        raise ValueError(f"{counter.name}: need a (4, ...) and b (...) of "
                         f"one inner shape, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if common.on_cpu(a, counter):
        return mul4_plain(a, b)
    dev = common.check_cuda_operands(counter, a=(a, torch.int8),
                                     b=(b, torch.int8))
    e = math.prod(b.shape)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((4, *b.shape), dtype=torch.int32, device=dev)
    if e > 0:
        vec = vector_path(symbol, e, (t.data_ptr() for t in (a, b, out)))
        code = _kernel(symbol)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               e, int(signed), int(vec),
                               torch.cuda.current_stream(dev).cuda_stream)
        counter.launched(a, b, signed=signed)
        _build.check(code, counter.name)
    return list(out.unbind(0))


def mul4_full32(a, b, *, signed: bool = True):
    """a: (4, ...) 4-bit-valued int8; b: (...) 4-bit-valued int8.
    Returns [p0..p3] int32 (full 32-bit-lane layout)."""
    return _run("repro_mul4_full32", LAUNCHES, a, b, signed)


def mul4_split(a, b, *, signed: bool = True):
    """The paper's Fig. 3 / Eq. 4 variant (27-bit port + correction)."""
    return _run("repro_mul4_split", SPLIT_LAUNCHES, a, b, signed)
