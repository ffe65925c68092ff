"""Factor-2 shared-operand MAD chains: wrapper of the Hopper kernel
`csrc/muladd2.cu`.

Port of `repro/kernels/muladd2.py` (`muladd2`, the Pallas TPU kernel) --
SILVIAMuladd's packed unit: p_a = sum a_i*c_i and p_b = sum b_i*c_i with
one 32-bit multiply per chain element (wp486, see the kernel source).
The caller keeps the chain length within the Eq. 2 bound
(`core/bounds.py`); beyond it the low lane overflows into the high one,
as it would on the DSP.  On a CUDA tensor this launches the kernel (or
raises); on a CPU tensor it runs the plain version, and only then.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build, common, ref

LAUNCHES = common.LaunchCounter("muladd2", r"\bmuladd2_kernel\b")


@functools.cache
def _kernel():
    return common.bind("muladd2", "repro_muladd2", 5, 3)


def muladd2_plain(a, b, c):
    """The plain version: the oracle over the stacked chain rows."""
    return ref.muladd2_ref(a.unbind(0), b.unbind(0), c.unbind(0))


def muladd2(a, b, c):
    """a, b, c: stacked (n, ...) int8 chains of one shape.  Returns
    (p_a, p_b), int32 tensors of shape (...)."""
    if not (a.shape == b.shape == c.shape) or a.ndim < 1 or a.shape[0] < 1:
        raise ValueError(f"{LAUNCHES.name}: need three (n>=1, ...) stacks "
                         f"of one shape, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if common.on_cpu(a, LAUNCHES):
        return muladd2_plain(a, b, c)
    dev = common.check_cuda_operands(LAUNCHES, a=(a, torch.int8),
                                     b=(b, torch.int8), c=(c, torch.int8))
    n, inner = a.shape[0], a.shape[1:]
    e = math.prod(inner)
    a, b, c = a.contiguous(), b.contiguous(), c.contiguous()
    pa = torch.empty(inner, dtype=torch.int32, device=dev)
    pb = torch.empty(inner, dtype=torch.int32, device=dev)
    if e == 0:
        return pa, pb
    vec = e % 16 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (a, b, c, pa, pb))
    code = _kernel()(a.data_ptr(), b.data_ptr(), c.data_ptr(), pa.data_ptr(),
                     pb.data_ptr(), n, e, int(vec),
                     torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES.launched(a, b, c)
    _build.check(code, LAUNCHES.name)
    return pa, pb
