"""Shared helpers for the kernel wrappers.

Port of the pieces of `repro/kernels/common.py` the port needs: `cdiv`,
`unpack_w4_words` (the inverse of `ref.pack_w4`, the same unpack the
Hopper w4a8 kernel performs in registers) and the SWAR lane packing
around the simd_add kernel (`lane_mask_high`, `pack_lanes`,
`unpack_lanes`, `simd_add_lanes`).

SWAR words are int32 tensors holding the uint32 bit pattern of the
reference's words: torch's uint32 supports few ops, and every word op
here (and in the kernel) is a bit operation, so only the interpretation
differs.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor

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


def lane_mask_high(lane_bits: int) -> int:
    """MSB-per-lane mask as a uint32 value, e.g. 0x80808080 for 8-bit
    lanes."""
    m = 0
    for off in range(0, 32, lane_bits):
        m |= 1 << (off + lane_bits - 1)
    return m


def pack_lanes(xs, lane_bits: int):
    """Pack 32//lane_bits narrow int tensors into one int32 word tensor
    (bit-concatenation of the two's-complement lanes, lane 0 lowest).

    The top lane is placed sign-extended (x * 2^(32 - lane_bits) fits
    int32 exactly), so no shift ever leaves the int32 range."""
    n_lanes = 32 // lane_bits
    if len(xs) != n_lanes:
        raise ValueError(f"pack_lanes: {len(xs)} tensors for {n_lanes} "
                         f"lanes of {lane_bits} bits")
    lane_max = (1 << lane_bits) - 1
    sign = 1 << (lane_bits - 1)
    shape = torch.broadcast_shapes(*[x.shape for x in xs])
    w = torch.zeros(shape, dtype=torch.int32, device=xs[0].device)
    for i, x in enumerate(xs):
        u = x.to(torch.int32) & lane_max
        if i == n_lanes - 1:
            w = w | (((u ^ sign) - sign) * (1 << (i * lane_bits)))
        else:
            w = w | (u << (i * lane_bits))
    return w


def unpack_lanes(w, lane_bits: int):
    """Inverse of pack_lanes: the lanes of int32 words as sign-extended
    int32 tensors."""
    lane_max = (1 << lane_bits) - 1
    sign = 1 << (lane_bits - 1)
    return [(((w >> (i * lane_bits)) & lane_max) ^ sign) - sign
            for i in range(32 // lane_bits)]


def simd_add_lanes(packed_fn, xs, ys, lane_bits: int):
    """Pack k narrow tensors into SWAR words (zero lanes pad a partly
    filled unit, paper sec. 3.2), apply `packed_fn(xw, yw)`, unpack the
    first k lanes."""
    n_lanes = 32 // lane_bits
    k = len(xs)
    if not len(ys) == k <= n_lanes:
        raise ValueError(f"simd_add: {len(xs)} + {len(ys)} operands for "
                         f"{n_lanes} lanes")
    zero = torch.zeros_like(xs[0])
    xw = pack_lanes(list(xs) + [zero] * (n_lanes - k), lane_bits)
    yw = pack_lanes(list(ys) + [zero] * (n_lanes - k), lane_bits)
    return unpack_lanes(packed_fn(xw, yw), lane_bits)[:k]


def bind(lib_name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The ctypes function `symbol` of csrc/<lib_name>.cu taking n_ptrs
    pointers, n_ints ints and the stream, returning cudaError_t.  Every
    pointer and the stream are c_void_p (a bare Python int would be
    passed as a 32-bit int and cut the pointer)."""
    return bind_in(_build.load(lib_name), symbol, n_ptrs, n_ints)


def bind_in(lib: ctypes.CDLL, symbol: str, n_ptrs: int, n_ints: int):
    """`bind` on a library already loaded (a build of csrc with other
    -D settings, as scripts/tile_sweep.py makes)."""
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_cuda_operands(counter: "LaunchCounter", **operands):
    """Raise unless every operand is a contiguous-able CUDA tensor of the
    dtype given with it ({name: (tensor, dtype)}), all on one device, and
    small enough for the kernels' int32 element indexing."""
    dev = None
    for name, (t, dtype) in operands.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{counter.name}: {name} must be a CUDA tensor "
                             f"(got {getattr(t, 'device', type(t))})")
        if t.dtype != dtype:
            raise ValueError(f"{counter.name}: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{counter.name}: operands on {dev} and "
                             f"{t.device}")
        dev = t.device
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{counter.name}: {name} has {t.numel()} "
                             "elements, beyond the kernel's int32 indexing")
    return dev


class LaunchCounter:
    """Launches of one kernel wrapper: `launched` is called exactly where
    the wrapper launches its kernel (never on the CPU path), so a run can
    show that it went through the kernel.  Under CUDA-graph capture the
    wrapper launches into the graph and counts; a replay launches without
    it and counts nowhere.  `symbol` is a regex that the device kernels
    counted here match, and no other kernel, as the profiler names them
    (`registry.profiled_launches` counts a replayed run with it; every
    wrapper's counter has one).  `last` holds the attrs of the latest
    launch (for a GEMM, the load paths it chose).  Inside
    `capture()` it also records each launch's operands, to replay the
    kernel at the shapes a run gave it (or, given `keep`, only what
    keep(operands, attrs) returns: a record that must not hold a
    prefill's activations alive)."""

    def __init__(self, name: str, symbol: str | None = None):
        self.name = name
        self.symbol = symbol
        self.count = 0
        self.last: dict = {}
        self.captured: list | None = None
        self._keep = None

    def reset(self) -> None:
        self.count = 0

    def launched(self, *operands, **attrs) -> None:
        self.count += 1
        self.last = attrs
        if self.captured is not None:
            self.captured.append((operands, attrs) if self._keep is None
                                 else self._keep(operands, attrs))

    @contextlib.contextmanager
    def capture(self, keep=None):
        """Record (operands, attrs) of every launch inside the block, or
        keep(operands, attrs) of each."""
        self.captured, self._keep = [], keep
        try:
            yield self.captured
        finally:
            self.captured, self._keep = None, None


def tracing(t) -> bool:
    """True while `t` may be traced (a fake tensor, or any dispatch mode
    active: `make_fx`, `FakeTensorMode`): a kernel wrapper must then go
    through its custom op, one opaque graph node that reaches no data
    pointer (and the op is right under any mode).  Run eagerly it
    launches directly: the custom op's dispatch would add host time to
    every call (PERF.md, scripts/prefill_ab.py)."""
    return torch._C._len_torch_dispatch_stack() > 0 or \
        isinstance(t, FakeTensor)


def on_cpu(t, counter: LaunchCounter) -> bool:
    """True for a CPU tensor (the wrapper then runs its plain version),
    False for a CUDA one (it launches its kernel); other devices raise."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{counter.name}: unsupported device {t.device}")
    return False


def launch_gemm(fn, counter: LaunchCounter, x_q, w, n: int, x_scale,
                w_scale, *, want_acc: bool, want_out: bool,
                vec_bytes: int = 16, also: LaunchCounter | None = None):
    """Validate operands, allocate outputs and launch one of the int8 GEMM
    kernels (`csrc/quant_matmul.cu` / `csrc/packed_w4_matmul.cu`, bound as
    `fn`) on the current stream.  `w` is the stored weight ([K,N] int8 or
    [K,N//2] packed words), `n` the logical column count.  The kernel's
    vector paths load `vec_bytes` at a time: x's when K is a multiple and
    x aligned to it, w's likewise for its row length.  A launch counts on
    `counter` and, if given, on `also` (a counter of this one kernel among
    several behind `counter`), with the paths it chose as attrs
    (`vec_bytes`, `vec_x`, `vec_w`).  Returns (acc int32 [M,n] or None, out f32
    [M,n] or None).

    Expert-stacked weights (w [E,K,N] or [E,K,N//2], `fn` a batched
    `*_experts` entry): x_q [E,M,K], x_scale [E,M,1], w_scale [E,1,N],
    and outputs [E,M,n], all E experts in ONE launch.  An x_q whose
    expert axis has stride 0 (an expanded [M,K], with an x_scale expanded
    alike) is passed once for every expert, uncopied.  The int32 index
    limit holds per expert."""
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"{counter.name}: kernel launch needs CUDA tensors "
                         f"(got {dev})")
    experts = w.ndim == 3
    nd = 3 if experts else 2
    for name, t in (("x_q", x_q), ("w", w)):
        if t.dtype != torch.int8 or t.ndim != nd or t.device != dev:
            raise ValueError(f"{counter.name}: {name} must be a {nd}-D int8 "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    m, k = x_q.shape[-2:]
    e = w.shape[0] if experts else 1
    if w.shape[-2] != k or (experts and x_q.shape[0] != e):
        raise ValueError(f"{counter.name}: K mismatch {tuple(x_q.shape)} @ "
                         f"{tuple(w.shape)}")
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError(f"{counter.name}: shape {(m, k, n)} exceeds the "
                         "kernel's int32 indexing")
    if e > 65535:
        raise ValueError(f"{counter.name}: {e} experts, beyond the grid's "
                         "65535")
    lead = (e,) if experts else ()
    shared = experts and x_q.stride(0) == 0 and (
        not want_out or x_scale.expand(e, m, 1).stride(0) == 0)
    x_q = x_q[0].contiguous() if shared else x_q.contiguous()
    w = w.contiguous()
    acc = torch.empty(lead + (m, n), dtype=torch.int32, device=dev) \
        if want_acc else None
    out = torch.empty(lead + (m, n), dtype=torch.float32, device=dev) \
        if want_out else None
    xs = ws = None
    if want_out:
        for name, s in (("x_scale", x_scale), ("w_scale", w_scale)):
            if s.dtype != torch.float32 or s.device != dev:
                raise ValueError(f"{counter.name}: {name} must be float32 "
                                 f"on {dev}, got {s.dtype} on {s.device}")
        xs = x_scale.expand(lead + (m, 1))
        xs = (xs[0] if shared else xs).reshape(-1).contiguous()
        ws = w_scale.expand(lead + (1, n)).reshape(-1).contiguous()
    if e == 0 or m == 0 or n == 0:
        return acc, out
    if k == 0:   # empty reduction: nothing to launch, the sum is 0
        for t in (acc, out):
            if t is not None:
                t.zero_()
        return acc, out
    vec_x = k % vec_bytes == 0 and x_q.data_ptr() % vec_bytes == 0
    vec_w = w.shape[-1] % vec_bytes == 0 and w.data_ptr() % vec_bytes == 0
    ptrs = (x_q.data_ptr(), w.data_ptr(),
            xs.data_ptr() if xs is not None else None,
            ws.data_ptr() if ws is not None else None,
            acc.data_ptr() if acc is not None else None,
            out.data_ptr() if out is not None else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if experts:
        code = fn(*ptrs, e, m, k, n, int(not shared), int(vec_x),
                  int(vec_w), stream)
    else:
        code = fn(*ptrs, m, k, n, int(vec_x), int(vec_w), stream)
    for c in (counter, also):
        if c is not None:
            c.launched(x_q, w, vec_bytes=vec_bytes, vec_x=vec_x,
                       vec_w=vec_w)
    _build.check(code, counter.name)
    return acc, out
