"""Port kernels (src/repro_torch/kernels) against the JAX reference.

The plain PyTorch versions must be bit-exact against `repro.kernels.ref`
and against the Pallas TPU kernels run in interpret mode, on identical
numpy inputs; so must quantization and int4 packing.  The Hopper kernels
themselves only run on a card: tests/test_torch_cuda.py holds them
against the plain versions there (and chip_smoke.py at the serving
shapes).
"""
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels import packed_matmul as jpmm  # noqa: E402
from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.quant import qtensor as jqt  # noqa: E402
from repro.quant.quantize import quantize as jquantize  # noqa: E402
from repro.quant.quantize import unpack_int4 as junpack_int4  # noqa: E402
from repro_torch.kernels import (_build, common, ops,  # noqa: E402
                                 packed_matmul, quant_matmul, ref, registry)
from repro_torch.quant import qtensor as tqt  # noqa: E402
from repro_torch.quant import quantize as tquant  # noqa: E402

# ragged M / K / N, including K=48 (not a multiple of 32) and the reduced
# smollm projections K in {48, 128}, N in {16, 48, 128}
SHAPES = [(1, 48, 16), (3, 48, 128), (17, 128, 48), (2, 100, 34),
          (9, 7, 6)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for every core; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i8(rng, *shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _operands(rng, m, k, n, packed):
    x = _i8(rng, m, k)
    w = _i8(rng, k, n // 2) if packed else _i8(rng, k, n)
    xs = (rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32)
    ws = (rng.random((1, n)) * 0.02 + 1e-3).astype(np.float32)
    return x, w, xs, ws


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# plain GEMMs: bit-exact against the oracle and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quant_matmul_plain_bit_exact(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    x, w, xs, ws = _operands(rng, m, k, n, packed=False)
    acc = ref.quant_matmul_acc_ref(_t(x), _t(w))
    assert acc.dtype == torch.int32
    want_acc = np.asarray(jqmm.quant_matmul_acc(
        jnp.asarray(x), jnp.asarray(w), block=(8, 128, 128), interpret=True))
    np.testing.assert_array_equal(_np(acc), want_acc)
    got = ref.quant_matmul_ref(_t(x), _t(w), _t(xs), _t(ws))
    want = np.asarray(jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(xs), jnp.asarray(ws)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), want)
    # the CPU wrapper is the plain version, and launches nothing
    before = quant_matmul.LAUNCHES.count
    np.testing.assert_array_equal(
        _np(quant_matmul.quant_matmul(_t(x), _t(w), _t(xs), _t(ws))), want)
    np.testing.assert_array_equal(
        _np(quant_matmul.quant_matmul_acc(_t(x), _t(w))), want_acc)
    assert quant_matmul.LAUNCHES.count == before


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_packed_w4_matmul_plain_bit_exact(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n + 7)
    x, wp, xs, ws = _operands(rng, m, k, n, packed=True)
    acc = ref.packed_w4_matmul_acc_ref(_t(x), _t(wp))
    want_acc = np.asarray(jpmm.packed_w4_matmul_acc(
        jnp.asarray(x), jnp.asarray(wp), block=(8, 256, 128),
        interpret=True))
    np.testing.assert_array_equal(_np(acc), want_acc)
    got = ref.packed_w4_matmul_ref(_t(x), _t(wp), _t(xs), _t(ws))
    want = np.asarray(jref.packed_w4_matmul_ref(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(xs), jnp.asarray(ws)))
    np.testing.assert_array_equal(_np(got), want)
    before = packed_matmul.LAUNCHES.count
    np.testing.assert_array_equal(_np(packed_matmul.packed_w4_matmul(
        _t(x), _t(wp), _t(xs), _t(ws))), want)
    np.testing.assert_array_equal(
        _np(packed_matmul.packed_w4_matmul_acc(_t(x), _t(wp))), want_acc)
    assert packed_matmul.LAUNCHES.count == before


def test_plain_gemm_out_dtype_and_scalar_scales():
    rng = np.random.default_rng(3)
    x, w, _, _ = _operands(rng, 4, 48, 16, packed=False)
    got = ref.quant_matmul_ref(_t(x), _t(w), torch.tensor(0.5),
                               torch.tensor(0.25), torch.bfloat16)
    want = np.asarray(jref.quant_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.float32(0.5), jnp.float32(0.25),
        jnp.bfloat16)).astype(np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_plain_gemm_exact_at_int8_extremes():
    """All -128 operands at the largest serving K: every partial sum is an
    integer far inside float64's exact range (K * 2^14 < 2^53)."""
    x = torch.full((2, 1536), -128, dtype=torch.int8)
    w = torch.full((1536, 4), -128, dtype=torch.int8)
    acc = ref.quant_matmul_acc_ref(x, w)
    assert bool((acc == 1536 * 128 * 128).all())


@pytest.mark.parametrize("k,packed", [(131073, False), (131073, True),
                                      (2 ** 21 + 1, True)])
def test_plain_gemm_wraps_like_reference(k, packed):
    """x and w all at their most negative value (-128; -8 in both nibbles
    of a packed word): at K = 131073 the int8 sum is 2^31 + 2^14 and
    wraps to -2147467264 in the reference's int32 accumulator; a packed
    sum (products of 2^10) first wraps at K = 2^21 + 1.  The plain
    versions equal `repro.kernels.ref` bit for bit, accumulator and
    dequantized output."""
    x = np.full((1, k), -128, np.int8)
    w = np.full((k, 1), -128, np.int8)
    xs = np.full((1, 1), 0.5, np.float32)
    ws = np.full((1, 2 if packed else 1), 0.25, np.float32)
    acc_fn = ref.packed_w4_matmul_acc_ref if packed \
        else ref.quant_matmul_acc_ref
    out_fn = ref.packed_w4_matmul_ref if packed else ref.quant_matmul_ref
    jout_fn = jref.packed_w4_matmul_ref if packed else jref.quant_matmul_ref
    acc = _np(acc_fn(_t(x), _t(w)))
    exact = k * 128 * (8 if packed else 128)
    wrapped = (exact + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert (wrapped != exact) == (k > 2 ** 21 or not packed)
    np.testing.assert_array_equal(acc, np.full((1, 2 if packed else 1),
                                               wrapped, np.int32))
    # the reference's dequantized output is its wrapped accumulator x 1/8
    want = np.asarray(jout_fn(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(xs), jnp.asarray(ws)))
    np.testing.assert_array_equal(want, acc.astype(np.float32) / 8)
    np.testing.assert_array_equal(
        _np(out_fn(_t(x), _t(w), _t(xs), _t(ws))), want)


@pytest.mark.parametrize("packed,k,n", [
    (False, 70, 35), (True, 70, 34), (False, 131073, 5),
    (True, 2 ** 21 + 1, 6)])
def test_plain_gemm_in_column_slices_is_bit_identical(monkeypatch, packed,
                                                      k, n):
    """A 2-D weight whose float64 copy would pass ref.PLAIN_EXPERT_BYTES
    (qwen2-vl-72b's [8192, 152064] head: 9.97 GB) is multiplied in column
    slices into one int32 result, a packed weight cut on word boundaries
    and each slice unpacked alone.  With the limit patched down to two
    stored columns' worth (so the last slice of an odd count is one
    column, or one word), quant_matmul_ref and packed_w4_matmul_ref,
    accumulator and f32 output, equal the one float64 matmul bit for
    bit: random operands, an odd N on the int8 path, and accumulators
    that wrap mod 2^32 (every operand -128; K = 131073 int8, 2^21 + 1
    packed)."""
    rng = np.random.default_rng(k + n)
    stored = n // 2 if packed else n
    if k > 1000:
        x = np.full((3, k), -128, np.int8)
        w = np.full((k, stored), -128, np.int8)
    else:
        x, w = _i8(rng, 3, k), _i8(rng, k, stored)
    xs = (rng.random((3, 1)) * 0.02 + 1e-3).astype(np.float32)
    ws = (rng.random((1, n)) * 0.02 + 1e-3).astype(np.float32)
    args = [_t(a) for a in (x, w, xs, ws)]
    acc_fn = ref.packed_w4_matmul_acc_ref if packed \
        else ref.quant_matmul_acc_ref
    out_fn = ref.packed_w4_matmul_ref if packed else ref.quant_matmul_ref
    want_acc, want_out = acc_fn(*args[:2]), out_fn(*args)
    calls = []
    f64 = ref._f64_matmul
    monkeypatch.setattr(ref, "_f64_matmul",
                        lambda a, b: calls.append(b.shape) or f64(a, b))
    monkeypatch.setattr(ref, "PLAIN_EXPERT_BYTES",
                        8 * (2 if packed else 1) * k * 2)
    got_acc = acc_fn(*args[:2])
    assert len(calls) == -(-stored // 2)
    assert torch.equal(got_acc, want_acc)
    assert torch.equal(out_fn(*args), want_out)
    if k > 1000:
        exact = k * 128 * (8 if packed else 128)
        wrapped = (exact + 2 ** 31) % 2 ** 32 - 2 ** 31
        assert wrapped != exact
        assert bool((got_acc == wrapped).all())


# ---------------------------------------------------------------------------
# int4 packing and quantization
# ---------------------------------------------------------------------------

def test_pack_w4_and_unpack_bit_exact():
    rng = np.random.default_rng(5)
    w4 = rng.integers(-8, 8, (3, 48, 32)).astype(np.int8)
    packed = ref.pack_w4(_t(w4))
    np.testing.assert_array_equal(_np(packed),
                                  np.asarray(jref.pack_w4(jnp.asarray(w4))))
    np.testing.assert_array_equal(_np(tquant.pack_int4(_t(w4))), _np(packed))
    words = _i8(rng, 5, 24)
    np.testing.assert_array_equal(
        _np(common.unpack_w4_words(_t(words))),
        np.asarray(jcommon.unpack_w4_words(jnp.asarray(words))))
    np.testing.assert_array_equal(
        _np(tquant.unpack_int4(_t(words))),
        np.asarray(junpack_int4(jnp.asarray(words))))
    np.testing.assert_array_equal(_np(tquant.unpack_int4(packed)), w4)
    with pytest.raises(ValueError):
        ref.pack_w4(torch.zeros((2, 3), dtype=torch.int8))


def _as(a, dtype):
    """numpy float32 data -> (jax array, torch tensor) of `dtype`."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bf16"
                              else jnp.float32)
    t = _t(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return j, t


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits,axis", [(8, 0), (8, None), (8, -1), (4, 0)])
def test_quantize_bit_exact(dtype, bits, axis):
    rng = np.random.default_rng(bits * 10 + (axis or 0) + 2)
    a = (rng.standard_normal((7, 48)) * 3).astype(np.float32)
    a[2] = 0.0                     # an all-zero row: scale is eps alone
    a[3] *= 1e-3
    j, t = _as(a, dtype)
    jq, js = jquantize(j, bits=bits, axis=axis)
    tq, ts = tquant.quantize(t, bits=bits, axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_quantize_weight_bit_exact(dtype, fmt):
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((2, 48, 16)) / 7).astype(np.float32)
    j, t = _as(a, dtype)
    jw = jqt.quantize_weight(j, fmt)
    tw = tqt.quantize_weight(t, fmt)
    assert tw.fmt == jw.fmt and tw.logical_shape == jw.logical_shape
    np.testing.assert_array_equal(_np(tw.q), np.asarray(jw.q))
    np.testing.assert_array_equal(_np(tw.scale), np.asarray(jw.scale))
    layer = tw[1]
    assert tuple(layer.q.shape) == tuple(jw.q.shape[1:])
    np.testing.assert_array_equal(_np(layer.scale), np.asarray(jw.scale[1]))


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_qmatmul_matches_reference(fmt):
    """The quantized matmul a projection runs: activation quantization,
    the plain GEMM, the f32 epilogue and the cast back to x's dtype,
    against the reference's as it serves it, compiled (its layers run
    inside `lax.scan`): the port quantizes activations in the compiled
    form (`quantize_compiled`, ROADMAP C7)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 16)) / 7).astype(np.float32)
    for dtype in ("f32", "bf16"):
        jx, tx = _as(x, dtype)
        jw, tw = _as(w, dtype)
        want = jax.jit(jqt.qmatmul)(jx, jqt.quantize_weight(jw, fmt))
        got = tqt.qmatmul(tx, tqt.quantize_weight(tw, fmt))
        assert got.dtype == tx.dtype and tuple(got.shape) == (2, 5, 16)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _gemm_args(rng, fmt):
    x, w, xs, ws = _operands(rng, 3, 48, 16, packed=fmt == "w4a8")
    return _t(x), _t(w), _t(xs), _t(ws)


def test_registry_resolution_and_counts(monkeypatch):
    monkeypatch.delenv(registry.ENV_VAR, raising=False)
    assert registry.resolve("quant_matmul", "cpu") == "ref"
    assert registry.resolve("quant_matmul", "cuda") == "hopper-cuda"
    assert registry.resolve("packed_w4_matmul", torch.device("cuda:0")) \
        == "hopper-cuda"
    with registry.force("ref"):
        assert registry.resolve("quant_matmul", "cuda") == "ref"
        with registry.force(packed_w4_matmul="hopper-cuda"):
            assert registry.resolve("packed_w4_matmul", "cpu") \
                == "hopper-cuda"
            assert registry.resolve("quant_matmul", "cuda") == "ref"
    assert registry.resolve("quant_matmul", "cuda") == "hopper-cuda"
    assert registry.fingerprint("cpu") == tuple(
        (op, "ref") for op in registry.OPS)
    assert registry.fingerprint("cuda") != registry.fingerprint("cpu")
    with registry.force("ref"):
        assert registry.fingerprint("cuda") == registry.fingerprint("cpu")
    assert registry.census_str("cpu") == \
        "simd_add=ref, muladd2=ref, mul4=ref, quant_matmul=ref, " \
        "packed_w4_matmul=ref"

    rng = np.random.default_rng(17)
    registry.reset_dispatch_counts()
    x, w, xs, ws = _gemm_args(rng, "w8a8")
    want = ref.quant_matmul_ref(x, w, xs, ws)
    for lid in registry.LOWERINGS:   # both serve a CPU tensor identically
        with registry.force(lid):
            assert torch.equal(ops.quant_matmul(x, w, xs, ws), want)
    x, w, xs, ws = _gemm_args(rng, "w4a8")
    out = ops.packed_w4_matmul(x, w, xs, ws, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert registry.dispatch_counts() == {
        "simd_add": 0, "muladd2": 0, "mul4": 0, "quant_matmul": 2,
        "packed_w4_matmul": 1}
    registry.reset_dispatch_counts()
    assert registry.dispatch_counts() == {op: 0 for op in registry.OPS}


# device kernels as the profiler names them (as read on the card), with
# the wrapper counters each one counts on
PROFILED = [
    ("void s8small::small_m_kernel<8, s8small::LoadW8Word>(signed char "
     "const*, signed char const*, float const*, float const*, int*, float*, "
     "int, int, int)", ("quant_matmul", "quant_matmul_small_m")),
    ("void s8small::small_m_kernel<2, s8small::LoadW4Word>(signed char "
     "const*, signed char const*, float const*, float const*, int*, float*, "
     "int, int, int)", ("packed_w4_matmul", "packed_w4_matmul_small_m")),
    ("void s8tile::tile_kernel<s8tile::TileW8, true, false>(signed char "
     "const*, signed char const*, float const*, float const*, int*, float*, "
     "int, int, int)", ("quant_matmul",)),
    ("void s8tile::tile_kernel<s8tile::TileW4, false, true>(signed char "
     "const*, signed char const*, float const*, float const*, int*, float*, "
     "int, int, int)", ("packed_w4_matmul",)),
    ("(anonymous namespace)::simd_add_kernel(unsigned int const*, unsigned "
     "int const*, unsigned int*, long, unsigned int, bool, bool)",
     ("simd_add_packed",)),
    ("(anonymous namespace)::muladd2_kernel(signed char const*, signed char "
     "const*, signed char const*, int*, int*, int, long, bool)",
     ("muladd2",)),
    ("void (anonymous namespace)::mul4_kernel<false, true>(signed char "
     "const*, signed char const*, int*, long, bool)", ("mul4_full32",)),
    ("void (anonymous namespace)::mul4_split_kernel<false>(signed char "
     "const*, signed char const*, int*, long, bool)", ("mul4_split",)),
    ("void (anonymous namespace)::mul4_split_kernel<true>(signed char "
     "const*, signed char const*, int*, long, bool)", ("mul4_split",)),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>(int)", ()),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3", ()),
    # the expert axis (a bool template argument more: false for the 2-D
    # launch, true for an expert-stacked one)
    ("void s8small::small_m_kernel<8, s8small::LoadW8Word, true>(signed "
     "char const*, signed char const*, float const*, float const*, int*, "
     "float*, int, int, int, bool, bool, s8small::ExpertStrides)",
     ("quant_matmul", "quant_matmul_small_m")),
    ("void s8small::small_m_kernel<16, s8small::LoadW4Word, false>(signed "
     "char const*, signed char const*, float const*, float const*, int*, "
     "float*, int, int, int, bool, bool, s8small::ExpertStrides)",
     ("packed_w4_matmul", "packed_w4_matmul_small_m")),
    ("void s8tile::tile_kernel<s8tile::TileW8, true, true, true>(signed "
     "char const*, signed char const*, float const*, float const*, int*, "
     "float*, int, int, int, s8small::ExpertStrides)", ("quant_matmul",)),
    ("void s8tile::tile_kernel<s8tile::TileW4, true, false, false>(signed "
     "char const*, signed char const*, float const*, float const*, int*, "
     "float*, int, int, int, s8small::ExpertStrides)",
     ("packed_w4_matmul",)),
]


@pytest.mark.parametrize("kernel,counters", PROFILED,
                         ids=[str(i) for i in range(len(PROFILED))])
def test_profiled_launches_by_symbol(kernel, counters):
    """A profile's kernel counts land on the wrapper counters that count
    that kernel, and on no other (a replayed CUDA graph is counted so)."""
    got = registry.profiled_launches({kernel: 210, "cudaLaunchKernel": 7})
    assert got == {c.name: 210 if c.name in counters else 0
                   for c in registry.LAUNCH_COUNTERS}


# the device types a raw profiler event reports (an enum, as kineto's)
CUDA = torch._C._autograd.DeviceType.CUDA
CPU = torch._C._autograd.DeviceType.CPU


class _FakeEvent:
    """A raw profiler event (the profile's `kineto_results.events()`)."""

    def __init__(self, name, device_type=CUDA, ns=1000):
        self._name, self._type, self._ns = name, device_type, ns

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def duration_ns(self):
        return self._ns


class _FakeProfile:
    """A profile whose raw events are `count` launches of each (key,
    count, device type) entry."""

    def __init__(self, entries):
        events = [_FakeEvent(key, *rest)
                  for key, count, *rest in entries for _ in range(count)]
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events))


SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


@pytest.mark.parametrize("seen", [1, 1999, 2000])
def test_window_events_take_the_prologue_out(seen):
    """A profile_window's device events without its prologue (however
    many of its launches the profiler kept) and without host entries."""
    kernel = PROFILED[0][0]
    prof = _FakeProfile([(SPIN, seen), (kernel, 210),
                         ("cudaLaunchKernel", 7, CPU)])
    got = registry.window_events(prof)
    assert [(e.key, e.count) for e in got] == [(kernel, 210)]
    assert got[0].device_time_us == 210.0
    assert seen <= registry.PROLOGUE == 2000


def test_window_events_count_as_key_averages():
    """Counted from a profile's raw events, the entries are those
    `key_averages()` gives, name for name (demangled) and count for count:
    real events of a CPU profile, each taken here as a device kernel,
    with one prologue launch."""
    from torch.profiler import ProfilerActivity, profile

    class AsKernel:
        def __init__(self, e):
            self.name, self.duration_ns = e.name, e.duration_ns

        def device_type(self):
            return CUDA

    a = torch.zeros(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            a.add_(1)
            torch.mm(a[None], a[:, None])
    events = [AsKernel(e) for e in prof.profiler.kineto_results.events()]
    raw = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(
            events=lambda: events + [_FakeEvent(SPIN)])))
    got = {e.key: e.count for e in registry.window_events(raw)}
    want = {e.key: e.count for e in prof.key_averages()}
    assert got == want and want["aten::mm"] == 20


@pytest.mark.parametrize("seen", [0, 2001])
def test_window_events_refuse_a_lost_prologue(seen):
    """No prologue launch seen: the profiler's loss may have reached the
    block's own first kernels, and the window raises (as it does for
    more prologue launches than it made)."""
    prof = _FakeProfile([(SPIN, seen), (PROFILED[0][0], 210)])
    with pytest.raises(RuntimeError, match="prologue"):
        registry.window_events(prof)


def test_launch_symbols_name_the_sources_kernels():
    """Every `__global__` function in kernels/csrc is one a counter's
    symbol names, and each symbol's identifiers are defined there."""
    csrc = pathlib.Path(common.__file__).parent / "csrc"
    text = "".join(p.read_text() for p in sorted(csrc.iterdir()))
    kernels = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        text))
    assert kernels == {"small_m_kernel", "tile_kernel", "simd_add_kernel",
                       "muladd2_kernel", "mul4_kernel", "mul4_split_kernel"}
    for c in registry.LAUNCH_COUNTERS:
        # the identifiers of the regex, its escapes (\b, \w) taken out
        for word in re.findall(r"[A-Za-z_]\w{3,}",
                               re.sub(r"\\\w", " ", c.symbol)):
            assert re.search(rf"\b{word}\b", text), (c.name, word)
    for name in kernels:
        assert any(name in c.symbol for c in registry.LAUNCH_COUNTERS), name


def test_tracing_seen_by_fake_tensors_and_make_fx():
    """`common.tracing`: a real tensor run eagerly is not traced (the GEMM
    wrappers then launch directly); a fake tensor, or any tensor inside a
    make_fx trace, is (they then go through their custom ops)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    real = torch.zeros(2, 3)
    assert not common.tracing(real)
    with FakeTensorMode():
        assert common.tracing(torch.empty(2, 3))
    seen = []

    def fn(t):
        seen.append(common.tracing(t))
        return t + 1

    make_fx(fn)(real)
    assert seen == [True]
    assert not common.tracing(real)


def test_registry_env_override_and_errors(monkeypatch):
    monkeypatch.setenv(registry.ENV_VAR, "*=ref")
    assert registry.resolve("quant_matmul", "cuda") == "ref"
    monkeypatch.setenv(registry.ENV_VAR, "packed_w4_matmul=ref")
    assert registry.resolve("packed_w4_matmul", "cuda") == "ref"
    assert registry.resolve("quant_matmul", "cuda") == "hopper-cuda"
    with registry.force("hopper-cuda"):       # force() beats the env
        assert registry.resolve("packed_w4_matmul", "cuda") == "hopper-cuda"
    # the JAX registry's variable is not read by the port
    monkeypatch.delenv(registry.ENV_VAR)
    monkeypatch.setenv("REPRO_LOWERING", "*=tpu-pallas")
    assert registry.resolve("quant_matmul", "cuda") == "hopper-cuda"
    # mul4_split is a kernel but no registry op, as in the reference
    for bad in ("quant_matmul=tpu-pallas", "mul4_split=ref", "ref"):
        monkeypatch.setenv(registry.ENV_VAR, bad)
        with pytest.raises(ValueError):
            registry.resolve("quant_matmul", "cpu")
    monkeypatch.delenv(registry.ENV_VAR)
    with pytest.raises(ValueError):
        with registry.force("gpu-pallas"):
            pass
    with pytest.raises(KeyError):
        registry.resolve("mul4_split", "cpu")


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 48), dtype=torch.int8, device="meta")
    w = torch.zeros((48, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        quant_matmul.quant_matmul_acc(x, w)
    with pytest.raises(ValueError):
        packed_matmul.packed_w4_matmul_acc(x, w[:, :8])
    # the launch helper itself never runs on a CPU tensor
    with pytest.raises(ValueError):
        common.launch_gemm(None, quant_matmul.LAUNCHES,
                              torch.zeros((2, 48), dtype=torch.int8),
                              torch.zeros((48, 16), dtype=torch.int8), 16,
                              None, None, want_acc=True, want_out=False)


# ---------------------------------------------------------------------------
# build: content-keyed library names, nvcc discovery
# ---------------------------------------------------------------------------

def test_build_paths_are_content_keyed():
    p = _build.library_path("quant_matmul")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("quant_matmul-")
    assert p == _build.library_path("quant_matmul")
    assert (_build.CSRC / "quant_matmul.cu").exists()
    for name in ("packed_w4_matmul", "simd_add", "muladd2", "mul4"):
        assert (_build.CSRC / f"{name}.cu").exists()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert (_build.BUILD_DIR.parents[1] / "src" / "repro_torch").is_dir()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.check(1, "probe")
    _build.check(0, "probe")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits nonzero and prints no result without CUDA, and
    alone in a directory without the rest of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    src = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(src.read_text())
    for script in (src, lone):
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
