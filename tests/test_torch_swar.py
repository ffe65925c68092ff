"""The port's SWAR kernels (simd_add, muladd2, mul4) against the JAX
reference.

On identical numpy inputs the plain PyTorch versions -- what a CPU
tensor runs -- must be bit-exact against `repro.kernels.ref` and against
the Pallas kernels run in interpret mode: the TPU kernels
(`kernels/{simd_add,muladd2,mul4}.py`) and their Pallas-Triton variants
(`kernels/gpu_pallas.py`, all five ops, which closes those variants
against the port's kernels of the same op).  The CUDA kernels themselves
only run on a card (tests/test_torch_cuda.py, chip_smoke.py); here a
numpy uint32 emulation of each kernel's word formulas -- the wrapping
arithmetic the CUDA source does in uint32_t -- is held against the
oracle, which catches a wrong formula before the card does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels import gpu_pallas  # noqa: E402
from repro.kernels import mul4 as jmul4  # noqa: E402
from repro.kernels import muladd2 as jmuladd2  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import simd_add as jsimd  # noqa: E402
from repro_torch.kernels import (common, mul4, muladd2, ops,  # noqa: E402
                                 ref, simd_add)

SHAPES = [(5,), (64,), (3, 7, 11)]
TPU_BLOCK = (8, 128)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def _lane_ints(rng, lane_bits, shape):
    lo = -(1 << (lane_bits - 1))
    dt = np.int8 if lane_bits == 8 else np.int16
    return rng.integers(lo, -lo, shape).astype(dt)


# ---------------------------------------------------------------------------
# simd_add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lane_bits,k", [(8, 1), (8, 2), (8, 3), (8, 4),
                                         (16, 1), (16, 2)])
@pytest.mark.parametrize("sub", [False, True])
def test_simd_add_plain_bit_exact(shape, lane_bits, k, sub):
    rng = np.random.default_rng(lane_bits * 100 + k * 10 + sub)
    xs = [_lane_ints(rng, lane_bits, shape) for _ in range(k)]
    ys = [_lane_ints(rng, lane_bits, shape) for _ in range(k)]
    want = jref.simd_add_ref([jnp.asarray(x) for x in xs],
                             [jnp.asarray(y) for y in ys], sub=sub,
                             lane_bits=lane_bits)
    before = simd_add.LAUNCHES.count
    got = simd_add.simd_add([_t(x) for x in xs], [_t(y) for y in ys],
                            lane_bits=lane_bits, sub=sub)
    assert all(g.dtype == torch.int32 for g in got)
    _eq(got, want)
    _eq(ref.simd_add_ref([_t(x) for x in xs], [_t(y) for y in ys], sub=sub,
                         lane_bits=lane_bits), want)
    _eq(ops.simd_add([_t(x) for x in xs], [_t(y) for y in ys],
                     lane_bits=lane_bits, sub=sub), want)
    assert simd_add.LAUNCHES.count == before   # the CPU path launches none


@pytest.mark.parametrize("lane_bits", [8, 16])
@pytest.mark.parametrize("sub", [False, True])
def test_simd_add_packed_words_vs_pallas(lane_bits, sub):
    """Words (int32 bit patterns here, uint32 in the reference): the
    plain packed version against the TPU and GPU Pallas kernels."""
    rng = np.random.default_rng(7 + lane_bits + sub)
    x = rng.integers(0, 2 ** 32, (9, 37), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 2 ** 32, (9, 37), dtype=np.uint64).astype(np.uint32)
    got = simd_add.simd_add_packed(_t(x.view(np.int32)),
                                   _t(y.view(np.int32)),
                                   lane_bits=lane_bits, sub=sub)
    for kernel, block in ((jsimd.simd_add_packed, TPU_BLOCK),
                          (gpu_pallas.simd_add_packed, (8, 128))):
        want = np.asarray(kernel(jnp.asarray(x), jnp.asarray(y),
                                 lane_bits=lane_bits, sub=sub, block=block,
                                 interpret=True))
        np.testing.assert_array_equal(_np(got).view(np.uint32), want)


@pytest.mark.parametrize("lane_bits", [8, 16])
def test_pack_unpack_lanes_match_reference(lane_bits):
    rng = np.random.default_rng(lane_bits)
    xs = [_lane_ints(rng, lane_bits, (4, 6)) for _ in range(32 // lane_bits)]
    words = common.pack_lanes([_t(x) for x in xs], lane_bits)
    want = np.asarray(jcommon.pack_lanes([jnp.asarray(x) for x in xs],
                                         lane_bits))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(_np(words).view(np.uint32), want)
    _eq(common.unpack_lanes(words, lane_bits),
        jcommon.unpack_lanes(jnp.asarray(want), lane_bits))
    with pytest.raises(ValueError):
        common.pack_lanes([_t(xs[0])], lane_bits)


def test_simd_add_wraps_like_int8():
    x = torch.tensor([127, -128, 100, -100], dtype=torch.int8)
    y = torch.tensor([1, -1, 100, -100], dtype=torch.int8)
    for g in simd_add.simd_add([x] * 4, [y] * 4, lane_bits=8):
        assert torch.equal(g, (x + y).to(torch.int32))
    with pytest.raises(ValueError):
        simd_add.simd_add([x] * 5, [y] * 5, lane_bits=8)
    with pytest.raises(ValueError):
        simd_add.simd_add_packed(x.int(), y.int(), lane_bits=12)


# ---------------------------------------------------------------------------
# muladd2
# ---------------------------------------------------------------------------

def _chains(rng, n, shape):
    """a, b 4-bit where n > 1 (inside the Eq. 2 bound, |p_b| < 2^15),
    c 8-bit; full int8 range for n = 1."""
    lo = -128 if n == 1 else -8
    a = rng.integers(lo, -lo, (n, *shape)).astype(np.int8)
    b = rng.integers(lo, -lo, (n, *shape)).astype(np.int8)
    c = rng.integers(-128, 128, (n, *shape)).astype(np.int8)
    if n == 31:      # the bound's worst case: every product at its peak
        a[:, 0], b[:, 0], c[:, 0] = -8, -8, -128
    return a, b, c


@pytest.mark.parametrize("n", [1, 9, 31])
@pytest.mark.parametrize("shape", [(7,), (3, 45)])
def test_muladd2_plain_bit_exact(n, shape):
    rng = np.random.default_rng(n * 10 + len(shape))
    a, b, c = _chains(rng, n, shape)
    want = jref.muladd2_ref(list(jnp.asarray(a)), list(jnp.asarray(b)),
                            list(jnp.asarray(c)))
    before = muladd2.LAUNCHES.count
    _eq(muladd2.muladd2(_t(a), _t(b), _t(c)), want)
    _eq(ops.muladd2(list(_t(a)), list(_t(b)), list(_t(c))), want)
    assert muladd2.LAUNCHES.count == before
    ja, jb, jc = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    _eq(jmuladd2.muladd2(ja, jb, jc, block=(32, 128), interpret=True), want)
    _eq(gpu_pallas.muladd2(ja, jb, jc, block=(8, 128), interpret=True), want)


def test_muladd2_refuses_bad_stacks():
    z = torch.zeros((2, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        muladd2.muladd2(z, z, z[:1])
    with pytest.raises(ValueError):
        muladd2.muladd2(z[:0], z[:0], z[:0])


# ---------------------------------------------------------------------------
# mul4
# ---------------------------------------------------------------------------

def _mul4_operands(rng, signed, shape):
    lo, hi = (-8, 8) if signed else (0, 16)
    a = rng.integers(lo, hi, (4, *shape)).astype(np.int8)
    b = rng.integers(lo, hi, shape).astype(np.int8)
    a.reshape(4, -1)[:, :2] = [lo, hi - 1]    # the extreme products
    b.reshape(-1)[:2] = [lo, hi - 1]
    return a, b


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", [(6,), (5, 33)])
def test_mul4_plain_bit_exact(signed, shape):
    rng = np.random.default_rng(int(signed) * 10 + len(shape))
    a, b = _mul4_operands(rng, signed, shape)
    want = jref.mul4_ref(list(jnp.asarray(a)), jnp.asarray(b))
    before = (mul4.LAUNCHES.count, mul4.SPLIT_LAUNCHES.count)
    _eq(mul4.mul4_full32(_t(a), _t(b), signed=signed), want)
    _eq(mul4.mul4_split(_t(a), _t(b), signed=signed), want)
    _eq(ops.mul4(list(_t(a)), _t(b)), want)
    assert (mul4.LAUNCHES.count, mul4.SPLIT_LAUNCHES.count) == before
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for kernel in (jmul4.mul4_full32, jmul4.mul4_split):
        _eq(kernel(ja, jb, block=(32, 128), interpret=True, signed=signed),
            want)
    if signed:   # the registered GPU lowering is the signed full32 layout
        _eq(gpu_pallas.mul4(ja, jb, block=(8, 128), interpret=True), want)


# ---------------------------------------------------------------------------
# numpy uint32 emulation of the CUDA kernels' word formulas
# (csrc/swar.cuh, simd_add.cu, muladd2.cu, mul4.cu)
# ---------------------------------------------------------------------------

def _u32(v):
    return np.asarray(v).astype(np.int64).astype(np.uint32)


def _as_i32(u):
    return u.astype(np.uint32).view(np.int32)


def _asr(v, s):
    v = v.astype(np.int32)
    return np.where(v >= 0, v >> s, ~((~v) >> s)).astype(np.int32)


def _pop_lane8_signed(r):
    lane = (((_u32(r) & 0xFF) ^ 0x80).astype(np.int32) - 0x80)
    return lane, _asr(_as_i32(_u32(r) - _u32(lane)), 8)


def _emu_simd(x, y, lane_bits, sub):
    h = np.uint32(common.lane_mask_high(lane_bits))
    nh = ~h
    if sub:
        return ((x | h) - (y & nh)) ^ ((x ^ ~y) & h)
    return ((x & nh) + (y & nh)) ^ ((x ^ y) & h)


def _emu_muladd2(a, b, c):
    acc = np.zeros(a.shape[1:], np.uint32)
    for k in range(a.shape[0]):
        acc = acc + ((_u32(a[k]) << np.uint32(16)) + _u32(b[k])) * _u32(c[k])
    lo = ((acc & 0xFFFF) ^ 0x8000).astype(np.int32) - 0x8000
    return _asr(_as_i32(acc - _u32(lo)), 16), lo


def _emu_mul4(a, b, split, signed):
    u = [_u32(x) for x in a]
    if split:
        a3_hi, a3_lo = _asr(a[3].astype(np.int32), 1), _u32(a[3]) & 1
        r = _as_i32((u[0] + (u[1] << 8) + (u[2] << 16) + (_u32(a3_hi) << 24))
                    * _u32(b))
        ps = []
        for _ in range(3):
            if signed:
                lane, r = _pop_lane8_signed(r)
            else:
                lane = (_u32(r) & 0xFF).astype(np.int32)
                r = _asr(_as_i32(_u32(r) - _u32(lane)), 8)
            ps.append(lane)
        ps.append(_as_i32((_u32(r) << 1) + np.where(a3_lo != 0, _u32(b), 0)
                          .astype(np.uint32)))
        return ps
    w = (u[0] + (u[1] << 8) + (u[2] << 16) + (u[3] << 24)) * _u32(b)
    if signed:
        r, ps = _as_i32(w), []
        for _ in range(3):
            lane, r = _pop_lane8_signed(r)
            ps.append(lane)
        return ps + [r]
    ps = []
    for _ in range(3):
        lane = w & 0xFF
        ps.append(_as_i32(lane))
        w = (w - lane) >> 8
    return ps + [_as_i32(w)]


@pytest.mark.parametrize("lane_bits", [8, 16])
@pytest.mark.parametrize("sub", [False, True])
def test_cuda_formula_simd_add(lane_bits, sub):
    rng = np.random.default_rng(3 + lane_bits + sub)
    xs = [_lane_ints(rng, lane_bits, (300,)) for _ in range(32 // lane_bits)]
    ys = [_lane_ints(rng, lane_bits, (300,)) for _ in range(32 // lane_bits)]
    xw = _np(common.pack_lanes([_t(x) for x in xs], lane_bits)).view(np.uint32)
    yw = _np(common.pack_lanes([_t(y) for y in ys], lane_bits)).view(np.uint32)
    got = _emu_simd(xw, yw, lane_bits, sub)
    want = ref.simd_add_ref([_t(x) for x in xs], [_t(y) for y in ys],
                            sub=sub, lane_bits=lane_bits)
    _eq(common.unpack_lanes(_t(got.view(np.int32)), lane_bits), want)


@pytest.mark.parametrize("n", [1, 9, 31])
def test_cuda_formula_muladd2(n):
    a, b, c = _chains(np.random.default_rng(n), n, (500,))
    _eq(_emu_muladd2(a, b, c),
        ref.muladd2_ref(list(_t(a)), list(_t(b)), list(_t(c))))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("signed", [True, False])
def test_cuda_formula_mul4(split, signed):
    a, b = _mul4_operands(np.random.default_rng(5), signed, (400,))
    _eq(_emu_mul4(a, b, split, signed), ref.mul4_ref(list(_t(a)), _t(b)))


# ---------------------------------------------------------------------------
# the Pallas-Triton GEMMs (gpu_pallas.py) against the port's GEMMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(3, 48, 16), (17, 100, 34)])
def test_gpu_pallas_gemms_vs_port(m, k, n):
    from repro_torch.kernels import packed_matmul, quant_matmul
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    wp = rng.integers(-128, 128, (k, n // 2)).astype(np.int8)
    np.testing.assert_array_equal(
        _np(quant_matmul.quant_matmul_acc(_t(x), _t(w))),
        np.asarray(gpu_pallas.quant_matmul_acc(
            jnp.asarray(x), jnp.asarray(w), block=(16, 32, 32),
            interpret=True)))
    np.testing.assert_array_equal(
        _np(packed_matmul.packed_w4_matmul_acc(_t(x), _t(wp))),
        np.asarray(gpu_pallas.packed_w4_matmul_acc(
            jnp.asarray(x), jnp.asarray(wp), block=(16, 32, 32),
            interpret=True)))


def test_swar_wrappers_refuse_other_devices():
    z8 = torch.zeros((4, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        muladd2.muladd2(z8, z8, z8)
    with pytest.raises(ValueError):
        mul4.mul4_full32(z8, z8[0])
    with pytest.raises(ValueError):
        simd_add.simd_add_packed(z8.int(), z8.int())


def test_launch_counter_records_operands_only_inside_capture():
    c = common.LaunchCounter("k")
    x = torch.zeros(3, dtype=torch.int32)
    c.launched(x, lane_bits=8)
    with c.capture() as seen:
        c.launched(x, x, sub=True)
    c.launched(x)
    assert c.count == 3 and c.captured is None
    assert len(seen) == 1 and seen[0][0][0] is x
    assert seen[0][1] == {"sub": True}


def test_launch_counter_capture_keeps_what_it_is_asked():
    """capture(keep) records keep(operands, attrs) of each launch and no
    operand (a prefill's activations are not held alive); the next plain
    capture() records operands again."""
    c = common.LaunchCounter("k")
    x = torch.zeros((3, 5), dtype=torch.int8)
    with c.capture(lambda ops, attrs: (ops[1].shape[-1], attrs)) as seen:
        c.launched(x, x[:, :2], vec_w=True)
    assert seen == [(2, {"vec_w": True})] and c.count == 1
    with c.capture() as seen:
        c.launched(x)
    assert seen[0][0][0] is x and c.captured is None


def test_launch_counter_keeps_the_last_launchs_attrs():
    """`last` holds the attrs of the latest launch (a GEMM's load paths),
    inside capture or not; a reset leaves it."""
    c = common.LaunchCounter("k")
    assert c.last == {}
    c.launched(1, vec_bytes=16, vec_w=False)
    assert c.last == {"vec_bytes": 16, "vec_w": False}
    with c.capture():
        c.launched(2, vec_bytes=4, vec_w=True)
    c.reset()
    assert c.last == {"vec_bytes": 4, "vec_w": True}
    c.launched(3)
    assert c.last == {}
