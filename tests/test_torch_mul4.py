"""The split factor-4 multiply kernel (`mul4_split_kernel`,
`csrc/mul4.cu`) emulated on the CPU.

The kernel runs only on the card.  This file emulates it in numpy,
thread for thread: the grid the launcher picks (capped at the SMs'
resident blocks), the grid-stride walk over groups of GROUP consecutive
elements, one group per step, the vector path (one 4-byte word
of each a row and of b, one 16-byte store per product row: their
alignment is asserted) or the masked scalar path, and the wrapper's
`vec` rule (`kernels/mul4.py::vector_path`).  The constants are read
from mul4.cu.  Every element must be written exactly once.  The
emulated split arithmetic (uint32, as mul4_elem<true, SIGNED> does it
on bytes taken out of the loaded words) is held bit for bit against the
port's `mul4_plain` and the reference's Pallas `mul4_split` in interpret
mode, exhaustively over a3 and b.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import mul4 as jmul4  # noqa: E402
from repro_torch.kernels import common, mul4  # noqa: E402

SOURCE = pathlib.Path(mul4.__file__).parent / "csrc" / "mul4.cu"


def _consts() -> dict:
    return {n: int(v) for n, v in re.findall(
        r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", SOURCE.read_text())}


C = _consts()
GROUP, THREADS = C["GROUP"], C["SPLIT_THREADS"]
H100_CAP = 132 * 2048 // THREADS      # 132 SMs, 2048 threads each


def _u32(v):
    return np.asarray(v).astype(np.int64).astype(np.uint32)


def _as_i32(u):
    return np.asarray(u, dtype=np.uint32).view(np.int32)


def _asr(v, s):
    v = np.asarray(v, dtype=np.int32)
    return np.where(v >= 0, v >> s, ~((~v) >> s)).astype(np.int32)


def _byte_s8(w, j):
    """byte_s8: byte j of the uint32 words w as signed int8 values."""
    return (((w >> np.uint32(8 * j)) & np.uint32(0xFF)) ^ np.uint32(0x80)) \
        .astype(np.int32) - 0x80


def split_elem(a0, a1, a2, a3, b, signed):
    """mul4_elem<true, SIGNED> on int32 arrays of 4-bit values."""
    a3_hi, a3_lo = _asr(a3, 1), _u32(a3) & np.uint32(1)
    r = _as_i32((_u32(a0) + (_u32(a1) << np.uint32(8)) +
                 (_u32(a2) << np.uint32(16)) +
                 (_u32(a3_hi) << np.uint32(24))) * _u32(b))
    ps = []
    for _ in range(3):
        if signed:
            lane = ((_u32(r) & np.uint32(0xFF)) ^ np.uint32(0x80)) \
                .astype(np.int32) - 0x80
        else:
            lane = (_u32(r) & np.uint32(0xFF)).astype(np.int32)
        r = _asr(_as_i32(_u32(r) - _u32(lane)), 8)
        ps.append(lane)
    ps.append(_as_i32((_u32(r) << np.uint32(1)) +
                      np.where(a3_lo != 0, _u32(b), np.uint32(0))))
    return ps


def emulate(a, b, signed, ptrs, cap):
    """The kernel's run on a (4, e) and b (e,) int8 arrays, with the
    wrapper's vec flag for the pointers `ptrs` (a, b, out) and the grid
    capped at `cap` blocks.  Returns (out (4, e) int32, writes per
    element (4, e))."""
    e = b.size
    vec = mul4.vector_path("repro_mul4_split", e, ptrs)
    pa, pb, po = ptrs
    groups = common.cdiv(e, GROUP)
    grid = min(common.cdiv(groups, THREADS), cap)
    stride = grid * THREADS
    tid = np.arange(stride)              # blockIdx.x * THREADS + threadIdx.x
    ua, ub = a.view(np.uint8), b.view(np.uint8)
    out = np.zeros((4, e), np.int32)
    writes = np.zeros((4, e), np.int64)
    for g in range(0, groups, stride):
        gu = tid + g
        gu = gu[gu < groups]
        i = gu * GROUP
        fast = vec & (i + GROUP <= e)
        if fast.any():               # the 4-byte loads, 16-byte stores
            for l in range(4):
                assert ((pa + l * e + i[fast]) % 4 == 0).all()
                assert ((po + 4 * (l * e + i[fast])) % 16 == 0).all()
            assert ((pb + i[fast]) % 4 == 0).all()
        idx = i[:, None] + np.arange(GROUP)
        live = idx < e               # all true on the vector path
        assert live[fast].all()
        src = np.where(live, idx, 0)

        def word(row):               # little-endian, 0 past e
            w = np.zeros(len(i), np.uint32)
            for j in range(GROUP):
                w |= np.where(live[:, j], row[src[:, j]], 0) \
                    .astype(np.uint32) << np.uint32(8 * j)
            return w
        wa = [word(ua[l]) for l in range(4)]
        wb = word(ub)
        for j in range(GROUP):
            ps = split_elem(*(_byte_s8(w, j) for w in wa),
                            _byte_s8(wb, j), signed)
            ok = live[:, j]
            for l in range(4):
                out[l, idx[ok, j]] = ps[l][ok]
                writes[l, idx[ok, j]] += 1
    return out, writes


def _operands(rng, e, signed):
    lo, hi = (-8, 8) if signed else (0, 16)
    return (rng.integers(lo, hi, (4, e)).astype(np.int8),
            rng.integers(lo, hi, e).astype(np.int8))


def _plain(a, b):
    return np.stack([p.numpy() for p in mul4.mul4_plain(
        torch.from_numpy(a), torch.from_numpy(b))])


@pytest.mark.parametrize("cap", [H100_CAP, 5])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("e", [1, 3, 4, 5, 17, 4103, 2 ** 20])
def test_split_kernel_writes_each_element_once(e, aligned, cap):
    """Every element written once, by the path the vec rule picks, and
    equal to the plain version (signed and unsigned operands)."""
    rng = np.random.default_rng(e + aligned)
    ptrs = (256, 512 + (0 if aligned else 1), 1024)   # b one byte off
    assert mul4.vector_path("repro_mul4_split", e, ptrs) == \
        (aligned and e % GROUP == 0)
    for signed in (True, False):
        a, b = _operands(rng, e, signed)
        out, writes = emulate(a, b, signed, ptrs, cap)
        assert (writes == 1).all()
        np.testing.assert_array_equal(out, _plain(a, b))


def test_vec_rules_follow_the_kernels():
    """The wrapper's vector steps are the kernels' (split's GROUP, full32's
    swar::PER_THREAD)."""
    swar = (SOURCE.parent / "swar.cuh").read_text()
    per_thread = int(re.search(r"constexpr\s+int\s+PER_THREAD\s*=\s*(\d+)",
                               swar).group(1))
    assert mul4.VEC_ELEMS == {"repro_mul4_full32": per_thread,
                              "repro_mul4_split": GROUP}
    assert not mul4.vector_path("repro_mul4_full32", 8, (0, 0, 0))
    assert mul4.vector_path("repro_mul4_split", 8, (0, 16, 32))


@pytest.mark.parametrize("signed", [True, False])
def test_split_arithmetic_exhaustive_vs_plain_and_reference(signed):
    """Every (a3, b) pair of 4-bit values, with random a0-a2, through the
    emulated kernel: equal to mul4_plain and to the reference's Pallas
    mul4_split (interpret mode), with no tolerance."""
    lo, hi = (-8, 8) if signed else (0, 16)
    vals = np.arange(lo, hi)
    a3, bb = (np.repeat(x.reshape(1, -1), 16, 0).reshape(-1).astype(np.int8)
              for x in np.meshgrid(vals, vals, indexing="ij"))
    rng = np.random.default_rng(41 + signed)
    a = np.concatenate([rng.integers(lo, hi, (3, a3.size)).astype(np.int8),
                        a3[None]])
    out, writes = emulate(a, bb, signed, (0, 0, 0), H100_CAP)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, _plain(a, bb))
    want = jmul4.mul4_split(jnp.asarray(a), jnp.asarray(bb), block=(32, 128),
                            interpret=True, signed=signed)
    np.testing.assert_array_equal(out, np.stack([np.asarray(w)
                                                 for w in want]))
