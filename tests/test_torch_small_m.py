"""The small-M GEMM kernel's lane arithmetic, on the CPU.

`csrc/s8_small_m.cuh` runs only on the card.  This file emulates it in
numpy, thread for thread: the weight words each thread loads (masked K
and N tails; int8 words, or packed int4 pairs decoded by the header's
`LoadW4Word`), the 4x4 `__byte_perm` transpose with the selector values
read from the header, `dp4a` on signed bytes, the lane-group shuffle, the
warp-order reduction through shared memory and the f32 epilogue.  The
emulation is held bit for bit against the plain PyTorch versions
(`kernels/ref.py`) of both `quant_matmul` and `packed_w4_matmul`.  No
JAX here.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import common, packed_matmul, quant_matmul, ref

HEADER = pathlib.Path(quant_matmul.__file__).parent / "csrc" / \
    "s8_small_m.cuh"


def _consts() -> dict:
    """The header's literal constants (`constexpr T NAME = literal;`)."""
    text = HEADER.read_text()
    found = re.findall(r"constexpr\s+(?:int|uint32_t)\s+(\w+)\s*=\s*"
                       r"(0x[0-9a-fA-F]+|\d+)\s*;", text)
    return {name: int(v, 0) for name, v in found}


C = _consts()
WARPS, GROUPS, RQ = C["WARPS"], C["GROUPS"], C["RQ"]
LANES_PER_GROUP = 32 // GROUPS
COLS = LANES_PER_GROUP * C["COLS_PER_LANE"]
STREAMS = WARPS * GROUPS
QR = STREAMS * RQ


def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (sel >> 4i) & 7 of {x: bytes 0-3, y: bytes 4-7}."""
    src = [(x >> (8 * b)) & 0xFF for b in range(4)] + \
          [(y >> (8 * b)) & 0xFF for b in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        assert nib < 8, "sign-replicating selectors are not emulated"
        out |= src[nib] << (8 * i)
    return out


def transpose4x4(r):
    """The header's transpose4x4 on arrays of row words r[0..3]."""
    t0 = byte_perm(r[0], r[1], C["PERM_PAIR_LO"])
    t1 = byte_perm(r[0], r[1], C["PERM_PAIR_HI"])
    t2 = byte_perm(r[2], r[3], C["PERM_PAIR_LO"])
    t3 = byte_perm(r[2], r[3], C["PERM_PAIR_HI"])
    return [byte_perm(t0, t2, C["PERM_HALF_LO"]),
            byte_perm(t0, t2, C["PERM_HALF_HI"]),
            byte_perm(t1, t3, C["PERM_HALF_LO"]),
            byte_perm(t1, t3, C["PERM_HALF_HI"])]


def _wrap32(v):
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def dp4a(a, b, c):
    """__dp4a(a, b, c): the signed bytes of a and b, multiplied pairwise
    and summed into c (int32)."""
    sb = lambda v, i: ((v >> (8 * i)) & 0xFF).astype(np.int64) - \
        (((v >> (8 * i)) & 0x80) << 1).astype(np.int64)
    return _wrap32(c + sum(sb(a, i) * sb(b, i) for i in range(4)))


def _bytes_word(a, rows, cols, nrows, ncols):
    """Words of a 2-D int8 array: bytes a[rows, cols + b] for b in 0..3,
    zeros outside [nrows, ncols) -- load_bytes / the vector loads."""
    word = np.zeros(np.broadcast(rows, cols).shape, dtype=np.uint64)
    u = a.view(np.uint8)
    for b in range(4):
        ok = (rows < nrows) & (cols + b < ncols)
        v = u[np.where(ok, rows, 0), np.where(ok, cols + b, 0)]
        word |= np.where(ok, v, 0).astype(np.uint64) << np.uint64(8 * b)
    return word


def columns_w4(r):
    """LoadW4Word::columns on arrays of the 4 rows' packed pairs r[0..3]:
    the 2x4 byte gather, the nibbles of 4 rows at a time and the 4-bit
    sign extension u | (u & 8) * 0x1E, with the header's constants."""
    nib, bias = np.uint64(C["W4_NIBBLES"]), np.uint64(C["W4_BIAS"])
    t0 = byte_perm(r[0], r[1], C["PERM_PAIR_LO"])
    t1 = byte_perm(r[2], r[3], C["PERM_PAIR_LO"])
    b0 = byte_perm(t0, t1, C["PERM_HALF_LO"])
    b1 = byte_perm(t0, t1, C["PERM_HALF_HI"])

    def sext4(u):
        return (u | (u & bias) * np.uint64(C["W4_SEXT"])) & \
            np.uint64(0xFFFFFFFF)
    four = np.uint64(4)
    return [sext4((b0 & nib) ^ bias), sext4((b0 >> four) & nib),
            sext4((b1 & nib) ^ bias), sext4((b1 >> four) & nib)]


def _w4_pair(wp, rows, cols, nrows, ncols):
    """LoadW4Word::load over arrays: the 2 packed bytes of columns
    cols..cols+3 of the logical [nrows, ncols] int4 matrix stored as
    wp [nrows, ncols // 2]; the padding byte W4_PAD outside [nrows,
    ncols)."""
    pad = np.uint64(C["W4_PAD"])
    p = _bytes_word(wp, rows, cols // 2, nrows, ncols // 2) & \
        np.uint64(0xFFFF)
    for b in range(2):      # bytes of columns >= ncols (or rows >= nrows)
        live = (rows < nrows) & (cols + 2 * b < ncols)
        p = np.where(live, p, p | pad << np.uint64(8 * b))
    return p


def emulate(x, w, xs=None, ws=None, *, packed=False):
    """The kernel, every block and thread at once: (acc int32, f32 or
    None) for int8 x [M,K] @ int8 w [K,N], or with packed=True @ packed
    int4 w [K, N//2] through the LoadW4Word loader (load, then unpack
    each quad at use)."""
    m_rows, k_dim = x.shape
    n_dim = 2 * w.shape[1] if packed else w.shape[1]
    load_w = _w4_pair if packed else _bytes_word
    columns = columns_w4 if packed else transpose4x4
    assert 1 <= m_rows <= C["MAX_M"]
    mt = next(t for t in (1, 2, 4, 8, 16) if t >= m_rows)
    nb = -(-n_dim // COLS)
    tid = np.arange(32 * WARPS)
    warp, lane = tid >> 5, tid & 31
    g, cl = lane // LANES_PER_GROUP, lane % LANES_PER_GROUP
    s = warp * GROUPS + g                                  # [T]
    n0 = np.arange(nb)[:, None] * COLS                     # [B, 1]
    col = n0 + cl[None, :] * C["COLS_PER_LANE"]            # [B, T]
    kq = -(-k_dim // 4)
    acc = np.zeros((nb, tid.size, mt, 4), dtype=np.int64)
    for q0 in range(0, kq, QR):
        wr = [[load_w(w, np.broadcast_to(4 * (q0 + s + i * STREAMS) + j,
                                         col.shape), col, k_dim, n_dim)
               for j in range(4)] for i in range(RQ)]
        nq = min(QR, kq - q0)
        xw = np.zeros((mt, nq), dtype=np.uint64)           # shared memory
        mm, qq = np.meshgrid(np.arange(mt), np.arange(nq), indexing="ij")
        xw[:] = _bytes_word(x, mm, 4 * (q0 + qq), m_rows, k_dim)
        for i in range(RQ):
            ql = s + i * STREAMS                           # [T]
            live = ql < nq
            wc = columns(wr[i])
            for m in range(mt):
                xv = xw[m, np.where(live, ql, 0)][None, :]
                for c in range(4):
                    acc[:, :, m, c] = np.where(
                        live, dp4a(wc[c], xv, acc[:, :, m, c]),
                        acc[:, :, m, c])
    # __shfl_xor_sync over the lane groups: xor 8, then xor 16
    acc = acc.reshape(nb, WARPS, 32, mt, 4)
    for off in (LANES_PER_GROUP, 2 * LANES_PER_GROUP):
        acc = _wrap32(acc + acc[:, :, np.arange(32) ^ off])
    red = np.zeros((nb, WARPS, mt, COLS), dtype=np.int64)
    for m in range(mt):
        lanes = np.flatnonzero(np.arange(32) // LANES_PER_GROUP
                               == m % GROUPS)
        for ln in lanes:
            c0 = (ln % LANES_PER_GROUP) * C["COLS_PER_LANE"]
            red[:, :, m, c0:c0 + 4] = acc[:, :, ln, m, :]
    total = np.zeros((nb, mt, COLS), dtype=np.int64)
    for v in range(WARPS):                                 # warp order
        total = _wrap32(total + red[:, v])
    out = total.transpose(1, 0, 2).reshape(mt, nb * COLS)[:m_rows, :n_dim]
    acc32 = out.astype(np.int32)
    if xs is None:
        return acc32, None
    f = (acc32.astype(np.float32) * xs.reshape(-1, 1)[:m_rows]) \
        * ws.reshape(1, -1)
    return acc32, f.astype(np.float32)


def _operands(rng, m, k, n):
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    xs = (rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32)
    ws = (rng.random((1, n)) * 0.02 + 1e-3).astype(np.float32)
    return x, w, xs, ws


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("k,n", [(7, 6), (100, 34), (1536, 576),
                                 (7, 576), (1536, 6)])
def test_emulated_kernel_matches_plain(m, k, n):
    rng = np.random.default_rng(1000 * m + k + n)
    x, w, xs, ws = _operands(rng, m, k, n)
    acc, f = emulate(x, w, xs, ws)
    t = [torch.from_numpy(a) for a in (x, w, xs, ws)]
    assert np.array_equal(acc, ref.quant_matmul_acc_ref(*t[:2]).numpy())
    assert np.array_equal(f, ref.quant_matmul_ref(*t).numpy())


@pytest.mark.parametrize("m,k,n", [(3, 48, 16), (8, 576, 192),
                                   (5, 1537, 33), (15, 3100, 70)])
def test_emulated_kernel_rounds_and_padding(m, k, n):
    """Rows padded to MT (3 -> 4, 5 -> 8, 15 -> 16), K past one round
    of 4 * QR k (two and three rounds), ragged N tails."""
    rng = np.random.default_rng(m + k + n)
    x, w, _, _ = _operands(rng, m, k, n)
    acc, _ = emulate(x, w)
    want = ref.quant_matmul_acc_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert np.array_equal(acc, want.numpy())


def test_extreme_bytes_sum_exactly():
    """All -128 (the most negative products and the largest sums)."""
    x = np.full((16, 1536), -128, dtype=np.int8)
    w = np.full((1536, 40), -128, dtype=np.int8)
    acc, _ = emulate(x, w)
    assert (acc == 1536 * 128 * 128).all()


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("k,n", [(7, 6), (100, 34), (1536, 6), (1536, 576)])
def test_emulated_packed_kernel_matches_plain(m, k, n):
    """The LoadW4Word loader: N % 4 == 2 leaves a last word of 2 live
    columns (the masked half), N % 4 == 0 none."""
    rng = np.random.default_rng(1000 * m + k + n + 7)
    x, _, xs, ws = _operands(rng, m, k, n)
    wp = rng.integers(-128, 128, (k, n // 2)).astype(np.int8)
    acc, f = emulate(x, wp, xs, ws, packed=True)
    t = [torch.from_numpy(a) for a in (x, wp, xs, ws)]
    assert np.array_equal(acc, ref.packed_w4_matmul_acc_ref(*t[:2]).numpy())
    assert np.array_equal(f, ref.packed_w4_matmul_ref(*t).numpy())


@pytest.mark.parametrize("byte,pair", [(0x08, (0, 0)), (0x00, (-8, 0)),
                                       (0x77, (-1, 7)), (0x88, (0, -8))])
def test_packed_nibble_extremes(byte, pair):
    """Every word one byte: the padding word 0x08 decodes to (0, 0), the
    zero word to (-8, 0), and the nibble extremes 0x77 / 0x88 to the ends
    of [-8, 7] on each side."""
    word = np.array([byte | byte << 8], dtype=np.uint64)
    cols = columns_w4([word] * 4)           # 4 rows, columns col..col+3
    for c, v in enumerate([pair[0], pair[1], pair[0], pair[1]]):
        assert int(cols[c][0]) == (v & 0xFF) * 0x01010101, (c, v)
    rng = np.random.default_rng(byte)
    for m, k, n in ((16, 1536, 576), (1, 100, 34)):
        x = rng.integers(-128, 128, (m, k)).astype(np.int8)
        wp = np.full((k, n // 2), np.uint8(byte).view(np.int8))
        acc, _ = emulate(x, wp, packed=True)
        want = ref.packed_w4_matmul_acc_ref(torch.from_numpy(x),
                                            torch.from_numpy(wp))
        assert np.array_equal(acc, want.numpy())


def test_packed_loader_zeros_outside_the_matrix():
    """Columns >= N and rows >= K unpack to zeros, never to a decoded
    zero byte (-8, 0): with N = 6 the word at column 4 keeps its 2 live
    columns only, and of rows 1..4 with K = 3 only rows 1 and 2 load."""
    wp = np.zeros((3, 3), dtype=np.int8)            # every column -8 / 0
    cols = np.array([0, 4, 8])
    got = columns_w4([_w4_pair(wp, np.full(3, k), cols, 3, 6)
                      for k in range(1, 5)])        # rows 1..4 of K = 3
    neg8 = 0xF8 | 0xF8 << 8                         # rows 1, 2; not 3, 4
    assert [int(v) for v in got[0]] == [neg8, neg8, 0]
    assert [int(v) for v in got[1]] == [0, 0, 0]
    assert [int(v) for v in got[2]] == [neg8, 0, 0]
    assert [int(v) for v in got[3]] == [0, 0, 0]


def test_transpose_selectors():
    rows = [np.array([0x03020100 + 0x10101010 * j], dtype=np.uint64)
            for j in range(4)]
    cols = transpose4x4(rows)
    for c in range(4):   # column c holds byte c of rows 0..3
        want = sum(((0x10 * j + c) << (8 * j)) for j in range(4))
        assert int(cols[c][0]) == want


def _recorded_launches(monkeypatch):
    calls = []

    def fake_launch(fn, counter, x_q, w, n, x_scale, w_scale, **kw):
        calls.append((fn, n, kw.get("vec_bytes", 16), kw.get("also")))
        return None, torch.zeros((x_q.shape[0], n))

    monkeypatch.setattr(common, "launch_gemm", fake_launch)
    for mod in (quant_matmul, packed_matmul):
        monkeypatch.setattr(mod, "_kernel", lambda: "tile")
        monkeypatch.setattr(mod, "_small_m_kernel", lambda: "small_m")
    return calls


@pytest.mark.parametrize("m,kernel", [(1, "small_m"), (16, "small_m"),
                                      (17, "tile"), (1024, "tile")])
def test_rule_picks_kernel_by_rows(monkeypatch, m, kernel):
    """M <= 16 goes to the small-M kernel with 4-byte vector loads and its
    own counter, M > 16 to the tile (only the rule runs here: the launch
    itself needs the card)."""
    calls = _recorded_launches(monkeypatch)
    x = torch.zeros((m, 32), dtype=torch.int8)
    w = torch.zeros((32, 8), dtype=torch.int8)
    quant_matmul._launch(x, w, None, None, want_acc=False, want_out=True)
    fn, n, vec, also = calls[0]
    assert (fn, n) == (kernel, 8)
    if kernel == "small_m":
        assert (vec, also) == (4, quant_matmul.SMALL_M_LAUNCHES)
    else:
        assert (vec, also) == (16, None)


@pytest.mark.parametrize("m,kernel", [(1, "small_m"), (16, "small_m"),
                                      (17, "tile"), (1024, "tile")])
def test_packed_rule_picks_kernel_by_rows(monkeypatch, m, kernel):
    """packed_w4_matmul takes quant_matmul's rule (the same SMALL_M): the
    small-M kernel with 4-byte vector loads and its own counter, or the
    tile; N is the logical column count, twice the stored words."""
    calls = _recorded_launches(monkeypatch)
    x = torch.zeros((m, 32), dtype=torch.int8)
    wp = torch.zeros((32, 6), dtype=torch.int8)
    packed_matmul._launch(x, wp, None, None, want_acc=True, want_out=False)
    fn, n, vec, also = calls[0]
    assert (fn, n) == (kernel, 12)
    if kernel == "small_m":
        assert (vec, also) == (4, packed_matmul.SMALL_M_LAUNCHES)
    else:
        assert (vec, also) == (16, None)


def test_small_m_takes_k_past_2_17(monkeypatch):
    """No K is refused any more: the small-M kernel's sums wrap modulo
    2^32 as the reference's accumulator does (and the plain version), so
    K = 2^17 + 1 takes the small-M kernel like any other K."""
    calls = _recorded_launches(monkeypatch)
    x = torch.zeros((8, 2 ** 17 + 1), dtype=torch.int8)
    quant_matmul._launch(x, x.T, None, None, want_acc=True, want_out=False)
    assert calls[0][0] == "small_m"


def test_packed_small_m_takes_k_past_2_17(monkeypatch):
    """packed_w4_matmul likewise: K = 2^17 + 1 on the small-M kernel for
    M <= 16, on the tile for M > 16."""
    calls = _recorded_launches(monkeypatch)
    k = 2 ** 17 + 1
    for m in (8, 17):
        packed_matmul._launch(torch.zeros((m, k), dtype=torch.int8),
                              torch.zeros((k, 4), dtype=torch.int8), None,
                              None, want_acc=True, want_out=False)
    assert [c[0] for c in calls] == ["small_m", "tile"]


@pytest.mark.parametrize("packed,fill", [(False, -128), (False, None),
                                         (True, -128)])
def test_emulated_kernel_wraps_past_2_17(packed, fill):
    """K = 2^17 + 1 = 131073, M = 8: with x = w = -128 the int8 sums leave
    the int32 range and wrap modulo 2^32 in the shuffle and warp adds, to
    what the plain version gives; random bytes and packed int4 weights
    (-8 in every nibble: no wrap at this K) at the same K sum exactly."""
    k, n = 2 ** 17 + 1, 6
    rng = np.random.default_rng(k + int(packed))
    wn = n // 2 if packed else n
    if fill is None:
        x = rng.integers(-128, 128, (8, k)).astype(np.int8)
        w = rng.integers(-128, 128, (k, wn)).astype(np.int8)
    else:
        x = np.full((8, k), fill, dtype=np.int8)
        w = np.full((k, wn), fill, dtype=np.int8)
    acc, _ = emulate(x, w, packed=packed)
    plain = ref.packed_w4_matmul_acc_ref if packed \
        else ref.quant_matmul_acc_ref
    want = plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert np.array_equal(acc, want)
    if fill is not None and not packed:
        assert (acc == k * 2 ** 14 - 2 ** 32).all()


# --- expert-stacked weights: one launch, experts on blockIdx.y ---

def expert_strides(m, k, n, w_row, x_per_expert):
    """The header's expert_strides: elements between consecutive experts
    of x, w (stored bytes), x_scale, w_scale and the outputs (Python
    ints: the kernel's size_t)."""
    return {"x": m * k if x_per_expert else 0, "w": k * w_row,
            "xs": m if x_per_expert else 0, "ws": n, "out": m * n}


def emulate_experts(kernel, x, w, xs=None, ws=None, *, packed=False):
    """A batched launch: the grid's y axis runs over the experts, and
    expert e's blocks read the flat operands from e times their expert
    stride (expert_ptr) and compute the 2-D kernel `kernel` (this file's
    `emulate`, or the tile's) there.  x [E,M,K], or [M,K] shared by
    every expert (stride 0, with xs [M,1]); w [E,K,N] or packed
    [E,K,N//2]; xs [E,M,1], ws [E,1,N].  Returns (acc [E,M,N], f32 or
    None)."""
    e, k, w_row = w.shape
    m = x.shape[-2]
    n = 2 * w_row if packed else w_row
    st = expert_strides(m, k, n, w_row, x.ndim == 3)
    flat = {name: None if a is None else a.reshape(-1)
            for name, a in (("x", x), ("w", w), ("xs", xs), ("ws", ws))}
    acc = np.zeros(e * m * n, np.int32)
    f = None if xs is None else np.zeros(e * m * n, np.float32)
    for ey in range(e):                                    # blockIdx.y

        def at(name, size, shape):
            o = ey * st[name]
            return flat[name][o:o + size].reshape(shape)

        a, fo = kernel(at("x", m * k, (m, k)), at("w", k * w_row, (k, w_row)),
                       None if f is None else at("xs", m, (m, 1)),
                       None if f is None else at("ws", n, (1, n)),
                       packed=packed)
        o = ey * st["out"]
        acc[o:o + m * n] = a.reshape(-1)
        if f is not None:
            f[o:o + m * n] = fo.reshape(-1)
    return acc.reshape(e, m, n), None if f is None else f.reshape(e, m, n)


def expert_operands(rng, e, m, k, n, packed, shared):
    x = rng.integers(-128, 128, (m, k) if shared else (e, m, k)).astype(
        np.int8)
    w = rng.integers(-128, 128, (e, k, n // 2 if packed else n)).astype(
        np.int8)
    xs = (rng.random((m, 1) if shared else (e, m, 1)) * 0.02 + 1e-3).astype(
        np.float32)
    ws = (rng.random((e, 1, n)) * 0.02 + 1e-3).astype(np.float32)
    return x, w, xs, ws


def check_experts_plain(kernel, x, w, xs, ws, packed):
    """The emulated batched launch against the batched plain version (a
    shared x expanded to every expert), bit for bit, acc and f32."""
    acc, f = emulate_experts(kernel, x, w, xs, ws, packed=packed)
    e = w.shape[0]
    t = [torch.from_numpy(a) for a in (x, w, xs, ws)]
    if x.ndim == 2:
        t[0], t[2] = t[0].expand(e, *x.shape), t[2].expand(e, *xs.shape)
    acc_ref, out_ref = (
        (ref.packed_w4_matmul_acc_ref, ref.packed_w4_matmul_ref) if packed
        else (ref.quant_matmul_acc_ref, ref.quant_matmul_ref))
    assert np.array_equal(acc, acc_ref(*t[:2]).numpy())
    assert np.array_equal(f, out_ref(*t).numpy())


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 100, 34), (8, 64, 32), (16, 40, 6)])
def test_emulated_experts_match_plain(m, k, n, packed, shared):
    """Three experts in one launch, with per-expert x or one x for all
    (stride 0), int8 and packed int4 weights, ragged K and N: each
    expert's slice at its size_t offsets gives the batched plain version
    bit for bit."""
    rng = np.random.default_rng(m + k + n + 10 * packed + 100 * shared)
    check_experts_plain(emulate, *expert_operands(rng, 3, m, k, n, packed,
                                                  shared), packed)


def test_one_expert_is_the_2d_launch():
    """E = 1 at zero offsets is the 2-D kernel, bit for bit."""
    rng = np.random.default_rng(3)
    x, w, xs, ws = _operands(rng, 8, 100, 34)
    acc, f = emulate_experts(emulate, x[None], w[None], xs[None], ws[None])
    acc2, f2 = emulate(x, w, xs, ws)
    assert np.array_equal(acc[0], acc2) and np.array_equal(f[0], f2)


HEADER_TEXT = HEADER.read_text()


def test_expert_offsets_are_size_t():
    """The header computes each expert's base offset in size_t: an
    arctic-shaped stacked weight (128 x 7168 x 4864 int8, 4.46e9 bytes)
    puts expert 127 past 2^31, where an int product would wrap; inside an
    expert the offsets stay below 2^31 (the wrapper checks per expert)."""
    assert re.search(r"struct ExpertStrides \{\s*size_t x, w, xs, ws, out;",
                     HEADER_TEXT)
    assert "base + static_cast<size_t>(blockIdx.y) * stride" in HEADER_TEXT
    body = re.search(r"inline ExpertStrides expert_strides\((.*?)\n\}",
                     HEADER_TEXT, re.S).group(1)
    assert "const size_t m = static_cast<size_t>(M);" in body
    assert "static_cast<size_t>(K) * w_row" in body
    assert "m * K" in body and "m * N" in body
    st = expert_strides(8, 7168, 4864, 4864, True)
    assert 127 * st["w"] > 2 ** 31 > max(8 * 7168, 7168 * 4864, 8 * 4864)
    off = 127 * st["w"]                     # as a 32-bit int it wraps
    assert (off + 2 ** 31) % 2 ** 32 - 2 ** 31 != off


def test_rule_reads_rows_per_expert(monkeypatch):
    """A stacked weight takes the batched entry of the kernel the rule
    picks for the rows of ONE expert: x [32, 8, K] (256 rows in all) goes
    to the small-M kernel, x [4, 17, K] to the tile."""
    calls = []

    def fake_launch(fn, counter, x_q, w, n, x_scale, w_scale, **kw):
        calls.append((fn, n, kw.get("vec_bytes", 16), kw.get("also")))
        return None, torch.zeros((*x_q.shape[:-1], n))

    monkeypatch.setattr(common, "launch_gemm", fake_launch)
    for mod in (quant_matmul, packed_matmul):
        monkeypatch.setattr(mod, "_experts_kernel", lambda: "tile_e")
        monkeypatch.setattr(mod, "_small_m_experts_kernel",
                            lambda: "small_m_e")
    for e, m, kernel in ((32, 8, "small_m_e"), (4, 17, "tile_e")):
        x = torch.zeros((e, m, 32), dtype=torch.int8)
        quant_matmul._launch(x, torch.zeros((e, 32, 8), dtype=torch.int8),
                             None, None, want_acc=True, want_out=False)
        packed_matmul._launch(x, torch.zeros((e, 32, 4), dtype=torch.int8),
                              None, None, want_acc=True, want_out=False)
    small = [(4, quant_matmul.SMALL_M_LAUNCHES),
             (4, packed_matmul.SMALL_M_LAUNCHES)]
    assert [(c[0], c[1]) for c in calls] == [
        ("small_m_e", 8), ("small_m_e", 8), ("tile_e", 8), ("tile_e", 8)]
    assert [c[2:] for c in calls[:2]] == small
    assert [c[2:] for c in calls[2:]] == [(16, None)] * 2


def test_fakes_give_expert_shapes():
    """The custom ops' fake implementations (traced graphs) give
    [E, M, N] for a stacked weight and [M, N] for a 2-D one."""
    x3, x2 = torch.zeros((5, 3, 32), dtype=torch.int8), \
        torch.zeros((3, 32), dtype=torch.int8)
    for fake, w in ((quant_matmul._quant_matmul_fake, 8),
                    (packed_matmul._packed_w4_matmul_fake, 4)):
        assert tuple(fake(x3, torch.zeros((5, 32, w), dtype=torch.int8),
                          None, None).shape) == (5, 3, 8)
        assert tuple(fake(x2, torch.zeros((32, w), dtype=torch.int8),
                          None, None).shape) == (3, 8)
