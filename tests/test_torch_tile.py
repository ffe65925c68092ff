"""The prefill tile's data flow, on the CPU.

`csrc/s8_tile.cuh` runs only on the card.  This file emulates it in
numpy, thread for thread, with the constants read from the header: each
thread's 16-byte chunk copies of the x and weight tiles (M/N/K masks,
the cp.async and byte paths) into the swizzled shared-memory stages, the
mma.sync m16n8k32 fragment reads of each K group's substep (A rows g /
g+8 at k = 4t.. and +16; the raw weight words of rows 4t+j at columns
4g, transposed with the small-M kernel's `__byte_perm` selectors), the
products in the PTX fragment layouts, the hand-over of one m16 row
block between the two K groups, and the epilogue's mapping of C
fragments to real columns.  It checks that every staged byte is written
once with the right value, that every shared-memory store and load of
every warp is free of bank conflicts, and that the int32 sums and the
f32 output are bit-identical to the plain versions (`kernels/ref.py`).
No JAX here.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import common, quant_matmul, ref
from test_torch_small_m import transpose4x4

CSRC = pathlib.Path(quant_matmul.__file__).parent / "csrc"


def _consts() -> dict:
    """The header's literal constants (`constexpr int NAME = literal;`,
    and the default of `#define S8TILE_NAME literal`)."""
    text = (CSRC / "s8_tile.cuh").read_text()
    found = re.findall(r"constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;", text) + \
        re.findall(r"#define\s+S8TILE_(\w+)\s+(\d+)", text)
    return {name: int(v) for name, v in found}


C = _consts()
BM, BN, BK, STAGES, KGROUPS, THREADS = (
    C[k] for k in ("BM", "BN", "BK", "STAGES", "KGROUPS", "THREADS"))
ROW, LINE, CHUNK = C["ROW_BYTES"], C["LINE_BYTES"], C["CHUNK"]
TILE = 64 * ROW
CHUNKS_PER_ROW = ROW // CHUNK
CHUNKS_PER_THREAD = TILE // CHUNK // THREADS
WARPS = THREADS // 32
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3
MAIN_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576)]


def swz(r, c):
    """The header's swz: byte offset of 16-byte chunk c of staged row r."""
    chunk = (((r & 1) << 2) | c) ^ ((r >> 1) & 3) ^ (((r >> 3) & 1) << 2)
    return (r >> 1) * LINE + chunk * CHUNK


def warp_role(warp):
    """(kg, wq, wm, wn, kk): the warp's K group, its 32x32 warp tile in the
    2x2 grid and the k32 substep of each step it runs."""
    kg, wq = warp >> 2, warp & 3
    return kg, wq, (wq >> 1) * 32, (wq & 1) * 32, 32 * kg


def stage_tile(a, rows, cols, r0, c0, vec):
    """load_stage's copies of one tile of every block: a [rows, cols]
    int8, tile origins r0 / c0 [B].  Returns (shared image [B, TILE]
    uint8, writes per byte [B, TILE], byte offsets of each store
    [CHUNKS_PER_THREAD, THREADS]): chunk q = tid + i * THREADS is row
    q // 4, chunk q % 4, zeros outside [rows, cols)."""
    nb = len(r0)
    q = np.arange(CHUNKS_PER_THREAD)[:, None] * THREADS + \
        np.arange(THREADS)[None, :]
    r, c = q // CHUNKS_PER_ROW, q % CHUNKS_PER_ROW
    gr = r0[:, None, None] + r[None]                     # [B, I, T]
    gc = c0[:, None, None] + CHUNK * c[None]
    if vec:   # a chunk lies wholly inside or outside cols
        assert cols % 16 == 0
        assert ((gc + CHUNK <= cols) | (gc >= cols)).all()
    gcb = gc[..., None] + np.arange(CHUNK)               # [B, I, T, 16]
    live = (gr[..., None] < rows) & (gcb < cols)
    u = a.view(np.uint8)
    vals = np.where(live, u[np.where(live, gr[..., None], 0),
                            np.where(live, gcb, 0)], 0).astype(np.uint8)
    offs = swz(r, c)                                     # [I, T]
    dst = offs[None, :, :, None] + np.arange(CHUNK)      # [1, I, T, 16]
    image = np.zeros((nb, TILE), dtype=np.uint8)
    writes = np.zeros((nb, TILE), dtype=np.int64)
    bi = np.broadcast_to(np.arange(nb)[:, None, None, None], vals.shape)
    image[bi, np.broadcast_to(dst, vals.shape)] = vals
    np.add.at(writes, (bi, np.broadcast_to(dst, vals.shape)), 1)
    return image, writes, offs


def banks_free(byte_offs, width: int) -> bool:
    """One shared-memory instruction of a warp (lane byte offsets, each
    access `width` bytes) is conflict free: per phase (32 lanes for 4-byte
    accesses, 8 for 16-byte ones) no bank is asked for two different
    words."""
    per_phase = 32 * 4 // width
    for p in range(0, 32, per_phase):
        words = {}
        for off in byte_offs[p:p + per_phase]:
            for wd in range(off // 4, (off + width) // 4):
                words.setdefault(wd % 32, set()).add(wd)
        if any(len(s) > 1 for s in words.values()):
            return False
    return True


def fragment_offsets(warp):
    """Byte offsets per lane of every fragment read of the warp's k32
    substep: {("A", i, reg): [32]} in the x tile, {("B", h, j): [32]} in
    the weight tile (rows kk + 16h + 4t + j, columns wn + 4g..)."""
    _, _, wm, wn, kk = warp_role(warp)
    out = {}
    for i in range(2):
        r = wm + i * 16 + G
        c = kk // CHUNK
        for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 1), (8, 1))):
            out[("A", i, reg)] = swz(r + dr, c + dc) + 4 * T
    b_chunk, b_byte = (wn >> 4) + (G >> 2), 4 * (G & 3)
    for h in range(2):
        for j in range(4):
            out[("B", h, j)] = swz(kk + 16 * h + 4 * T + j, b_chunk) + b_byte
    return out


def _words(image, offs):
    """Little-endian 32-bit words of image [B, TILE] at offsets [32]."""
    b = image[:, offs[:, None] + np.arange(4)].astype(np.uint64)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _sbytes(word):
    """The 4 signed bytes of words [...] -> [..., 4] int64."""
    b = (word[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF
    return b.astype(np.int64) - ((b & 0x80) << 1).astype(np.int64)


def mma_substep(xs_img, ws_img, warp, acc):
    """One warp's k32 substep of a step in every block: fragments from the
    stage images, the B words through transpose4x4, then
    mma.sync.m16n8k32.row.col in the PTX fragment layouts.  acc: [B, 32
    lanes, 2 (i), 4 (n8 tile c), 4 (c0..c3)] int64, updated."""
    offs = fragment_offsets(warp)
    nb = xs_img.shape[0]
    a = np.zeros((nb, 2, 16, 32), dtype=np.int64)       # A of m16 tile i
    for i in range(2):
        for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
            v = _sbytes(_words(xs_img, offs[("A", i, reg)]))  # [B, 32, 4]
            for b in range(4):
                a[:, i, G + dr, dk + 4 * T + b] = v[:, :, b]
    bm = np.zeros((nb, 4, 32, 8), dtype=np.int64)       # B of n8 tile c
    for h in range(2):
        cols = transpose4x4([_words(ws_img, offs[("B", h, j)])
                             for j in range(4)])
        for c in range(4):
            col = _sbytes(cols[c])                           # [B, 32, 4]
            for b in range(4):
                bm[:, c, 16 * h + 4 * T + b, G] = col[:, :, b]
    d = a[:, :, None] @ bm[:, None]                      # [B, 2, 4, 16, 8]
    acc[..., 0] += np.moveaxis(d[:, :, :, G, 2 * T], -1, 1)
    acc[..., 1] += np.moveaxis(d[:, :, :, G, 2 * T + 1], -1, 1)
    acc[..., 2] += np.moveaxis(d[:, :, :, G + 8, 2 * T], -1, 1)
    acc[..., 3] += np.moveaxis(d[:, :, :, G + 8, 2 * T + 1], -1, 1)


def red_index(kg_rows, wq, c):
    """The hand-over buffer's int4 slot per lane for m16 row block
    kg_rows of warp tile wq, n8 tile c: lanes consecutive."""
    return ((kg_rows * 4 + wq) * 4 + c) * 32 + LANE


def hand_over(acc):
    """The two K groups' sums of each warp tile: group kg sends its m16
    row block 1 - kg through the shared buffer (int4 of c0..c3 per n8
    tile) and adds the partner's block kg to its own.  acc: [B, WARPS,
    32, 2 (i), 4 (c), 4].  Returns [B, WARPS, 32, 4 (c), 4]: warp (kg, wq)
    holds row block kg of tile wq, summed over K."""
    red = np.full((acc.shape[0], 2 * 4 * 4 * 32, 4), np.iinfo(np.int64).min)
    for warp in range(WARPS):
        kg, wq = warp_role(warp)[:2]
        for c in range(4):
            slot = red_index(1 - kg, wq, c)
            assert (red[:, slot] == np.iinfo(np.int64).min).all()
            red[:, slot] = acc[:, warp, :, 1 - kg, c]
    out = np.zeros(acc.shape[:3] + (4, 4), dtype=np.int64)
    for warp in range(WARPS):
        kg, wq = warp_role(warp)[:2]
        for c in range(4):
            got = red[:, red_index(kg, wq, c)]
            assert (got != np.iinfo(np.int64).min).all()
            out[:, warp, :, c] = _wrap32(acc[:, warp, :, kg, c] + got)
    return out


def _wrap32(v):
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


def grid_blocks(m, n):
    """grid_for: one block per 64x64 tile, linear, N tiles fastest."""
    return common.cdiv(m, BM) * common.cdiv(n, BN)


def emulate(x, w, xs=None, ws=None, *, vec_x=None, vec_w=None):
    """The kernel over every block: (acc int32 [M,N], f32 or None).  The
    vector paths default to the wrapper's choice for aligned operands."""
    m, k = x.shape
    n = w.shape[1]
    vec_x = k % 16 == 0 if vec_x is None else vec_x
    vec_w = n % 16 == 0 if vec_w is None else vec_w
    tiles_n = common.cdiv(n, BN)
    bid = np.arange(grid_blocks(m, n))
    m0, n0 = (bid // tiles_n) * BM, (bid % tiles_n) * BN
    acc = np.zeros((len(bid), WARPS, 32, 2, 4, 4), dtype=np.int64)
    for k0 in range(0, k, BK):
        xs_img, xw, _ = stage_tile(x, m, k, m0, np.full_like(m0, k0), vec_x)
        ws_img, ww, _ = stage_tile(w, k, n, np.full_like(n0, k0), n0, vec_w)
        assert (xw == 1).all() and (ww == 1).all()
        for warp in range(WARPS):
            mma_substep(xs_img, ws_img, warp, acc[:, warp])
    acc = _wrap32(acc)
    summed = hand_over(acc)                 # [B, WARPS, 32, 4 (c), 4]
    out = np.zeros((m, n), dtype=np.int64)
    written = np.zeros((m, n), dtype=np.int64)
    for warp in range(WARPS):
        kg, _, wm, wn, _ = warp_role(warp)
        for h in range(2):
            row = m0[:, None] + wm + kg * 16 + G[None] + 8 * h
            for q in range(2):
                for c in range(4):
                    col = n0[:, None] + wn + 8 * T[None] + 4 * q + c
                    ok = (row < m) & (col < n)
                    np.add.at(written, (row[ok], col[ok]), 1)
                    out[row[ok], col[ok]] = \
                        summed[:, warp, :, c, 2 * h + q][ok]
    assert (written == 1).all(), "every output written exactly once"
    acc32 = out.astype(np.int32)
    if xs is None:
        return acc32, None
    f = (acc32.astype(np.float32) * xs.reshape(-1, 1)) * ws.reshape(1, -1)
    return acc32, f.astype(np.float32)


def _operands(rng, m, k, n):
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    xs = (rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32)
    ws = (rng.random((1, n)) * 0.02 + 1e-3).astype(np.float32)
    return x, w, xs, ws


def _check_plain(x, w, xs, ws, **kw):
    acc, f = emulate(x, w, xs, ws, **kw)
    t = [torch.from_numpy(a) for a in (x, w, xs, ws)]
    assert np.array_equal(acc, ref.quant_matmul_acc_ref(*t[:2]).numpy())
    assert np.array_equal(f, ref.quant_matmul_ref(*t).numpy())


@pytest.mark.parametrize("k,n", MAIN_KN)
def test_emulated_tile_matches_plain_main_shapes(k, n):
    """The four prefill (K, N) of smollm-135m, M cut from 1024 to 128
    (two row tiles; the blocks of a row tile do not interact)."""
    rng = np.random.default_rng(k + n)
    _check_plain(*_operands(rng, 128, k, n))


@pytest.mark.parametrize("m", [17, 70, 1027])
@pytest.mark.parametrize("k", [48, 100, 2100])
@pytest.mark.parametrize("n", [34, 70])
def test_emulated_tile_matches_plain_ragged(m, k, n):
    """Ragged M, K (not multiples of BK; 100 misses x's vector path) and
    N (misses the weights' vector path and the 16-byte epilogue)."""
    rng = np.random.default_rng(7 * m + 3 * k + n)
    _check_plain(*_operands(rng, m, k, n))


@pytest.mark.parametrize("m,k,n", [(64, 576, 192), (17, 64, 64)])
def test_byte_path_matches_plain(m, k, n):
    """Aligned shapes with both vector paths off (unaligned operands):
    every chunk gathered byte by byte."""
    rng = np.random.default_rng(m + k + n)
    _check_plain(*_operands(rng, m, k, n), vec_x=False, vec_w=False)


@pytest.mark.parametrize("value", [-128, 127])
def test_extreme_bytes_sum_exactly(value):
    """int8 extremes: all -128 gives the largest sums (K * 2^14), 127
    against -128 the most negative."""
    x = np.full((70, 1536), value, dtype=np.int8)
    w = np.full((1536, 70), -128, dtype=np.int8)
    acc, _ = emulate(x, w)
    assert (acc == 1536 * value * -128).all()


@pytest.mark.parametrize("which,rows,cols,vec", [
    ("x", 1024, 576, True), ("x", 70, 100, False), ("w", 576, 1536, True),
    ("w", 2100, 70, False)])
def test_stage_writes_every_byte_once(which, rows, cols, vec):
    """Every (row, column) of a staged tile is written exactly once, with
    the matrix byte inside [rows, cols) and zero outside (tile at the
    matrix's ragged corner and at its origin)."""
    rng = np.random.default_rng(rows + cols)
    a = rng.integers(-128, 128, (rows, cols)).astype(np.int8)
    r0 = np.array([0, (rows - 1) // 64 * 64])
    c0 = np.array([0, (cols - 1) // 64 * 64])
    image, writes, _ = stage_tile(a, rows, cols, r0, c0, vec)
    assert (writes == 1).all()
    r = np.arange(64)[:, None]
    c = np.arange(64)[None, :]
    off = swz(r, c // CHUNK) + c % CHUNK
    for b in range(2):
        gr, gc = r0[b] + r, c0[b] + c
        live = (gr < rows) & (gc < cols)
        want = np.where(live, a.view(np.uint8)[np.minimum(gr, rows - 1),
                                               np.minimum(gc, cols - 1)], 0)
        assert np.array_equal(image[b][off], want)


def test_stage_stores_are_conflict_free():
    """Each warp's 16-byte stores (cp.async, or st.shared on the byte
    path): every 8-lane phase covers 32 distinct banks."""
    offs = stage_tile(np.zeros((64, 64), np.int8), 64, 64, np.zeros(1, int),
                      np.zeros(1, int), True)[2]
    for i in range(offs.shape[0]):
        for warp in range(WARPS):
            assert banks_free(offs[i, 32 * warp:32 * (warp + 1)], CHUNK)


@pytest.mark.parametrize("warp", range(8))
def test_fragment_reads_are_conflict_free(warp):
    """Every 32-bit fragment read of every warp (8 A words, 8 raw B
    words per k32 substep) hits 32 distinct banks."""
    for key, offs in fragment_offsets(warp).items():
        assert banks_free(offs, 4), key


def test_fragment_reads_cover_each_step_once():
    """The two K groups read disjoint halves of a step: together every
    byte of the x tile's rows and the w tile's rows, each k once."""
    seen_a, seen_b = np.zeros(TILE, int), np.zeros(TILE, int)
    for warp in range(WARPS):
        for (kind, *_), offs in fragment_offsets(warp).items():
            assert ((offs >= 0) & (offs + 4 <= TILE)).all()
            seen = seen_a if kind == "A" else seen_b
            np.add.at(seen, offs[:, None] + np.arange(4), 1)
    # A: each byte by the 2 warps of its row band (wn = 0, 32); B: each
    # byte by the 2 warps of its column band (wm = 0, 32)
    assert (seen_a == 2).all() and (seen_b == 2).all()


@pytest.mark.parametrize("kg_rows", [0, 1])
def test_hand_over_is_conflict_free(kg_rows):
    """The int4 stores and loads of the hand-over buffer: 8 consecutive
    lanes per phase, 32 distinct banks."""
    for wq in range(4):
        for c in range(4):
            assert banks_free(red_index(kg_rows, wq, c) * 16, 16)


@pytest.mark.parametrize("k,n,blocks", [(576, 576, 144), (576, 192, 48),
                                        (576, 1536, 384), (1536, 576, 144)])
def test_grid_blocks_at_prefill_shapes(k, n, blocks):
    """One block per 64x64 output tile at M = 1024; K is inside the
    block (576 / 64 = 9 and 1536 / 64 = 24 steps, no zero-padded step)."""
    assert grid_blocks(1024, n) == blocks
    assert k % BK == 0


def test_header_static_shape():
    """The ring fits the 48 KB of static shared memory, keeps STAGES - 1
    steps in flight and holds the hand-over buffer; BK divides both model
    K; one k32 substep per K group, one chunk per tile per thread."""
    assert STAGES >= 2 and STAGES * 2 * TILE <= 48 * 1024
    assert 2 * 4 * 4 * 32 * 16 <= STAGES * 2 * TILE
    assert 576 % BK == 0 and 1536 % BK == 0
    assert WARPS == KGROUPS * (BM // 32) * (BN // 32) and KGROUPS * 32 == BK
    assert CHUNKS_PER_THREAD == 1


def test_entries_bound(monkeypatch):
    """The wrapper binds the tile (repro_quant_matmul) like the other
    entries; quant_matmul.cu also defines the old 64x64 tile
    (repro_quant_matmul_tile64, which only chip_smoke.py and the card-only
    tests bind) and the tile's grid (repro_quant_matmul_grid)."""
    bound = []
    monkeypatch.setattr(common, "bind",
                        lambda lib, sym, p, i: bound.append((lib, sym, p, i)))
    quant_matmul._kernel.cache_clear()
    quant_matmul._kernel()
    quant_matmul._kernel.cache_clear()
    assert bound == [("quant_matmul", "repro_quant_matmul", 6, 5)]
    assert not hasattr(quant_matmul, "_tile64_kernel")
    src = (CSRC / "quant_matmul.cu").read_text()
    assert '#include "s8_tile.cuh"' in src
    for sym in ("repro_quant_matmul", "repro_quant_matmul_tile64",
                "repro_quant_matmul_grid"):
        assert re.search(rf'extern "C" int {sym}\(', src)
    assert re.search(r"repro_quant_matmul_grid\(int M, int N\) \{\s*"
                     r"return static_cast<int>\(s8tile::grid_for\(M, N\)",
                     src)
