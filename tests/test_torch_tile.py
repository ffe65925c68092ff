"""The prefill tile's data flow, on the CPU.

`csrc/s8_tile.cuh` runs only on the card.  This file emulates it in
numpy, thread for thread, with the constants read from the header, for
both weight loaders (`TileW8`: int8 weights, `TileW4`: packed int4): each
thread's 16-byte chunk copies of the x and weight tiles (M/N/K masks,
the cp.async and byte paths) into the swizzled shared-memory stages, the
mma.sync m16n8k32 fragment reads of each K group's substep (A rows g /
g+8 at k = 4t.. and +16; the weight words of rows 4t+j at columns 4g --
32-bit int8 words transposed with the small-M kernel's `__byte_perm`
selectors, or 16-bit packed half-words unpacked by its `LoadW4Word`
columns), the products in the PTX fragment layouts, the hand-over of one
m16 row block between the two K groups, and the epilogue's mapping of C
fragments to real columns.  It checks that every staged byte is written
once with the right value, that every shared-memory store and load of
every warp is free of bank conflicts, and that the int32 sums and the
f32 output are bit-identical to the plain versions (`kernels/ref.py`).
One case holds the packed tile against the JAX reference's Pallas kernel
in interpret mode; nothing else here needs JAX.
"""
import pathlib
import re
from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.kernels import common, packed_matmul, quant_matmul, ref
from test_torch_small_m import columns_w4, transpose4x4

CSRC = pathlib.Path(quant_matmul.__file__).parent / "csrc"


HEADER = (CSRC / "s8_tile.cuh").read_text()


def _consts() -> dict:
    """The header's literal constants at namespace scope (`constexpr int
    NAME = literal;`, and the default of `#define S8TILE_NAME literal`)."""
    found = re.findall(r"\nconstexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;",
                       HEADER) + \
        re.findall(r"#define\s+S8TILE_(\w+)\s+(\d+)", HEADER)
    return {name: int(v) for name, v in found}


C = _consts()
BM, BN, BK, STAGES, KGROUPS, THREADS = (
    C[k] for k in ("BM", "BN", "BK", "STAGES", "KGROUPS", "THREADS"))
ROW, LINE, CHUNK = C["ROW_BYTES"], C["LINE_BYTES"], C["CHUNK"]
TILE = 64 * ROW
WARPS = THREADS // 32
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3
MAIN_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576)]


def _device_fn(scope: str, name: str, env: dict):
    """The header's `int name(int r, int c)` (searched in `scope`: the
    header, or one loader struct's text) as a Python function over numpy
    int arrays: its statements are C integer expressions that read the
    same in Python, so the emulation runs the header's own swizzles and
    fragment offsets."""
    m = re.search(rf"int {name}\(int r, int (\w+)\) \{{(.*?)\n\s*\}}", scope,
                  re.S)
    stmts = [" ".join(st.split()).replace("const int ", "")
             for st in m.group(2).split(";") if st.strip()]
    ns = dict(env)
    exec(f"def {name}(r, {m.group(1)}):\n" +
         "".join(f"    {st}\n" for st in stmts), ns)
    return ns[name]


_ENV = {"LINE_BYTES": LINE, "CHUNK": CHUNK}
swz = _device_fn(HEADER, "swz", _ENV)      # chunk c of a 64-byte row r
swz4 = _device_fn(HEADER, "swz4", _ENV)    # chunk c of a 32-byte row r
_ENV.update(swz=swz, swz4=swz4)


class Layout(NamedTuple):
    """A staged tile of 64 rows (the x tile, or a weight loader's): its
    row bytes, its swizzle, and for a weight loader the byte offset of the
    fragment word of columns col.. of k row r, the word's width in bytes,
    the logical columns per stored byte and the loader's columns()."""
    row: int
    swz: Callable
    frag: Callable = None
    width: int = 4
    cols_per_byte: int = 1
    columns: Callable = None


def _loader(name: str) -> Layout:
    """The loader struct `name` of the header as a Layout: its row bytes,
    columns per byte, chunk and frag functions, the width its read()
    loads and the small-M loader whose columns() it inherits."""
    scope = re.search(rf"struct {name} : s8small::(\w+) \{{.*?\n\}};", HEADER,
                      re.S)
    text = scope.group(0)
    row = re.search(r"int ROW = (\w+);", text).group(1)
    per = int(re.search(r"int COLS_PER_BYTE = (\d+);", text).group(1))
    width = 2 if "const uint16_t*" in text else 4
    columns = {"LoadW8Word": transpose4x4,
               "LoadW4Word": columns_w4}[scope.group(1)]
    return Layout(C[row], _device_fn(text, "chunk", _ENV),
                  _device_fn(text, "frag", _ENV), width, per, columns)


X = Layout(ROW, swz)
W8 = _loader("TileW8")
W4 = _loader("TileW4")


def warp_role(warp):
    """(kg, wq, wm, wn, kk): the warp's K group, its 32x32 warp tile in the
    2x2 grid and the k32 substep of each step it runs."""
    kg, wq = warp >> 2, warp & 3
    return kg, wq, (wq >> 1) * 32, (wq & 1) * 32, 32 * kg


def stage_tile(a, rows, cols, r0, c0, vec, layout=X):
    """The copies of one tile of every block: a [rows, cols] int8 (stored
    bytes), tile origins r0 / c0 [B].  Returns (shared image [B, 64 *
    row] uint8, writes per byte [B, 64 * row], byte offset of each
    thread's store [copies]): chunk q is issued by thread q (so a packed
    weight tile's 128 chunks by the first 128 threads), row q // (row /
    16), chunk q % (row / 16), zeros outside [rows, cols)."""
    nb = len(r0)
    per_row = layout.row // CHUNK
    q = np.arange(64 * per_row)
    r, c = q // per_row, q % per_row
    gr = r0[:, None] + r[None]                           # [B, Q]
    gc = c0[:, None] + CHUNK * c[None]
    if vec:   # a chunk lies wholly inside or outside cols
        assert cols % 16 == 0
        assert ((gc + CHUNK <= cols) | (gc >= cols)).all()
    gcb = gc[..., None] + np.arange(CHUNK)               # [B, Q, 16]
    live = (gr[..., None] < rows) & (gcb < cols)
    u = a.view(np.uint8)
    vals = np.where(live, u[np.where(live, gr[..., None], 0),
                            np.where(live, gcb, 0)], 0).astype(np.uint8)
    offs = layout.swz(r, c)                              # [Q]
    dst = offs[None, :, None] + np.arange(CHUNK)         # [1, Q, 16]
    image = np.zeros((nb, 64 * layout.row), dtype=np.uint8)
    writes = np.zeros((nb, 64 * layout.row), dtype=np.int64)
    bi = np.broadcast_to(np.arange(nb)[:, None, None], vals.shape)
    image[bi, np.broadcast_to(dst, vals.shape)] = vals
    np.add.at(writes, (bi, np.broadcast_to(dst, vals.shape)), 1)
    return image, writes, offs


def banks_free(byte_offs, width: int) -> bool:
    """One shared-memory instruction of a warp (lane byte offsets, each
    access `width` bytes) is conflict free: per phase (32 lanes for 4-byte
    accesses, 8 for 16-byte ones) no bank is asked for two different
    words."""
    per_phase = min(32, 32 * 4 // width)
    for p in range(0, 32, per_phase):
        words = {}
        for off in byte_offs[p:p + per_phase]:
            for wd in range(off // 4, (off + width - 1) // 4 + 1):
                words.setdefault(wd % 32, set()).add(wd)
        if any(len(s) > 1 for s in words.values()):
            return False
    return True


def fragment_offsets(warp, layout=W8):
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
    for h in range(2):
        for j in range(4):
            out[("B", h, j)] = layout.frag(kk + 16 * h + 4 * T + j,
                                           wn + 4 * G)
    return out


def _words(image, offs, width=4):
    """Little-endian words of `width` bytes of image [B, bytes] at
    offsets [32]."""
    b = image[:, offs[:, None] + np.arange(width)].astype(np.uint64)
    return sum(b[..., i] << np.uint64(8 * i) for i in range(width))


def _sbytes(word):
    """The 4 signed bytes of words [...] -> [..., 4] int64."""
    b = (word[..., None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF
    return b.astype(np.int64) - ((b & 0x80) << 1).astype(np.int64)


def mma_substep(xs_img, ws_img, warp, acc, layout=W8):
    """One warp's k32 substep of a step in every block: fragments from the
    stage images, the weight words through the loader's columns(), then
    mma.sync.m16n8k32.row.col in the PTX fragment layouts.  acc: [B, 32
    lanes, 2 (i), 4 (n8 tile c), 4 (c0..c3)] int64, updated."""
    offs = fragment_offsets(warp, layout)
    nb = xs_img.shape[0]
    a = np.zeros((nb, 2, 16, 32), dtype=np.int64)       # A of m16 tile i
    for i in range(2):
        for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
            v = _sbytes(_words(xs_img, offs[("A", i, reg)]))  # [B, 32, 4]
            for b in range(4):
                a[:, i, G + dr, dk + 4 * T + b] = v[:, :, b]
    bm = np.zeros((nb, 4, 32, 8), dtype=np.int64)       # B of n8 tile c
    for h in range(2):
        cols = layout.columns([_words(ws_img, offs[("B", h, j)],
                                      layout.width) for j in range(4)])
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


def emulate(x, w, xs=None, ws=None, *, packed=False, vec_x=None,
            vec_w=None):
    """The kernel over every block: (acc int32 [M,N], f32 or None) for
    int8 x [M,K] @ int8 w [K,N] (TileW8), or with packed=True @ packed
    int4 w [K, N//2] (TileW4).  The vector paths default to the wrapper's
    choice for aligned operands (a stored row of a multiple of 16)."""
    layout = W4 if packed else W8
    m, k = x.shape
    n = w.shape[1] * layout.cols_per_byte
    vec_x = k % 16 == 0 if vec_x is None else vec_x
    vec_w = w.shape[1] % 16 == 0 if vec_w is None else vec_w
    tiles_n = common.cdiv(n, BN)
    bid = np.arange(grid_blocks(m, n))
    m0, n0 = (bid // tiles_n) * BM, (bid % tiles_n) * BN
    acc = np.zeros((len(bid), WARPS, 32, 2, 4, 4), dtype=np.int64)
    for k0 in range(0, k, BK):
        xs_img, xw, _ = stage_tile(x, m, k, m0, np.full_like(m0, k0), vec_x)
        ws_img, ww, _ = stage_tile(w, k, w.shape[1], np.full_like(n0, k0),
                                   n0 // layout.cols_per_byte, vec_w, layout)
        assert (xw == 1).all() and (ww == 1).all()
        for warp in range(WARPS):
            mma_substep(xs_img, ws_img, warp, acc[:, warp], layout)
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


def _operands(rng, m, k, n, packed=False):
    """x, w (int8 [K,N], or packed words [K,N//2]), x_scale, w_scale."""
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n // 2 if packed else n)).astype(np.int8)
    xs = (rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32)
    ws = (rng.random((1, n)) * 0.02 + 1e-3).astype(np.float32)
    return x, w, xs, ws


def _check_plain(x, w, xs, ws, packed=False, **kw):
    acc, f = emulate(x, w, xs, ws, packed=packed, **kw)
    t = [torch.from_numpy(a) for a in (x, w, xs, ws)]
    acc_ref, out_ref = (
        (ref.packed_w4_matmul_acc_ref, ref.packed_w4_matmul_ref) if packed
        else (ref.quant_matmul_acc_ref, ref.quant_matmul_ref))
    assert np.array_equal(acc, acc_ref(*t[:2]).numpy())
    assert np.array_equal(f, out_ref(*t).numpy())


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


def _check_stage(a, rows, cols, vec, layout):
    """Every (row, byte) of a staged tile is written exactly once, with
    the matrix byte inside [rows, cols) and zero outside, for the tile at
    the matrix's ragged corner and at its origin."""
    r0 = np.array([0, (rows - 1) // 64 * 64])
    c0 = np.array([0, (cols - 1) // layout.row * layout.row])
    image, writes, _ = stage_tile(a, rows, cols, r0, c0, vec, layout)
    assert (writes == 1).all()
    r = np.arange(64)[:, None]
    c = np.arange(layout.row)[None, :]
    off = layout.swz(r, c // CHUNK) + c % CHUNK
    for b in range(2):
        gr, gc = r0[b] + r, c0[b] + c
        live = (gr < rows) & (gc < cols)
        want = np.where(live, a.view(np.uint8)[np.minimum(gr, rows - 1),
                                               np.minimum(gc, cols - 1)], 0)
        assert np.array_equal(image[b][off], want)


@pytest.mark.parametrize("which,rows,cols,vec", [
    ("x", 1024, 576, True), ("x", 70, 100, False), ("w", 576, 1536, True),
    ("w", 2100, 70, False)])
def test_stage_writes_every_byte_once(which, rows, cols, vec):
    """Every (row, column) of a staged tile is written exactly once, with
    the matrix byte inside [rows, cols) and zero outside (tile at the
    matrix's ragged corner and at its origin)."""
    rng = np.random.default_rng(rows + cols)
    a = rng.integers(-128, 128, (rows, cols)).astype(np.int8)
    _check_stage(a, rows, cols, vec, X)


def test_stage_stores_are_conflict_free():
    """Each warp's 16-byte stores (cp.async, or st.shared on the byte
    path): every 8-lane phase covers 32 distinct banks."""
    offs = stage_tile(np.zeros((64, 64), np.int8), 64, 64, np.zeros(1, int),
                      np.zeros(1, int), True)[2]
    assert len(offs) == THREADS
    for warp in range(WARPS):
        assert banks_free(offs[32 * warp:32 * (warp + 1)], CHUNK)


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
    """The ring fits the 48 KB of static shared memory with either loader
    and keeps STAGES - 1 steps in flight; the hand-over buffer fits in the
    block's shared memory; BK divides both model K; one k32 substep per K
    group, one x chunk per thread, and a packed w tile copied by whole
    warps (the first 4)."""
    w4_tile = 64 * W4.row
    assert W4.row * 2 == BN and w4_tile // CHUNK == THREADS // 2
    for w_tile in (TILE, w4_tile):
        assert STAGES >= 2 and STAGES * (TILE + w_tile) <= 48 * 1024
    assert C["RED_BYTES"] == 2 * 4 * 4 * 32 * 16 <= 48 * 1024
    assert 576 % BK == 0 and 1536 % BK == 0
    assert WARPS == KGROUPS * (BM // 32) * (BN // 32) and KGROUPS * 32 == BK
    assert TILE // CHUNK == THREADS


def test_entries_bound(monkeypatch):
    """Each wrapper binds its tile entry (repro_quant_matmul,
    repro_packed_w4_matmul), which launches s8_tile.cuh's tile with its
    weight loader (TileW8, TileW4); both sources also define the tile's
    grid (repro_*_grid), and nothing of the retired 64x64 tile is left.
    The batched entries of expert-stacked weights (repro_*_experts, the
    tile; repro_*_small_m_experts) take E and the x flag: 7 ints."""
    bound = []
    monkeypatch.setattr(common, "bind",
                        lambda lib, sym, p, i: bound.append((lib, sym, p, i)))
    for mod in (quant_matmul, packed_matmul):
        mod._kernel.cache_clear()
        mod._kernel()
        mod._kernel.cache_clear()
    assert bound == [("quant_matmul", "repro_quant_matmul", 6, 5),
                     ("packed_w4_matmul", "repro_packed_w4_matmul", 6, 5)]
    bound.clear()
    for mod in (quant_matmul, packed_matmul):
        for fn in (mod._experts_kernel, mod._small_m_experts_kernel):
            fn.cache_clear()
            fn()
            fn.cache_clear()
    assert bound == [
        ("quant_matmul", "repro_quant_matmul_experts", 6, 7),
        ("quant_matmul", "repro_quant_matmul_small_m_experts", 6, 7),
        ("packed_w4_matmul", "repro_packed_w4_matmul_experts", 6, 7),
        ("packed_w4_matmul", "repro_packed_w4_matmul_small_m_experts", 6, 7)]
    assert sorted(p.name for p in CSRC.glob("*.cuh")) == [
        "s8_small_m.cuh", "s8_tile.cuh", "swar.cuh"]
    for name, entry, loader in (
            ("quant_matmul", "repro_quant_matmul", "TileW8"),
            ("packed_w4_matmul", "repro_packed_w4_matmul", "TileW4")):
        src = (CSRC / f"{name}.cu").read_text()
        assert re.findall(r'#include "(\w+\.cuh)"', src) == [
            "s8_small_m.cuh", "s8_tile.cuh"]
        assert re.findall(r'extern "C" int (\w+)\(', src) == [
            entry, f"{entry}_grid", f"{entry}_small_m", f"{entry}_experts",
            f"{entry}_small_m_experts"]
        for e in (entry, f"{entry}_experts"):
            assert re.search(rf'extern "C" int {e}\([^)]*\) \{{\s*'
                             rf"return s8tile::launch_tile<s8tile::{loader}>"
                             r"\(", src), e
        assert re.search(rf"{entry}_grid\(int M, int N\) \{{\s*"
                         r"return static_cast<int>\(s8tile::grid_for\(M, N\)",
                         src), name


# --- the packed loader (TileW4): packed int4 weights, 32-byte k rows ---

@pytest.mark.parametrize("k,n", MAIN_KN)
def test_emulated_packed_tile_matches_plain_main_shapes(k, n):
    """The four prefill (K, N) of smollm-135m with packed weights, M cut
    from 1024 to 128 (two row tiles)."""
    rng = np.random.default_rng(k + n + 4)
    _check_plain(*_operands(rng, 128, k, n, packed=True), packed=True)


@pytest.mark.parametrize("m", [17, 70, 1027])
@pytest.mark.parametrize("k", [48, 100, 2100])
@pytest.mark.parametrize("n", [34, 70, 192])
def test_emulated_packed_tile_matches_plain_ragged(m, k, n):
    """Ragged M and K; N = 34 and 70 store 17 and 35 bytes per row (N/2
    odd: the weights' byte path, a last byte of 2 live columns in the
    last tile), N = 192 96 bytes (the vector path)."""
    rng = np.random.default_rng(7 * m + 3 * k + n + 4)
    _check_plain(*_operands(rng, m, k, n, packed=True), packed=True)


@pytest.mark.parametrize("m,k,n,vec", [(64, 576, 192, False),
                                       (17, 64, 64, False),
                                       (70, 576, 96, True)])
def test_packed_byte_path_matches_plain(m, k, n, vec):
    """Aligned shapes with both vector paths off: every chunk gathered
    byte by byte; and N = 96 on the vector path, whose last tile's second
    chunk of each row lies past N (a copy of size 0)."""
    rng = np.random.default_rng(m + k + n + 4)
    _check_plain(*_operands(rng, m, k, n, packed=True), packed=True,
                 vec_x=vec, vec_w=vec)


@pytest.mark.parametrize("xv", [-128, 127])
@pytest.mark.parametrize("wv", [-8, 7])
@pytest.mark.parametrize("n", [64, 70])
def test_packed_extremes_sum_exactly(xv, wv, n):
    """Every weight -8 (byte 0x80) or 7 (0x7F) against every x -128 or
    127, on the vector (N = 64) and byte (N = 70) paths."""
    byte = np.uint8(((wv + 8) | (wv << 4)) & 0xFF).view(np.int8)
    x = np.full((70, 1536), xv, dtype=np.int8)
    wp = np.full((1536, n // 2), byte, dtype=np.int8)
    acc, _ = emulate(x, wp, packed=True)
    assert (acc == 1536 * xv * wv).all()
    want = ref.packed_w4_matmul_acc_ref(torch.from_numpy(x),
                                        torch.from_numpy(wp))
    assert np.array_equal(acc, want.numpy())


@pytest.mark.parametrize("rows,n,vec", [(576, 1536, True), (2100, 70, False),
                                        (100, 34, False), (64, 96, True)])
def test_packed_stage_writes_every_byte_once(rows, n, vec):
    """The packed w tile (32 stored bytes of a k row per block) at the
    matrix's origin and ragged corner: every byte written once, zeros
    outside [K, N/2)."""
    rng = np.random.default_rng(rows + n)
    a = rng.integers(-128, 128, (rows, n // 2)).astype(np.int8)
    _check_stage(a, rows, n // 2, vec, W4)


def test_packed_stage_stores_are_conflict_free():
    """The packed tile's 128 chunk copies, issued by warps 0-3: every
    8-lane phase stores one line's 8 chunks, 32 distinct banks."""
    offs = stage_tile(np.zeros((64, 32), np.int8), 64, 32, np.zeros(1, int),
                      np.zeros(1, int), True, W4)[2]
    assert len(offs) == THREADS // 2
    for warp in range(len(offs) // 32):
        assert banks_free(offs[32 * warp:32 * (warp + 1)], CHUNK)


@pytest.mark.parametrize("warp", range(8))
def test_packed_fragment_reads_are_conflict_free(warp):
    """Every 16-bit B read of every warp: rows 4t + j of one chunk, the
    4 rows on consecutive lines moved to 4 distinct chunks by swz4; two
    lanes share each word."""
    for key, offs in fragment_offsets(warp, W4).items():
        if key[0] == "B":
            assert banks_free(offs, W4.width), key


def test_packed_reads_conflict_without_swizzle():
    """The check is not vacuous: 32-byte rows laid out plainly (row r at
    byte 32 r) put the B read's 4 rows at one offset of 4 consecutive
    lines, a 4-way conflict."""
    _, _, _, wn, kk = warp_role(0)
    plain = (kk + 4 * T) * W4.row + (wn + 4 * G) // 2
    assert not banks_free(plain, W4.width)


def test_packed_fragment_reads_cover_each_step_once():
    """Every byte of the packed w tile is read by the 2 warps of its
    column band, each k once per K group."""
    seen = np.zeros(64 * W4.row, int)
    for warp in range(WARPS):
        for (kind, *_), offs in fragment_offsets(warp, W4).items():
            if kind == "B":
                assert ((offs >= 0) & (offs + 2 <= seen.size)).all()
                np.add.at(seen, offs[:, None] + np.arange(2), 1)
    assert (seen == 2).all()


def test_emulated_packed_tile_matches_jax():
    """The emulated packed tile against the JAX reference's Pallas kernel
    (repro.kernels.packed_matmul.packed_w4_matmul_acc) in interpret mode,
    as tests/test_torch_kernels.py runs it on the CPU."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import packed_matmul as jpmm
    rng = np.random.default_rng(20)
    x, wp, _, _ = _operands(rng, 130, 576, 70, packed=True)
    acc, _ = emulate(x, wp, packed=True)
    want = np.asarray(jpmm.packed_w4_matmul_acc(
        jnp.asarray(x), jnp.asarray(wp), block=(8, 256, 128),
        interpret=True))
    assert np.array_equal(acc, want)


# --- expert-stacked weights: one launch, experts on blockIdx.y ---

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n", [(17, 100, 34), (70, 64, 64)])
def test_emulated_tile_experts_match_plain(m, k, n, packed, shared):
    """The tile over three experts in one launch (each expert's x, w,
    scales and outputs at its size_t offsets; or one x for all, stride 0)
    against the batched plain version, bit for bit: ragged M, K, N, both
    loaders, the vector and byte paths."""
    from test_torch_small_m import (check_experts_plain,  # noqa: E402
                                    expert_operands)
    rng = np.random.default_rng(m + k + n + 10 * packed + 100 * shared)
    check_experts_plain(emulate, *expert_operands(rng, 3, m, k, n, packed,
                                                  shared), packed)


def test_tile_grid_has_an_expert_axis():
    """grid_for(M, N, E): the 2-D linear grid on x, the experts on y (E = 1
    for a 2-D launch); every batched entry launches E experts and the
    2-D entries E = 1 with zero strides."""
    assert re.search(
        r"inline dim3 grid_for\(int M, int N, int E = 1\) \{\s*"
        r"return dim3\(static_cast<unsigned>\(\(\(M \+ BM - 1\) / BM\) \*"
        r"\s*\(\(N \+ BN - 1\) / BN\)\),\s*E\);", HEADER)
    for name, w_row in (("quant_matmul", "N"), ("packed_w4_matmul", "N / 2")):
        src = (CSRC / f"{name}.cu").read_text()
        assert src.count("s8small::ExpertStrides{}, stream);") == 2
        assert src.count(f"s8small::expert_strides(M, K, N, {w_row}, "
                         "x_per_expert != 0), stream);") == 2
