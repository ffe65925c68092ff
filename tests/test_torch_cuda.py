"""The Hopper kernels on the card, against their plain versions.

These need an NVIDIA GPU: they carry the `cuda` marker and skip without
one.  The file imports neither JAX nor the reference package, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py pins the JAX registry's caches.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (mul4, muladd2, packed_matmul,  # noqa: E402
                                 quant_matmul, ref, simd_add)

# ragged M / K / N (K=48 is not a multiple of 32; K=100 and N=34 miss the
# vector paths) and serving shapes of smollm-135m; then the ragged K and N
# at M on both sides of quant_matmul's switch (M <= 16: the small-M
# kernel, M > 16: the tile), the four decode (K, N) pairs at M = 8, and
# K past one of the small-M kernel's 1536-k rounds; then the prefill
# tile (M > 16) at the four main (K, N) with M on and off its 64 rows,
# and K / N off its 64 and off the 16-byte vector paths
RAGGED_KN = [(48, 16), (48, 128), (128, 48), (100, 34), (7, 6)]
MAIN_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
SHAPES = [(1, 48, 16), (3, 48, 128), (17, 128, 48), (2, 100, 34),
          (9, 7, 6), (8, 576, 192), (64, 1536, 576), (130, 576, 1536)] + \
    [(m, k, n) for m in (1, 8, 15, 16, 17) for k, n in RAGGED_KN] + \
    [(8, k, n) for k, n in ((576, 576), (576, 192), (576, 1536),
                            (1536, 576))] + [(16, 2100, 70)] + \
    [(m, k, n) for m in (17, 64, 1024, 1027) for k, n in MAIN_KN] + \
    [(100, 1000, 250), (1027, 2100, 70), (65, 48, 200), (300, 1600, 96)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (kernels have no CPU "
                    "mode); chip_smoke.py runs them on the card")
    return torch.device("cuda")


def _operands(rng, m, k, n, packed, dev):
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n // 2 if packed else n)).astype(np.int8)
    xs = (rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32)
    ws = (rng.random((1, n)) * 0.02 + 1e-3).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (x, w, xs, ws))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_kernels_bit_exact_vs_plain(cuda, packed):
    rng = np.random.default_rng(23)
    mod = packed_matmul if packed else quant_matmul
    acc_fn = mod.packed_w4_matmul_acc if packed else mod.quant_matmul_acc
    out_fn = mod.packed_w4_matmul if packed else mod.quant_matmul
    acc_ref = ref.packed_w4_matmul_acc_ref if packed \
        else ref.quant_matmul_acc_ref
    out_ref = ref.packed_w4_matmul_ref if packed else ref.quant_matmul_ref
    small = mod.SMALL_M_LAUNCHES
    for m, k, n in SHAPES:
        x, w, xs, ws = _operands(rng, m, k, n, packed, cuda)
        before, before_small = mod.LAUNCHES.count, small.count
        assert torch.equal(acc_fn(x, w), acc_ref(x, w)), (m, k, n)
        assert torch.equal(out_fn(x, w, xs, ws), out_ref(x, w, xs, ws)), \
            (m, k, n)
        assert mod.LAUNCHES.count == before + 2
        # rows M <= 16 go through the small-M kernel, others the tile
        want_small = 2 if m <= quant_matmul.SMALL_M else 0
        assert small.count == before_small + want_small, (m, k, n)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [1, 8, 16])
def test_cuda_small_m_unaligned_operands(cuda, m, packed):
    """x one byte off 4-byte alignment, w one byte off (packed w also two
    bytes off: 2- but not 4-byte aligned): the byte-load paths."""
    rng = np.random.default_rng(m)
    mod = packed_matmul if packed else quant_matmul
    acc_fn = mod.packed_w4_matmul_acc if packed else mod.quant_matmul_acc
    out_fn = mod.packed_w4_matmul if packed else mod.quant_matmul
    acc_ref = ref.packed_w4_matmul_acc_ref if packed \
        else ref.quant_matmul_acc_ref
    out_ref = ref.packed_w4_matmul_ref if packed else ref.quant_matmul_ref
    for k, n in ((576, 192), (100, 36)):
        x, w, xs, ws = _operands(rng, m, k, n, packed, cuda)
        for off in ((1, 2) if packed else (1,)):
            xu = torch.empty(m * k + 1, dtype=torch.int8, device=cuda)[1:]
            wu = torch.empty(w.numel() + off, dtype=torch.int8,
                             device=cuda)[off:]
            xu, wu = xu.view(m, k), wu.view(w.shape)
            xu.copy_(x)
            wu.copy_(w)
            assert xu.data_ptr() % 4 and wu.data_ptr() % 4
            assert wu.data_ptr() % 2 == off % 2
            before = mod.SMALL_M_LAUNCHES.count
            assert torch.equal(acc_fn(xu, wu), acc_ref(x, w)), (m, k, n)
            assert torch.equal(out_fn(xu, wu, xs, ws),
                               out_ref(x, w, xs, ws)), (m, k, n)
            assert mod.SMALL_M_LAUNCHES.count == before + 2
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 576, 192), (70, 100, 34),
                                   (17, 1536, 576)])
def test_cuda_tile_unaligned_operands(cuda, m, k, n):
    """x and w one byte off 16-byte alignment: the prefill tile gathers
    every chunk byte by byte (its cp.async path needs 16-byte chunks)."""
    rng = np.random.default_rng(m + k + n)
    x, w, xs, ws = _operands(rng, m, k, n, False, cuda)
    xu = torch.empty(m * k + 1, dtype=torch.int8, device=cuda)[1:]
    wu = torch.empty(k * n + 1, dtype=torch.int8, device=cuda)[1:]
    xu, wu = xu.view(m, k), wu.view(k, n)
    xu.copy_(x)
    wu.copy_(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 16
    before = quant_matmul.LAUNCHES.count, quant_matmul.SMALL_M_LAUNCHES.count
    assert torch.equal(quant_matmul.quant_matmul_acc(xu, wu),
                       ref.quant_matmul_acc_ref(x, w)), (m, k, n)
    assert torch.equal(quant_matmul.quant_matmul(xu, wu, xs, ws),
                       ref.quant_matmul_ref(x, w, xs, ws)), (m, k, n)
    assert (quant_matmul.LAUNCHES.count,
            quant_matmul.SMALL_M_LAUNCHES.count) == (before[0] + 2,
                                                     before[1])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_packed_tile_matches_plain(cuda, aligned):
    """The packed prefill tile (repro_packed_w4_matmul: s8_tile.cuh with
    the TileW4 loader) against the plain version, int32 and f32, at the
    four prefill shapes and ragged M > 16 ones (N/2 odd: N = 34, 70, 250;
    N = 96: a half tile on the vector path); unaligned, x and w one byte
    off 16-byte alignment, every chunk gathered byte by byte."""
    rng = np.random.default_rng(20 + aligned)
    shapes = [(1024, k, n) for k, n in MAIN_KN] + \
        [(17, 48, 16), (1027, 2100, 70), (65, 100, 34), (129, 1000, 250),
         (300, 576, 96)]
    small = packed_matmul.SMALL_M_LAUNCHES.count
    for m, k, n in shapes:
        x, w, xs, ws = _operands(rng, m, k, n, True, cuda)
        xu, wu = x, w
        if not aligned:
            xu = torch.empty(m * k + 1, dtype=torch.int8,
                             device=cuda)[1:].view(m, k)
            wu = torch.empty(w.numel() + 1, dtype=torch.int8,
                             device=cuda)[1:].view(w.shape)
            xu.copy_(x)
            wu.copy_(w)
            assert xu.data_ptr() % 16 and wu.data_ptr() % 16
        before = packed_matmul.LAUNCHES.count
        assert torch.equal(packed_matmul.packed_w4_matmul_acc(xu, wu),
                           ref.packed_w4_matmul_acc_ref(x, w)), (m, k, n)
        assert torch.equal(packed_matmul.packed_w4_matmul(xu, wu, xs, ws),
                           ref.packed_w4_matmul_ref(x, w, xs, ws)), (m, k, n)
        assert packed_matmul.LAUNCHES.count == before + 2
    assert packed_matmul.SMALL_M_LAUNCHES.count == small
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [8, 64])
def test_cuda_gemm_records_its_load_paths(cuda, m, packed):
    """Each GEMM launch records on its wrapper's counter the paths it
    took (`LaunchCounter.last`): the small-M kernels ask 4-byte vectors,
    the tiles 16; at N = 80 the packed row is 40 bytes, so the packed
    tile takes the byte path for w (as in_proj's 5288-byte rows of
    mamba2-2.7b do) and the others the vector path.  Results equal the
    plain versions."""
    mod = packed_matmul if packed else quant_matmul
    out_fn = mod.packed_w4_matmul if packed else mod.quant_matmul
    plain = ref.packed_w4_matmul_ref if packed else ref.quant_matmul_ref
    x, w, xs, ws = _operands(np.random.default_rng(40 + m + packed), m, 64,
                             80, packed, cuda)
    assert torch.equal(out_fn(x, w, xs, ws), plain(x, w, xs, ws))
    small = m <= quant_matmul.SMALL_M
    assert mod.LAUNCHES.last == {"vec_bytes": 4 if small else 16,
                                 "vec_x": True,
                                 "vec_w": small or not packed}


@pytest.mark.cuda
def test_cuda_tile_grid(cuda):
    """The grid the prefill tile's launchers compute
    (repro_quant_matmul_grid, repro_packed_w4_matmul_grid): one block per
    64x64 output tile, 144 / 48 / 384 / 144 blocks at the four prefill
    shapes, for either weight format."""
    import ctypes

    from repro_torch.kernels import _build
    for name in ("quant_matmul", "packed_w4_matmul"):
        grid = getattr(_build.load(name), f"repro_{name}_grid")
        grid.argtypes = [ctypes.c_int, ctypes.c_int]
        grid.restype = ctypes.c_int
        assert [grid(1024, n) for _, n in MAIN_KN] == [144, 48, 384, 144]
        assert [grid(m, n) for m, n in ((17, 34), (65, 70), (1027, 70))] \
            == [1, 4, 34]


@pytest.mark.cuda
def test_cuda_kernel_refuses_bad_operands(cuda):
    x = torch.zeros((4, 48), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="K mismatch"):
        quant_matmul.quant_matmul_acc(x, torch.zeros((40, 16),
                                                     dtype=torch.int8,
                                                     device=cuda))
    with pytest.raises(ValueError, match="int8"):
        quant_matmul.quant_matmul_acc(x.float(), torch.zeros(
            (48, 16), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        packed_matmul.packed_w4_matmul(
            x, torch.zeros((48, 8), dtype=torch.int8, device=cuda),
            torch.ones((4, 1), dtype=torch.bfloat16, device=cuda),
            torch.ones((1, 16), device=cuda))


@pytest.mark.cuda
def test_cuda_serve_matches_plain_forced(cuda):
    """The reduced model served through the kernels equals the same run on
    the plain versions, token for token and logit for logit."""
    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    cfg = configs.get_reduced_config("smollm-135m")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (3, 8))
    for fmt in ("w4a8", "w8a8"):
        params = serve.build_params(cfg, fmt, quant_force=True, device=cuda)
        toks, logits = serve.generate(params, prompts, cfg, gen=5,
                                      cache_len=13, device=cuda,
                                      return_logits=True)
        with registry.force("ref"):
            toks_p, logits_p = serve.generate(params, prompts, cfg, gen=5,
                                              cache_len=13, device=cuda,
                                              return_logits=True)
        assert torch.equal(toks, toks_p) and torch.equal(logits, logits_p)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_tile_wraps_like_plain(cuda, packed):
    """ROADMAP C5: at K = 131073 an int8 sum of all -128 operands leaves
    the int32 range; the tile (M = 17) wraps it as the plain version and
    the reference do (a packed sum stays inside the range there: checked
    all the same).  Random operands at the same K too.  The small-M
    kernel wraps too: test_cuda_small_m_wraps_like_plain."""
    k = 131073
    mod = packed_matmul if packed else quant_matmul
    acc_fn = mod.packed_w4_matmul_acc if packed else mod.quant_matmul_acc
    out_fn = mod.packed_w4_matmul if packed else mod.quant_matmul
    acc_ref = ref.packed_w4_matmul_acc_ref if packed \
        else ref.quant_matmul_acc_ref
    out_ref = ref.packed_w4_matmul_ref if packed else ref.quant_matmul_ref
    n = 34
    x = torch.full((17, k), -128, dtype=torch.int8, device=cuda)
    w = torch.full((k, n // 2 if packed else n), -128, dtype=torch.int8,
                   device=cuda)
    xs = torch.full((17, 1), 0.5, device=cuda)
    ws = torch.full((1, n), 0.25, device=cuda)
    for xx, ww in ((x, w), tuple(_operands(np.random.default_rng(5), 17, k,
                                           n, packed, cuda))[:2]):
        before = mod.SMALL_M_LAUNCHES.count
        acc = acc_fn(xx, ww)
        assert torch.equal(acc, acc_ref(xx, ww))
        assert torch.equal(out_fn(xx, ww, xs, ws), out_ref(xx, ww, xs, ws))
        assert mod.SMALL_M_LAUNCHES.count == before
    if not packed:
        assert bool((acc_ref(x, w) == -2147467264).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_small_m_wraps_like_plain(cuda, packed):
    """ROADMAP C5, the small-M kernel: at M = 8, K = 131073 its lane and
    warp sums wrap modulo 2^32 as the plain version and the reference
    do (x = w = -128: every int8 sum leaves the int32 range; packed int4
    sums stay inside it), bit for bit; random operands at the same K
    too."""
    k, n = 131073, 34
    mod = packed_matmul if packed else quant_matmul
    acc_fn = mod.packed_w4_matmul_acc if packed else mod.quant_matmul_acc
    out_fn = mod.packed_w4_matmul if packed else mod.quant_matmul
    acc_ref = ref.packed_w4_matmul_acc_ref if packed \
        else ref.quant_matmul_acc_ref
    out_ref = ref.packed_w4_matmul_ref if packed else ref.quant_matmul_ref
    x = torch.full((8, k), -128, dtype=torch.int8, device=cuda)
    w = torch.full((k, n // 2 if packed else n), -128, dtype=torch.int8,
                   device=cuda)
    xs = torch.full((8, 1), 0.5, device=cuda)
    ws = torch.full((1, n), 0.25, device=cuda)
    for xx, ww in ((x, w), tuple(_operands(np.random.default_rng(6), 8, k,
                                           n, packed, cuda))[:2]):
        before = mod.SMALL_M_LAUNCHES.count
        assert torch.equal(acc_fn(xx, ww), acc_ref(xx, ww))
        assert torch.equal(out_fn(xx, ww, xs, ws), out_ref(xx, ww, xs, ws))
        assert mod.SMALL_M_LAUNCHES.count == before + 2
    if not packed:
        assert bool((acc_fn(x, w) == -2147467264).all())
    torch.cuda.synchronize()


def _counts():
    from repro_torch.kernels import registry
    return {c.name: c.count for c in registry.LAUNCH_COUNTERS}


def _served(cuda, fmt, seed=0):
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.get_reduced_config("smollm-135m")
    return cfg, serve.build_params(cfg, fmt, seed=seed, quant_force=True,
                                   device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_eager_gemm_bypasses_custom_op(cuda, packed, monkeypatch):
    """Run eagerly, each GEMM wrapper launches its kernel directly: the
    custom op (for traced graphs only) is never dispatched."""
    from repro_torch.kernels import packed_matmul, quant_matmul
    mod, fn, op = (packed_matmul, packed_matmul.packed_w4_matmul,
                   "_packed_w4_matmul_op") if packed else \
        (quant_matmul, quant_matmul.quant_matmul, "_quant_matmul_op")

    def refuse(*args):
        raise AssertionError("custom op dispatched eagerly")

    monkeypatch.setattr(mod, op, refuse)
    for m in (8, 64):
        x, w, xs, ws = _operands(np.random.default_rng(m), m, 576, 192,
                                 packed, cuda)
        before = mod.LAUNCHES.count
        fn(x, w, xs, ws)
        assert mod.LAUNCHES.count == before + 1
    torch.cuda.synchronize()


def _profiled_launches(run):
    """run()'s launches per wrapper counter as the profiler saw them on
    the device (a graph replay launches without the wrappers), in a
    `registry.profile_window`."""
    from repro_torch.kernels import registry
    with registry.profile_window() as prof:
        run()
        torch.cuda.synchronize()
    return registry.profiled_launches({
        e.key: e.count for e in registry.window_events(prof)})


@pytest.mark.cuda
@pytest.mark.parametrize("silvia_passes", ["off", "all"])
@pytest.mark.parametrize("fmt", ["w4a8", "w8a8"])
def test_cuda_fused_decode_matches_stepwise(cuda, fmt, silvia_passes):
    """generate(fused=True) replays one captured decode step: tokens and
    logits equal the per-step loop's bit for bit, at the first call (the
    capture) and at a replay of the same graph.  The wrappers count the
    prefill, the warm-up step and the capture, never a replay; the
    profiler sees a replayed run launch what the per-step run launched."""
    from repro_torch.launch import serve
    serve.decode_cache_clear()       # graphs of earlier tests' params
    cfg, params = _served(cuda, fmt)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (3, 8))
    out = []

    def run(fused):
        before = _counts()
        out.append(serve.generate(params, prompts, cfg, gen=6, cache_len=14,
                                  silvia_passes=silvia_passes, fused=fused,
                                  device=cuda, return_logits=True))
        torch.cuda.synchronize()
        return {k: n - before[k] for k, n in _counts().items()}

    name = "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul"
    per_step = 7 * cfg.n_layers
    launches = run(False)
    assert launches[name] == per_step * 6
    assert launches[f"{name}_small_m"] == per_step * 5
    bundle = serve._decode_bundle(cfg, silvia_passes, cuda)
    first = run(True)
    assert first[f"{name}_small_m"] == 2 * per_step     # warm-up, capture
    assert first[name] == 3 * per_step
    # the profiler can drop a share of a profile's events: a run it
    # counts short (and never over) is driven again, three runs at most
    for _ in range(3):
        profiled = _profiled_launches(lambda: run(True))
        if all(n >= launches[k] for k, n in profiled.items()) or \
                any(n > launches[k] for k, n in profiled.items()):
            break
    assert profiled == launches
    assert bundle.captures == 1
    toks, logits = out[0]
    for toks_f, logits_f in out[1:]:
        assert torch.equal(toks_f, toks) and torch.equal(logits_f, logits)


@pytest.mark.cuda
def test_cuda_fused_decode_two_params_trees(cuda):
    """Two params trees of one config share a bundle, which re-captures
    its one step for each tree in turn: each replays its own weights."""
    from repro_torch.launch import serve
    serve.decode_cache_clear()
    cfg, p0 = _served(cuda, "w4a8", seed=0)
    _, p1 = _served(cuda, "w4a8", seed=1)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab, (2, 8))

    def gen(p, fused):
        return serve.generate(p, prompts, cfg, gen=5, cache_len=12,
                              fused=fused, device=cuda, return_logits=True)

    want = [gen(p, False) for p in (p0, p1)]
    assert not torch.equal(want[0][1], want[1][1])
    for p, w in ((p0, want[0]), (p1, want[1]), (p0, want[0])):
        got = gen(p, True)
        assert torch.equal(got[0], w[0]) and torch.equal(got[1], w[1])
    assert serve._decode_bundle(cfg, "off", cuda).captures == 3


@pytest.mark.cuda
def test_cuda_fused_decode_forced_plain_launches_nothing(cuda):
    """Under registry.force("ref") the captured step runs the plain
    versions: no kernel launches, the same tokens and logits."""
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    cfg, params = _served(cuda, "w8a8")
    prompts = np.random.default_rng(9).integers(0, cfg.vocab, (2, 8))
    want = serve.generate(params, prompts, cfg, gen=5, cache_len=12,
                          device=cuda, return_logits=True)
    before = _counts()
    with registry.force("ref"):
        got = serve.generate(params, prompts, cfg, gen=5, cache_len=12,
                             device=cuda, return_logits=True)
    torch.cuda.synchronize()
    assert _counts() == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["w4a8", "w8a8"])
def test_cuda_fused_decode_int8_kv_matches_stepwise(cuda, fmt):
    """qwen-reduced with nonzero q/k/v biases and the int8 KV cache: the
    captured step's tokens and logits equal the per-step loop's and the
    plain versions', bit for bit; its cache holds int8 values and float32
    scales, updated in place."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    serve.decode_cache_clear()
    cfg = dataclasses.replace(configs.get_reduced_config("qwen1.5-0.5b"),
                              serve_kv_dtype="int8")
    params = serve.build_params(cfg, fmt, quant_force=True, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    attn = params["blocks"]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = torch.randn(attn[b].shape, generator=gen, device=cuda,
                              dtype=torch.float32).to(attn[b].dtype)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (3, 8))
    kw = dict(gen=6, cache_len=14, device=cuda, return_logits=True)
    stepwise = serve.generate(params, prompts, cfg, fused=False, **kw)
    fused = serve.generate(params, prompts, cfg, **kw)
    with registry.force("ref"):
        plain = serve.generate(params, prompts, cfg, **kw)
    for got in (fused, plain):
        assert torch.equal(got[0], stepwise[0])
        assert torch.equal(got[1], stepwise[1])
    cache = serve._decode_bundle(cfg, "off", cuda).step.cache
    assert cache["k"].dtype == torch.int8
    assert cache["k_s"].dtype == torch.float32
    assert bool((cache["k_s"][:, :, 8:13] > 1e-8).all())


@pytest.mark.cuda
def test_cuda_attn_q_chunk_prefill_matches_unchunked(cuda):
    """yi-reduced in float32: the chunked prefill's logits equal the
    unchunked one's within 1e-4 (the reference's bound), the caches bit
    for bit (the chunks change only the attention's query blocks)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get_reduced_config("yi-6b"),
                              dtype="float32")
    params = serve.build_params(cfg, "w4a8", quant_force=True, device=cuda)
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 64))).to(cuda)
    want, want_kv = lm.prefill(params, prompts, cfg, cache_len=64)
    got, got_kv = lm.prefill(params, prompts, dataclasses.replace(
        cfg, attn_q_chunk=16), cache_len=64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for k in want_kv:
        assert torch.equal(got_kv[k], want_kv[k])


# ragged element counts (not multiples of the 16 a thread owns, so the
# masked tail runs) and aligned ones (the 16-byte path)
SWAR_SHAPES = [(1,), (5,), (17, 3), (4096,), (33, 65), (2, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("lane_bits,k", [(8, 1), (8, 3), (8, 4), (16, 1),
                                         (16, 2)])
@pytest.mark.parametrize("sub", [False, True])
def test_cuda_simd_add_bit_exact_vs_plain(cuda, lane_bits, k, sub):
    rng = np.random.default_rng(lane_bits * 10 + k + sub)
    dt = np.int8 if lane_bits == 8 else np.int16
    lo = -(1 << (lane_bits - 1))
    for shape in SWAR_SHAPES:
        xs = [torch.from_numpy(rng.integers(lo, -lo, shape).astype(dt))
              .to(cuda) for _ in range(k)]
        ys = [torch.from_numpy(rng.integers(lo, -lo, shape).astype(dt))
              .to(cuda) for _ in range(k)]
        before = simd_add.LAUNCHES.count
        got = simd_add.simd_add(xs, ys, lane_bits=lane_bits, sub=sub)
        assert simd_add.LAUNCHES.count == before + 1
        want = ref.simd_add_ref(xs, ys, sub=sub, lane_bits=lane_bits)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), shape
        xw, yw = (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape)
                                   .astype(np.int32)).to(cuda)
                  for _ in range(2))
        assert torch.equal(
            simd_add.simd_add_packed(xw, yw, lane_bits=lane_bits, sub=sub),
            simd_add.simd_add_packed_plain(xw, yw, lane_bits=lane_bits,
                                           sub=sub)), shape
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 9, 31])
def test_cuda_muladd2_bit_exact_vs_plain(cuda, n):
    rng = np.random.default_rng(n)
    lo = -128 if n == 1 else -8
    for shape in SWAR_SHAPES:
        a, b = (torch.from_numpy(rng.integers(lo, -lo, (n, *shape))
                                 .astype(np.int8)).to(cuda) for _ in range(2))
        c = torch.from_numpy(rng.integers(-128, 128, (n, *shape))
                             .astype(np.int8)).to(cuda)
        before = muladd2.LAUNCHES.count
        got = muladd2.muladd2(a, b, c)
        assert muladd2.LAUNCHES.count == before + 1
        want = muladd2.muladd2_plain(a, b, c)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), shape
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [True, False])
def test_cuda_mul4_bit_exact_vs_plain(cuda, signed):
    rng = np.random.default_rng(int(signed))
    lo, hi = (-8, 8) if signed else (0, 16)
    for shape in SWAR_SHAPES:
        a = torch.from_numpy(rng.integers(lo, hi, (4, *shape))
                             .astype(np.int8)).to(cuda)
        b = torch.from_numpy(rng.integers(lo, hi, shape)
                             .astype(np.int8)).to(cuda)
        # b also as a view one byte into its storage: no vector path
        b_off = torch.empty(b.numel() + 1, dtype=torch.int8,
                            device=cuda)[1:].view(shape)
        b_off.copy_(b)
        assert b_off.data_ptr() % 16 == 1
        want = mul4.mul4_plain(a, b)
        for bb in (b, b_off):
            for fn, counter in ((mul4.mul4_full32, mul4.LAUNCHES),
                                (mul4.mul4_split, mul4.SPLIT_LAUNCHES)):
                before = counter.count
                got = fn(a, bb, signed=signed)
                assert counter.count == before + 1
                assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                    (fn.__name__, shape, bb.data_ptr() % 16)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_optimized_program_matches_unoptimized(cuda):
    """The 4-bit conv pair through the SILVIA passes on the card: one
    muladd2 launch per call, outputs equal to the unrewritten program."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch import core as silvia
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-128, 128, (3, 20, 20))
                         .astype(np.int8)).to(cuda)
    w_even, w_odd = (torch.from_numpy(rng.integers(-8, 8, (9,))
                                      .astype(np.int8)).to(cuda)
                     for _ in range(2))
    opt = silvia.optimize(chip_smoke.conv3x3_pair_4b,
                          [silvia.PassConfig(op="muladd", m_bits=4)])
    before = muladd2.LAUNCHES.count
    got = opt(x, w_even, w_odd)
    assert muladd2.LAUNCHES.count == before + 1
    want = chip_smoke.conv3x3_pair_4b(x, w_even, w_odd)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["MMM", "MMM-4b"])
def test_cuda_scan_program_launches_per_iteration(cuda, name):
    """MMM / MMM-4b through the SILVIA passes on the card: the packed unit
    sits in the scan body and launches once per call of the body
    (muladd2 / mul4_full32: K times a call, plus the calls torch's eager
    scan adds, chip_smoke.scan_extra_calls); outputs equal the
    unrewritten program bit for bit."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch import core as silvia
    _, fn, make, specs, *_, launches = next(
        s for s in chip_smoke.program_specs(card=False) if s[0] == name)
    rng = np.random.default_rng(10)
    i8 = lambda *s: torch.from_numpy(rng.integers(-128, 128, s)
                                     .astype(np.int8)).to(cuda)
    i4 = lambda *s: torch.from_numpy(rng.integers(-8, 8, s)
                                     .astype(np.int8)).to(cuda)
    args = make(i8, i4, None)
    opt = silvia.optimize(fn, [silvia.PassConfig(**p) for p in specs])
    opt(*args)                      # trace + rewrite
    (kname, want), = launches.items()
    counter = {"muladd2": muladd2.LAUNCHES,
               "mul4_full32": mul4.LAUNCHES}[kname]
    before = counter.count
    got = opt(*args)
    assert counter.count == before + want
    assert all(torch.equal(g, w) for g, w in zip(got, fn(*args)))


# --- expert-stacked weights (the MoE family): one launch per weight ---

EXPERT_SHAPES = [(3, 1, 100, 34), (4, 8, 1024, 512), (4, 16, 512, 1024),
                 (3, 17, 100, 34), (2, 1024, 512, 1024), (5, 70, 48, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_experts_bit_exact_vs_plain(cuda, packed, shared):
    """Both kernels on [E, K, N] weights against the batched plain
    version, acc and f32 out bit for bit, each call ONE launch (on the
    small-M counter for M <= 16 rows per expert, whatever E x M); with
    shared, one x expanded to every expert (stride 0, not copied).  E = 1
    equals the 2-D entry bit for bit."""
    rng = np.random.default_rng(31 + packed + 2 * shared)
    mod = packed_matmul if packed else quant_matmul
    acc_fn = mod.packed_w4_matmul_acc if packed else mod.quant_matmul_acc
    out_fn = mod.packed_w4_matmul if packed else mod.quant_matmul
    acc_ref = ref.packed_w4_matmul_acc_ref if packed \
        else ref.quant_matmul_acc_ref
    out_ref = ref.packed_w4_matmul_ref if packed else ref.quant_matmul_ref
    for e, m, k, n in EXPERT_SHAPES:
        x, _, xs, _ = _operands(rng, m, k, n, packed, cuda)
        w = torch.randint(-128, 128, (e, k, n // 2 if packed else n),
                          dtype=torch.int8, device=cuda)
        ws = torch.rand((e, 1, n), device=cuda) * 0.02 + 1e-3
        if shared:
            x, xs = x.expand(e, m, k), xs.expand(e, m, 1)
        else:
            x = torch.randint(-128, 128, (e, m, k), dtype=torch.int8,
                              device=cuda)
            xs = torch.rand((e, m, 1), device=cuda) * 0.02 + 1e-3
        before = (mod.LAUNCHES.count, mod.SMALL_M_LAUNCHES.count)
        assert torch.equal(acc_fn(x, w), acc_ref(x, w)), (e, m, k, n)
        assert torch.equal(out_fn(x, w, xs, ws), out_ref(x, w, xs, ws)), \
            (e, m, k, n)
        small = 2 if m <= quant_matmul.SMALL_M else 0
        assert (mod.LAUNCHES.count, mod.SMALL_M_LAUNCHES.count) == \
            (before[0] + 2, before[1] + small), (e, m, k, n)
        one = out_fn(x[:1].contiguous(), w[:1], xs[:1].contiguous(), ws[:1])
        assert torch.equal(one[0], out_fn(x[0].contiguous(), w[0],
                                          xs[0].contiguous(), ws[0]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["w4a8", "w8a8"])
def test_cuda_moe_fused_decode_matches_stepwise(cuda, fmt):
    """Reduced granite through generate(fused=True), the captured decode
    step with its topk / scatter routing and expert-stacked GEMMs, equals
    the per-step loop bit for bit; each layer launches 4 attention and 3
    expert GEMMs per step (7, as a dense layer), the untied head one."""
    from repro_torch import configs
    from repro_torch.launch import serve
    serve.decode_cache_clear()
    cfg = configs.get_reduced_config("granite-moe-1b-a400m")
    params = serve.build_params(cfg, fmt, quant_force=True, device=cuda)
    prompts = np.random.default_rng(12).integers(0, cfg.vocab, (3, 8))
    name = "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul"
    out = []
    for fused in (False, True):
        before = _counts()
        out.append(serve.generate(params, prompts, cfg, gen=6, cache_len=14,
                                  fused=fused, device=cuda,
                                  return_logits=True))
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in _counts().items()}
        if not fused:
            assert launched[name] == (7 * cfg.n_layers + 1) * 6
            assert launched[f"{name}_small_m"] == (7 * cfg.n_layers + 1) \
                * 5 + 1
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    from repro_torch.kernels import registry
    with registry.force("ref"):
        plain = serve.generate(params, prompts, cfg, gen=6, cache_len=14,
                               device=cuda, return_logits=True)
    assert torch.equal(plain[0], out[0][0]) and \
        torch.equal(plain[1], out[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["w4a8", "w8a8"])
def test_cuda_ssm_fused_decode_matches_stepwise(cuda, fmt):
    """Reduced mamba2 through generate(fused=True): the captured decode
    step updates the {ssm, conv} state in place as static buffers and
    equals the per-step loop and the plain-forced run bit for bit; the
    prompt of 20 tokens runs on the fixed chunk grid (padded to 32); two
    GEMMs per layer (in_proj, out_proj) and token, none for the tied
    head."""
    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    serve.decode_cache_clear()
    cfg = configs.get_reduced_config("mamba2-2.7b")
    params = serve.build_params(cfg, fmt, quant_force=True, device=cuda)
    prompts = np.random.default_rng(13).integers(0, cfg.vocab, (3, 20))
    name = "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul"
    out = []
    for fused in (False, True):
        before = _counts()
        out.append(serve.generate(params, prompts, cfg, gen=6, cache_len=26,
                                  fused=fused, device=cuda,
                                  return_logits=True))
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in _counts().items()}
        if not fused:
            assert launched[name] == 2 * cfg.n_layers * 6
            assert launched[f"{name}_small_m"] == 2 * cfg.n_layers * 5
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    step = serve._decode_bundle(cfg, "off", cuda).step
    assert set(step.cache) == {"ssm", "conv"}
    with registry.force("ref"):
        plain = serve.generate(params, prompts, cfg, gen=6, cache_len=26,
                               device=cuda, return_logits=True)
    assert torch.equal(plain[0], out[0][0]) and \
        torch.equal(plain[1], out[0][1])


def _chip_smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
def test_cuda_hybrid_reduced_matches_cpu(cuda):
    """Reduced jamba at 2 scan units (float32) on the card against its
    CPU run on the same weights, both formats, teacher-forced one GEMM
    and one MoE layer at a time (chip_smoke.py's `teacher_forced_vs_cpu`:
    every GEMM's output from the CPU's input bit for bit; every GEMM's
    and MoE layer's input, the logits and the cache within CARD_CPU_RTOL
    at the prefill and every decode step)."""
    _chip_smoke().hybrid_reduced_vs_cpu(
        torch.Generator(device="cuda").manual_seed(3))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b",
                                  "jamba-v0.1-52b"])
def test_cuda_build_params_matches_whole_tree(cuda, arch):
    """build_params on the card (each matrix quantized as it is drawn from
    the card's generator) equals quantize_tree_for_serving over
    lm.init_params' whole tree on the card, bit for bit, forced and not,
    under both formats."""
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.quant import qtensor
    cfg = configs.get_reduced_config(arch)
    for fmt in ("w4a8", "w8a8"):
        for force in (False, True):
            got = serve.build_params(cfg, fmt, seed=4, quant_force=force,
                                     device=cuda)
            want = qtensor.quantize_tree_for_serving(
                lm.init_params(cfg, 4, device=cuda), fmt, force=force)
            g, gs = pytree.tree_flatten(got)
            w, ws = pytree.tree_flatten(want)
            assert gs == ws
            assert all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["w4a8", "w8a8"])
def test_cuda_hybrid_fused_decode_matches_stepwise(cuda, fmt):
    """Reduced jamba at 2 scan units through generate(fused=True): the
    captured decode step updates the flat hybrid cache (the mixers'
    {ssm, conv} state and the attention layers' {k, v}) in place as
    static buffers and equals the per-step loop and the plain-forced run
    bit for bit; 42 GEMM launches per unit and token, the untied head
    one."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    serve.decode_cache_clear()
    cfg = dataclasses.replace(configs.get_reduced_config("jamba-v0.1-52b"),
                              n_layers=16)
    params = serve.build_params(cfg, fmt, quant_force=True, device=cuda)
    prompts = np.random.default_rng(14).integers(0, cfg.vocab, (3, 20))
    name = "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul"
    out = []
    for fused in (False, True):
        before = _counts()
        out.append(serve.generate(params, prompts, cfg, gen=6, cache_len=26,
                                  fused=fused, device=cuda,
                                  return_logits=True))
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in _counts().items()}
        if not fused:
            assert launched[name] == (42 * 2 + 1) * 6
            assert launched[f"{name}_small_m"] == 42 * 2 * 5 + 6
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    step = serve._decode_bundle(cfg, "off", cuda).step
    assert set(step.cache) == {"ssm", "conv", "k", "v"}
    with registry.force("ref"):
        plain = serve.generate(params, prompts, cfg, gen=6, cache_len=26,
                               device=cuda, return_logits=True)
    assert torch.equal(plain[0], out[0][0]) and \
        torch.equal(plain[1], out[0][1])
