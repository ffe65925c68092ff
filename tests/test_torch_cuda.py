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

from repro_torch.kernels import packed_matmul, quant_matmul, ref  # noqa: E402

# ragged M / K / N (K=48 is not a multiple of 32; K=100 and N=34 miss the
# vector paths) and serving shapes of smollm-135m
SHAPES = [(1, 48, 16), (3, 48, 128), (17, 128, 48), (2, 100, 34),
          (9, 7, 6), (8, 576, 192), (64, 1536, 576), (130, 576, 1536)]


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
    for m, k, n in SHAPES:
        x, w, xs, ws = _operands(rng, m, k, n, packed, cuda)
        before = mod.LAUNCHES.count
        assert torch.equal(acc_fn(x, w), acc_ref(x, w)), (m, k, n)
        assert torch.equal(out_fn(x, w, xs, ws), out_ref(x, w, xs, ws)), \
            (m, k, n)
        assert mod.LAUNCHES.count == before + 2
    torch.cuda.synchronize()


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
