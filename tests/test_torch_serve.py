"""The port's greedy `generate` and serving CLI against `repro`.

Free-running greedy tokens are compared only where they are stable: on
random reduced weights the reference's top-1/top-2 logit gap can be one
bf16 step, below the two frameworks' rounding differences.  So at each
step, while the port's context still equals the reference's, the tokens
must be equal where the reference's margin exceeds twice the logit
tolerance; elsewhere the port's token must score within the tolerance of
the reference's maximum, and once the tokens part the row's later steps
have different contexts and are not compared.  Tolerances and their
reasons: tests/test_torch_model.py.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smollm_135m as jsmollm  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.quant.qtensor import QTensor as JQTensor  # noqa: E402
from repro.quant.qtensor import \
    quantize_tree_for_serving as jquantize_tree  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smollm_135m as tsmollm  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.03}
B, S, G = 3, 8, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for every core; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_numpy(tree):
    def leaf(x):
        if isinstance(x, JQTensor):
            return (np.asarray(x.q), np.asarray(x.scale), x.fmt)
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree_util.tree_map(
        leaf, tree, is_leaf=lambda x: isinstance(x, JQTensor))


_SETUPS = {}


def _setup(dtype, fmt):
    """(jax cfg, port cfg, jax params, port params) on the same weights;
    memoized per module (read-only use)."""
    if (dtype, fmt) not in _SETUPS:
        jcfg = dataclasses.replace(jsmollm.reduced(), dtype=dtype)
        tcfg = dataclasses.replace(tsmollm.reduced(), dtype=dtype)
        jp = jquantize_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg,
                                            max_seq=64), fmt, force=True)
        _SETUPS[dtype, fmt] = (jcfg, tcfg, jp, convert.from_jax_params(
            _to_numpy(jp), device="cpu"))
    return _SETUPS[dtype, fmt]


_jit_prefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
_jit_decode = jax.jit(jlm.decode_step, static_argnums=(4,))


def _reference_logits(jp, jcfg, prompts, toks):
    """The reference's logits at each generate step, teacher-forced on its
    own tokens: [B, G, V]."""
    lg, cache = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S + G)
    out = [np.asarray(lg[:, -1])]
    for i in range(G - 1):
        pos = jnp.full((B,), S + i, jnp.int32)
        lg, cache = _jit_decode(jp, jnp.asarray(toks[:, i:i + 1]), cache,
                                pos, jcfg)
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("dtype,fmt", [
    ("bfloat16", "bf16"), ("bfloat16", "w8a8"), ("bfloat16", "w4a8"),
    ("float32", "w4a8")])
def test_generate_matches_reference(dtype, fmt):
    """bf16 is the serving dtype; the float32 case has the small tolerance
    under which nearly every step's margin is decisive."""
    jcfg, tcfg, jp, tp = _setup(dtype, fmt)
    tol = LOGIT_TOL[dtype]
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    want = np.asarray(jserve.generate(jp, jnp.asarray(prompts), jcfg, gen=G,
                                      cache_len=S + G))
    ref_logits = _reference_logits(jp, jcfg, prompts, want)
    np.testing.assert_array_equal(ref_logits.argmax(-1), want)

    registry.reset_dispatch_counts()
    got, logits = tserve.generate(tp, prompts, tcfg, gen=G, cache_len=S + G,
                                  device="cpu", return_logits=True)
    got, logits = got.numpy(), logits.numpy()
    n_q = sum(registry.dispatch_counts().values())
    assert n_q == (0 if fmt == "bf16" else 7 * tcfg.n_layers * G)
    assert got.shape == (B, G)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(logits.argmax(-1), got)

    assert_tokens_match(got, logits, want, ref_logits, tol)


def assert_tokens_match(got, logits, want, ref_logits, tol):
    """The rule of the module docstring (ROADMAP C2): the port's tokens
    `got` and logits against the reference's tokens `want` and its
    teacher-forced logits `ref_logits`, [B, G(, V)] numpy."""
    compared = 0
    for b in range(got.shape[0]):
        for t in range(got.shape[1]):
            ref = ref_logits[b, t]
            np.testing.assert_allclose(logits[b, t], ref, rtol=0, atol=tol,
                                       err_msg=f"row {b} step {t}")
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > 2 * tol:
                assert got[b, t] == want[b, t], (b, t)
                compared += 1
            else:
                assert ref[got[b, t]] >= ref.max() - tol, (b, t)
            if got[b, t] != want[b, t]:
                break        # contexts differ from here on
    assert compared > 0


def test_generate_tokens_identical_across_lowerings(monkeypatch):
    """Forcing either lowering by env var or force() serves the same tokens
    on the CPU (both run the plain versions there)."""
    _, tcfg, _, tp = _setup("bfloat16", "w4a8")
    prompts = np.arange(B * S).reshape(B, S) % tcfg.vocab
    base = tserve.generate(tp, prompts, tcfg, gen=4, cache_len=S + 4,
                           device="cpu")
    monkeypatch.setenv(registry.ENV_VAR, "*=hopper-cuda")
    assert torch.equal(tserve.generate(tp, prompts, tcfg, gen=4,
                                       cache_len=S + 4, device="cpu"), base)
    with registry.force("ref"):
        assert torch.equal(tserve.generate(tp, prompts, tcfg, gen=4,
                                           cache_len=S + 4, device="cpu"),
                           base)
    with pytest.raises(ValueError):
        tserve.generate(tp, prompts, tcfg, gen=4, cache_len=S + 2,
                        device="cpu")


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "smollm-135m", "--reduced", "--quant", "w8a8",
                 "--quant-force", "--batch", "2", "--prompt-len", "6",
                 "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "quantized weights to w8a8 (forced floors)" in out
    assert "active lowerings: simd_add=ref, muladd2=ref, mul4=ref, " \
           "quant_matmul=ref, packed_w4_matmul=ref" in out
    n = 7 * tsmollm.reduced().n_layers * 3
    assert f"dispatch counts: {{'simd_add': 0, 'muladd2': 0, 'mul4': 0, " \
           f"'quant_matmul': {n}, 'packed_w4_matmul': 0}}" in out
    assert "sample tokens:" in out


def test_entry_points_need_cuda_when_asked(monkeypatch):
    """device defaults to "cuda"; without CUDA every entry point raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsmollm.reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_jax_params({"embed": np.zeros((2, 2), np.float32)})
    params = tlm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.generate(params, np.zeros((1, 4), np.int64), cfg, gen=2,
                        cache_len=8)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "smollm-135m", "--reduced"])


def test_port_imports_neither_jax_nor_repro():
    """An ast walk of every module of the port: torch and numpy, never jax
    and nothing of the reference package."""
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (f, name)


def test_generate_runs_without_jax_loaded():
    code = (
        "import sys\n"
        "from repro_torch.configs import get_reduced_config\n"
        "from repro_torch.launch import serve\n"
        "cfg = get_reduced_config('smollm-135m')\n"
        "p = serve.build_params(cfg, 'w4a8', quant_force=True, "
        "device='cpu')\n"
        "t = serve.generate(p, [[1, 2, 3, 4]], cfg, gen=3, cache_len=8, "
        "device='cpu')\n"
        "assert tuple(t.shape) == (1, 3), t.shape\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
