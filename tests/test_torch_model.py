"""The port's dense model (src/repro_torch/models) against `repro.models`.

Weights come from the reference: `repro.models.lm.init_params` builds
them, `quantize_tree_for_serving(force=True)` quantizes them, and
`repro_torch.convert.from_jax_params` imports them through numpy (bf16
as a uint16 view), bit-exactly.  Inputs are numpy from a seed.

Tolerances, on logits of magnitude ~0.4 (reduced smollm):
* float32 configs check the algorithm.  Unquantized: 1e-5 (float32 sums
  in a different order).  Quantized: 2e-3, because an activation whose
  x/scale lands within rounding noise of a .5 boundary may round to the
  neighbouring int8 step, which moves a logit by about |w| * scale, ~1e-3.
* bf16 configs (the serving dtype): 0.03.  Both sides round to bf16 at
  the same places but sum in different orders, so a value can land one
  bf16 step (2^-8 relative) apart and carry that through two layers;
  measured worst case 0.012.  The KV cache holds values up to ~4, where a
  bf16 step is 0.016-0.031: 0.125.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smollm_135m as jsmollm  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.quant.qtensor import QTensor as JQTensor  # noqa: E402
from repro.quant.qtensor import \
    quantize_tree_for_serving as jquantize_tree  # noqa: E402
from repro_torch.configs import smollm_135m as tsmollm  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.quant.qtensor import QTensor  # noqa: E402
from repro_torch.quant.qtensor import quantize_tree_for_serving  # noqa: E402

TOL = {"float32": {"bf16": 1e-5, "w8a8": 2e-3, "w4a8": 2e-3},
       "bfloat16": {"bf16": 0.03, "w8a8": 0.03, "w4a8": 0.03}}
CACHE_TOL = {"float32": 2e-3, "bfloat16": 0.125}
VARIANTS = {"reduced": {}, "kv2": {"n_heads": 4, "n_kv": 2}}
B, S, G = 2, 8, 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread keeps torch from competing with
    the other test workers for every core; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_to_numpy(tree):
    """The reference's params as numpy, the carrier from_jax_params takes:
    bf16 as its uint16 view, QTensor leaves as (q, scale, fmt)."""
    def leaf(x):
        if isinstance(x, JQTensor):
            return (np.asarray(x.q), np.asarray(x.scale), x.fmt)
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree_util.tree_map(
        leaf, tree, is_leaf=lambda x: isinstance(x, JQTensor))


def configs_for(variant, dtype):
    kw = dict(VARIANTS[variant], dtype=dtype)
    return (dataclasses.replace(jsmollm.reduced(), **kw),
            dataclasses.replace(tsmollm.reduced(), **kw))


_PARAMS = {}


def params_for(variant, dtype, fmt):
    """(jax params, port params) on the same weights; memoized per
    module (read-only use)."""
    key = (variant, dtype, fmt)
    if key not in _PARAMS:
        jcfg, _ = configs_for(variant, dtype)
        jp = jquantize_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg,
                                            max_seq=64), fmt, force=True)
        _PARAMS[key] = (jp, from_jax_params(jax_to_numpy(jp), device="cpu"))
    return _PARAMS[key]


def _f32(x):
    return np.asarray(x).astype(np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["bf16", "w8a8", "w4a8"])
def test_from_jax_params_bit_exact(fmt):
    jp, tp = params_for("reduced", "bfloat16", fmt)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jp, is_leaf=lambda x: isinstance(x, JQTensor))
    n_q = 0
    for path, jleaf in jleaves:
        node = tp
        for p in path:
            node = node[p.key]
        if isinstance(jleaf, JQTensor):
            n_q += 1
            assert isinstance(node, QTensor) and node.fmt == jleaf.fmt
            assert node.q.dtype == torch.int8
            np.testing.assert_array_equal(node.q.numpy(), np.asarray(jleaf.q))
            np.testing.assert_array_equal(node.scale.numpy(),
                                          np.asarray(jleaf.scale))
            continue
        a = np.asarray(jleaf)
        assert str(node.dtype).split(".")[-1] == str(a.dtype)
        if a.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(
                node.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(node.numpy(), a)
    assert n_q == (0 if fmt == "bf16" else 7)


def test_init_params_matches_reference_layout():
    """Same tree, shapes and dtypes as the reference's init; the same
    scales (std 1/sqrt(d_in) for dense weights, 0.02 for the embedding)."""
    jcfg, tcfg = configs_for("reduced", "bfloat16")
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    tp = tlm.init_params(tcfg, seed=3, device="cpu")
    for path, s in jax.tree_util.tree_leaves_with_path(shapes):
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(s.shape), path
        assert str(node.dtype).split(".")[-1] == str(s.dtype), path
    std = tp["blocks"]["mlp"]["wo"].float().std().item()
    assert abs(std * np.sqrt(tcfg.d_ff) - 1.0) < 0.1
    assert abs(tp["embed"].float().std().item() / 0.02 - 1.0) < 0.1
    again = tlm.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
@pytest.mark.parametrize("force", [False, True])
def test_quantize_tree_matches_reference(fmt, force):
    """Same leaves quantized (skip keys, size floors, force=) and the same
    bits, on the port's own quantization of the same bf16 weights."""
    jp0, tp0 = params_for("reduced", "bfloat16", "bf16")
    jq = jquantize_tree(jp0, fmt, force=force)
    tq = quantize_tree_for_serving(tp0, fmt, force=force)
    want = jax_to_numpy(jq)

    def check(w, t):
        if isinstance(w, dict):
            assert set(w) == set(t)
            for k in w:
                check(w[k], t[k])
        elif isinstance(w, tuple):
            assert isinstance(t, QTensor) and t.fmt == w[2]
            np.testing.assert_array_equal(t.q.numpy(), w[0])
            np.testing.assert_array_equal(t.scale.numpy(), w[1])
        else:
            assert not isinstance(t, QTensor)
    check(want, tq)
    assert quantize_tree_for_serving(tp0, "bf16") is tp0


def test_w4a8_odd_columns_fall_back_to_w8a8():
    w = torch.randn((2, 512, 129), generator=torch.Generator().manual_seed(0))
    tree = quantize_tree_for_serving({"blocks": {"x": {"w": w}}}, "w4a8")
    assert tree["blocks"]["x"]["w"].fmt == "w8a8"
    tree = quantize_tree_for_serving({"blocks": {"x": {"w": w[..., :128]}}},
                                     "w4a8")
    assert tree["blocks"]["x"]["w"].fmt == "w4a8"
    # under the size floor it stays a plain tensor unless forced
    small = {"blocks": {"x": {"w": w[:, :64, :64]}}}
    assert not isinstance(quantize_tree_for_serving(small, "w4a8")
                          ["blocks"]["x"]["w"], QTensor)
    assert quantize_tree_for_serving(small, "w4a8", force=True)[
        "blocks"]["x"]["w"].fmt == "w4a8"


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcommon.rope_freqs(16, 10000.0),
                                  jcommon.rope_freqs(16, 10000.0))
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# prefill + teacher-forced decode
# ---------------------------------------------------------------------------

_jit_prefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
_jit_decode = jax.jit(jlm.decode_step, static_argnums=(4,))


@pytest.mark.parametrize("variant,dtype", [
    ("reduced", "bfloat16"), ("kv2", "bfloat16"), ("reduced", "float32")])
@pytest.mark.parametrize("fmt", ["bf16", "w8a8", "w4a8"])
def test_prefill_and_decode_match_reference(variant, fmt, dtype):
    """bf16 (the serving dtype) on both configs; float32 checks the
    algorithm at the tight tolerance."""
    jcfg, tcfg = configs_for(variant, dtype)
    jp, tp = params_for(variant, dtype, fmt)
    tol, ctol = TOL[dtype][fmt], CACHE_TOL[dtype]
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (B, G)).astype(np.int32)

    jl, jc = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S + G)
    tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + G)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 1, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), rtol=0,
                                   atol=ctol)
    for i in range(G):       # teacher-forced: both sides see the same tokens
        pos = np.full((B,), S + i, np.int32)
        jl, jc = _jit_decode(jp, jnp.asarray(forced[:, i:i + 1]), jc,
                             jnp.asarray(pos), jcfg)
        tl, tc = tlm.decode_step(tp, torch.from_numpy(forced[:, i:i + 1]),
                                 tc, torch.from_numpy(pos).long(), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol, err_msg=f"decode step {i}")
    for k in ("k", "v"):
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), rtol=0,
                                   atol=ctol)


def test_prefill_last_positions_and_masked_decode():
    """Ragged prompts (last_positions) and the `active` slot mask: an
    inactive row's cache is untouched; active rows match the reference."""
    jcfg, tcfg = configs_for("reduced", "float32")
    jp, tp = params_for("reduced", "float32", "w4a8")
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, jcfg.vocab, (3, S)).astype(np.int32)
    last = np.array([S - 1, 3, 5], np.int32)
    jl, jc = jlm.prefill(jp, jnp.asarray(prompts), jcfg, S + 2,
                         last_positions=jnp.asarray(last))
    tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + 2,
                         last_positions=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=2e-3)

    tok = rng.integers(0, jcfg.vocab, (3, 1)).astype(np.int32)
    pos = (last + 1).astype(np.int32)
    active = np.array([True, False, True])
    before = {k: t.clone() for k, t in tc.items()}
    jl, jc = jlm.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(pos),
                             jcfg, active=jnp.asarray(active))
    tl, tc = tlm.decode_step(tp, torch.from_numpy(tok), tc,
                             torch.from_numpy(pos).long(), tcfg,
                             active=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               rtol=0, atol=2e-3)
    for k in ("k", "v"):
        assert torch.equal(tc[k][:, 1], before[k][:, 1])
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), rtol=0,
                                   atol=2e-3)


def test_gqa_groups_heads_by_kv_head():
    """Head h reads kv head h // G: with n_kv=2 the port's attention, with
    the reference's weights, must not mix up the groups (the reduced
    config's n_kv=1 would hide such a bug)."""
    from repro_torch.models import attention as tattn
    q = torch.zeros((1, 1, 4, 2))
    q[0, 0, :, 0] = 1.0
    k = torch.zeros((1, 3, 2, 2))
    k[0, :, 0, 0] = torch.tensor([1.0, 2.0, 3.0])     # kv head 0
    k[0, :, 1, 0] = torch.tensor([-1.0, -2.0, -3.0])  # kv head 1
    s = tattn._gqa_scores(q, k)                        # [B,KV,G,S,T]
    assert tuple(s.shape) == (1, 2, 2, 1, 3)
    assert torch.equal(s[0, 0, :, 0], torch.tensor([[1.0, 2, 3]] * 2))
    assert torch.equal(s[0, 1, :, 0], torch.tensor([[-1.0, -2, -3]] * 2))
