"""The rest of the dense family in the port against `repro`: the
qwen1.5-0.5b, yi-6b and command-r-35b configs, the q/k/v biases
(`qkv_bias`), the int8 KV cache (`serve_kv_dtype="int8"`) and the
chunked prefill attention (`attn_q_chunk`).

Weights come from the reference (`repro.models.lm.init_params`, then
`quantize_tree_for_serving(force=True)`), imported through numpy.  The
reference inits the biases to zero, so every test that runs qwen first
overwrites them with nonzero values drawn from a seed, the same values
on both sides.  Inputs are numpy from a seed.  Logit and bf16-cache
tolerances are tests/test_torch_model.py's (`TOL`, `CACHE_TOL`, with
their reasons there), set on reduced smollm, whose largest |logit| is
~0.47 (its head is the tied 0.02-scale embedding).  yi and command-r
have untied heads (std 1/sqrt(d)) and logits up to ~4.8: a bf16 step
and an int8 activation flip both move a logit in proportion to its
size, so their logit bound is TOL times max|logit| / 0.47 (`_scaled`).

The int8 cache: quantization is per position over D, so the same float32
vector gives the same int8 values and scale on both sides (bit for bit,
`test_kv_quantize_bit_exact`).  Where the two frameworks' float32 keys
differ (summation order, see C1), an int8 value may land one step
apart, and only there: the bound is one step, at positions whose float32
input differs.  A scale is amax / 127 + 1e-8 of that input, so two
scales differ by the relative difference of the inputs' amax, ~1e-6 in
float32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.quant.qtensor import \
    quantize_tree_for_serving as jquantize_tree  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.quant.qtensor import QTensor  # noqa: E402
from repro_torch.quant.qtensor import quantize_tree_for_serving  # noqa: E402
from test_torch_model import CACHE_TOL, TOL, jax_to_numpy  # noqa: E402
from test_torch_serve import (_reference_logits,  # noqa: E402
                              assert_tokens_match)

DENSE = ["smollm-135m", "qwen1.5-0.5b", "yi-6b", "command-r-35b"]
SMOLLM_MAX_LOGIT = 0.47
NEW = DENSE[1:]
B, S, G = 2, 8, 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """(reference, port) reduced configs of `arch` with fields replaced."""
    return (dataclasses.replace(jconfigs.get_reduced_config(arch), **kw),
            dataclasses.replace(tconfigs.get_reduced_config(arch), **kw))


_PARAMS = {}


def params_for(arch, dtype, fmt):
    """(jax params, port params) on the same weights, nonzero biases where
    the config has them; memoized per module (read-only use)."""
    key = (arch, dtype, fmt)
    if key not in _PARAMS:
        jcfg, _ = _cfgs(arch, dtype=dtype)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg, max_seq=64)
        if jcfg.qkv_bias:
            rng = np.random.default_rng(7)
            attn = jp["blocks"]["attn"]
            for name in ("bq", "bk", "bv"):
                assert not np.asarray(attn[name]).any()   # the reference's
                attn[name] = jnp.asarray(
                    rng.normal(0, 0.5, attn[name].shape), jnp.dtype(dtype))
        jp = jquantize_tree(jp, fmt, force=True)
        _PARAMS[key] = (jp, from_jax_params(jax_to_numpy(jp), device="cpu"))
    return _PARAMS[key]


def _scaled(tol, ref_logits):
    """tol, set on logits of reduced smollm's size, at the size of
    ref_logits (module docstring)."""
    return tol * max(1.0, float(np.abs(np.asarray(ref_logits)).max())
                     / SMOLLM_MAX_LOGIT)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.float32)


_jit_prefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
_jit_decode = jax.jit(jlm.decode_step, static_argnums=(4,))


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_config_fields_match_reference(arch, reduced):
    """Every field the port carries equals the reference's; every field it
    does not carry (MoE, SSM, M-RoPE, ...) is at its default in the
    reference; the derived widths and param_count agree."""
    get = "get_reduced_config" if reduced else "get_config"
    j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    carried = {f.name for f in dataclasses.fields(t)}
    for name in carried:
        assert getattr(t, name) == getattr(j, name), name
    for f in dataclasses.fields(j):
        if f.name not in carried:
            assert getattr(j, f.name) == f.default, f.name
    for name in ("head_dim", "q_dim", "kv_dim"):
        assert getattr(t, name) == getattr(j, name)
    assert t.param_count() == j.param_count()


def test_archs_are_the_dense_family():
    """The dense family leads ARCHS (the vlm, MoE, SSM, hybrid and encdec
    families follow it: tests/test_torch_vlm.py::test_config_fields_match_reference,
    tests/test_torch_moe.py::test_archs_include_the_moe_family,
    tests/test_torch_ssm.py::test_config_fields_match_reference,
    tests/test_torch_hybrid.py::test_archs_include_the_hybrid_family,
    tests/test_torch_encdec.py::test_config_fields_match_reference); every
    arch of the reference is ported, and an unknown name raises."""
    assert tconfigs.ARCHS[:len(DENSE)] == DENSE
    assert all(tconfigs.get_config(a).family in ("vlm", "moe", "ssm",
                                                 "hybrid", "encdec")
               for a in tconfigs.ARCHS[len(DENSE):])
    assert set(DENSE) <= set(jconfigs.ARCHS)
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)
    assert all(jconfigs.get_config(a).family == "dense" for a in DENSE)
    with pytest.raises(KeyError, match="not yet ported"):
        tconfigs.get_config("qwen3-vl-235b")


@pytest.mark.parametrize("arch", NEW)
def test_init_params_layout_and_bias_leaves(arch):
    """The port's init has the reference's tree, shapes and dtypes (the
    bq / bk / bv leaves [L, width], zeros, with qkv_bias); quantization
    leaves the 2-D bias leaves in the config's dtype, forced or not, as
    the reference's does; and they convert bit for bit."""
    jcfg, tcfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    tp = tlm.init_params(tcfg, seed=1, device="cpu")
    n = 0
    for path, s in jax.tree_util.tree_leaves_with_path(shapes):
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(s.shape), path
        assert str(node.dtype).split(".")[-1] == str(s.dtype), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(tp))
    attn = tp["blocks"]["attn"]
    assert ("bq" in attn) == tcfg.qkv_bias
    if not tcfg.qkv_bias:
        return
    assert not any(attn[b].any() for b in ("bq", "bk", "bv"))
    jp, tq = params_for(arch, "bfloat16", "w8a8")
    for force in (False, True):
        q = quantize_tree_for_serving(tp, "w8a8", force=force)
        for b in ("bq", "bk", "bv"):
            assert not isinstance(q["blocks"]["attn"][b], QTensor)
            assert q["blocks"]["attn"][b].dtype == torch.bfloat16
    for b in ("bq", "bk", "bv"):
        want = np.asarray(jp["blocks"]["attn"][b])
        assert want.any()
        np.testing.assert_array_equal(
            tq["blocks"]["attn"][b].view(torch.int16).numpy(),
            want.view(np.int16))


# ---------------------------------------------------------------------------
# prefill + teacher-forced decode, bf16 cache
# ---------------------------------------------------------------------------

def _run_both(arch, dtype, fmt, tol, ctol, steps=G, **kw):
    """Prefill + `steps` teacher-forced decode steps on both sides; logits
    within tol, the caches within ctol (bf16 / float32 caches) or by the
    int8 rule.  Returns the final caches (port, reference)."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype, **kw)
    jp, tp = params_for(arch, dtype, fmt)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (B, steps)).astype(np.int32)
    jl, jc = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S + steps)
    tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + steps)
    tol = _scaled(tol, jl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    assert set(tc) == set(jc)
    for i in range(steps):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = _jit_decode(jp, jnp.asarray(forced[:, i:i + 1]), jc,
                             jnp.asarray(pos), jcfg)
        tl, tc = tlm.decode_step(tp, torch.from_numpy(forced[:, i:i + 1]),
                                 tc, torch.from_numpy(pos).long(), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol, err_msg=f"decode step {i}")
    if ctol is not None:
        for k in ("k", "v"):
            np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), rtol=0,
                                       atol=ctol)
    return tc, jc


@pytest.mark.parametrize("arch,dtype,fmt", [
    (a, "bfloat16", f) for a in NEW for f in ("bf16", "w8a8", "w4a8")] + [
    ("qwen1.5-0.5b", "float32", "bf16"), ("qwen1.5-0.5b", "float32", "w4a8"),
    ("yi-6b", "float32", "w8a8")])
def test_prefill_and_decode_match_reference(arch, dtype, fmt):
    """bf16 (the serving dtype) under every format; float32 checks the
    algorithm (the biases' adds included) at the tight tolerance."""
    _run_both(arch, dtype, fmt, TOL[dtype][fmt], CACHE_TOL[dtype])


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------

def _kv_inputs(dtype):
    """[2, 5, 3, 16] keys: normal, one all-zero position (scale 1e-8),
    one of large magnitude, one with a single nonzero entry."""
    rng = np.random.default_rng(3)
    t = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    t[0, 1, 2] = 0.0
    t[1, 3] *= 1e4
    t[1, 4, 0] = 0.0
    t[1, 4, 0, 5] = -3.0
    j = jnp.asarray(t, jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_exact(dtype):
    """_kv_quantize and _kv_dequant equal the reference's jitted ones
    (its serving path runs them under jit) bit for bit on the same
    inputs; the all-zero position's scale is exactly float32(1e-8).
    Run eagerly, the reference divides amax by 127, where XLA multiplies
    by float32(1 / 127): its scales then differ by one ulp at some
    positions (ROADMAP C-ref6)."""
    j, t = _kv_inputs(dtype)
    tq, ts = tattn._kv_quantize(t)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (2, 5, 3)
    jq, js = jax.jit(jattn._kv_quantize)(j)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    _, eager = jattn._kv_quantize(j)
    np.testing.assert_allclose(ts.numpy(), np.asarray(eager), rtol=2 ** -23,
                               atol=0)
    assert ts[0, 1, 2].item() == np.float32(1e-8)
    assert int(tq.abs().max()) == 127
    for out in ("float32", "bfloat16"):
        want = np.asarray(jattn._kv_dequant(jq, js, jnp.dtype(out))
                          .astype(jnp.float32))
        got = tattn._kv_dequant(tq, ts, getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("c", [1, 2])
def test_cache_insert_bit_exact(c):
    """The quantized insert of C new rows at per-row positions: values
    and scales equal the reference's `_cache_insert`, bit for bit; the
    other positions keep what they held."""
    rng = np.random.default_rng(5)
    b, s_max, kv, d = 3, 9, 2, 8
    cache_q = rng.integers(-127, 128, (b, s_max, kv, d)).astype(np.int8)
    cache_s = rng.random((b, s_max, kv)).astype(np.float32)
    new = rng.standard_normal((b, c, kv, d)).astype(np.float32)
    pos = np.array([0, 4, s_max - c], np.int32)
    insert = jax.jit(jattn._cache_insert, static_argnums=4)
    jq, js = insert(jnp.asarray(cache_q), jnp.asarray(cache_s),
                    jnp.asarray(new), jnp.asarray(pos), True)
    cache = {"k": torch.from_numpy(cache_q.copy()),
             "k_s": torch.from_numpy(cache_s.copy())}
    rows = torch.arange(b)
    qpos = torch.from_numpy(pos).long()[:, None] + torch.arange(c)
    tattn._cache_insert(cache, "k", torch.from_numpy(new),
                        (rows[:, None], qpos), rows)
    np.testing.assert_array_equal(cache["k"].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(cache["k_s"].numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    untouched = np.ones((b, s_max), bool)
    for r in range(b):
        untouched[r, pos[r]:pos[r] + c] = False
    np.testing.assert_array_equal(cache["k"].numpy()[untouched],
                                  cache_q[untouched])


def _assert_int8_rule(tq, ts, jq, js, tf=None, jf=None, n=None):
    """The int8 rule of the module docstring over the first n positions:
    values one step apart at most, and equal (scales too, bit for bit)
    at every position whose float32 input (tf, jf), when given, is equal
    on both sides; scales within 1e-5 relative elsewhere."""
    tq, jq = tq.numpy().astype(np.int32)[..., :n, :, :], \
        np.asarray(jq).astype(np.int32)[..., :n, :, :]
    ts, js = ts.numpy()[..., :n, :], np.asarray(js)[..., :n, :]
    assert np.abs(tq - jq).max() <= 1
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
    if tf is None:
        return 0
    same = (tf.numpy()[..., :n, :, :] == np.asarray(jf)[..., :n, :, :]
            ).all(axis=-1)
    np.testing.assert_array_equal(tq[same], jq[same])
    np.testing.assert_array_equal(ts[same], js[same])
    return int((tq != jq).any(axis=-1).sum())


@pytest.mark.parametrize("arch,fmt", [("qwen1.5-0.5b", "bf16"),
                                      ("qwen1.5-0.5b", "w8a8"),
                                      ("yi-6b", "w4a8")])
def test_int8_kv_prefill_and_decode_match_reference(arch, fmt):
    """float32 config.  Prefill: each side's int8 cache is the
    quantization of its own float32 keys and values (a float32-cache run
    of the same weights), the sequence attends over the unquantized ones
    (prefill logits equal the float32-cache run's), the padding past the
    prompt holds 0 with scale 1e-8 on both sides, and port and reference
    agree by the int8 rule.  Then teacher-forced decode with logits
    within TOL (where an int8 value lands one step apart, its key moves
    by ~1% of its amax; over these few positions that stays under the
    bound) and the caches by the int8 rule."""
    dtype = "float32"
    jcfg, tcfg = _cfgs(arch, dtype=dtype, serve_kv_dtype="int8")
    jcfg_f, tcfg_f = _cfgs(arch, dtype=dtype)
    jp, tp = params_for(arch, dtype, fmt)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (B, G)).astype(np.int32)
    jl, jc = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S + G)
    jl_f, jc_f = _jit_prefill(jp, jnp.asarray(prompts), jcfg_f, S + G)
    tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + G)
    tl_f, tc_f = tlm.prefill(tp, torch.from_numpy(prompts), tcfg_f, S + G)
    assert set(tc) == set(jc) == {"k", "v", "k_s", "v_s"}
    assert tc["k"].dtype == torch.int8 and tc["k_s"].dtype == torch.float32
    assert tuple(tc["k_s"].shape) == tuple(jc["k_s"].shape) == \
        (tcfg.n_layers, B, S + G, tcfg.n_kv)
    assert torch.equal(tl, tl_f)
    np.testing.assert_array_equal(np.asarray(jl), np.asarray(jl_f))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL[dtype][fmt])
    for k in ("k", "v"):
        tq, ts = tattn._kv_quantize(tc_f[k][:, :, :S])
        assert torch.equal(tc[k][:, :, :S], tq)
        assert torch.equal(tc[f"{k}_s"][:, :, :S], ts)
        jq, js = jax.jit(jattn._kv_quantize)(jc_f[k][:, :, :S])
        np.testing.assert_array_equal(np.asarray(jc[k])[:, :, :S],
                                      np.asarray(jq))
        np.testing.assert_array_equal(np.asarray(jc[f"{k}_s"])[:, :, :S],
                                      np.asarray(js))
        for q, sc in ((tc[k].numpy(), tc[f"{k}_s"].numpy()),
                      (np.asarray(jc[k]), np.asarray(jc[f"{k}_s"]))):
            assert not q[:, :, S:].any()
            assert (sc[:, :, S:] == np.float32(1e-8)).all()
        _assert_int8_rule(tc[k], tc[f"{k}_s"], jc[k], jc[f"{k}_s"],
                          tc_f[k], jc_f[k], n=S)
    for i in range(G):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = _jit_decode(jp, jnp.asarray(forced[:, i:i + 1]), jc,
                             jnp.asarray(pos), jcfg)
        tl, tc = tlm.decode_step(tp, torch.from_numpy(forced[:, i:i + 1]),
                                 tc, torch.from_numpy(pos).long(), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL[dtype][fmt],
                                   err_msg=f"decode step {i}")
    for k in ("k", "v"):
        _assert_int8_rule(tc[k], tc[f"{k}_s"], jc[k], jc[f"{k}_s"])


def test_int8_kv_inactive_row_untouched():
    """The `active` slot mask with an int8 cache: the inactive row's
    values and scales stay as they were, bit for bit, in every layer;
    the active rows' logits match the reference's."""
    dtype, fmt = "float32", "w8a8"
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", dtype=dtype, serve_kv_dtype="int8")
    jp, tp = params_for("qwen1.5-0.5b", dtype, fmt)
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, jcfg.vocab, (3, S)).astype(np.int32)
    tok = rng.integers(0, jcfg.vocab, (3, 1)).astype(np.int32)
    pos = np.full((3,), S, np.int32)
    active = np.array([True, False, True])
    _, jc = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S + 2)
    _, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + 2)
    before = {k: t.clone() for k, t in tc.items()}
    jl, jc = jlm.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(pos),
                             jcfg, active=jnp.asarray(active))
    tl, tc = tlm.decode_step(tp, torch.from_numpy(tok), tc,
                             torch.from_numpy(pos).long(), tcfg,
                             active=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               rtol=0, atol=TOL[dtype][fmt])
    for k in ("k", "v", "k_s", "v_s"):
        assert torch.equal(tc[k][:, 1], before[k][:, 1]), k
        assert not torch.equal(tc[k][:, 0], before[k][:, 0]), k
    for k in ("k", "v"):
        _assert_int8_rule(tc[k], tc[f"{k}_s"], jc[k], jc[f"{k}_s"])


# ---------------------------------------------------------------------------
# attn_q_chunk
# ---------------------------------------------------------------------------

CHUNK, S_LONG = 16, 64


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_attn_q_chunk_matches_reference_and_unchunked(kv):
    """float32 yi-reduced, a 64-token prompt in chunks of 16 (rtol = atol
    = 1e-4, as the reference's tests/test_perf_variants.py): the port's
    chunked prefill against the reference's chunked prefill and against
    the port's unchunked one; the chunked branch writes the same cache
    as the unchunked one, an int8 cache included."""
    dtype, fmt = "float32", "bf16"
    jcfg, tcfg = _cfgs("yi-6b", dtype=dtype, serve_kv_dtype=kv,
                       attn_q_chunk=CHUNK)
    _, tcfg0 = _cfgs("yi-6b", dtype=dtype, serve_kv_dtype=kv)
    jp, tp = params_for("yi-6b", dtype, fmt)
    prompts = np.random.default_rng(8).integers(
        0, jcfg.vocab, (B, S_LONG)).astype(np.int32)
    jl, jc = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S_LONG + 4)
    tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S_LONG + 4)
    tl0, tc0 = tlm.prefill(tp, torch.from_numpy(prompts), tcfg0,
                           S_LONG + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), tl0.numpy(), rtol=1e-4,
                               atol=1e-4)
    for k in tc:
        assert torch.equal(tc[k], tc0[k]), k
    if kv == "int8":
        for k in ("k", "v"):
            _assert_int8_rule(tc[k], tc[f"{k}_s"], jc[k], jc[f"{k}_s"])
    else:
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-4, atol=1e-4)


def test_attn_full_chunked_layer_matches_reference():
    """One layer's `attn_full` with attn_q_chunk against the reference's
    chunked `attn_full` on the same input (biased qwen, 4 chunks of 8);
    and where the reference's gate does not chunk (S = chunk, S not a
    multiple) the port's output is the unchunked one, bit for bit."""
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", dtype="float32", attn_q_chunk=8)
    _, tcfg0 = _cfgs("qwen1.5-0.5b", dtype="float32")
    jp, tp = params_for("qwen1.5-0.5b", "float32", "bf16")
    jl = jax.tree_util.tree_map(lambda t: t[0], jp["blocks"]["attn"])
    tl = {k: t[0] for k, t in tp["blocks"]["attn"].items()}
    rng = np.random.default_rng(9)
    for s, chunked in ((32, True), (8, False), (20, False)):
        x = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
        want = np.asarray(jattn.attn_full(jl, jnp.asarray(x), jcfg))
        got = tattn.attn_full(tl, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        unchunked = tattn.attn_full(tl, torch.from_numpy(x), tcfg0)
        if not chunked:
            assert torch.equal(got, unchunked)
        np.testing.assert_allclose(got.numpy(), unchunked.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_attn_chunked_keeps_one_score_block(monkeypatch):
    """Only a [B, KV, G, chunk, T] score block is computed at a time:
    every score tensor the chunked prefill makes has chunk query rows."""
    _, tcfg = _cfgs("yi-6b", dtype="float32", attn_q_chunk=CHUNK)
    _, tp = params_for("yi-6b", "float32", "bf16")
    seen = []
    orig = tattn._gqa_scores

    def spy(q, k):
        out = orig(q, k)
        seen.append(tuple(out.shape))
        return out
    monkeypatch.setattr(tattn, "_gqa_scores", spy)
    tlm.prefill(tp, torch.zeros((B, S_LONG), dtype=torch.long), tcfg,
                S_LONG)
    g = tcfg.n_heads // tcfg.n_kv
    assert seen == [(B, tcfg.n_kv, g, CHUNK, S_LONG)] * (
        tcfg.n_layers * S_LONG // CHUNK)


# ---------------------------------------------------------------------------
# serving with the int8 cache
# ---------------------------------------------------------------------------

# the shapes of test_torch_serve.py's `_reference_logits`
GB, GS, GG = 3, 8, 8


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_generate_int8_kv_matches_reference(dtype):
    """Greedy `generate` on biased qwen-reduced, w8a8 weights and the int8
    cache, against the reference's, by the C2 rule
    (tests/test_torch_serve.py) at TOL."""
    fmt = "w8a8"
    tol = TOL[dtype][fmt]
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", dtype=dtype, serve_kv_dtype="int8")
    jp, tp = params_for("qwen1.5-0.5b", dtype, fmt)
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab, (GB, GS)).astype(np.int32)
    want = np.asarray(jserve.generate(jp, jnp.asarray(prompts), jcfg,
                                      gen=GG, cache_len=GS + GG))
    ref_logits = _reference_logits(jp, jcfg, prompts, want)
    np.testing.assert_array_equal(ref_logits.argmax(-1), want)
    got, logits = tserve.generate(tp, prompts, tcfg, gen=GG,
                                  cache_len=GS + GG, device="cpu",
                                  return_logits=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == (GB, GG)
    assert_tokens_match(got.numpy(), logits.numpy(), want, ref_logits, tol)


@pytest.mark.parametrize("silvia_passes", ["off", "all"])
def test_static_step_int8_kv_matches_stepwise(silvia_passes):
    """The captured step's static buffers, run eagerly (the CPU has no
    graph), with the int8 cache: its tokens and logits rows equal the
    per-step loop's, and so do its cache's values and scales after the
    run, bit for bit; the scales are buffers of the step, updated in
    place."""
    _, tcfg = _cfgs("qwen1.5-0.5b", serve_kv_dtype="int8")
    _, tp = params_for("qwen1.5-0.5b", "bfloat16", "w8a8")
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, (GB, GS)))
    n = GG - 1
    logits, cache = tlm.prefill(tp, prompts, tcfg, cache_len=GS + GG)
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    bundle = tserve._decode_bundle(tcfg, silvia_passes, "cpu")
    step = bundle.captured(tp, GB, GS + GG, True, n, torch.device("cpu"))
    assert set(step.cache) == {"k", "v", "k_s", "v_s"}
    scales = step.cache["k_s"].data_ptr()
    toks, seen = step.run(tok, cache, GS, n)
    assert step.cache["k_s"].data_ptr() == scales
    want, want_logits, t = [], [], tok
    for i in range(n):
        lg, _ = bundle.decode(tp, t, cache,
                              torch.full((GB,), GS + i, dtype=torch.long))
        t = lg[:, -1].argmax(dim=-1)[:, None]
        want.append(t)
        want_logits.append(lg[:, -1])
    assert torch.equal(toks, torch.cat(want, dim=1).to(torch.int32))
    assert torch.equal(seen, torch.stack(want_logits, dim=1))
    for k in ("k", "v", "k_s", "v_s"):
        assert torch.equal(step.cache[k], cache[k]), k
    assert (step.cache["k_s"][:, :, GS:GS + n] > 1e-8).all()
