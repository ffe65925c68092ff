"""The encoder-decoder family in the port against `repro`: whisper-small
at its reduced config (2 encoder and 2 decoder layers, d_model 64, 4
heads of 16, d_ff 128, vocab 256; LayerNorm, the GELU MLP with biases,
learned positions, untied head).  The encoder takes precomputed frame
embeddings (the audio frontend is a stub in the reference too), made
from a seed with numpy.

Weights come from the reference (`repro.models.lm.init_params`, its
LayerNorm weights and biases and its MLP biases then given seeded values
by `_perturb`: at the init's ones and zeros a dropped bias would not
show; then `quantize_tree_for_serving(force=True)`), imported through
numpy.  The reference is compared as it serves: jitted (`jax.jit` of
`enc_block`, `dec_block`, `lm.prefill`, `lm.decode_step`; its
`generate`), the form in which the port quantizes activations (ROADMAP
C7).

Tolerances and why (measured on these inputs):
* `layer_norm` and `gelu` in float32: not bit for bit (ROADMAP C9).
  XLA's CPU reduction splits the 64-wide mean into windows of 32 and
  sums in its own order, and its tanh is its own polynomial: the port's
  LayerNorm within LN_F32_TOL 4e-6, a few float32 ulps of its largest
  output (measured 9.5e-7 at outputs up to ~4; 2.9e-6 at d 768), its
  GELU within GELU_F32_TOL 1e-6 (measured 5.8e-7 over [-12, 12];
  torch's erf form is 4.7e-4 away).  In bf16 both are bit for bit here
  (the GELU's constants rounded to bf16 as jax rounds them), held to
  bit for bit (GELU) and one bf16 step (LayerNorm).
* float32 configs check the algorithm: F32_TOL 1e-5 on block outputs
  (every format, from the reference's input; measured <= 1.0e-6), and
  on the whole model's logits and caches unquantized (measured 2.6e-6
  on logits of max ~3.4).  With int8 activations the whole model is
  held to QUANT_F32_TOL 0.05, as tests/test_torch_hybrid.py holds it
  (ROADMAP C8): an activation on an int8 rounding tie rounds to either
  side under the two frameworks' last-bit differences, and the rest of
  the stack carries that one step.  Here the last decoder layer's GELU
  output sits exactly on a tie in one row (C9's tanh tips it) and moves
  that row's logits by 0.036 (w8a8, max ~3.4); w4a8 agrees within
  1.2e-6.
* bf16 configs (the serving dtype): both sides round to bf16 at the
  same places and sum in other orders (ROADMAP C1).  Logits are held to
  tests/test_torch_model.py's TOL (0.03) scaled by max|logit| / 0.47,
  ~0.2, as the untied heads of tests/test_torch_dense.py (measured <=
  0.068 on logits of max ~3.4); the self and cross K/V to its CACHE_TOL
  (0.125; measured <= 0.074); a block's output to BF16_OUT_TOL 0.125,
  a bf16 step at its largest values of ~10-16 (measured <= 0.0625).
* Port-internal invariants are bit for bit: the real positions of a
  right-padded encoder batch equal the unpadded encode, an inactive
  row's self KV and every cross K/V are untouched by a decode step, the
  captured step equals the per-step loop, `--silvia all` equals off,
  and `build_params` equals whole-tree quantization.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.quant import qtensor as jqt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.quant import qtensor as tqt  # noqa: E402
from test_torch_model import CACHE_TOL, TOL, jax_to_numpy  # noqa: E402
from test_torch_serve import assert_tokens_match  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCH = "whisper-small"
SMOLLM_MAX_LOGIT = 0.47
F32_TOL = 1e-5
QUANT_F32_TOL = 0.05
LN_F32_TOL = 4e-6
GELU_F32_TOL = 1e-6
BF16_OUT_TOL = 0.125
B, SE, S, G = 2, 24, 10, 4          # rows, encoder frames, prompt, steps
MAX_SEQ = 64
FORMATS = ["bf16", "w8a8", "w4a8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return tuple(dataclasses.replace(c.get_reduced_config(ARCH), **kw)
                 for c in (jconfigs, tconfigs))


def _perturb(jp, seed=7):
    """Every LayerNorm's w and b and every MLP bias given seeded values:
    w 1 + N(0, 0.1), b and the biases N(0, 0.1), in their dtypes."""
    rng = np.random.default_rng(seed)

    def walk(path, x):
        keys = [getattr(p, "key", "") for p in path]
        if keys[-1] in ("bi", "bo") or (keys[-1] in ("w", "b") and any(
                k.startswith("ln") or k.endswith("norm") for k in keys)):
            noise = rng.normal(0.0, 0.1, x.shape)
            return (x.astype(jnp.float32) + noise).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(walk, jp)


_PARAMS = {}


def params_for(dtype, fmt):
    """(jax params, port params) on the same weights; memoized (read-only
    use)."""
    if (dtype, fmt) not in _PARAMS:
        jcfg, _ = _cfgs(dtype=dtype)
        jp = jqt.quantize_tree_for_serving(
            _perturb(jlm.init_params(jax.random.PRNGKey(0), jcfg,
                                     max_seq=MAX_SEQ)), fmt, force=True)
        _PARAMS[dtype, fmt] = (jp, from_jax_params(jax_to_numpy(jp),
                                                   device="cpu"))
    return _PARAMS[dtype, fmt]


def _layer0(tree_j, tree_t):
    return (jax.tree_util.tree_map(lambda a: a[0], tree_j),
            tblocks.tree_idx(tree_t, 0))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=tol,
                               err_msg=what)


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _inputs(seed, b=B, se=SE, s=S):
    """(features [b, se, 64] float32, dec_tokens [b, s] int32), numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, se, 64)).astype(np.float32),
            rng.integers(0, 256, (b, s)).astype(np.int32))


def _j(inputs):
    return tuple(jnp.asarray(a) for a in inputs)


def _t(inputs):
    return tuple(torch.from_numpy(a) for a in inputs)


def _logit_tol(dtype, fmt, ref_logits):
    if dtype == "float32":
        return F32_TOL if fmt == "bf16" else QUANT_F32_TOL
    return TOL[dtype][fmt] * max(1.0, float(np.abs(ref_logits).max())
                                 / SMOLLM_MAX_LOGIT)


def _cache_tol(dtype, fmt="bf16"):
    if dtype == "float32":
        return F32_TOL if fmt == "bf16" else QUANT_F32_TOL
    return CACHE_TOL["bfloat16"]


def _out_tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_OUT_TOL


def _nested(cache):
    """The port's flat encdec cache in the reference's nesting."""
    return {"self": {k: t for k, t in cache.items()
                     if k not in tblocks.CROSS},
            "cross": {k: cache[f"cross_{k}"] for k in ("k", "v", "len")}}


def _close_cache(got, want, dtype, what="", fmt="bf16"):
    g = _nested(got)
    for part in ("self", "cross"):
        assert set(g[part]) == set(want[part]), part
        for k, t in g[part].items():
            assert tuple(t.shape) == tuple(want[part][k].shape), (part, k)
            if k == "len":
                assert t.dtype == torch.int32
                np.testing.assert_array_equal(t.numpy(), want[part][k])
            else:
                _close(t, want[part][k], _cache_tol(dtype, fmt),
                       f"{what} {part} {k}")


# ---------------------------------------------------------------------------
# configs, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(reduced):
    """Every field the port carries equals the reference's; the one it
    does not carry (subquadratic) is at its default there; param_count
    equals the reference's: 277.8 M at full width."""
    get = "get_reduced_config" if reduced else "get_config"
    j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    carried = {f.name for f in dataclasses.fields(t)}
    for name in carried:
        assert getattr(t, name) == getattr(j, name), name
    for f in dataclasses.fields(j):
        if f.name not in carried:
            assert getattr(j, f.name) == f.default, f.name
    assert t.param_count() == j.param_count()
    if not reduced:
        assert t.param_count() == 277845504
        assert (t.n_decoder_layers, t.learned_pos, t.frontend) == \
            (12, True, "audio")
    assert tconfigs.ARCHS[-1] == ARCH


def test_init_params_tree_matches_reference():
    """The port's own init has the reference's tree, shapes and dtypes:
    embed, lm_head, final_norm {w, b}, pos_embed and enc_pos [max_seq,
    d], enc [2, ...] {ln1, attn, ln2, mlp {wi, bi, wo, bo}}, enc_norm, dec
    [2, ...] {ln1, self, ln2, cross, ln3, mlp}; LayerNorms ones and zeros
    in float32, MLP biases zeros in bf16."""
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg, max_seq=MAX_SEQ))
    got = tlm.init_params(tcfg, 0, device="cpu", max_seq=MAX_SEQ)
    jl = {jax.tree_util.keystr(p): a
          for p, a in jax.tree_util.tree_leaves_with_path(want)}
    tl = {pytree.keystr(p): t for p, t in pytree.tree_leaves_with_path(got)}
    assert sorted(jl) == sorted(tl)
    for key, a in jl.items():
        assert tuple(a.shape) == tuple(tl[key].shape), key
        assert str(a.dtype) == str(tl[key].dtype).split(".")[-1], key
    assert tuple(got["enc_pos"].shape) == (MAX_SEQ, 64)
    ln = got["dec"]["ln3"]
    assert bool((ln["w"] == 1).all()) and bool((ln["b"] == 0).all())
    assert bool((got["enc"]["mlp"]["bi"] == 0).all())


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_quantize_tree_and_convert_encdec(fmt):
    """quantize_tree_for_serving on the encdec tree equals the reference's,
    leaf for leaf and bit for bit: the encoder's four projections and
    two MLP weights, the decoder's self and cross projections and two
    MLP weights and the head become QTensors (17); the position tables,
    norms and biases stay float; from_jax_params carries every leaf."""
    jcfg, _ = _cfgs()
    raw = _perturb(jlm.init_params(jax.random.PRNGKey(3), jcfg,
                                   max_seq=MAX_SEQ))
    want = jqt.quantize_tree_for_serving(raw, fmt, force=True)
    got = tqt.quantize_tree_for_serving(
        from_jax_params(jax_to_numpy(raw), device="cpu"), fmt, force=True)
    conv = from_jax_params(jax_to_numpy(want), device="cpu")
    is_q = lambda x: isinstance(x, jqt.QTensor)           # noqa: E731
    n_q = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want, is_leaf=is_q):
        for tree in (got, conv):
            node = tree
            for p in path:
                node = node[p.key]
            if is_q(leaf):
                assert isinstance(node, tqt.QTensor) and node.fmt == leaf.fmt
                assert np.array_equal(node.q.numpy(), np.asarray(leaf.q))
                assert np.array_equal(node.scale.numpy(),
                                      np.asarray(leaf.scale))
            else:
                assert node.dtype == getattr(torch, str(leaf.dtype))
                assert np.array_equal(_f32(node), _f32(leaf))
        n_q += is_q(leaf)
    assert n_q == 17
    assert conv["dec"]["cross"]["wk"].logical_shape == (2, 64, 64)
    assert conv["enc"]["mlp"]["bi"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# LayerNorm, GELU, the MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """layer_norm (and norm_apply's layernorm branch) against the
    reference's jitted: float32 within LN_F32_TOL, bf16 within one bf16
    step of the largest output; the output in x's dtype."""
    rng = np.random.default_rng(1)
    jx, tx = _x(2, (3, 50, 64), dtype)
    jx, tx = jx * 3 + 0.5, tx * 3 + 0.5
    w = rng.normal(1.0, 0.3, 64).astype(np.float32)
    b = rng.normal(0.0, 0.3, 64).astype(np.float32)
    want = _f32(jax.jit(jcommon.layer_norm)(jx, jnp.asarray(w),
                                            jnp.asarray(b)))
    got = tcommon.norm_apply(tx, {"w": torch.from_numpy(w),
                                  "b": torch.from_numpy(b)},
                             "layernorm", 1e-5)
    assert got.dtype == tx.dtype
    tol = LN_F32_TOL if dtype == "float32" else \
        2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_reference(dtype):
    """gelu is jax.nn.gelu's default tanh form (jitted), over [-12, 12]:
    bf16 bit for bit, float32 within GELU_F32_TOL (XLA's tanh); torch's
    default erf form is 1e-4 or more away in both."""
    x = np.linspace(-12, 12, 20001).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    want = _f32(jax.jit(jax.nn.gelu)(jx))
    got = tmlp.gelu(tx)
    assert got.dtype == tx.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got), want)
    else:
        _close(got, want, GELU_F32_TOL)
    erf = _f32(torch.nn.functional.gelu(tx))
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_gelu_mlp_matches_reference(fmt, dtype):
    """The GELU MLP, qmatmul(gelu(x wi + bi), wo) + bo, on the decoder's
    layer-0 weights (nonzero biases) against the reference's jitted."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    jl, tl = _layer0(jp["dec"]["mlp"], tp["dec"]["mlp"])
    jx, tx = _x(3, (B, S, 64), dtype)
    want = jax.jit(jmlp.mlp, static_argnums=2)(jl, jx, jcfg)
    got = tmlp.mlp(tl, tx, tcfg)
    assert got.dtype == tx.dtype
    _close(got, want, _out_tol(dtype))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

_jit_enc = jax.jit(jblocks.enc_block, static_argnums=(2,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_enc_block_matches_reference(fmt, dtype):
    """enc_block from the reference's input, rows of 24 and 17 real
    frames: the real positions' output against the jitted reference's."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    jl, tl = _layer0(jp["enc"], tp["enc"])
    jx, tx = _x(4, (B, SE, 64), dtype)
    lens = np.array([SE, 17], np.int32)
    want = _jit_enc(jl, jx, jcfg, jnp.asarray(lens))
    got = tblocks.enc_block(tl, tx, tcfg, lengths=torch.from_numpy(lens))
    for b, n in enumerate(lens):
        _close(got[b, :n], want[b, :n], _out_tol(dtype), f"row {b}")


@pytest.mark.parametrize("dtype,fmt", [("float32", "w8a8"),
                                       ("float32", "w4a8"),
                                       ("bfloat16", "w8a8")])
def test_dec_block_matches_reference(dtype, fmt):
    """dec_block from the reference's input: prefill (memory of 24 and 17
    real frames, the cross K/V right-padded to enc_pad 32) then one
    decode step with the `active` mask, against the jitted reference's:
    outputs and every cache tensor; the decode writes the active row's
    self KV in place, leaves the inactive row's and all cross K/V
    untouched."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    jl, tl = _layer0(jp["dec"], tp["dec"])
    jx, tx = _x(5, (B, S, 64), dtype)
    jm, tm = _x(6, (B, SE, 64), dtype)
    lens, pad, cache_len = np.array([SE, 17], np.int32), 32, S + 2
    jprefill = jax.jit(functools.partial(
        jblocks.dec_block, cfg=jcfg, mode="prefill", cache_len=cache_len,
        enc_pad=pad))
    want, jc, _ = jprefill(jl, jx, memory=jm, enc_lengths=jnp.asarray(lens))
    full = tlm.init_cache(tcfg, B, cache_len, device="cpu", s_enc=pad)
    cache = {k: t[0] for k, t in full.items()}
    got = tblocks.dec_block(tl, tx, tcfg, memory=tm, mode="prefill",
                            cache=cache, enc_lengths=torch.from_numpy(lens))
    _close(got, want, _out_tol(dtype), "prefill")
    _close_cache(cache, jc, dtype, "prefill")
    assert bool((cache["cross_k"][1, 17:] != 0).any())  # row 1's padding
    assert bool((cache["cross_k"][:, SE:] == 0).all())
    jt, tt = _x(7, (B, 1, 64), dtype)
    active = np.array([True, False])
    pos = np.full((B,), S, np.int32)
    jdecode = jax.jit(functools.partial(jblocks.dec_block, cfg=jcfg,
                                        mode="decode"))
    want, jc, _ = jdecode(jl, jt, cache=jc, pos=jnp.asarray(pos),
                          active=jnp.asarray(active))
    before = {k: t.clone() for k, t in cache.items()}
    got = tblocks.dec_block(tl, tt, tcfg, mode="decode", cache=cache,
                            pos=torch.from_numpy(pos).long(),
                            active=torch.from_numpy(active))
    _close(got[0], want[0], _out_tol(dtype), "decode")
    _close_cache(cache, jc, dtype, "decode")
    for k, t in cache.items():
        if k in tblocks.CROSS:
            assert torch.equal(t, before[k]), k
        else:
            assert torch.equal(t[1], before[k][1]), k
            assert not torch.equal(t[0], before[k][0]), k


def test_attn_cross_row_of_length_zero_is_finite():
    """A cross-attention row with no real frame (an inactive slot) gets a
    uniform softmax over the page, finite (never NaN), as the
    reference's: its output is the mean of the values' projection."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = params_for("float32", "bf16")
    jl, tl = _layer0(jp["dec"]["cross"], tp["dec"]["cross"])
    jx, tx = _x(8, (B, 3, 64), "float32")
    jm, tm = _x(9, (B, SE, 64), "float32")
    lens = np.array([0, 11], np.int32)
    want = jax.jit(functools.partial(jattn.attn_cross, cfg=jcfg))(
        jl, jx, jm, enc_lengths=jnp.asarray(lens))
    got = tattn.attn_cross(tl, tx, tm, tcfg,
                           enc_lengths=torch.from_numpy(lens))
    assert bool(torch.isfinite(got).all())
    _close(got, want, F32_TOL)
    _, v = tattn._project_kv(tl, tm, tcfg)
    uniform = v[0].mean(dim=0).reshape(-1) @ tl["wo"]
    _close(got[0], uniform.expand(3, -1), F32_TOL)


# ---------------------------------------------------------------------------
# encode, prefill / decode, greedy generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["bf16", "w4a8"])
def test_encode_ragged_rows_equal_unpadded_runs(fmt):
    """encode with enc_lengths (24, 13, 5 real frames, right-padded to 24;
    bf16): each row's real positions equal, bit for bit, that row encoded
    alone and unpadded; and the batch against the jitted reference's
    encode at the bf16 bound."""
    jcfg, tcfg = _cfgs()
    jp, tp = params_for("bfloat16", fmt)
    lens = [SE, 13, 5]
    feats = np.random.default_rng(10).standard_normal(
        (len(lens), SE, 64)).astype(np.float32)
    got = tlm.encode(tp, torch.from_numpy(feats), tcfg,
                     lengths=torch.tensor(lens, dtype=torch.int32))
    want = jax.jit(jlm.encode, static_argnums=2)(
        jp, jnp.asarray(feats), jcfg, jnp.asarray(lens, jnp.int32))
    for b, n in enumerate(lens):
        one = tlm.encode(tp, torch.from_numpy(feats[b:b + 1, :n]), tcfg)
        assert torch.equal(got[b:b + 1, :n], one), b
        _close(got[b, :n], want[b, :n], BF16_OUT_TOL, f"row {b}")


_jit_prefill = jax.jit(jlm.prefill, static_argnums=(2, 3),
                       static_argnames=("enc_pad",))
_jit_decode = jax.jit(jlm.decode_step, static_argnums=(4,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_and_decode_match_reference(fmt, dtype):
    """lm.prefill on (features, dec_tokens) and G teacher-forced
    decode_steps against the jitted reference's: logits at every step,
    and the flat cache ({k, v} self, {cross_k, cross_v, cross_len}) in
    the reference's nesting after the prefill and at the end."""
    assert tlm.blocks.BLOCK_FNS["encdec"] is tblocks.dec_block
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    inputs = _inputs(11)
    forced = np.random.default_rng(12).integers(0, 256, (B, G)).astype(
        np.int32)
    jl, jc = _jit_prefill(jp, _j(inputs), jcfg, S + G)
    tl, tc = tlm.prefill(tp, _t(inputs), tcfg, S + G)
    tol = _logit_tol(dtype, fmt, np.asarray(jl))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 1, 256)
    _close(tl, jl, tol, "prefill")
    _close_cache(tc, jc, dtype, "prefill", fmt)
    for i in range(G):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = _jit_decode(jp, jnp.asarray(forced[:, i:i + 1]), jc,
                             jnp.asarray(pos), jcfg)
        tl, tc = tlm.decode_step(tp, torch.from_numpy(forced[:, i:i + 1]),
                                 tc, torch.from_numpy(pos).long(), tcfg)
        _close(tl, jl, tol, f"decode step {i}")
    _close_cache(tc, jc, dtype, "end", fmt)


def test_ragged_prefill_and_masked_decode_match_reference():
    """lm.prefill with enc_lengths (24 and 9 real frames), enc_pad 32 and
    last_positions (prompts of 10 and 4 real tokens), then a decode step
    with the `active` mask, against the jitted reference (float32,
    w4a8): the real rows' logits, the cache (cross_len the rows'
    lengths, the cross K/V 32 wide); the inactive row's self KV and all
    cross K/V bit-identical across the step."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = params_for("float32", "w4a8")
    inputs = _inputs(13)
    lens = np.array([SE, 9], np.int32)
    last = np.array([S - 1, 3], np.int32)
    kw = dict(enc_lengths=lens, last_positions=last)
    jl, jc = _jit_prefill(jp, _j(inputs), jcfg, S + 2, enc_pad=32,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, tc = tlm.prefill(tp, _t(inputs), tcfg, S + 2, enc_pad=32,
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(tl, jl, F32_TOL)
    _close_cache(tc, jc, "float32")
    assert tuple(tc["cross_k"].shape) == (2, B, 32, 4, 16)
    np.testing.assert_array_equal(tc["cross_len"].numpy(), [lens, lens])
    tok = np.random.default_rng(14).integers(0, 256, (B, 1)).astype(np.int32)
    pos, active = last + 1, np.array([True, False])
    before = {k: t.clone() for k, t in tc.items()}
    jl, jc = _jit_decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg,
                         active=jnp.asarray(active))
    tl, tc = tlm.decode_step(tp, torch.from_numpy(tok), tc,
                             torch.from_numpy(pos).long(), tcfg,
                             active=torch.from_numpy(active))
    _close(tl[0], jl[0], F32_TOL)
    _close_cache(tc, jc, "float32")
    for k, t in tc.items():
        rows = slice(None) if k in tblocks.CROSS else 1
        assert torch.equal(t[:, rows], before[k][:, rows]), k


def _reference_logits(jp, jcfg, inputs, toks):
    """The reference's logits at each generate step, teacher-forced on its
    own tokens [B, g]: [B, g, V]."""
    b, g = toks.shape
    s = inputs[1].shape[1]
    lg, cache = _jit_prefill(jp, _j(inputs), jcfg, s + g)
    out = [np.asarray(lg[:, -1])]
    for i in range(g - 1):
        lg, cache = _jit_decode(jp, jnp.asarray(toks[:, i:i + 1]), cache,
                                jnp.full((b,), s + i, jnp.int32), jcfg)
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("dtype,fmt", [("bfloat16", "w8a8"),
                                       ("float32", "w4a8")])
def test_generate_matches_reference(dtype, fmt):
    """Greedy generate on (features, dec_tokens) (fused=True: the per-step
    loop on the CPU) against the reference's served `generate` (its
    decode one jitted `lax.scan`), by ROADMAP C2's rule
    (tests/test_torch_serve.py), 3 rows of 6 tokens: per token 8 GEMM
    dispatches per decoder layer and the head's, and the prefill's 6 per
    encoder layer and 2 more per decoder layer (the cross K/V)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    g = 6
    inputs = _inputs(15, b=3)
    want = np.asarray(jserve.generate(jp, _j(inputs), jcfg, gen=g,
                                      cache_len=S + g))
    ref_logits = _reference_logits(jp, jcfg, inputs, want)
    np.testing.assert_array_equal(ref_logits.argmax(-1), want)
    registry.reset_dispatch_counts()
    got, logits = tserve.generate(tp, inputs, tcfg, gen=g, cache_len=S + g,
                                  device="cpu", return_logits=True)
    assert sum(registry.dispatch_counts().values()) == \
        (8 * 2 + 1) * g + 6 * 2 + 2 * 2
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, g)
    assert_tokens_match(got.numpy(), logits.numpy(), want, ref_logits,
                        _logit_tol(dtype, fmt, ref_logits))


# ---------------------------------------------------------------------------
# serving: the captured step, --silvia, build_params, the CLI
# ---------------------------------------------------------------------------

def test_captured_step_static_buffers():
    """The captured step (run eagerly: the CPU has no graph) holds the flat
    encdec cache as its static buffers, the cross K/V as wide as the
    prefill's frames: the prefill's cache is copied in, each step
    updates the same tensors in place (the cross K/V unchanged), and the
    tokens, logits and final cache equal the per-step loop's bit for
    bit.  Another encoder width captures anew, with buffers of its
    width; the same width again keeps the step."""
    _, tcfg = _cfgs()
    _, tp = params_for("bfloat16", "w8a8")
    inputs = _t(_inputs(16))
    want, want_logits = tserve.generate(tp, inputs, tcfg, gen=G,
                                        cache_len=S + G, device="cpu",
                                        fused=False, return_logits=True)
    logits, cache = tlm.prefill(tp, inputs, tcfg, cache_len=S + G)
    bundle = tserve._decode_bundle(tcfg, "off", "cpu")
    cpu = torch.device("cpu")
    step = bundle.captured(tp, B, S + G, True, G - 1, cpu, SE)
    assert set(step.cache) == {"k", "v", "cross_k", "cross_v", "cross_len"}
    assert tuple(step.cache["cross_k"].shape) == (2, B, SE, 4, 16)
    assert tuple(step.cache["k"].shape) == (2, B, S + G, 4, 16)
    ptrs = {k: t.data_ptr() for k, t in step.cache.items()}
    toks, seen = step.run(logits[:, -1].argmax(dim=-1)[:, None], cache, S,
                          G - 1)
    assert torch.equal(toks, want[:, 1:])
    assert torch.equal(seen, want_logits[:, 1:])
    assert {k: t.data_ptr() for k, t in step.cache.items()} == ptrs
    for k in tblocks.CROSS:
        assert torch.equal(step.cache[k], cache[k]), k
    pos = torch.full((B,), S)
    tok = want[:, :1].long()
    for i in range(G - 1):
        _, cache = tlm.decode_step(tp, tok, cache, pos + i, tcfg)
        tok = want[:, i + 1:i + 2].long()
    for k in step.cache:
        assert torch.equal(step.cache[k], cache[k]), k
    captures = bundle.captures
    assert bundle.captured(tp, B, S + G, True, G - 1, cpu, SE) is step
    other = bundle.captured(tp, B, S + G, True, G - 1, cpu, SE + 8)
    assert other is not step and bundle.captures == captures + 1
    assert tuple(other.cache["cross_v"].shape) == (2, B, SE + 8, 4, 16)


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_generate_silvia_equals_off(fmt):
    """--silvia all changes no token and no logit on the encdec path: the
    traced step is functionalized and writes the self KV back at its
    end; the cross K/V it only reads."""
    _, tcfg = _cfgs()
    _, tp = params_for("bfloat16", fmt)
    inputs = _inputs(17, s=6)

    def gen(passes):
        return tserve.generate(tp, inputs, tcfg, gen=3, cache_len=9,
                               device="cpu", return_logits=True,
                               silvia_passes=passes)

    base, packed = gen("off"), gen("all")
    assert torch.equal(base[0], packed[0])
    assert torch.equal(base[1], packed[1])


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_build_params_equals_whole_tree_quantization(fmt):
    """build_params gives bit for bit the tree of
    quantize_tree_for_serving(lm.init_params(...)) for reduced whisper,
    forced and not (unforced, every reduced weight sits under the
    floors), with max_seq passed through to both position tables; and
    full-width whisper-small's unforced formats: every projection and
    MLP weight and the head quantize, the head (768, 51865) in w8a8
    under w4a8 (odd N)."""
    _, cfg = _cfgs()
    for force in (True, False):
        got = tserve.build_params(cfg, fmt, seed=5, quant_force=force,
                                  device="cpu", max_seq=40)
        want = tqt.quantize_tree_for_serving(
            tlm.init_params(cfg, 5, device="cpu", max_seq=40), fmt,
            force=force)
        g, gs = pytree.tree_flatten_with_path(got)
        w, ws = pytree.tree_flatten_with_path(want)
        assert gs == ws
        for (path, a), (_, b) in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b), \
                pytree.keystr(path)
        n_q = sum(isinstance(x, tqt.QTensor) for x in pytree.tree_leaves(
            got, is_leaf=lambda x: isinstance(x, tqt.QTensor)))
        assert n_q == (17 if force else 0)
        assert tuple(got["pos_embed"].shape) == (40, 64)
    full = tconfigs.get_config(ARCH)
    specs = tlm.param_specs(full, "meta", max_seq=1500)
    fmts = {pytree.keystr(p): tqt.serving_format(
        "/".join(k.key for k in p), s.shape, fmt)
        for p, s in pytree.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, tlm.Draw))
        if isinstance(s, tlm.Draw)}
    assert fmts.pop("['lm_head']") == "w8a8"
    assert fmts.pop("['embed']") is None and fmts.pop("['pos_embed']") is None
    assert fmts.pop("['enc_pos']") is None
    assert set(fmts.values()) == {fmt} and len(fmts) == 16


def test_serve_cli_refuses_encdec(capsys):
    """The CLI has no features to give the encoder: `--arch whisper-small`
    exits with a usage error naming generate(), as the reference's CLI
    refuses the family."""
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    assert e.value.code == 2
    assert "generate()" in capsys.readouterr().err


def test_card_check_teacher_forces_each_gemm():
    """chip_smoke.py's card-against-CPU check (`teacher_forced_vs_cpu`) on
    whisper's (features, dec_tokens), run with both sides on the CPU on
    the float32 w8a8 tree: the same tree twice agrees exactly; the
    prefill's 32 GEMMs (6 per encoder layer, 10 per decoder layer) and
    16 per decode step, and the head each time, are compared, with the
    logits and the 5 cache tensors; one column of enc_pos moved by 0.5
    fails at a GEMM's input; one weight's int8 value moved fails at that GEMM's
    output."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    _, tcfg = _cfgs(dtype="float32")
    tp = tserve.build_params(tcfg, "w8a8", seed=0, quant_force=True,
                             device="cpu", max_seq=MAX_SEQ)
    check = functools.partial(chip_smoke.teacher_forced_vs_cpu,
                              cpu_params=tp, prompts=_t(_inputs(18)),
                              cfg=tcfg, steps=2)
    st = check(tp)
    assert (st["gemms"], st["moes"], st["worst"]) == (
        (32 + 1) + 2 * (16 + 1), 0, 0.0)
    assert st["tensors"] == (32 + 1) + 2 * (16 + 1) + 3 * (1 + 5)
    enc_pos = tp["enc_pos"].clone()
    enc_pos[:, 0] += 0.5        # not a constant shift, which LayerNorm drops
    with pytest.raises(AssertionError, match="GEMM .*'s input"):
        check({**tp, "enc_pos": enc_pos})
    wo = tp["dec"]["cross"]["wo"]
    q = wo.q.clone()
    q[1, 0, 0] += 1 if q[1, 0, 0] < 127 else -1
    cross = {**tp["dec"]["cross"], "wo": tqt.QTensor(q, wo.scale, wo.fmt)}
    with pytest.raises(AssertionError, match="not the host's, bit for bit"):
        check({**tp, "dec": {**tp["dec"], "cross": cross}})
