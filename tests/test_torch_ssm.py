"""The SSM family in the port against `repro`: mamba2-2.7b at its reduced
config (2 layers, d_model 64, 8 heads of headdim 16, d_state 16, chunk
16, vocab 256, tied head).

Weights come from the reference (`repro.models.lm.init_params`, its
SSM parameters then given seeded values by `_perturb`: A per head in
[-16, -1], nonzero dt_bias and conv_b, D and norm_w away from 1; then
`quantize_tree_for_serving(force=True)`), imported through numpy; inputs
are numpy from a seed.  The reference is compared as it serves: jitted
(`jax.jit` of `ssd_forward`, `ssd_decode`, `lm.prefill`, `decode_step`),
the form in which the port quantizes activations (ROADMAP C7).  Prompts
of 40 tokens span three chunks of 16, the last one padded.

Tolerances and why (measured on these inputs):
* float32 configs check the algorithm: 1e-5 on outputs, logits and
  states (float32 sums in other orders, and the SSD einsums contracted
  pairwise in another order: measured <= 3.0e-7 on logits of max ~0.56
  in every format, <= 1.9e-6 on the conv state, whose values reach ~4,
  <= 1.5e-6 on one mixer call's output).
  With the activation quantization in the compiled form on both sides
  no int8 step moves, so the quantized formats hold the same bound.
* bf16 configs (the serving dtype): both sides round to bf16 at the
  same places (the conv's shift-and-add chain, silu, the cast before
  out_proj) but XLA may drop intermediate roundings inside a fused
  computation and sums in other orders (ROADMAP C1): logits measured
  <= 0.0133 (prefill and decode, max ~0.56), held to
  tests/test_torch_model.py's TOL (0.03) scaled by max|logit| / 0.47;
  one mixer call's output <= 0.0469 (three bf16 steps at its max of
  3.64) within BF16_OUT_TOL; the float32 SSM state <= 0.026 and the
  bf16 conv state <= 0.071 (values up to ~3.8, where a bf16 step is
  0.016, the second layer's input carrying the first's roundings):
  CACHE_TOL 0.125 as the KV cache's.
* Port-internal invariants are bit for bit: a right-padded ragged
  batch's rows equal their unpadded runs (output and final state), an
  inactive row's state is untouched, the captured step equals the
  per-step loop, `--silvia all` equals off.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jsil  # noqa: E402
from repro.core import opcount as jopcount  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.quant import qtensor as jqt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.quant import qtensor as tqt  # noqa: E402
from test_torch_model import TOL, jax_to_numpy  # noqa: E402
from test_torch_serve import assert_tokens_match  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCH = "mamba2-2.7b"
SMOLLM_MAX_LOGIT = 0.47
F32_TOL = 1e-5
BF16_OUT_TOL = 0.05
CACHE_TOL = {"float32": 1e-5, "bfloat16": 0.125}
B, S, G = 2, 40, 5
GEN_ROWS, GEN_TOKENS = 4, 8
FORMATS = ["bf16", "w8a8", "w4a8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (dataclasses.replace(jconfigs.get_reduced_config(ARCH), **kw),
            dataclasses.replace(tconfigs.get_reduced_config(ARCH), **kw))


_PARAMS = {}


def _perturb(jp, seed=7):
    """The reference's init leaves conv_b 0, A_log 0 (A = -1 on every
    head), D 1, dt_bias 0 and norm_w 1, under which a dropped bias or a
    per-head parameter broadcast over the wrong axis would not show.
    Give each seeded values, per layer and per head: A_log = log(U(1,
    16)), dt_bias ~ N(0, 0.5), conv_b, D and norm_w N(0, 0.1) added to
    their init."""
    rng = np.random.default_rng(seed)
    ssm = dict(jp["blocks"]["ssm"])

    def add(name, noise):
        ssm[name] = (ssm[name].astype(jnp.float32) + noise).astype(
            ssm[name].dtype)

    n = lambda k, sd: jnp.asarray(                        # noqa: E731
        rng.normal(0.0, sd, ssm[k].shape), jnp.float32)
    ssm["A_log"] = jnp.asarray(
        np.log(rng.uniform(1.0, 16.0, ssm["A_log"].shape)), jnp.float32)
    add("dt_bias", n("dt_bias", 0.5))
    for k in ("conv_b", "D", "norm_w"):
        add(k, n(k, 0.1))
    return {**jp, "blocks": {**jp["blocks"], "ssm": ssm}}


def params_for(dtype, fmt):
    """(jax params, port params) on the same weights, the reference's init
    with its SSM parameters perturbed (`_perturb`); memoized (read-only
    use)."""
    if (dtype, fmt) not in _PARAMS:
        jcfg, _ = _cfgs(dtype=dtype)
        jp = jqt.quantize_tree_for_serving(
            _perturb(jlm.init_params(jax.random.PRNGKey(0), jcfg,
                                     max_seq=64)), fmt, force=True)
        _PARAMS[dtype, fmt] = (jp, from_jax_params(jax_to_numpy(jp),
                                                   device="cpu"))
    return _PARAMS[dtype, fmt]


def _layer0(dtype, fmt):
    jp, tp = params_for(dtype, fmt)
    return (jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]),
            tblocks.tree_idx(tp["blocks"], 0))


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


def _logit_tol(dtype, fmt, ref_logits):
    if dtype == "float32":
        return F32_TOL
    return TOL[dtype][fmt] * max(1.0, float(np.abs(ref_logits).max())
                                 / SMOLLM_MAX_LOGIT)


def _out_tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_OUT_TOL


# ---------------------------------------------------------------------------
# configs, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(reduced):
    """Every field the port carries equals the reference's (SSMConfig
    whole); the rest are at their defaults there, but `subquadratic`,
    which only the reference's long-context shape table reads (not
    ported); param_count equals the reference's exactly (the final norm
    and the mixer's extras counted)."""
    get = "get_reduced_config" if reduced else "get_config"
    j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    carried = {f.name for f in dataclasses.fields(t)}
    assert "subquadratic" not in carried and j.subquadratic
    for name in carried - {"ssm"}:
        assert getattr(t, name) == getattr(j, name), name
    assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    for f in dataclasses.fields(j):
        if f.name not in carried | {"subquadratic"}:
            assert getattr(j, f.name) == f.default, f.name
    assert t.param_count() == j.param_count()
    assert t._ssm_layer_params() == j._ssm_layer_params()
    if not reduced:
        assert t.param_count() == 2702415360
    # the SSM family follows the MoE family in ARCHS (the hybrid family
    # follows it: tests/test_torch_hybrid.py)
    assert tconfigs.ARCHS[tconfigs.ARCHS.index(ARCH) - 1] == "arctic-480b"


def test_init_params_tree_matches_reference():
    """The port's own init has the reference's tree: {embed, final_norm,
    blocks: {ln, ssm: in_proj, conv_w, conv_b, A_log, D, dt_bias,
    norm_w, out_proj}} stacked on L, no lm_head (tied), with the
    reference's shapes and dtypes (float32 A_log, D, dt_bias, norm_w)."""
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  jcfg, max_seq=64))
    got = tlm.init_params(tcfg, 0, device="cpu")
    jl = {jax.tree_util.keystr(p): a
          for p, a in jax.tree_util.tree_leaves_with_path(want)}
    tl = {pytree.keystr(p): t for p, t in pytree.tree_leaves_with_path(got)}
    assert sorted(jl) == sorted(tl)
    for key, a in jl.items():
        assert tuple(a.shape) == tuple(tl[key].shape), key
        assert str(a.dtype) == str(tl[key].dtype).split(".")[-1], key
    ssm = got["blocks"]["ssm"]
    assert bool((ssm["D"] == 1).all()) and bool((ssm["A_log"] == 0).all())
    assert "lm_head" not in got


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_quantize_tree_and_convert_ssm(fmt):
    """quantize_tree_for_serving on an ssm tree equals the reference's,
    leaf for leaf and bit for bit: in_proj and out_proj become QTensors,
    the conv's taps and bias stay bf16 and A_log, D, dt_bias and norm_w
    float32 (skip_keys); from_jax_params carries every leaf unchanged."""
    jcfg, tcfg = _cfgs()
    raw = _perturb(jlm.init_params(jax.random.PRNGKey(3), jcfg, max_seq=64))
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
    assert n_q == 2
    ssm = conv["blocks"]["ssm"]
    for k in ("A_log", "D", "dt_bias", "norm_w"):
        assert ssm[k].dtype == torch.float32, k
    for k in ("conv_w", "conv_b"):
        assert ssm[k].dtype == torch.bfloat16, k
    assert ssm["in_proj"].logical_shape == (jcfg.n_layers, 64, 296)


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------

def test_softplus_and_silu_match_jax():
    """_softplus is jax.nn.softplus (logaddexp(x, 0)) across its range,
    past F.softplus's switch at 20 too; _silu is jax.nn.silu to float32
    rounding, and in bf16 within one bf16 step of the input's magnitude
    (XLA's bf16 sigmoid rounds otherwise, ROADMAP C1: measured one such
    step at most)."""
    x = np.concatenate([np.linspace(-40, 40, 4001), [-1e4, 1e4]]).astype(
        np.float32)
    got = tssm._softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    jx, tx = _x(9, (4096,), "float32")
    _close(tssm._silu(tx), jax.nn.silu(jx), 1e-6)
    jx, tx = _x(9, (4096,), "bfloat16")
    step = 2.0 ** (np.floor(np.log2(np.abs(_f32(tx)) + 1e-30)) - 7)
    assert (np.abs(_f32(tssm._silu(tx)) - _f32(jax.nn.silu(jx)))
            <= step).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    """The shift-and-add depthwise conv and its silu, on layer 0's taps
    and bias, against the reference's jitted: float32 within 1e-6, bf16
    within two bf16 steps of the largest output (the chain rounds at
    each of its four products and adds and at the silu, where XLA may
    fuse roundings away: measured one such step, 0.0078 at max 1.98)."""
    jcfg, _ = _cfgs(dtype=dtype)
    jl, tl = _layer0(dtype, "bf16")
    ch = jssm.dims(jcfg)[3]
    jx, tx = _x(2, (B, S, ch), dtype)
    want = jax.jit(jssm._causal_conv, static_argnums=3)(
        jx, jl["ssm"]["conv_w"], jl["ssm"]["conv_b"], 4)
    got = tssm._causal_conv(tx, tl["ssm"]["conv_w"], tl["ssm"]["conv_b"], 4)
    assert got.dtype == tx.dtype and tuple(got.shape) == (B, S, ch)
    w = _f32(want)
    tol = 1e-6 if dtype == "float32" else \
        2 * 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    _close(got, w, tol)


def test_segsum_decay_matches_reference():
    """L[i, j] = exp(cs[i] - cs[j]) on and below the diagonal, exactly 0
    above it (where exp overflowed to inf first), no NaN; equal to the
    reference's to float32 rounding."""
    rng = np.random.default_rng(3)
    cs = np.cumsum(-np.abs(rng.standard_normal((2, 16, 3))) * 30,
                   axis=1).astype(np.float32)
    got = tssm._segsum_decay(torch.from_numpy(cs)).numpy()
    want = np.asarray(jax.jit(jssm._segsum_decay)(jnp.asarray(cs)))
    assert got.shape == (2, 3, 16, 16) and not np.isnan(got).any()
    assert (got[:, :, ~np.tri(16, dtype=bool)] == 0).all()
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cs[:, :, None, :] - cs[:, None, :, :])).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


_jit_forward = jax.jit(jssm.ssd_forward, static_argnums=(2,),
                       static_argnames=("return_state",))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_ssd_forward_matches_reference(fmt, dtype):
    """ssd_forward with lengths on a 40-token input (three chunks of 16,
    the last padded; row 1 ragged at 29): output and final {ssm, conv}
    state against the reference's jitted."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jl, tl = _layer0(dtype, fmt)
    jx, tx = _x(4, (B, S, jcfg.d_model), dtype)
    lens = np.array([S, 29], np.int32)
    want, jst = _jit_forward(jl["ssm"], jx, jcfg, return_state=True,
                             lengths=jnp.asarray(lens))
    got, st = tssm.ssd_forward(tl["ssm"], tx, tcfg, torch.from_numpy(lens),
                               return_state=True)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    for b, n in enumerate(lens):       # a padded row's tail is not output
        _close(got[b, :n], want[b, :n], _out_tol(dtype), f"row {b}")
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].dtype == tx.dtype
    for k in ("ssm", "conv"):
        assert tuple(st[k].shape) == tuple(jst[k].shape)
        _close(st[k], jst[k], CACHE_TOL[dtype], k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_rows_equal_unpadded_runs(dtype):
    """A right-padded ragged batch (lengths 40, 23, 16, 2: three, two,
    one and one chunks) on the fixed chunk grid: each row's output and
    final {ssm, conv} state equal, bit for bit, that row run alone and
    unpadded (padded steps are identity steps; a row shorter than the
    conv window keeps the window's leading zeros)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    _, tl = _layer0(dtype, "w8a8")
    lens = [S, 23, 16, 2]
    _, tx = _x(5, (len(lens), S, jcfg.d_model), dtype)
    out, st = tssm.ssd_forward(tl["ssm"], tx, tcfg, torch.tensor(lens),
                               return_state=True)
    for b, n in enumerate(lens):
        one, st1 = tssm.ssd_forward(tl["ssm"], tx[b:b + 1, :n], tcfg,
                                    torch.tensor([n]), return_state=True)
        assert torch.equal(out[b:b + 1, :n], one), b
        assert torch.equal(st["ssm"][b:b + 1], st1["ssm"]), b
        assert torch.equal(st["conv"][b:b + 1], st1["conv"]), b
    assert bool((st["conv"][3, 0] == 0).all())       # 2 < W - 1
    assert torch.equal(st["conv"][3, 1:], tssm._split_proj(
        tqt.qmatmul(tx[3:, :2], tl["ssm"]["in_proj"]), tcfg)[1][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_matches_reference(dtype):
    """ssd_decode from a prefilled state against the reference's jitted,
    with the `active` mask: active rows' output and new state within the
    tolerances; the inactive row's {ssm, conv} state bit-identical; the
    state updated in place (the same tensors)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jl, tl = _layer0(dtype, "w4a8")
    jx, tx = _x(6, (3, 17, jcfg.d_model), dtype)
    lens = jnp.asarray([17, 11, 17], jnp.int32)
    _, jst = _jit_forward(jl["ssm"], jx, jcfg, return_state=True,
                          lengths=lens)
    _, st = tssm.ssd_forward(tl["ssm"], tx, tcfg,
                             torch.tensor([17, 11, 17]), return_state=True)
    jt, tt = _x(7, (3, 1, jcfg.d_model), dtype)
    active = np.array([True, False, True])
    want, jnew = jax.jit(jssm.ssd_decode, static_argnums=(3,))(
        jl["ssm"], jt, jst, jcfg, active=jnp.asarray(active))
    before = {k: t.clone() for k, t in st.items()}
    ptrs = {k: t.data_ptr() for k, t in st.items()}
    got, new = tssm.ssd_decode(tl["ssm"], tt, st, tcfg,
                               active=torch.from_numpy(active))
    assert new is st and {k: t.data_ptr() for k, t in st.items()} == ptrs
    _close(got[active], np.asarray(want)[active], _out_tol(dtype))
    for k in ("ssm", "conv"):
        assert torch.equal(st[k][1], before[k][1]), k
        assert not torch.equal(st[k][0], before[k][0]), k
        _close(st[k], jnew[k], CACHE_TOL[dtype], k)


def test_prefill_then_decode_equals_forward():
    """The recurrent decode continues the chunked form: ssd_forward over
    S tokens, then G single-token ssd_decode steps, equals ssd_forward
    over all S + G tokens (float32, the port alone: the chunked and the
    recurrent algebra differ only in rounding)."""
    jcfg, tcfg = _cfgs(dtype="float32")
    _, tl = _layer0("float32", "w8a8")
    _, tx = _x(8, (B, S + G, jcfg.d_model), "float32")
    full = tssm.ssd_forward(tl["ssm"], tx, tcfg, torch.full((B,), S + G))
    _, st = tssm.ssd_forward(tl["ssm"], tx[:, :S], tcfg, torch.full((B,), S),
                             return_state=True)
    for i in range(G):
        y, st = tssm.ssd_decode(tl["ssm"], tx[:, S + i:S + i + 1], st, tcfg)
        _close(y[:, 0], full[:, S + i], F32_TOL, f"step {i}")


# ---------------------------------------------------------------------------
# the model: prefill / decode, greedy generate, serving
# ---------------------------------------------------------------------------

_jit_prefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
_jit_decode = jax.jit(jlm.decode_step, static_argnums=(4,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_and_decode_match_reference(fmt, dtype):
    """lm.prefill and G teacher-forced decode_steps against the jitted
    reference's: logits at every step, and the stacked {ssm: [L, B, H, P,
    N], conv: [L, B, W-1, ch]} cache after the prefill and at the end;
    the block is `blocks.BLOCK_FNS["ssm"]`."""
    assert tlm.blocks.BLOCK_FNS["ssm"] is tblocks.ssm_block
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    rng = np.random.default_rng(10)
    prompts = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (B, G)).astype(np.int32)
    jl, jc = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S + G)
    tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + G)
    tol = _logit_tol(dtype, fmt, np.asarray(jl))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 1, 256)
    assert set(tc) == {"ssm", "conv"}
    _close(tl, jl, tol, "prefill")
    for k in ("ssm", "conv"):
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        _close(tc[k], jc[k], CACHE_TOL[dtype], k)
    for i in range(G):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = _jit_decode(jp, jnp.asarray(forced[:, i:i + 1]), jc,
                             jnp.asarray(pos), jcfg)
        tl, tc = tlm.decode_step(tp, torch.from_numpy(forced[:, i:i + 1]),
                                 tc, torch.from_numpy(pos).long(), tcfg)
        _close(tl, jl, tol, f"decode step {i}")
    for k in ("ssm", "conv"):
        _close(tc[k], jc[k], CACHE_TOL[dtype], k)


def test_ragged_prefill_and_masked_decode_match_reference():
    """lm.prefill with last_positions (rows of 40, 17 and 5 real tokens)
    and a decode step with the `active` mask, against the jitted
    reference (float32, w4a8): logits of the real rows; the inactive
    row's state in every layer bit-identical."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = params_for("float32", "w4a8")
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, jcfg.vocab, (3, S)).astype(np.int32)
    last = np.array([S - 1, 16, 4], np.int32)
    jl, jc = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S + 2,
                          last_positions=jnp.asarray(last))
    tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + 2,
                         last_positions=torch.from_numpy(last))
    _close(tl, jl, F32_TOL)
    tok = rng.integers(0, jcfg.vocab, (3, 1)).astype(np.int32)
    pos = last + 1
    active = np.array([True, False, True])
    before = {k: t.clone() for k, t in tc.items()}
    jl, jc = _jit_decode(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg,
                         active=jnp.asarray(active))
    tl, tc = tlm.decode_step(tp, torch.from_numpy(tok), tc,
                             torch.from_numpy(pos).long(), tcfg,
                             active=torch.from_numpy(active))
    _close(tl.numpy()[active], np.asarray(jl)[active], F32_TOL)
    for k in ("ssm", "conv"):
        assert torch.equal(tc[k][:, 1], before[k][:, 1]), k
        _close(tc[k], jc[k], CACHE_TOL["float32"], k)


def _reference_logits(jp, jcfg, prompts, toks):
    """The reference's logits at each generate step, teacher-forced on its
    own tokens [B, g]: [B, g, V]."""
    b, g = toks.shape
    lg, cache = _jit_prefill(jp, jnp.asarray(prompts), jcfg, S + g)
    out = [np.asarray(lg[:, -1])]
    for i in range(g - 1):
        lg, cache = _jit_decode(jp, jnp.asarray(toks[:, i:i + 1]), cache,
                                jnp.full((b,), S + i, jnp.int32), jcfg)
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("dtype,fmt", [("bfloat16", "w8a8"),
                                       ("bfloat16", "w4a8"),
                                       ("float32", "w4a8")])
def test_generate_matches_reference(dtype, fmt):
    """Greedy generate (fused=True: the per-step loop on the CPU) against
    the reference's served `generate` (its prefill's layers inside
    `lax.scan`, its decode one jitted `lax.scan`), by ROADMAP C2's rule
    (tests/test_torch_serve.py), on 4 rows of 8 tokens (bf16 w4a8 has 5
    decisive steps of 32 there, 1 of 10 on 2 rows of 5): two GEMM
    dispatches per layer and token, none for the tied head."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    b, g = GEN_ROWS, GEN_TOKENS
    prompts = np.random.default_rng(12).integers(
        0, jcfg.vocab, (b, S)).astype(np.int32)
    want = np.asarray(jserve.generate(jp, jnp.asarray(prompts), jcfg, gen=g,
                                      cache_len=S + g))
    ref_logits = _reference_logits(jp, jcfg, prompts, want)
    np.testing.assert_array_equal(ref_logits.argmax(-1), want)
    registry.reset_dispatch_counts()
    got, logits = tserve.generate(tp, prompts, tcfg, gen=g, cache_len=S + g,
                                  device="cpu", return_logits=True)
    assert sum(registry.dispatch_counts().values()) == 2 * tcfg.n_layers * g
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, g)
    assert_tokens_match(got.numpy(), logits.numpy(), want, ref_logits,
                        _logit_tol(dtype, fmt, ref_logits))


def test_captured_step_static_buffers():
    """The captured step (run eagerly: the CPU has no graph) holds the ssm
    state as its static buffers, {ssm, conv} from init_cache: the
    prefill's state is copied in, each step updates the same tensors in
    place, and the tokens, logits and final state equal the per-step
    loop's bit for bit."""
    _, tcfg = _cfgs()
    _, tp = params_for("bfloat16", "w8a8")
    prompts = np.random.default_rng(13).integers(0, tcfg.vocab, (B, S))
    want, want_logits = tserve.generate(tp, prompts, tcfg, gen=G,
                                        cache_len=S + G, device="cpu",
                                        fused=False, return_logits=True)
    logits, cache = tlm.prefill(tp, torch.as_tensor(prompts), tcfg,
                                cache_len=S + G)
    bundle = tserve._decode_bundle(tcfg, "off", "cpu")
    step = bundle.captured(tp, B, S + G, True, G - 1, torch.device("cpu"))
    assert set(step.cache) == {"ssm", "conv"}
    assert tuple(step.cache["ssm"].shape) == (2, B, 8, 16, 16)
    assert step.cache["ssm"].dtype == torch.float32
    ptrs = {k: t.data_ptr() for k, t in step.cache.items()}
    toks, seen = step.run(logits[:, -1].argmax(dim=-1)[:, None], cache, S,
                          G - 1)
    assert torch.equal(toks, want[:, 1:])
    assert torch.equal(seen, want_logits[:, 1:])
    assert {k: t.data_ptr() for k, t in step.cache.items()} == ptrs
    pos = torch.full((B,), S)
    tok = want[:, :1].long()
    for i in range(G - 1):       # the per-step loop's state, step by step
        _, cache = tlm.decode_step(tp, tok, cache, pos + i, tcfg)
        tok = want[:, i + 1:i + 2].long()
    for k in ("ssm", "conv"):
        assert torch.equal(step.cache[k], cache[k]), k


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_generate_silvia_equals_off(fmt):
    """--silvia all changes no token and no logit on the ssm path: the
    traced step is functionalized and writes the state back at its end.
    The passes find nothing to pack in it, as the reference's find
    nothing in its own (in_proj's and out_proj's int4 unpacking have no
    partner of their shape within a layer, where the dense step's wk /
    wv pair packs: tests/test_torch_serve_fused.py)."""
    jcfg, tcfg = _cfgs()
    jp, tp = params_for("bfloat16", fmt)
    prompts = np.random.default_rng(14).integers(0, tcfg.vocab, (B, 8))

    def gen(passes):
        return tserve.generate(tp, prompts, tcfg, gen=G, cache_len=8 + G,
                               device="cpu", return_logits=True,
                               silvia_passes=passes)

    base = gen("off")
    registry.reset_dispatch_counts()
    packed = gen("all")
    assert torch.equal(base[0], packed[0])
    assert torch.equal(base[1], packed[1])
    assert registry.dispatch_counts()["simd_add"] == 0
    _, jc = jlm.prefill(jp, jnp.asarray(prompts[:, :4], jnp.int32), jcfg, 8)
    closed = jsil.optimized_jaxpr(
        lambda p, t, k, q: jlm.decode_step(p, t, k, q, jcfg), jp,
        jnp.zeros((B, 1), jnp.int32), jc, jnp.full((B,), 4, jnp.int32))
    assert jopcount.count_ops(closed).packed_units == 0


def test_serve_cli_ssm_on_cpu(capsys):
    """`--arch mamba2-2.7b` through the CLI on the CPU: in_proj and
    out_proj per layer and token, on the packed GEMM; the tied head is a
    plain bf16 matmul."""
    tserve.main(["--arch", ARCH, "--reduced", "--quant", "w4a8",
                 "--quant-force", "--batch", "2", "--prompt-len", "20",
                 "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    counts = eval(re.search(r"dispatch counts: (\{.*\})", out).group(1))
    assert counts["packed_w4_matmul"] == 2 * 2 * 3
    assert counts["quant_matmul"] == 0
    assert re.search(r"sample tokens: \[", out)
