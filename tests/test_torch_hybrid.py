"""The hybrid family in the port against `repro`: jamba-v0.1-52b at its
reduced config (one scan unit of 8 layers: layer 4 attention, the other
seven SSD mixers; MoE of 4 experts top-2 on layers 1, 3, 5, 7, a dense
SwiGLU MLP on the others; d_model 64, vocab 256, untied head) and a
2-unit variant (n_layers 16) that exercises the unit axis.  And the
port's streaming init (`launch/serve.py::build_params`) against
whole-tree quantization for every ported family.

Weights come from the reference (`repro.models.lm.init_params`, its
mixers' parameters then given seeded values by `_perturb`, as
tests/test_torch_ssm.py does; then `quantize_tree_for_serving(
force=True)`), imported through numpy; inputs are numpy from a seed.
The reference is compared as it serves: jitted (`jax.jit` of
`hybrid_block`, `lm.prefill`, `lm.decode_step`; its `generate`), the form
in which the port quantizes activations (ROADMAP C7).

Routes: each side's MoE routes are recorded (the reference's from inside
its jitted computation, by `jax.debug.callback`) and ROADMAP C2's router
rule applies, as in tests/test_torch_moe.py: wherever the routes
differ, the reference's k-th / (k+1)-th probability margin must be
under twice ROUTER_TOL, and a row is compared up to its first position
routed otherwise in some layer (the SSM state and causal attention carry
a swap to every later position of the row).

Tolerances and why (measured on these inputs):
* float32, unquantized: 1e-5 on logits, 3e-5 on caches and on a
  block's output (float32 sums in other orders: measured <= 6.2e-6 on
  logits of max ~3.9, at one unit and at two, 1.13e-5 on the second
  unit's value cache and 1.4e-5 on its output, a residual stream up to
  ~5).  The routes agree everywhere.
* float32 with int8 activations, one unit from the same input
  (`test_hybrid_block_matches_reference`, w8a8 and w4a8): 1e-5 on the
  output, 3e-5 on caches, as unquantized.
* float32 with int8 activations, the whole model: QUANT_F32_TOL, 0.05.
  An activation that sits on an int8 rounding boundary is rounded to
  either side by the two frameworks' last-bit differences, and the stack
  carries that one step (ROADMAP C8): one row moved 0.0175 (w4a8, one
  unit) and 0.03 (w8a8, two units) on logits of max ~3.8 with every
  route alike, while each unit fed the reference's own input agrees
  within 3.4e-6.  Wiring faults of the quantized path move logits by
  O(1).
* bf16 (the serving dtype): the two frameworks round to bf16 at the same
  places but sum in other orders (ROADMAP C1), and this stack amplifies
  it: each side's bf16 logits sit 0.08-0.27 (RMS; up to 1.6 at most)
  from the reference's float32 run on the same weights, and routes part
  from the first positions at router margins up to 0.18.  So bf16 runs
  are held to that oracle: the port's RMS error against the reference's
  float32 run, over every logit and every cache, within BF16_RATIO (2.5)
  times the reference's own bf16 run's (measured 0.6-1.39 in 12 runs of
  w8a8 / w4a8 at one and two units).  A dropped or misplaced term
  computed in bf16 moves it by far more.
* Port-internal invariants are bit for bit: an inactive row's state and
  KV are untouched, the captured step equals the per-step loop,
  `--silvia all` equals off, and `build_params` equals the whole-tree
  quantization of `lm.init_params`.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.quant import qtensor as jqt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.quant import qtensor as tqt  # noqa: E402
from test_torch_model import jax_to_numpy  # noqa: E402
from test_torch_moe import _first_diff, _recorded  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCH = "jamba-v0.1-52b"
F32_TOL = 1e-5
F32_CACHE_TOL = 3e-5
QUANT_F32_TOL = 0.05
BF16_RATIO = 2.5
B, S, G = 2, 20, 4
PORTED = ["smollm-135m", "qwen1.5-0.5b", "granite-moe-1b-a400m",
          "arctic-480b", "mamba2-2.7b", ARCH]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(units=1, **kw):
    return tuple(dataclasses.replace(
        c.get_reduced_config(ARCH), n_layers=8 * units, **kw)
        for c in (jconfigs, tconfigs))


def _perturb(jp, seed=7):
    """The mixers' A_log, dt_bias, conv_b, D and norm_w given seeded
    values (tests/test_torch_ssm.py::_perturb's, on the hybrid's
    [U, 7, ...] leaves): at the init's constants a dropped term or a
    per-head parameter on the wrong axis would not show."""
    rng = np.random.default_rng(seed)
    m = dict(jp["blocks"]["mamba"])

    def add(name, noise):
        m[name] = (m[name].astype(jnp.float32) + noise).astype(m[name].dtype)

    n = lambda k, sd: jnp.asarray(                        # noqa: E731
        rng.normal(0.0, sd, m[k].shape), jnp.float32)
    m["A_log"] = jnp.asarray(
        np.log(rng.uniform(1.0, 16.0, m["A_log"].shape)), jnp.float32)
    add("dt_bias", n("dt_bias", 0.5))
    for k in ("conv_b", "D", "norm_w"):
        add(k, n(k, 0.1))
    return {**jp, "blocks": {**jp["blocks"], "mamba": m}}


_PARAMS = {}


def params_for(dtype, fmt, units=1):
    """(jax params, port params) on the same weights, the reference's init
    with its mixers perturbed; memoized (read-only use)."""
    key = (dtype, fmt, units)
    if key not in _PARAMS:
        jcfg, _ = _cfgs(units, dtype=dtype)
        jp = jqt.quantize_tree_for_serving(
            _perturb(jlm.init_params(jax.random.PRNGKey(0), jcfg,
                                     max_seq=64)), fmt, force=True)
        _PARAMS[key] = (jp, from_jax_params(jax_to_numpy(jp), device="cpu"))
    return _PARAMS[key]


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=tol,
                               err_msg=what)


def _tol(fmt, what="logits"):
    """The float32 tolerance of a format (module docstring)."""
    if fmt != "bf16":
        return QUANT_F32_TOL
    return F32_TOL if what in ("logits", "prefill", "decode") else \
        F32_CACHE_TOL


def _upcast(jp):
    """The reference's params with every bf16 leaf in float32: the same
    weights, for the float32 oracle of a bf16 run."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jp)


def _rms(a, b):
    return float(np.sqrt(np.mean((_f32(a) - _f32(b)) ** 2)))


def _within_bf16_noise(port, ref, oracle, what):
    """The port's bf16 result no farther (RMS) from the reference's
    float32 run on the same weights than BF16_RATIO times the reference's
    own bf16 result (module docstring)."""
    got, own = _rms(port, oracle), _rms(ref, oracle)
    assert own > 0 and got <= BF16_RATIO * own, \
        f"{what}: port {got:.4g} against the reference's {own:.4g}"


def _nested(cache):
    """The port's flat hybrid cache in the reference's nesting."""
    return {"mamba": {k: cache[k] for k in ("ssm", "conv")},
            "attn": {k: t for k, t in cache.items()
                     if k not in ("ssm", "conv")}}


# ---------------------------------------------------------------------------
# the reference, jitted, with its routes recorded
# ---------------------------------------------------------------------------

_ROUTES = []
_JMOE = jmlp.moe


def _routed_moe(p, x, cfg, per_token=False, **kw):
    """The reference's moe, recording (sorted top-k ids [B, T, k], k-th
    minus (k+1)-th probability [B, T]) of its router as test_torch_moe's
    `_routes` computes them, from inside a jitted computation."""
    k = cfg.moe.top_k
    shape = x.shape[:2]
    probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                           @ p["router"], axis=-1)
    top, ids = jax.lax.top_k(probs, k + 1)

    def keep(ids, top):
        ids, top = np.asarray(ids), np.asarray(top)
        _ROUTES.append((np.sort(ids[:, :k], axis=-1).reshape(*shape, k),
                        (top[:, k - 1] - top[:, k]).reshape(shape)))

    jax.debug.callback(keep, ids, top, ordered=True)
    return _JMOE(p, x, cfg, per_token, **kw)


def _routing(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        jmlp.moe = _routed_moe
        try:
            return fn(*args, **kw)
        finally:
            jmlp.moe = _JMOE
    return run


_jit_block = jax.jit(_routing(jblocks.hybrid_block), static_argnums=(2,),
                     static_argnames=("mode", "cache_len"))
_jit_prefill = jax.jit(_routing(jlm.prefill), static_argnums=(2, 3))
_jit_decode = jax.jit(_routing(jlm.decode_step), static_argnums=(4,))


def _ref(fn, *args, **kw):
    """(fn's outputs, the routes its MoE calls recorded, in call order)."""
    _ROUTES.clear()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    jax.effects_barrier()
    return out, list(_ROUTES)


# ---------------------------------------------------------------------------
# configs, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(reduced):
    """Every field the port carries equals the reference's (HybridConfig,
    MoEConfig and SSMConfig whole); the rest are at their defaults there,
    but `subquadratic` (only the reference's long-context shape table
    reads it); param_count equals the reference's exactly, 51.46 B at
    full width."""
    get = "get_reduced_config" if reduced else "get_config"
    j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    carried = {f.name for f in dataclasses.fields(t)}
    assert "subquadratic" not in carried and j.subquadratic
    subs = {"hybrid", "moe", "ssm"}
    for name in carried - subs:
        assert getattr(t, name) == getattr(j, name), name
    for name in subs:
        assert dataclasses.asdict(getattr(t, name)) == \
            dataclasses.asdict(getattr(j, name)), name
    for f in dataclasses.fields(j):
        if f.name not in carried | {"subquadratic"}:
            assert getattr(j, f.name) == f.default, f.name
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert tlm.n_scan_units(t) == jlm.n_scan_units(j)
    if not reduced:
        assert t.param_count() == 51459734400
        assert tlm.n_scan_units(t) == 4


def test_archs_include_the_hybrid_family():
    # the encoder-decoder family follows it (tests/test_torch_encdec.py)
    assert tconfigs.ARCHS[-2:] == [ARCH, "whisper-small"]
    assert [a for a in tconfigs.ARCHS
            if tconfigs.get_config(a).family == "hybrid"] == [ARCH]
    assert tlm.blocks.BLOCK_FNS["hybrid"] is tblocks.hybrid_block


@pytest.mark.parametrize("units", [1, 2])
def test_init_params_tree_matches_reference(units):
    """The port's own init has the reference's tree (`init_hybrid_block`
    stacked on the scan units): mamba and mamba_ln [U, 7, ...], attn and
    attn_ln [U, ...], moe [U, 4, ...], dense [U, 4, ...], ffn_ln
    [U, 8, d], with its shapes and dtypes."""
    jcfg, tcfg = _cfgs(units)
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
    assert tuple(got["blocks"]["moe"]["wi"].shape) == (units, 4, 4, 64, 96)
    assert tuple(got["blocks"]["ffn_ln"]["w"].shape) == (units, 8, 64)


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_quantize_tree_and_convert_hybrid(fmt):
    """quantize_tree_for_serving on a hybrid tree equals the reference's,
    leaf for leaf and bit for bit: the mixers' in_proj and out_proj, the
    attention's four projections, the [U, 4, E, K, N] experts, the dense
    MLPs and the head become QTensors; the router, the conv and every
    norm stay float.  from_jax_params carries every leaf unchanged."""
    jcfg, _ = _cfgs(1)
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
    assert n_q == 2 + 4 + 3 + 3 + 1          # mamba, attn, moe, dense, head
    assert want["blocks"]["moe"]["wo"].scale.shape == (1, 4, 4, 1, 64)


# ---------------------------------------------------------------------------
# hybrid_block
# ---------------------------------------------------------------------------

def _block_prefill(jl, jcfg, tl, tcfg, x, lens, cache_len):
    """The reference's jitted block and the port's on the same input: a
    prefill filling the port's flat cache in place.  Returns (port out,
    port cache, reference out, reference cache, per-row first position
    routed otherwise)."""
    dt = jnp.dtype(jcfg.dtype)
    (want, jcache, _), ref = _ref(
        _jit_block, jl, jnp.asarray(x, dt), jcfg, mode="prefill",
        cache_len=cache_len, lengths=jnp.asarray(lens))
    cache = {k: t[0] for k, t in tlm.init_cache(tcfg, B, cache_len,
                                                device="cpu").items()}
    with _recorded(tmlp) as port:
        got = tblocks.hybrid_block(
            tl, torch.from_numpy(x).to(getattr(torch, tcfg.dtype)), tcfg,
            mode="prefill", cache=cache, lengths=torch.from_numpy(lens))
    return got, cache, want, jcache, port, ref


@pytest.mark.parametrize("dtype,fmt", [("float32", "bf16"),
                                       ("float32", "w8a8"),
                                       ("float32", "w4a8"),
                                       ("bfloat16", "w4a8")])
def test_hybrid_block_matches_reference(dtype, fmt):
    """hybrid_block on unit 1 of the 2-unit tree (the unit axis sliced
    past 0) against the reference's jitted block, from the same input: a
    ragged prefill (rows of 20 and 9 real tokens, on the fixed chunk
    grid) filling the flat cache in place, then a decode step with row 1
    inactive.  float32 under w8a8 and w4a8 (the int8 sums exact): outputs
    within 1e-5, caches within 3e-5; unquantized: both within 3e-5 (its
    output, a residual stream up to ~5, measured 1.4e-5 off); every
    route alike.  bf16: within the reference's own bf16 noise against its
    float32 block on the same weights.  The inactive row's state and KV
    bit-identical; the cache written in place."""
    jcfg, tcfg = _cfgs(2, dtype=dtype)
    jp, tp = params_for(dtype, fmt, 2)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"])
    tl = tblocks.tree_idx(tp["blocks"], 1)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    t = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    lens = np.array([S, 9], np.int32)
    active = np.array([True, False])
    got, cache, want, jcache, port, ref = _block_prefill(
        jl, jcfg, tl, tcfg, x, lens, S + 1)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, S, 64)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    prefilled = (got, _nested(before))
    step = dict(mode="decode", pos=jnp.asarray(lens),
                active=jnp.asarray(active))
    (want_t, jcache_t, _), _ = _ref(_jit_block, jl, jnp.asarray(
        t, jnp.dtype(dtype)), jcfg, cache=jcache, **step)
    got_t = tblocks.hybrid_block(tl, torch.from_numpy(t).to(got.dtype),
                                 tcfg, mode="decode", cache=cache,
                                 pos=torch.from_numpy(lens).long(),
                                 active=torch.from_numpy(active))
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    for k in ("ssm", "conv"):
        assert torch.equal(cache[k][:, 1], before[k][:, 1]), k
        assert not torch.equal(cache[k][:, 0], before[k][:, 0]), k
    for k in ("k", "v"):
        assert torch.equal(cache[k][1], before[k][1]), k
    pairs = [(prefilled[0], want, "prefill"), (got_t[0], want_t[0], "decode")]
    for group in ("mamba", "attn"):
        for k, v in prefilled[1][group].items():
            assert tuple(v.shape) == tuple(jcache[group][k].shape), k
            pairs.append((v, jcache[group][k], f"prefill {k}"))
        for k, v in _nested(cache)[group].items():
            pairs.append((v, jcache_t[group][k], f"decode {k}"))
    if dtype == "float32":
        assert (_first_diff(port, ref, 4, dtype) == S).all()
        # unquantized, the block's float GEMMs sum in other orders too
        out_tol = F32_CACHE_TOL if fmt == "bf16" else F32_TOL
        for g, w, what in pairs:
            _close(g, w, out_tol if what in ("prefill", "decode")
                   else F32_CACHE_TOL, what)
    else:           # the oracle: the reference's float32 block
        j32 = dataclasses.replace(jcfg, dtype="float32")
        jl32 = _upcast(jl)
        (o, oc, _), _ = _ref(_jit_block, jl32, jnp.asarray(x), j32,
                             mode="prefill", cache_len=S + 1,
                             lengths=jnp.asarray(lens))
        (o_t, oc_t, _), _ = _ref(_jit_block, jl32, jnp.asarray(t), j32,
                                 cache=oc, **step)
        oracle = [o, o_t[0]] + [
            c[group][k] for group in ("mamba", "attn")
            for c in (oc, oc_t) for k in prefilled[1][group]]
        for (g, w, what), orc in zip(pairs, oracle):
            _within_bf16_noise(g, w, orc, what)
    with pytest.raises(ValueError, match="mode"):
        tblocks.hybrid_block(tl, got, tcfg, mode="train", cache=cache)


# ---------------------------------------------------------------------------
# the model: prefill / decode, greedy generate, serving
# ---------------------------------------------------------------------------

def _run_reference(jp, jcfg, prompts, forced):
    """The jitted reference's prefill then teacher-forced decode steps:
    (logits [B, G+1, V], cache after the prefill, cache at the end,
    routes)."""
    (jl, jc), routes = _ref(_jit_prefill, jp, jnp.asarray(prompts), jcfg,
                            S + G)
    out, first = [np.asarray(jl)[:, 0]], jc
    for i in range(G):
        (jl, jc), r = _ref(_jit_decode, jp, jnp.asarray(forced[:, i:i + 1]),
                           jc, jnp.full((B,), S + i, jnp.int32), jcfg)
        routes += r
        out.append(np.asarray(jl)[:, 0])
    return np.stack(out, 1), first, jc, routes


# (units, dtype, fmt): float32 unquantized at two units, quantized at
# one (ROADMAP C8); bf16 quantized at one unit and at two
MODEL_CASES = [(2, "float32", "bf16"),
               (1, "float32", "w8a8"), (1, "float32", "w4a8"),
               (1, "bfloat16", "w8a8"), (2, "bfloat16", "w4a8")]


@pytest.mark.parametrize("units,dtype,fmt", MODEL_CASES)
def test_prefill_and_decode_match_reference(units, dtype, fmt):
    """lm.prefill and G teacher-forced decode_steps against the jitted
    reference's: the logits at every step and the flat cache {ssm, conv:
    [U, 7, B, ...], k, v: [U, B, S, KV, D]} against the reference's
    nested one, after the prefill and at the end.  float32: within the
    format's tolerance, every route alike (the near-tie rule); bf16:
    within the reference's own bf16 noise against its float32 run on the
    same weights (module docstring)."""
    jcfg, tcfg = _cfgs(units, dtype=dtype)
    jp, tp = params_for(dtype, fmt, units)
    rng = np.random.default_rng(10 + units)
    prompts = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (B, G)).astype(np.int32)
    want, jc0, jc, ref = _run_reference(jp, jcfg, prompts, forced)
    with _recorded(tmlp) as port:
        tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + G)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 1, 256)
        assert set(tc) == {"ssm", "conv", "k", "v"}
        tc0 = _nested({k: t.clone() for k, t in tc.items()})
        got = [tl[:, 0]]
        for i in range(G):
            tl, tc = tlm.decode_step(tp, torch.from_numpy(forced[:, i:i + 1]),
                                     tc, torch.full((B,), S + i), tcfg)
            got.append(tl[:, 0])
    got = torch.stack(got, 1)
    pairs = [(got, want, "logits")] + [
        (t[group][k], c[group][k], f"{group}/{k}")
        for t, c in ((tc0, jc0), (_nested(tc), jc))
        for group in ("mamba", "attn") for k in t[group]]
    for g, w, what in pairs:
        assert tuple(g.shape) == tuple(w.shape), what
    if dtype == "float32":
        assert (_first_diff(port, ref, 4 * units, dtype) == S + G).all()
        for g, w, what in pairs:
            _close(g, w, _tol(fmt, what), what)
        return
    oracle, oc0, oc, _ = _run_reference(
        _upcast(jp), dataclasses.replace(jcfg, dtype="float32"), prompts,
        forced)
    oracles = [oracle] + [c[group][k] for c in (oc0, oc)
                          for group in ("mamba", "attn") for k in tc0[group]]
    for (g, w, what), o in zip(pairs, oracles):
        _within_bf16_noise(g, w, o, what)


def test_ragged_prefill_and_masked_decode_match_reference():
    """lm.prefill with last_positions (rows of 20 and 7 real tokens; the
    second's padded steps identity steps of every mixer) and a decode
    step with row 0 inactive, against the jitted reference (float32,
    unquantized, 2 units): logits of the real rows and the caches within
    1e-5; the inactive row's state and KV in every unit bit-identical."""
    jcfg, tcfg = _cfgs(2, dtype="float32")
    jp, tp = params_for("float32", "bf16", 2)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    last = np.array([S - 1, 6], np.int32)
    (jl, jc), ref = _ref(_jit_prefill, jp, jnp.asarray(prompts), jcfg,
                         S + 2, last_positions=jnp.asarray(last))
    with _recorded(tmlp) as port:
        tl, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, S + 2,
                             last_positions=torch.from_numpy(last))
    assert (_first_diff(port, ref, 8, "float32") == S).all()
    _close(tl, jl, F32_TOL)
    tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
    active = np.array([False, True])
    before = {k: t.clone() for k, t in tc.items()}
    (jl, jc), _ = _ref(_jit_decode, jp, jnp.asarray(tok), jc,
                       jnp.asarray(last + 1), jcfg,
                       active=jnp.asarray(active))
    tl, tc = tlm.decode_step(tp, torch.from_numpy(tok), tc,
                             torch.from_numpy(last + 1).long(), tcfg,
                             active=torch.from_numpy(active))
    _close(tl[1], np.asarray(jl)[1], F32_TOL)
    nest = _nested(tc)
    for group in ("mamba", "attn"):
        for k, t in nest[group].items():
            _close(t, jc[group][k], F32_CACHE_TOL, k)
    for k in ("ssm", "conv"):
        assert torch.equal(tc[k][:, :, 0], before[k][:, :, 0]), k
    for k in ("k", "v"):
        assert torch.equal(tc[k][:, 0], before[k][:, 0]), k


def _reference_generate(jp, jcfg, prompts, gen):
    """The reference's served greedy `generate`, and its logits and routes
    at each step, teacher-forced on its own tokens (jitted prefill and
    decode): (tokens [B, g], logits [B, g, V], routes)."""
    want = np.asarray(jserve.generate(jp, jnp.asarray(prompts), jcfg,
                                      gen=gen, cache_len=S + gen))
    (lg, cache), routes = _ref(_jit_prefill, jp, jnp.asarray(prompts),
                               jcfg, S + gen)
    out = [np.asarray(lg[:, -1])]
    for i in range(gen - 1):
        (lg, cache), r = _ref(_jit_decode, jp, jnp.asarray(want[:, i:i + 1]),
                              cache, jnp.full((B,), S + i, jnp.int32), jcfg)
        routes += r
        out.append(np.asarray(lg[:, -1]))
    return want, np.stack(out, axis=1), routes


@pytest.mark.parametrize("units,fmt", [(1, "w4a8"), (2, "w8a8")])
def test_generate_matches_reference(units, fmt):
    """Greedy generate (fused=True: the per-step loop on the CPU) against
    the reference's `generate` under C2's rule (tests/test_torch_moe.py):
    while a row's context equals the reference's and is routed alike,
    its logits are within the tolerance and its token equals the
    reference's where the reference's top-1/top-2 margin exceeds twice
    the tolerance (near-max elsewhere); float32, where routes part only at
    near-ties (bf16 routes part from the first positions: module
    docstring).  Each unit launches 42 GEMM dispatches per token (4
    attention, 7 x 2 mixer, 4 x 3 expert-stacked, 4 x 3 dense), the head
    one."""
    dtype = "float32"
    jcfg, tcfg = _cfgs(units, dtype=dtype)
    jp, tp = params_for(dtype, fmt, units)
    prompts = np.random.default_rng(12).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    want, ref_logits, ref_routes = _reference_generate(jp, jcfg, prompts, G)
    np.testing.assert_array_equal(ref_logits.argmax(-1), want)
    registry.reset_dispatch_counts()
    with _recorded(tmlp) as routes:
        got, logits = tserve.generate(tp, prompts, tcfg, gen=G,
                                      cache_len=S + G, device="cpu",
                                      return_logits=True)
    assert sum(registry.dispatch_counts().values()) == \
        (42 * units + 1) * G
    got, logits = got.numpy(), logits.numpy()
    assert got.shape == (B, G) and got.dtype == np.int32
    tol = _tol(fmt)
    parted = [np.flatnonzero(got[b] != want[b]) for b in range(B)]
    valid = np.array([S + (p[0] if p.size else G) for p in parted])
    upto = _first_diff(routes, ref_routes, 4 * units, dtype, valid) - S + 1
    compared = 0
    for b in range(B):
        for t in range(min(G, upto[b])):
            ref = ref_logits[b, t]
            np.testing.assert_allclose(logits[b, t], ref, rtol=0, atol=tol)
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > 2 * tol:
                assert got[b, t] == want[b, t], (b, t)
                compared += 1
            else:
                assert ref[got[b, t]] >= ref.max() - tol, (b, t)
            if got[b, t] != want[b, t]:
                break
    assert compared > 0


def test_captured_step_static_buffers():
    """The captured step (run eagerly: the CPU has no graph) holds the
    flat hybrid cache as its static buffers, {ssm, conv, k, v} from
    init_cache: the prefill's cache is copied in, each step updates the
    same tensors in place, and the tokens, logits and final cache equal
    the per-step loop's bit for bit (2 units)."""
    _, tcfg = _cfgs(2)
    _, tp = params_for("bfloat16", "w8a8", 2)
    prompts = np.random.default_rng(13).integers(0, tcfg.vocab, (B, S))
    want, want_logits = tserve.generate(tp, prompts, tcfg, gen=G,
                                        cache_len=S + G, device="cpu",
                                        fused=False, return_logits=True)
    logits, cache = tlm.prefill(tp, torch.as_tensor(prompts), tcfg,
                                cache_len=S + G)
    bundle = tserve._decode_bundle(tcfg, "off", "cpu")
    step = bundle.captured(tp, B, S + G, True, G - 1, torch.device("cpu"))
    assert set(step.cache) == {"ssm", "conv", "k", "v"}
    assert tuple(step.cache["ssm"].shape) == (2, 7, B, 8, 16, 16)
    assert tuple(step.cache["k"].shape) == (2, B, S + G, 2, 16)
    ptrs = {k: t.data_ptr() for k, t in step.cache.items()}
    toks, seen = step.run(logits[:, -1].argmax(dim=-1)[:, None], cache, S,
                          G - 1)
    assert torch.equal(toks, want[:, 1:])
    assert torch.equal(seen, want_logits[:, 1:])
    assert {k: t.data_ptr() for k, t in step.cache.items()} == ptrs
    pos = torch.full((B,), S)
    tok = want[:, :1].long()
    for i in range(G - 1):
        _, cache = tlm.decode_step(tp, tok, cache, pos + i, tcfg)
        tok = want[:, i + 1:i + 2].long()
    for k in step.cache:
        assert torch.equal(step.cache[k], cache[k]), k


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_generate_silvia_equals_off(fmt):
    """--silvia all changes no token and no logit on the hybrid path: the
    traced step is functionalized and writes the flat cache back at its
    end."""
    _, tcfg = _cfgs(1)
    _, tp = params_for("bfloat16", fmt)
    prompts = np.random.default_rng(14).integers(0, tcfg.vocab, (B, 8))

    def gen(passes):
        return tserve.generate(tp, prompts, tcfg, gen=3, cache_len=11,
                               device="cpu", return_logits=True,
                               silvia_passes=passes)

    base, packed = gen("off"), gen("all")
    assert torch.equal(base[0], packed[0])
    assert torch.equal(base[1], packed[1])


def test_serve_cli_hybrid_on_cpu(capsys):
    """`--arch jamba-v0.1-52b` through the CLI on the CPU: 42 GEMM
    dispatches per unit and token, and the untied head's, all on the
    packed GEMM (vocab 256 is even)."""
    tserve.main(["--arch", ARCH, "--reduced", "--quant", "w4a8",
                 "--quant-force", "--batch", "2", "--prompt-len", "20",
                 "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    counts = eval(re.search(r"dispatch counts: (\{.*\})", out).group(1))
    assert counts["packed_w4_matmul"] == (42 + 1) * 3
    assert counts["quant_matmul"] == 0
    assert re.search(r"sample tokens: \[", out)


# ---------------------------------------------------------------------------
# the streaming init: build_params
# ---------------------------------------------------------------------------

def _same_tree(got, want):
    """Same keys, leaf types, formats, dtypes and bits."""
    g, gs = pytree.tree_flatten_with_path(got)
    w, ws = pytree.tree_flatten_with_path(want)
    assert gs == ws
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), \
            pytree.keystr(path)


def _formats(tree):
    is_q = lambda x: isinstance(x, tqt.QTensor)           # noqa: E731
    return {pytree.keystr(p): (x.fmt if is_q(x) else str(x.dtype))
            for p, x in pytree.tree_leaves_with_path(tree, is_leaf=is_q)}


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
@pytest.mark.parametrize("arch", PORTED)
def test_build_params_equals_whole_tree_quantization(arch, fmt):
    """build_params (each matrix quantized as it is drawn) gives bit for
    bit the QTensors and float leaves of quantize_tree_for_serving over
    lm.init_params' whole tree, forced (every weight quantized) and not
    (the floors decide: the reduced hybrid's [1, 4, 4, 64, 96] experts and
    [1, 7, 64, 296] in_proj quantize, every other reduced weight stays
    bf16), on the reduced
    config of every ported family: dense (qwen's q/k/v biases), moe
    (arctic's dense residual), ssm and hybrid; and the seed picks the
    weights."""
    cfg = tconfigs.get_reduced_config(arch)
    for force in (True, False):
        got = tserve.build_params(cfg, fmt, seed=5, quant_force=force,
                                  device="cpu")
        want = tqt.quantize_tree_for_serving(
            tlm.init_params(cfg, 5, device="cpu"), fmt, force=force)
        _same_tree(got, want)
        assert _formats(got) == _formats(want)
        quantized = {k for k, f in _formats(got).items() if "torch" not in f}
        assert quantized if force else quantized == (
            {"['blocks']['moe']['wi']", "['blocks']['moe']['wg']",
             "['blocks']['moe']['wo']", "['blocks']['mamba']['in_proj']"}
            if arch == ARCH else set())
    other = tserve.build_params(cfg, fmt, seed=6, quant_force=True,
                                device="cpu")
    assert not torch.equal(other["embed"], got["embed"])


def test_build_params_decides_by_the_whole_leaf():
    """The size floors, the 2-D rule and the odd-N fallback are decided
    from the whole leaf's shape, never a matrix's: at 16 layers of
    d_model 64, wq [16, 64, 64] holds 65536 weights (the floor) while
    each of its [64, 64] matrices holds 4096 and is 2-D, so it quantizes
    unforced; wk [16, 64, 32] stays bf16 (32 < 64 columns); the odd vocab
    1025's head [64, 1025] (65600 weights) falls back to w8a8 under
    w4a8."""
    cfg = dataclasses.replace(tconfigs.get_reduced_config("yi-6b"),
                              n_layers=16, d_model=64, n_heads=4, n_kv=2,
                              d_ff=1024, vocab=1025)
    got = tserve.build_params(cfg, "w4a8", seed=1, device="cpu")
    _same_tree(got, tqt.quantize_tree_for_serving(
        tlm.init_params(cfg, 1, device="cpu"), "w4a8"))
    attn, ffn = got["blocks"]["attn"], got["blocks"]["mlp"]
    assert attn["wq"].fmt == "w4a8" and attn["wo"].fmt == "w4a8"
    assert attn["wq"].logical_shape == (16, 64, 64)
    assert attn["wk"].dtype == torch.bfloat16
    assert ffn["wi"].fmt == ffn["wo"].fmt == "w4a8"
    assert got["lm_head"].fmt == "w8a8"
    for shape in ((64, 64), (1, 64, 64)):
        assert tqt.serving_format("blocks/attn/wq", shape, "w4a8") is None
    assert tqt.serving_format("blocks/attn/wq", (16, 64, 64), "w4a8") == \
        "w4a8"


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_build_params_quantizes_column_slices(monkeypatch, fmt):
    """A matrix quantized QUANT_SLICE_ELEMS elements of columns at a time
    (its columns' scales are independent; slices of an even width, so a
    packed int4 word never straddles two) gives the whole-tree QTensors
    bit for bit: 384 elements make slices of 6 columns at K = 64 (the
    last of the 296 in_proj columns and of the vocab 256 head a partial
    one), 2 at K = 96 and wider K (the floor), on the 2-unit hybrid and
    on yi with an odd vocab (its head w8a8 under w4a8)."""
    monkeypatch.setattr(tserve, "QUANT_SLICE_ELEMS", 384)
    yi = dataclasses.replace(tconfigs.get_reduced_config("yi-6b"),
                             vocab=1025)
    for cfg in (_cfgs(2)[1], yi):
        got = tserve.build_params(cfg, fmt, seed=2, quant_force=True,
                                  device="cpu")
        want = tqt.quantize_tree_for_serving(
            tlm.init_params(cfg, 2, device="cpu"), fmt, force=True)
        _same_tree(got, want)
        assert _formats(got) == _formats(want)
    assert got["lm_head"].fmt == "w8a8"


def test_build_params_draws_one_matrix_at_a_time(monkeypatch):
    """No random draw is larger than one [K, N] matrix of its leaf: on the
    2-unit hybrid every torch.randn call has at most two axes, the
    experts' drawn one [64, 96] at a time, and the calls follow the
    tree's order (the whole-tree init makes the same calls)."""
    _, cfg = _cfgs(2)
    calls, randn = [], torch.randn

    def spy(*shape, **kw):
        calls.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return randn(*shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    tserve.build_params(cfg, "w8a8", quant_force=True, device="cpu")
    streamed, calls[:] = list(calls), []
    tlm.init_params(cfg, 0, device="cpu")
    assert streamed == calls
    assert max(len(c) for c in calls) == 2
    assert calls.count((64, 96)) >= 2 * 4 * 4 * 2       # wi, wg experts
    n_matrices = sum(
        int(np.prod(s.shape[:-2])) for s in pytree.tree_leaves(
            tlm.param_specs(cfg, "cpu"), is_leaf=lambda x: isinstance(
                x, tlm.Draw)) if isinstance(s, tlm.Draw))
    assert len(calls) == n_matrices


@pytest.mark.parametrize("packed", [False, True])
def test_plain_experts_one_at_a_time_are_bit_identical(monkeypatch, packed):
    """The batched plain GEMMs walk a stack an expert at a time once its
    float64 copy would pass ref.PLAIN_EXPERT_BYTES (a full-width jamba
    stack: 7.5 GB): the same int32 accumulators and f32 outputs, bit for
    bit, as the one batched float64 matmul, with x per expert and x
    broadcast (expert stride 0)."""
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(31 + packed)
    e, m, k, n = 3, 5, 70, 34
    t = [torch.from_numpy(a) for a in (
        rng.integers(-128, 128, (e, m, k)).astype(np.int8),
        rng.integers(-128, 128, (e, k, n // 2 if packed else n)).astype(
            np.int8),
        (rng.random((e, m, 1)) * 0.02 + 1e-3).astype(np.float32),
        (rng.random((e, 1, n)) * 0.02 + 1e-3).astype(np.float32))]
    acc, out = ((tref.packed_w4_matmul_acc_ref, tref.packed_w4_matmul_ref)
                if packed else (tref.quant_matmul_acc_ref,
                                tref.quant_matmul_ref))
    shared = [t[0][:1].expand(e, m, k), t[1], t[2][:1].expand(e, m, 1), t[3]]
    want = [(acc(*a[:2]), out(*a)) for a in (t, shared)]
    monkeypatch.setattr(tref, "PLAIN_EXPERT_BYTES", 0)
    for a, (w_acc, w_out) in zip((t, shared), want):
        assert torch.equal(acc(*a[:2]), w_acc)
        assert torch.equal(out(*a), w_out)


def test_card_check_teacher_forces_each_gemm():
    """chip_smoke.py's card-against-CPU check (`teacher_forced_vs_cpu`)
    run with both sides on the CPU, on the 2-unit float32 w8a8 tree: the
    same tree twice agrees exactly, and every GEMM (42 per unit and the
    head), MoE layer (4 per unit), logit and cache tensor of the prefill
    and each decode step is compared; an embedding 2^-20 off, which tips
    int8 activations one step in a free run (ROADMAP C8), stays within
    the limit, since each GEMM is fed the other side's input; a mixer's
    D moved by 0.5 fails at a GEMM's input, and one weight's int8 value
    moved fails at that GEMM's output."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    _, tcfg = _cfgs(2, dtype="float32")
    tp = tserve.build_params(tcfg, "w8a8", seed=0, quant_force=True,
                             device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab, (B, S)))
    check = functools.partial(chip_smoke.teacher_forced_vs_cpu,
                              cpu_params=tp, prompts=prompts, cfg=tcfg,
                              steps=2)
    st = check(tp)
    per_step = 42 * 2 + 1
    assert (st["gemms"], st["moes"], st["worst"]) == (3 * per_step, 3 * 8,
                                                      0.0)
    # per step: each GEMM's and MoE's input, each MoE's output, the
    # logits and the 4 cache tensors
    assert st["tensors"] == 3 * (per_step + 2 * 8 + 1 + 4)
    nudged = check({**tp, "embed": tp["embed"] * (1 + 2 ** -20)})
    assert 0 < nudged["worst"] <= chip_smoke.CARD_CPU_RTOL
    blocks = tp["blocks"]
    mamba = {**blocks["mamba"], "D": blocks["mamba"]["D"] + 0.5}
    with pytest.raises(AssertionError, match="GEMM .*'s input"):
        check({**tp, "blocks": {**blocks, "mamba": mamba}})
    wo = blocks["attn"]["wo"]
    q = wo.q.clone()
    q[1, 0, 0] += 1 if q[1, 0, 0] < 127 else -1
    attn = {**blocks["attn"], "wo": tqt.QTensor(q, wo.scale, wo.fmt)}
    with pytest.raises(AssertionError, match="not the host's, bit for bit"):
        check({**tp, "blocks": {**blocks, "attn": attn}})
