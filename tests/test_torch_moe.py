"""The MoE family in the port against `repro`: granite-moe-1b-a400m and
arctic-480b (dense residual) at their reduced configs.

Weights come from the reference (`repro.models.lm.init_params`, then
`quantize_tree_for_serving(force=True)`), imported through numpy; inputs
are numpy from a seed.

What is held bit for bit: the expert-stacked GEMM (`qmatmul` on a
[E, K, N] QTensor: the int8 activations, the int32 accumulators and the
f32 output) against the reference's `vmap(_q2d)` under `jax.jit`, and
the batched plain versions against `jax.vmap` of `repro.kernels.ref`.

Tolerances and why:
* The reference is compared in the form it serves activations in: its
  layers run compiled (inside `lax.scan`, decode under jit), where XLA
  computes the per-row activation scale as `fma(amax, float32(1/127),
  1e-8)` (float32) or with the bf16 divide and a float32 add (bf16), and
  the port does the same (`quantize_compiled`, ROADMAP C7).  The eager
  reference differs from it by an int8 step now and then, which the
  router amplifies (reduced arctic's float32 w4a8 prefill logits moved
  by 0.047 of max 2.6; in bf16 w8a8 one token took other experts:
  ROADMAP C-ref7).  So every reference call here runs with the
  reference's `quantize` jitted (`_served_quantize`), and the MoE calls
  otherwise op by op: the routes of each layer are recorded from
  concrete values (`_recorded`), which a call traced whole under jit
  has not got.  `test_reference_loop_is_the_reference` holds that loop
  against the jitted `lm.prefill` / `decode_step` in float32, quantized
  and not, within 1e-5.  Against it the port's reduced arctic logits sit
  within 7.2e-7 (float32 w4a8) and 0.0625 of max 3.98 (bf16 w8a8, one
  token-layer routed otherwise at a near-tie).
* float32 configs: MOE_TOL / LOGIT_TOL float32, 1e-5 (float32 sums in
  another order: measured <= 1.8e-6 on logits of max ~3.4).
* bf16 configs (the serving dtype): the two frameworks round to bf16 at
  the same places but sum in other orders (ROADMAP C1).  One MoE call:
  0.016-0.031 on outputs of max ~2.4 (a bf16 step there is 0.0078-
  0.0156), of which the gate combine `einsum("etd,te->td")` alone is at
  most one bf16 step of its output (`test_gate_combine_rounding`):
  MOE_TOL 0.05.  Logits: tests/test_torch_model.py's TOL scaled by
  max|logit| / 0.47 as in tests/test_torch_dense.py (measured 0.03-0.06
  on logits of max ~3).
* Router near-ties (ROADMAP C2's rule, on the experts): the router is a
  float32 matmul summed in other orders, on inputs that differ by C1's
  roundings, so the k-th and (k+1)-th experts can swap where their
  probabilities nearly tie, and that token's output then differs by a
  whole expert.  Both sides' routes are recorded (each side's top-k of
  its own router input): wherever they differ, the reference's k-th /
  (k+1)-th probability margin must be under twice ROUTER_TOL (float32
  1e-5; bf16 0.01: the inputs differ by bf16 steps, measured <= 0.0071
  in probability), and outputs are compared where the routes agree; in a
  model run, a row up to its first position routed otherwise in some
  layer (causal attention carries a swap to every later position).
  Each test asserts it compared something.
"""
import contextlib
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
from repro.kernels import packed_matmul as jpmm  # noqa: E402
from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.quant import qtensor as jqt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tsil  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import opcount as topcount  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.quant import qtensor as tqt  # noqa: E402
from repro_torch.quant import quantize as tquant  # noqa: E402
from test_torch_model import TOL, jax_to_numpy  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

MOE = ["granite-moe-1b-a400m", "arctic-480b"]
SMOLLM_MAX_LOGIT = 0.47
MOE_TOL = {"float32": 1e-5, "bfloat16": 0.05}
LOGIT_TOL = {"float32": 1e-5, "bfloat16": None}     # bf16: _scaled(TOL)
ROUTER_TOL = {"float32": 1e-5, "bfloat16": 0.01}
B, S, G = 2, 8, 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_reduced_config(arch), **kw),
            dataclasses.replace(tconfigs.get_reduced_config(arch), **kw))


_PARAMS = {}


def params_for(arch, dtype, fmt):
    """(jax params, port params) on the same weights; memoized (read-only
    use)."""
    key = (arch, dtype, fmt)
    if key not in _PARAMS:
        jcfg, _ = _cfgs(arch, dtype=dtype)
        jp = jqt.quantize_tree_for_serving(
            jlm.init_params(jax.random.PRNGKey(0), jcfg, max_seq=64), fmt,
            force=True)
        _PARAMS[key] = (jp, from_jax_params(jax_to_numpy(jp), device="cpu"))
    return _PARAMS[key]


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.float32)


def _logit_tol(dtype, fmt, ref_logits):
    if LOGIT_TOL[dtype] is not None:
        return LOGIT_TOL[dtype]
    return TOL[dtype][fmt] * max(1.0, float(np.abs(ref_logits).max())
                                 / SMOLLM_MAX_LOGIT)


def _routes(x, router, k):
    """(sorted top-k expert ids [T, k], k-th minus (k+1)-th probability
    [T]) of the tokens of x [..., d] against a float32 router, each side
    with its own ops as its moe computes them."""
    if isinstance(x, torch.Tensor):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router,
                              dim=-1)
        top, ids = torch.topk(probs, k + 1, dim=-1)
        top, ids = top.numpy(), ids.numpy()
    else:
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
            jnp.float32) @ router, axis=-1)
        top, ids = (np.asarray(a) for a in jax.lax.top_k(probs, k + 1))
    return np.sort(ids[:, :k], axis=-1), top[:, k - 1] - top[:, k]


def _agree(port, ref, dtype):
    """Tokens whose top-k sets agree; where they differ the reference's
    margin must be a near-tie (module docstring)."""
    same = (port[0] == ref[0]).all(-1)
    assert (ref[1][~same] <= 2 * ROUTER_TOL[dtype]).all(), \
        "experts differ away from a near-tie"
    return same


@contextlib.contextmanager
def _served_quantize():
    """Inside the block the reference's activation quantization (`_q2d`'s
    `quantize`, under vmap too) runs under jax.jit, the form it is
    served in (module docstring); weights are quantized beforehand,
    eagerly, as the reference serves them."""
    orig = jqt.quantize
    jqt.quantize = jax.jit(orig, static_argnames=("bits", "axis", "eps"))
    try:
        yield
    finally:
        jqt.quantize = orig


@contextlib.contextmanager
def _recorded(mod):
    """Record the routes of every `mod.moe` call inside the block (the
    port's mlp or the reference's): a list of (ids [B, T, k], margins
    [B, T]) per call, in call order."""
    calls, orig = [], mod.moe

    def record(p, x, cfg, per_token=False, **kw):
        ids, margin = _routes(x, p["router"], cfg.moe.top_k)
        calls.append((ids.reshape(*x.shape[:2], -1),
                      margin.reshape(x.shape[:2])))
        return orig(p, x, cfg, per_token, **kw)

    mod.moe = record
    try:
        yield calls
    finally:
        mod.moe = orig


def _first_diff(port, ref, n_layers, dtype, valid=None):
    """Per row, the first position (the prompt's, then one per decode
    step) that some layer routed otherwise on the two sides, among the
    first valid[b] positions (those with the same context on both
    sides; all by default); else valid[b].  At that position the first
    layer routed otherwise must be at a near-tie of the reference's
    (later layers and positions follow from it)."""
    n = min(len(port), len(ref))
    assert n >= n_layers and n % n_layers == 0
    same, margin = [], []
    for i in range(0, n, n_layers):                 # one step, every layer
        agree = np.stack([(p[0] == r[0]).all(-1) for p, r in
                          zip(port[i:i + n_layers], ref[i:i + n_layers])])
        first = np.argmin(agree, axis=0)            # first layer routed apart
        same.append(agree.all(0))
        margin.append(np.take_along_axis(np.stack(
            [r[1] for r in ref[i:i + n_layers]]), first[None], 0)[0])
    same, margin = np.concatenate(same, 1), np.concatenate(margin, 1)
    valid = np.full(same.shape[0], same.shape[1]) if valid is None \
        else np.minimum(valid, same.shape[1])
    out = valid.copy()
    for b in range(same.shape[0]):
        apart = np.flatnonzero(~same[b, :valid[b]])
        if apart.size:
            out[b] = apart[0]
            assert margin[b, apart[0]] <= 2 * ROUTER_TOL[dtype], \
                f"row {b}: experts differ away from a near-tie"
    return out


# ---------------------------------------------------------------------------
# configs, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_config_fields_match_reference(arch, reduced):
    """Every field the port carries equals the reference's (MoEConfig
    whole, capacity and dispatch fields included); the rest are at their
    defaults there; param_count (router and arctic's dense residual
    counted) and active_param_count agree."""
    get = "get_reduced_config" if reduced else "get_config"
    j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    carried = {f.name for f in dataclasses.fields(t)}
    for name in carried - {"moe"}:
        assert getattr(t, name) == getattr(j, name), name
    assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    for f in dataclasses.fields(j):
        if f.name not in carried:
            assert getattr(j, f.name) == f.default, f.name
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    if not reduced and arch == MOE[0]:
        assert (t.param_count(), t.active_param_count()) == \
            (1384912896, 478943232)


def test_init_params_tree_matches_reference():
    """The port's own init has the reference's tree: stacked [L, E, K, N]
    experts in cfg.dtype, the float32 router [L, d, E], arctic's dense
    MLP beside the experts."""
    for arch in MOE:
        jcfg, tcfg = _cfgs(arch)
        want = jax.eval_shape(lambda: jlm.init_params(
            jax.random.PRNGKey(0), jcfg, max_seq=64))
        got = tlm.init_params(tcfg, 0, device="cpu")
        jl = {jax.tree_util.keystr(p): a
              for p, a in jax.tree_util.tree_leaves_with_path(want)}
        tl = {pytree.keystr(p): t
              for p, t in pytree.tree_leaves_with_path(got)}
        assert sorted(jl) == sorted(tl)
        for key, a in jl.items():
            assert tuple(a.shape) == tuple(tl[key].shape), key
            assert str(a.dtype) == str(tl[key].dtype).split(".")[-1], key


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_quantize_tree_and_convert_moe(fmt):
    """quantize_tree_for_serving on a MoE tree equals the reference's, leaf
    for leaf and bit for bit: the router stays float32 (skip_keys), the
    experts quantize to [L, E, K, N] QTensors with scales [L, E, 1, N],
    and an odd N (vocab 257 here, as granite's 49155) falls back to w8a8
    under w4a8.  from_jax_params carries the 4-D QTensor leaves and the
    float32 router across unchanged (convert.py needed no change)."""
    jcfg, tcfg = _cfgs("arctic-480b", vocab=257)
    raw = jlm.init_params(jax.random.PRNGKey(3), jcfg, max_seq=64)
    want = jqt.quantize_tree_for_serving(raw, fmt, force=True)
    got = tqt.quantize_tree_for_serving(
        from_jax_params(jax_to_numpy(raw), device="cpu"), fmt, force=True)
    conv = from_jax_params(jax_to_numpy(want), device="cpu")
    is_q = lambda x: isinstance(x, jqt.QTensor)           # noqa: E731
    n_q = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want, is_leaf=is_q):
        keys = [p.key for p in path]
        for tree in (got, conv):
            node = tree
            for k in keys:
                node = node[k]
            if is_q(leaf):
                assert isinstance(node, tqt.QTensor) and node.fmt == leaf.fmt
                assert np.array_equal(node.q.numpy(), np.asarray(leaf.q))
                assert np.array_equal(node.scale.numpy(),
                                      np.asarray(leaf.scale))
            else:
                assert node.dtype == getattr(torch, str(leaf.dtype))
                assert np.array_equal(_f32(node), _f32(leaf))
        n_q += is_q(leaf)
    moe = want["blocks"]["moe"]
    assert not is_q(moe["router"]) and moe["router"].dtype == jnp.float32
    e, d, f = jcfg.moe.n_experts, jcfg.d_model, jcfg.moe.d_ff_expert
    assert moe["wi"].scale.shape == (jcfg.n_layers, e, 1, f)
    assert moe["wo"].fmt == fmt and moe["wo"].q.shape[:3] == \
        (jcfg.n_layers, e, f)
    assert want["lm_head"].fmt == "w8a8"              # odd vocab
    assert n_q == 4 + 3 + 3 + 1                       # attn, moe, dense, head
    assert got["blocks"]["moe"]["wi"].q.shape == tuple(
        moe["wi"].q.shape) == (jcfg.n_layers, e, d, f // (
            2 if fmt == "w4a8" else 1))


def test_archs_include_the_moe_family():
    assert [a for a in tconfigs.ARCHS
            if tconfigs.get_config(a).family == "moe"] == MOE
    assert all(jconfigs.get_config(a).family == "moe" for a in MOE)


# ---------------------------------------------------------------------------
# the expert-stacked GEMM
# ---------------------------------------------------------------------------

def _stacked_weight(rng, e, k, n):
    return (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("fmt,n", [("w8a8", 24), ("w4a8", 24),
                                   ("w4a8", 25)])
def test_qmatmul_experts_bit_exact(fmt, n, shared, x_dtype):
    """qmatmul on a [E, K, N] QTensor against the reference's
    (vmap(_q2d) under jax.jit, as it is served): the per-row int8
    activations, the int32 accumulators and the f32 (then x's dtype)
    output, bit for bit.  N = 25
    under w4a8 is quantized by quantize_tree_for_serving, which falls back
    to w8a8 as the reference's does.  shared: one x broadcast to every
    expert (the per-token path's wi / wg), which the port quantizes once
    and passes with expert stride 0."""
    rng = np.random.default_rng(n + 2 * shared)
    e, m, k = 4, 6, 40
    w = _stacked_weight(rng, e, k, n)
    jw = jqt.quantize_tree_for_serving({"blocks": {"wi": jnp.asarray(w)}},
                                       fmt, force=True)["blocks"]["wi"]
    tw = tqt.quantize_tree_for_serving(
        {"blocks": {"wi": torch.from_numpy(w)}}, fmt,
        force=True)["blocks"]["wi"]
    assert tw.fmt == jw.fmt == ("w8a8" if n % 2 else fmt)
    assert np.array_equal(tw.q.numpy(), np.asarray(jw.q))
    x = rng.standard_normal((m, k) if shared else (e, m, k)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.dtype(x_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    if shared:
        jx = jnp.broadcast_to(jx[None], (e, m, k))
        tx = tx[None].expand(e, m, k)
    want = jax.jit(jqt.qmatmul)(jx, jw)
    registry.reset_dispatch_counts()
    got = tqt.qmatmul(tx, tw)
    assert sum(registry.dispatch_counts().values()) == 1     # one GEMM
    assert got.dtype == tx.dtype and tuple(got.shape) == (e, m, n)
    assert np.array_equal(_f32(got), _f32(want))
    # the accumulators: each side's int8 rows, then the int32 GEMM of the
    # reference's Pallas kernel under vmap (interpret mode)
    jq_, _ = jax.jit(jax.vmap(lambda x2: jqt.quantize(x2, bits=8,
                                                      axis=0)))(jx)
    tq_, _ = tquant.quantize_compiled(tx.reshape(e * m, k))
    assert np.array_equal(tq_.reshape(e, m, k).numpy(), np.asarray(jq_))
    acc_j = jax.vmap(_jacc(jw.fmt == "w4a8"))(jq_, jw.q)
    acc_t = (tref.quant_matmul_acc_ref if tw.fmt == "w8a8"
             else tref.packed_w4_matmul_acc_ref)(tq_.reshape(e, m, k), tw.q)
    assert acc_t.dtype == torch.int32
    assert np.array_equal(acc_t.numpy(), np.asarray(acc_j))


def _jacc(packed):
    """The reference's int32 accumulator: its Pallas kernel, interpreted."""
    if packed:
        return lambda x, w: jpmm.packed_w4_matmul_acc(
            x, w, block=(8, 256, 128), interpret=True)
    return lambda x, w: jqmm.quant_matmul_acc(x, w, block=(8, 128, 128),
                                              interpret=True)


@pytest.mark.parametrize("packed", [False, True])
def test_batched_plain_matches_vmap(packed):
    """The batched plain versions (kernels/ref.py over a leading E axis)
    against jax.vmap of the reference's, bit for bit, acc and f32 out; an
    expanded x (expert stride 0) gives the materialized one's result, and
    each expert equals the 2-D plain version on its slice.  Extreme
    bytes (all -128) at K = 2^17 + 1 wrap as the reference's."""
    rng = np.random.default_rng(11 + packed)
    e, m, k, n = 3, 5, 70, 34
    x = rng.integers(-128, 128, (e, m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (e, k, n // 2 if packed else n)).astype(
        np.int8)
    xs = (rng.random((e, m, 1)) * 0.02 + 1e-3).astype(np.float32)
    ws = (rng.random((e, 1, n)) * 0.02 + 1e-3).astype(np.float32)
    acc_t, out_t = ((tref.packed_w4_matmul_acc_ref, tref.packed_w4_matmul_ref)
                    if packed else (tref.quant_matmul_acc_ref,
                                    tref.quant_matmul_ref))
    out_j = jref.packed_w4_matmul_ref if packed else jref.quant_matmul_ref
    t = [torch.from_numpy(a) for a in (x, w, xs, ws)]
    got_acc, got = acc_t(*t[:2]), out_t(*t)
    assert np.array_equal(got_acc.numpy(),
                          np.asarray(jax.vmap(_jacc(packed))(x, w)))
    assert np.array_equal(got.numpy(), np.asarray(jax.vmap(out_j)(
        x, w, xs, ws)))
    for i in range(e):
        assert torch.equal(got[i], out_t(t[0][i], t[1][i], t[2][i],
                                         t[3][i]))
    xe = t[0][:1].expand(e, m, k)
    xse = t[2][:1].expand(e, m, 1)
    assert torch.equal(out_t(xe, t[1], xse, t[3]),
                       out_t(xe.contiguous(), t[1], xse.contiguous(), t[3]))
    kk = 2 ** 17 + 1        # all -128: the int8 sums leave int32 and wrap
    xw = torch.full((2, 1, kk), -128, dtype=torch.int8)
    ww = torch.full((2, kk, 2), -128, dtype=torch.int8)   # packed: (-8, -8)
    want = kk * 128 * (8 if packed else 128)
    acc = acc_t(xw, ww)
    assert bool((acc == (want + 2 ** 31) % 2 ** 32 - 2 ** 31).all())
    if not packed:
        assert want > 2 ** 31


def test_registry_refuses_mismatched_experts():
    x = torch.zeros((3, 2, 8), dtype=torch.int8)
    w = torch.zeros((4, 8, 6), dtype=torch.int8)
    one = torch.ones(())
    with pytest.raises(ValueError, match="expert-stacked"):
        registry.dispatch("quant_matmul", x, w, one, one)
    with pytest.raises(ValueError, match="expert-stacked"):
        tqt.qmatmul(torch.zeros((2, 8)), tqt.quantize_weight(
            torch.ones((4, 8, 6)), "w8a8"))


# ---------------------------------------------------------------------------
# mlp.moe and moe_block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["bf16", "w8a8", "w4a8"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_matches_reference(arch, fmt, dtype):
    """mlp.moe(per_token=True) on layer 0's weights against the
    reference's (its quantization compiled, `_served_quantize`): the
    outputs of tokens routed alike within MOE_TOL, aux within 1e-6
    (float32 means of the same probabilities); per_token=False
    (training's capacity dispatch) is not ported."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp, tp = params_for(arch, dtype, fmt)
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"])
    tmoe = tblocks.tree_idx(tp["blocks"]["moe"], 0)
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with _served_quantize():
        want, want_aux = jmlp.moe(jmoe, jx, jcfg, per_token=True)
    got, aux = tmlp.moe(tmoe, tx, tcfg, per_token=True)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    k = tcfg.moe.top_k
    ok = _agree(_routes(tx, tmoe["router"], k),
                _routes(jx, jmoe["router"], k), dtype)
    assert ok.sum() >= ok.size // 2
    np.testing.assert_allclose(_f32(got).reshape(-1, jcfg.d_model)[ok],
                               _f32(want).reshape(-1, jcfg.d_model)[ok],
                               rtol=0, atol=MOE_TOL[dtype])
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    _, none = tmlp.moe(tmoe, tx, tcfg, per_token=True, want_aux=False)
    assert none is None
    with pytest.raises(NotImplementedError, match="4.6"):
        tmlp.moe(tmoe, tx, tcfg)


def test_gate_combine_rounding():
    """The bf16 gate combine einsum("etd,te->td") alone, on the same bf16
    inputs: within one bf16 step of the output's magnitude (XLA and
    torch both sum the E products in float32 and round once, in other
    orders)."""
    rng = np.random.default_rng(5)
    e, t, d = 32, 16, 64
    eout = rng.standard_normal((e, t, d)).astype(np.float32)
    gate = np.zeros((t, e), np.float32)
    for i in range(t):
        gate[i, rng.choice(e, 8, replace=False)] = rng.random(8) / 4
    want = jnp.einsum("etd,te->td", jnp.asarray(eout, jnp.bfloat16),
                      jnp.asarray(gate, jnp.bfloat16))
    got = torch.einsum("etd,te->td", torch.from_numpy(eout).bfloat16(),
                       torch.from_numpy(gate).bfloat16())
    step = 2.0 ** (np.floor(np.log2(np.abs(_f32(want)) + 1e-30)) - 7)
    assert (np.abs(_f32(got) - _f32(want)) <= step).all()


@pytest.mark.parametrize("dtype,fmt", [("float32", "w4a8"),
                                       ("bfloat16", "w8a8")])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch, dtype, fmt):
    """moe_block in prefill mode (its cache filled in place) against the
    reference's (quantization compiled): granite without, arctic with
    the parallel dense residual; tokens routed alike within MOE_TOL, the
    cache within it too."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp, tp = params_for(arch, dtype, fmt)
    assert ("dense" in tp["blocks"]) == (arch == "arctic-480b")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    tl = tblocks.tree_idx(tp["blocks"], 0)
    x = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with _recorded(jmlp) as ref, _served_quantize():
        want, jcache, _ = jblocks.moe_block(jl, jx, jcfg, mode="prefill",
                                            cache_len=S)
    cache = {k: t[0] for k, t in tlm.init_cache(tcfg, B, S,
                                                device="cpu").items()}
    with _recorded(tmlp) as port:
        got = tblocks.BLOCK_FNS["moe"](tl, tx, tcfg, mode="prefill",
                                       cache=cache)
    ok = _agree(port[0], ref[0], dtype).reshape(-1)
    assert ok.sum() >= ok.size // 2
    np.testing.assert_allclose(_f32(got).reshape(-1, jcfg.d_model)[ok],
                               _f32(want).reshape(-1, jcfg.d_model)[ok],
                               rtol=0, atol=MOE_TOL[dtype])
    np.testing.assert_allclose(_f32(cache["k"]), _f32(jcache["k"]), rtol=0,
                               atol=MOE_TOL[dtype])


# ---------------------------------------------------------------------------
# the model: prefill / decode, greedy generate
# ---------------------------------------------------------------------------

def _reference_run(jp, jcfg, prompts, toks=None):
    """The reference's prefill then G-1 decode steps, layer by layer as
    lm.prefill / decode_step scan them, op by op but for the activation
    quantization, which runs compiled (`_served_quantize`).
    Teacher-forced on `toks` [B, G] if given, else greedy on its own
    argmax.  Returns (tokens [B, G], logits [B, G, V] float32)."""
    layers = [jax.tree_util.tree_map(lambda a, i=i: a[i], jp["blocks"])
              for i in range(jcfg.n_layers)]

    def head(x):
        x = jcommon.norm_apply(x, jp["final_norm"], jcfg.norm, jcfg.norm_eps)
        return np.asarray(jlm._lm_head(jp, x[:, -1:], jcfg))[:, 0]

    x = jlm._embed(jp, jnp.asarray(prompts), jcfg)
    caches = []
    for lp in layers:
        x, c, _ = jblocks.moe_block(lp, x, jcfg, mode="prefill",
                                    cache_len=S + G)
        caches.append(c)
    out = [head(x)]
    got = [out[0].argmax(-1)]
    for i in range(G - 1):
        t = got[-1] if toks is None else toks[:, i]
        x = jlm._embed(jp, jnp.asarray(t[:, None], jnp.int32), jcfg)
        pos = jnp.full((prompts.shape[0],), S + i, jnp.int32)
        for li, lp in enumerate(layers):
            x, caches[li], _ = jblocks.moe_block(
                lp, x, jcfg, mode="decode", cache=caches[li], pos=pos)
        out.append(head(x))
        got.append(out[-1].argmax(-1))
    return np.stack(got, 1).astype(np.int32), np.stack(out, 1)


_REF = {}


def _reference(arch, dtype, fmt):
    """(prompts, greedy tokens, logits, routes) of the reference's run;
    memoized."""
    key = (arch, dtype, fmt)
    if key not in _REF:
        jcfg, _ = _cfgs(arch, dtype=dtype)
        jp, _ = params_for(arch, dtype, fmt)
        prompts = np.random.default_rng(4).integers(
            0, jcfg.vocab, (B, S)).astype(np.int32)
        with _recorded(jmlp) as routes, _served_quantize():
            toks, logits = _reference_run(jp, jcfg, prompts)
        _REF[key] = (prompts, toks, logits, routes)
    return _REF[key]


def test_reference_loop_is_the_reference():
    """_reference_run is the reference's prefill / decode_step as served:
    on float32 configs, unquantized and w4a8, it equals the jitted
    lm.prefill and lm.decode_step to float32 rounding (quantized, only
    because its activation quantization runs compiled: op by op, the
    router amplifies the eager form's int8 steps to 0.047, ROADMAP
    C-ref7)."""
    jcfg, _ = _cfgs("arctic-480b", dtype="float32")
    for fmt in ("bf16", "w4a8"):
        jp, _ = params_for("arctic-480b", "float32", fmt)
        prompts, toks, logits, _ = _reference("arctic-480b", "float32", fmt)
        lg, cache = jax.jit(jlm.prefill, static_argnums=(2, 3))(
            jp, jnp.asarray(prompts), jcfg, S + G)
        want = [np.asarray(lg[:, -1])]
        dec = jax.jit(jlm.decode_step, static_argnums=(4,))
        for i in range(G - 1):
            lg, cache = dec(jp, jnp.asarray(toks[:, i:i + 1]), cache,
                            jnp.full((B,), S + i, jnp.int32), jcfg)
            want.append(np.asarray(lg[:, -1]))
        np.testing.assert_allclose(logits, np.stack(want, 1), rtol=0,
                                   atol=1e-5, err_msg=fmt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["bf16", "w8a8", "w4a8"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch, fmt, dtype):
    """The port's lm.prefill and decode_step, teacher-forced on the
    reference's greedy tokens, against the reference's logits at each
    step: float32 within 1e-5, bf16 within the scaled TOL, each row up to
    its first position routed otherwise (module docstring)."""
    _, tcfg = _cfgs(arch, dtype=dtype)
    _, tp = params_for(arch, dtype, fmt)
    prompts, toks, want, ref_routes = _reference(arch, dtype, fmt)
    with _recorded(tmlp) as routes:
        lg, cache = tlm.prefill(tp, torch.from_numpy(prompts), tcfg,
                                cache_len=S + G)
        got = [lg[:, -1]]
        for i in range(G - 1):
            lg, cache = tlm.decode_step(
                tp, torch.from_numpy(toks[:, i:i + 1]), cache,
                torch.full((B,), S + i), tcfg)
            got.append(lg[:, -1])
    got = torch.stack(got, 1).numpy()
    tol = _logit_tol(dtype, fmt, want)
    # step t's logits read positions up to S - 1 + t
    upto = _first_diff(routes, ref_routes, tcfg.n_layers, dtype) - S + 1
    assert upto.max() >= 1
    for b in range(B):
        n = max(0, upto[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0, atol=tol,
                                   err_msg=f"row {b}")


@pytest.mark.parametrize("dtype,fmt", [("float32", "w4a8"),
                                       ("bfloat16", "bf16"),
                                       ("bfloat16", "w8a8"),
                                       ("bfloat16", "w4a8")])
@pytest.mark.parametrize("arch", MOE)
def test_generate_matches_reference(arch, dtype, fmt):
    """Greedy generate (fused=True: the per-step loop on the CPU) against
    the reference's greedy tokens under C2's rule: while a row's context
    equals the reference's and is routed alike, its token equals the
    reference's where the reference's top-1/top-2 margin exceeds twice
    the logit tolerance, and scores within the tolerance of its maximum
    elsewhere."""
    _, tcfg = _cfgs(arch, dtype=dtype)
    _, tp = params_for(arch, dtype, fmt)
    prompts, want, ref_logits, ref_routes = _reference(arch, dtype, fmt)
    with _recorded(tmlp) as routes:
        got, logits = tserve.generate(tp, prompts, tcfg, gen=G,
                                      cache_len=S + G, device="cpu",
                                      return_logits=True)
    got, logits = got.numpy(), logits.numpy()
    assert got.shape == (B, G) and got.dtype == np.int32
    tol = _logit_tol(dtype, fmt, ref_logits)
    # position S + i reads token i: the same context while tokens agree
    parted = [np.flatnonzero(got[b] != want[b]) for b in range(B)]
    valid = np.array([S + (p[0] if p.size else G) for p in parted])
    upto = _first_diff(routes, ref_routes, tcfg.n_layers, dtype,
                       valid) - S + 1
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


# ---------------------------------------------------------------------------
# tracing: the passes, the CUDA custom ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,units", [("w8a8", (0, 0)), ("w4a8", (2, 0))])
def test_decode_packed_units_vs_reference(fmt, units):
    """Packed units of the optimized MoE decode step on reduced granite,
    (port, reference), on the plain CPU lowering: as the dense step's
    (tests/test_torch_serve_fused.py), the port packs one de-bias pair of
    the plain GEMM's int4 unpacking under w4a8, two units, where the
    reference sizes its literal operands as 64 bits and packs none
    (ROADMAP C-ref5); the expert-stacked GEMMs add none."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m")
    jp, tp = params_for("granite-moe-1b-a400m", "bfloat16", fmt)
    prompts = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 4))
    _, jcache = jlm.prefill(jp, jnp.asarray(prompts, jnp.int32), jcfg, 8)
    closed = jsil.optimized_jaxpr(
        lambda p, t, k, q: jlm.decode_step(p, t, k, q, jcfg), jp,
        jnp.zeros((2, 1), jnp.int32), jcache, jnp.full((2,), 4, jnp.int32))
    _, tcache = tlm.prefill(tp, torch.as_tensor(prompts), tcfg, cache_len=8)
    leaves, spec = pytree.tree_flatten(
        (tp, torch.zeros((2, 1), dtype=torch.long), tcache, torch.full(
            (2,), 4)))

    def fn(*ts):
        return pytree.tree_leaves(tlm.decode_step(
            *pytree.tree_unflatten(list(ts), spec), tcfg))

    got = topcount.count_ops(tsil.optimized_graph(fn, *leaves))
    assert (got.packed_units, jopcount.count_ops(closed).packed_units) == \
        units


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_cuda_experts_trace_as_custom_ops(fmt):
    """One MoE layer's three expert GEMMs traced with fake CUDA tensors
    (no card needed): each expert-stacked GEMM is ONE custom-op node whose
    fake output is [E, T, N] (the broadcast x of wi / wg enters expanded),
    and nothing is left to pack.  (The routing's factory ops do not trace
    on fake CUDA tensors in a CPU-only build; on the card chip_smoke.py
    traces the whole step under --silvia.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    _, tp = params_for("granite-moe-1b-a400m", "bfloat16", fmt)
    layer = tblocks.tree_idx(tp["blocks"]["moe"], 0)
    e, f, d = tcfg.moe.n_experts, tcfg.moe.d_ff_expert, tcfg.d_model
    with FakeTensorMode(allow_non_fake_inputs=True):
        layer = pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda"),
            layer)
        x = torch.empty((3, d), dtype=torch.bfloat16, device="cuda")

    def experts(p, xt):
        xe = xt.unsqueeze(0).expand(e, *xt.shape)
        h = torch.nn.functional.silu(tmlp._emm(xe, p["wg"])) * \
            tmlp._emm(xe, p["wi"])
        return tmlp._emm(h, p["wo"])

    leaves, spec = pytree.tree_flatten((layer, x))
    gm = tsil.optimized_graph(
        lambda *ts: experts(*pytree.tree_unflatten(list(ts), spec)), *leaves)
    op = getattr(torch.ops.repro_torch,
                 "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul")
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"
             and n.target == op.default]
    assert [tuple(n.meta["val"].shape) for n in nodes] == \
        [(e, 3, f), (e, 3, f), (e, 3, d)]
    assert topcount.count_ops(gm).packed_units == 0


def test_serve_cli_moe_on_cpu(capsys):
    """`--arch granite-moe-1b-a400m` through the CLI on the CPU: three
    expert GEMM dispatches and four attention ones per layer and step,
    and the untied head's (vocab 256 is even: packed too)."""
    tserve.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--quant",
                 "w4a8", "--quant-force", "--batch", "2", "--prompt-len",
                 "4", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    counts = eval(re.search(r"dispatch counts: (\{.*\})", out).group(1))
    assert counts["packed_w4_matmul"] == (7 * 2 + 1) * 3
    assert counts["quant_matmul"] == 0
    assert re.search(r"sample tokens: \[", out)
