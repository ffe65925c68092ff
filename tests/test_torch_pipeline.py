"""The port's pass pipeline inside loop bodies and its caches
(src/repro_torch/core/pipeline.py) against the reference's
(src/repro/core/pipeline.py).

Counterparts of tests/test_pipeline_cache.py and of
tests/test_silvia_passes.py::test_scan_body_optimized:

* `optimize()` traces and rewrites once per input signature,
* a body that two HOP nodes name is rewritten once,
* the passes of a pipeline share one analysis context per BB, patched
  in place by a rewrite,
* the passes recurse into the bodies of `scan`, `cond` and
  `while_loop`, and pack there what the reference packs in its
  sub-jaxprs, on the same numpy inputs, bit for bit.

Two reference tests have no counterpart here: `test_cached_wrapper_
still_jit_compatible` (the port's wrapper runs eagerly; there is no jit
to be compatible with) and `test_fused_scan_decode_matches_stepwise`
(the port's fused decode replays a captured CUDA graph, not a scan;
tests/test_torch_serve_fused.py holds it against the per-step loop).
Nor do the reference's tests of its body memo and analysis cache
(`RewriteCache`, `AnalysisCache`): the port keeps one local context per
BB and rewrites a body once per walk, since no program it runs holds two
identical bodies that a trace-wide memo could share.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._higher_order_ops.scan import scan  # noqa: E402
from torch._higher_order_ops.while_loop import while_loop  # noqa: E402

from benchmarks import table1b  # noqa: E402
from repro import core as jsil  # noqa: E402
from repro.core import opcount as jopcount  # noqa: E402
from repro_torch import core as tsil  # noqa: E402
from repro_torch.core import ir, pipeline  # noqa: E402
from repro_torch.core import opcount as topcount  # noqa: E402
from repro_torch.core import prims as tprims  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

MULADD = [tsil.PassConfig(op="muladd")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def i8(rng, shape, lo=-100, hi=100):
    return rng.integers(lo, hi, shape).astype(np.int8)


def T(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def J(*arrays):
    return [jnp.asarray(a) for a in arrays]


def I32(x):
    return x.to(torch.int32) if isinstance(x, torch.Tensor) \
        else x.astype(jnp.int32)


def muls(a0, a1, b):
    return I32(a0) * I32(b), I32(a1) * I32(b)


def _same(got, want):
    got, want = jax.tree_util.tree_leaves(got), \
        jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _bodies(gm):
    """The HOP bodies of a graph: (get_attr target, GraphModule)."""
    return [(n.target, getattr(gm, n.target)) for n in gm.graph.nodes
            if n.op == "get_attr"
            and isinstance(getattr(gm, n.target), torch.fx.GraphModule)]


def _packed(gm):
    """Packed calls of a graph and every body in it, by name."""
    names = [n.target.__name__ for n in gm.graph.nodes
             if n.op == "call_function" and n.target in tprims.PACKED_PRIMS]
    for _, sub in _bodies(gm):
        names += _packed(sub)
    return sorted(names)


def _jax_packed(closed):
    names = []
    for e in closed.jaxpr.eqns:
        if e.primitive.name.startswith("silvia_packed"):
            names.append(e.primitive.name.removeprefix("silvia_"))
        for v in e.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else [v]):
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    names += _jax_packed(sub)
    return sorted(names)


def _counts(x):
    c = topcount.count_ops(x) if isinstance(x, torch.fx.GraphModule) \
        else jopcount.count_ops(x)
    return dataclasses.astuple(c)


# ---------------------------------------------------------------------------
# trace cache
# ---------------------------------------------------------------------------

def test_trace_cache_single_trace_across_calls(rng):
    opt = tsil.optimize(muls, MULADD)
    args = T(*(i8(rng, (16,)) for _ in range(3)))
    for _ in range(5):
        got = opt(*args)
    info = opt.cache_info()
    assert (info["trace_misses"], info["trace_hits"], info["traces"]) == \
        (1, 4, 1)
    _same(got, muls(*args))


def test_trace_cache_retraces_on_shape_change(rng):
    opt = tsil.optimize(muls, MULADD)
    opt(*T(*(i8(rng, (16,)) for _ in range(3))))
    opt(*T(*(i8(rng, (32,)) for _ in range(3))))
    opt(*T(*(i8(rng, (32,)) for _ in range(3))))   # a hit
    info = opt.cache_info()
    assert (info["trace_misses"], info["trace_hits"], info["traces"]) == \
        (2, 1, 2)


def test_trace_cache_retraces_on_dtype_change(rng):
    opt = tsil.optimize(lambda x, y: x + y)
    opt(*T(i8(rng, (8,)), i8(rng, (8,))))
    opt(torch.ones(8, dtype=torch.int16), torch.ones(8, dtype=torch.int16))
    assert opt.cache_info()["trace_misses"] == 2


def test_cache_clear_forces_retrace(rng):
    opt = tsil.optimize(muls, MULADD)
    args = T(*(i8(rng, (16,)) for _ in range(3)))
    opt(*args)
    opt.cache_clear()
    opt(*args)
    info = opt.cache_info()
    assert (info["trace_misses"], info["trace_hits"]) == (1, 0)


# ---------------------------------------------------------------------------
# the body memo
# ---------------------------------------------------------------------------

def two_identical_scans(a, b):
    def body(c, xs):
        x, y = xs
        p0 = I32(x) * I32(y)
        p1 = I32(x + 1) * I32(y)
        return c + p0.sum(dtype=torch.int32) + p1.sum(dtype=torch.int32), []

    zero = lambda: torch.zeros((), dtype=torch.int32)
    s1, _ = scan(body, zero(), (a, b))
    s2, _ = scan(body, zero(), (a, b))
    return s1 + s2


def two_identical_scans_jax(a, b):
    def body(c, xs):
        x, y = xs
        p0 = I32(x) * I32(y)
        p1 = I32(x + 1) * I32(y)
        return c + p0.sum() + p1.sum(), None

    s1, _ = jax.lax.scan(body, jnp.int32(0), (a, b))
    s2, _ = jax.lax.scan(body, jnp.int32(0), (a, b))
    return s1 + s2


def _scan_args(rng):
    return i8(rng, (4, 16)), i8(rng, (4, 16))


@pytest.fixture
def contexts(monkeypatch):
    """Every BBContext the pipeline builds, in the order it builds them."""
    built = []

    class Counted(pipeline.BBContext):
        def __init__(self, gm):
            super().__init__(gm)
            built.append(self)

    monkeypatch.setattr(pipeline, "BBContext", Counted)
    return built


def test_identical_bodies_each_pack_like_reference(rng):
    """make_fx gives each of two scans over one combine function a body
    of its own; each packs as the reference's sub-jaxpr does."""
    args = _scan_args(rng)
    out = tsil.optimize_graph(tsil.trace(two_identical_scans, *T(*args)),
                              [p.instantiate() for p in MULADD])
    want = jsil.optimize_closed_jaxpr(
        jax.make_jaxpr(two_identical_scans_jax)(*J(*args)),
        [jsil.PassConfig(op="muladd").instantiate()])
    bodies = _bodies(out)
    assert len(bodies) == 2 and bodies[0][1] is not bodies[1][1]
    assert _packed(out) == _jax_packed(want) == ["packed_muladd"] * 2
    _same(out(*T(*args)), two_identical_scans_jax(*J(*args)))


def test_scan_wrapper_traces_once(rng):
    """The trace cache holds a program with scan bodies like any other:
    one trace and rewrite, then the cached graph."""
    opt = tsil.optimize(two_identical_scans, MULADD)
    args = T(*_scan_args(rng))
    first, second = opt(*args), opt(*args)
    info = opt.cache_info()
    assert (info["trace_misses"], info["trace_hits"]) == (1, 1)
    _same(first, two_identical_scans(*args))
    _same(second, first)


def test_two_pass_lists_on_one_graph_are_independent(rng):
    """optimize_graph leaves the graph it was given as it was: a second
    pass list on the same graph sees no packed call of the first."""
    args = T(*_scan_args(rng))
    gm = tsil.trace(two_identical_scans, *args)
    out1 = tsil.optimize_graph(gm, [p.instantiate() for p in MULADD])
    out2 = tsil.optimize_graph(
        gm, [tsil.PassConfig(op="add", op_size=16).instantiate()])
    assert _packed(out1) == ["packed_muladd"] * 2
    assert _packed(gm) == []
    assert "packed_muladd" not in _packed(out2)


def test_cache_clear_resets_all_counters(rng):
    opt = tsil.optimize(two_identical_scans, MULADD)
    opt(*T(*_scan_args(rng)))
    opt.cache_clear()
    assert opt.cache_info() == {"trace_hits": 0, "trace_misses": 0,
                                "rewrite_ms": 0.0, "traces": 0}


def test_body_shared_by_two_scan_nodes(rng, contexts):
    """One body module that two scan nodes name is rewritten once (one
    context for it, one for the top level), and both nodes run the
    rewritten body."""
    args = T(*_scan_args(rng))
    gm = tsil.trace(two_identical_scans, *args)
    scans = [n for n in gm.graph.nodes if pipeline._hop_name(n) == "scan"]
    first = scans[0].args[0]
    scans[1].args = (first,) + scans[1].args[1:]
    gm.graph.eliminate_dead_code()
    gm.recompile()
    assert len(_bodies(gm)) == 1
    out = tsil.optimize_graph(gm, [p.instantiate() for p in MULADD])
    assert len(contexts) == 2
    (_, body), = _bodies(out)
    assert _packed(body) == ["packed_muladd"]
    _same(out(*args), two_identical_scans(*args))


# ---------------------------------------------------------------------------
# shared BB analysis
# ---------------------------------------------------------------------------

def test_bb_analysis_built_once_across_default_passes(rng, contexts):
    """No default pass rewrites this float BB: the four passes share ONE
    context, which none patches."""
    x = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    gm = tsil.trace(lambda x, y: x * y + torch.sin(x), x, x)
    out = tsil.optimize_graph(
        gm, [p.instantiate() for p in tsil.DEFAULT_PASSES])
    assert out is gm
    assert [c.patches for c in contexts] == [0]


def test_bb_analysis_patched_not_rebuilt_on_rewrite(rng, contexts):
    """muladd patches the shared context in place; the other three
    passes go on with it (1 context, 1 patch)."""
    args = T(*(i8(rng, (16,)) for _ in range(3)))
    out = tsil.optimize_graph(tsil.trace(muls, *args),
                              [p.instantiate() for p in tsil.DEFAULT_PASSES])
    assert [c.patches for c in contexts] == [1]
    assert _packed(out) == ["packed_muladd"]


def test_bb_analysis_patch_preserves_values_on_table2_pipeline(rng,
                                                               contexts):
    """The conv pair under the default passes: its one BB analysed once,
    patched at least once, and the output equals the reference's on the
    same inputs."""
    from benchmarks import table2_cnn

    x = i8(rng, (8, 8))
    w_even, w_odd = i8(rng, (9,), -8, 8), i8(rng, (9,), -8, 8)
    opt = tsil.optimize(chip_smoke.conv3x3_pair_naive,
                        list(tsil.DEFAULT_PASSES))
    got = opt(*T(x, w_even, w_odd))
    assert len(contexts) == 1 and contexts[0].patches >= 1
    _same(got, table2_cnn.conv3x3_pair_naive(*J(x, w_even, w_odd)))


def test_single_pass_stats(rng):
    """One pass through optimize_graph: a pass that packs emits a new
    graph and reports its tuple; one that packs nothing returns the
    graph it was given.  Both report the reference's stats keys."""
    args = T(*(i8(rng, (16,)) for _ in range(3)))
    gm = tsil.trace(muls, *args)
    stats = []
    new = tsil.optimize_graph(gm, [MULADD[0].instantiate()], stats)
    assert _packed(new) == ["packed_muladd"]
    assert stats == [{"candidates": 2, "tuples": 1, "packed_ops": 2,
                      "ii_dropped": 0, "pass": "silvia_muladd"}]
    stats = []
    same = tsil.optimize_graph(
        gm, [tsil.PassConfig(op="add", op_size=8).instantiate()], stats)
    assert same is gm and stats[0]["tuples"] == 0
    _same(new(*args), muls(*args))


# ---------------------------------------------------------------------------
# recursion into scan, cond and while_loop bodies
# ---------------------------------------------------------------------------

def scan_muls(a, b):
    """tests/test_silvia_passes.py::test_scan_body_optimized's program."""
    def body(c, xs):
        x, y = xs
        p0 = I32(x) * I32(y)
        p1 = I32(x + 1) * I32(y)
        return c + p0.sum(dtype=torch.int32) + p1.sum(dtype=torch.int32), p0

    return scan(body, torch.zeros((), dtype=torch.int32), (a, b))


def scan_muls_jax(a, b):
    def body(c, xs):
        x, y = xs
        p0 = I32(x) * I32(y)
        p1 = I32(x + 1) * I32(y)
        return c + p0.sum() + p1.sum(), p0

    return jax.lax.scan(body, jnp.int32(0), (a, b))


def test_scan_body_optimized(rng):
    args = _scan_args(rng)
    gm = tsil.optimized_graph(scan_muls, *T(*args), passes=MULADD)
    (_, body), = _bodies(gm)
    assert _packed(body) == ["packed_muladd"]
    want = scan_muls_jax(*J(*args))
    _same(tsil.optimize(scan_muls, MULADD)(*T(*args)), want)
    _same(scan_muls(*T(*args)), want)


def cond_muls(p, a0, a1, b):
    """Two muls sharing b in the true branch; adds in the false one."""
    return torch.cond(p.sum() > 0, lambda a0, a1, b: muls(a0, a1, b),
                      lambda a0, a1, b: (I32(a0) + I32(b), I32(a1) - I32(b)),
                      (a0, a1, b))


def cond_muls_jax(p, a0, a1, b):
    return jax.lax.cond(p.sum() > 0, muls,
                        lambda a0, a1, b: (I32(a0) + I32(b),
                                           I32(a1) - I32(b)), a0, a1, b)


def while_muls(a0, a1, b):
    """Three steps of acc += a*b for two streams sharing b."""
    def body(i, acc0, acc1):
        p0, p1 = muls(a0, a1, b)
        return i + 1, acc0 + p0, acc1 + p1

    zero = lambda: torch.zeros(a0.shape, dtype=torch.int32)
    return while_loop(lambda i, acc0, acc1: i < 3, body,
                      (torch.zeros((), dtype=torch.int32), zero(), zero()))


def while_muls_jax(a0, a1, b):
    def body(carry):
        i, acc0, acc1 = carry
        p0, p1 = muls(a0, a1, b)
        return i + 1, acc0 + p0, acc1 + p1

    zero = jnp.zeros(a0.shape, jnp.int32)
    return jax.lax.while_loop(lambda c: c[0] < 3, body,
                              (jnp.int32(0), zero, zero))


HOP_CASES = {
    "cond_true": (cond_muls, cond_muls_jax,
                  lambda rng: (np.ones(4, np.int8), *(i8(rng, (16,))
                                                      for _ in range(3)))),
    "cond_false": (cond_muls, cond_muls_jax,
                   lambda rng: (-np.ones(4, np.int8), *(i8(rng, (16,))
                                                        for _ in range(3)))),
    "while_loop": (while_muls, while_muls_jax,
                   lambda rng: tuple(i8(rng, (16,)) for _ in range(3))),
}


@pytest.mark.parametrize("case", HOP_CASES, ids=str)
def test_hop_body_packs_like_reference(case, rng):
    """The pass packs the two muls inside a cond branch / a while_loop
    body, as the reference does in its sub-jaxpr; the op counts and the
    outputs (of either branch) equal the reference's."""
    tfn, jfn, make = HOP_CASES[case]
    args = make(rng)
    gm = tsil.optimized_graph(tfn, *T(*args), passes=MULADD)
    closed = jsil.optimized_jaxpr(jfn, *J(*args),
                                  passes=[jsil.PassConfig(op="muladd")])
    assert _packed(gm) == _jax_packed(closed) == ["packed_muladd"]
    assert _counts(gm) == _counts(closed)
    assert _counts(tsil.trace(tfn, *T(*args))) == \
        _counts(jax.make_jaxpr(jfn)(*J(*args)))
    want = jfn(*J(*args))
    _same(gm(*T(*args)), want)
    _same(tsil.optimize(tfn, MULADD)(*T(*args)), want)


MMM = {"MMM": (chip_smoke.mmm, table1b.mmm, [{"op": "muladd"}],
               "packed_muladd"),
       "MMM-4b": (chip_smoke.mmm_4b, table1b.mmm_4b, [{"op": "mul4"}],
                  "packed_mul4")}


@pytest.mark.parametrize("name", MMM, ids=str)
def test_mmm_body_packs_like_reference(name):
    """MMM / MMM-4b at the reference sizes: the packed unit sits in the
    scan body, the units (body counted once) are the reference's
    count_ops, and the outputs equal benchmarks/table1b.py's bit for
    bit."""
    tfn, jfn, passes, packed = MMM[name]
    spec = next(s for s in chip_smoke.program_specs(card=False)
                if s[0] == name)
    rng = np.random.default_rng(sum(map(ord, name)))
    args = spec[2](lambda *s: i8(rng, s, -128, 128),
                   lambda *s: i8(rng, s, -8, 8), None)
    gm = tsil.optimized_graph(tfn, *T(*args),
                              passes=[tsil.PassConfig(**p) for p in passes])
    (_, body), = _bodies(gm)
    assert _packed(gm) == _packed(body) == [packed]
    jp = [jsil.PassConfig(**p) for p in passes]
    j_before = jopcount.count_ops(jax.make_jaxpr(jfn)(*J(*args)))
    j_after = jopcount.count_ops(jsil.optimized_jaxpr(jfn, *J(*args),
                                                      passes=jp))
    units = lambda c: c.mul_units + c.add_units + c.madd_units
    t_after = topcount.count_ops(gm)
    assert (topcount.count_ops(tsil.trace(tfn, *T(*args))).units,
            t_after.units, t_after.packed_units) == \
        (units(j_before), units(j_after), j_after.packed_units) == \
        tuple(spec[4:7])
    _same(gm(*T(*args)), jfn(*J(*args)))


@pytest.mark.parametrize("view", ["unsqueeze", "reshape"])
def test_functionalized_view_passes_width(view):
    """Inside a HOP body `torch.func.functionalize` turns views into their
    `_copy` forms (`unsqueeze_copy`, `view_copy`); width must pass
    through them as through the top level's views, or nothing in MMM's
    body packs."""
    def mmm_view(a_even, a_odd, b):
        col = (lambda t: I32(t)[:, None]) if view == "unsqueeze" \
            else (lambda t: I32(t).reshape(-1, 1))
        row = (lambda t: I32(t)[None, :]) if view == "unsqueeze" \
            else (lambda t: I32(t).reshape(1, -1))

        def body(acc, inp):
            a_e, a_o, b_k = inp
            return (acc[0] + col(a_e) * row(b_k),
                    acc[1] + col(a_o) * row(b_k)), []

        zero = lambda: torch.zeros((a_even.shape[0], b.shape[1]),
                                   dtype=torch.int32)
        return scan(body, (zero(), zero()), (a_even.T, a_odd.T, b))[0]

    rng = np.random.default_rng(3)
    args = T(i8(rng, (6, 5)), i8(rng, (6, 5)), i8(rng, (5, 7)))
    (_, body), = _bodies(tsil.trace(mmm_view, *args))
    copy_op = torch.ops.aten.unsqueeze_copy.default if view == "unsqueeze" \
        else torch.ops.aten.view_copy.default
    views = [n for n in body.graph.nodes if n.target is copy_op]
    assert len(views) == 4
    widths = ir.WidthAnalysis(ir.items_of(body), ir.outvars_of(body))
    for n in views:
        assert ir.prim_name(n) == "broadcast_in_dim"
        w = widths.width_of(n)
        assert (w.bits, w.signed, w.match_src.op) == (8, True, "placeholder")
    gm = tsil.optimized_graph(mmm_view, *args, passes=MULADD)
    assert _packed(gm) == ["packed_muladd"]
    _same(gm(*args), mmm_view(*args))


def test_top_level_rewrite_keeps_the_body(rng):
    """A graph that packs at the top level AND in a scan body: the
    emitted top-level graph still resolves its body attribute."""
    def fn(a0, a1, b, xs, ys):
        return muls(a0, a1, b), scan_muls(xs, ys)

    args = T(*(i8(rng, (16,)) for _ in range(3)), *_scan_args(rng))
    gm = tsil.optimized_graph(fn, *args, passes=MULADD)
    assert _packed(gm) == ["packed_muladd"] * 2
    (_, body), = _bodies(gm)
    assert _packed(body) == ["packed_muladd"]
    _same(gm(*args), fn(*args))
