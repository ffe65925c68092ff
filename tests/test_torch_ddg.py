"""The port's DDG / initiation-interval analysis (src/repro_torch/core/
ddg.py) and its II-aware tuple filter against the reference's (paper
sec. 3.5.1, Fig. 5).

Counterparts of tests/test_ddg.py and tests/test_ii_filter.py: the same
DDGs go through both analyzers, and the same scan programs, on the same
numpy inputs, through both pass pipelines.  Torch's scan body orders its
inputs [*carry, *xs, *additional_inputs] (JAX's: [*consts, *carry,
*xs]), so the loop-carried edges come from a different placeholder
order and must land on the same items.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._higher_order_ops.scan import scan  # noqa: E402

from repro import core as jsil  # noqa: E402
from repro.core import ddg as jddg  # noqa: E402
from repro.core import opcount as jopcount  # noqa: E402
from repro_torch import core as tsil  # noqa: E402
from repro_torch.core import ddg as tddg  # noqa: E402
from repro_torch.core import opcount as topcount  # noqa: E402
from repro_torch.core import prims as tprims  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the analyzer on hand-built DDGs (tests/test_ddg.py)
# ---------------------------------------------------------------------------

# (latencies, edges (u, v, distance), II_min, merged group, its II_min)
DDG_CASES = {
    # paper Fig. 5: a = x + y ; b = x + d_prev ; c = w * a ; d = c + b.
    # The cycle b->d->b has latency 2 over distance 1; packing {a, b}
    # adds the cycle (ab)->c->d->(ab): 3 / 1.
    "fig5": ([1, 1, 1, 1], [(0, 2, 0), (2, 3, 0), (1, 3, 0), (3, 1, 1)],
             2, [0, 1], 3),
    "acyclic": ([1, 1, 1], [(0, 1, 0), (1, 2, 0)], 1, [0, 1], 1),
    # a cycle of latency 6 over distance 2; merged, a self-loop of
    # latency 3 over distance 2
    "long_latency": ([3, 3], [(0, 1, 0), (1, 0, 2)], 3, [0, 1], 2),
    "merge_keeps_acyclic": ([1, 1, 1, 1], [(0, 2, 0), (1, 3, 0)], 1,
                            [0, 1], 1),
}


@pytest.mark.parametrize("case", DDG_CASES, ids=str)
def test_ddg_matches_reference(case):
    lat, edges, ii, group, merged_ii = DDG_CASES[case]
    for mod in (tddg, jddg):
        g = mod.ddg_from_edges(lat, edges)
        assert g.ii_min() == ii
        assert g.with_merged(group).ii_min() == merged_ii
        assert mod.would_increase_ii(g, group) == (merged_ii > ii)
    t, j = (mod.ddg_from_edges(lat, edges).with_merged(group)
            for mod in (tddg, jddg))
    assert (t.latencies, t.edges) == (j.latencies, j.edges)


def test_ddg_from_scan_body():
    """The Fig. 5 pattern as a torch scan: its body's DDG has II 2, and
    merging the two adds that feed the carry raises it to 3, as the
    reference's DDG of the same JAX body."""
    def tbody(d, xy):
        x, y = xy
        a = x + y
        b = x + d
        d_new = 3 * a + b
        return d_new, d_new.clone()

    def jbody(d, xy):
        x, y = xy
        a = x + y
        b = x + d
        d_new = 3 * a + b
        return d_new, d_new

    xs = torch.arange(4, dtype=torch.int32)
    gm = tsil.trace(lambda xs, ys: scan(tbody, torch.zeros(
        (), dtype=torch.int32), (xs, ys)), xs, xs)
    node = next(n for n in gm.graph.nodes
                if n.op == "call_function" and "scan" in str(n.target))
    body = getattr(gm, node.args[0].target)
    g = tddg.ddg_from_scan_body(body, num_carry=len(node.args[1]))
    names = [it.name for it in tsil.ir.items_of(body)]
    a_idx = names.index("add")
    b_idx = names.index("add", a_idx + 1)

    closed = jax.make_jaxpr(lambda xs, ys: jax.lax.scan(
        jbody, jnp.int32(0), (xs, ys)))(jnp.arange(4, dtype=jnp.int32),
                                         jnp.arange(4, dtype=jnp.int32))
    eqn = next(e for e in closed.jaxpr.eqns if e.primitive.name == "scan")
    sub = eqn.params["jaxpr"]
    jg = jddg.ddg_from_scan_body(sub, num_carry=eqn.params["num_carry"],
                                 num_consts=eqn.params["num_consts"])
    jnames = [e.primitive.name for e in sub.jaxpr.eqns]
    ja = jnames.index("add")
    jb = jnames.index("add", ja + 1)

    assert (g.ii_min(), g.with_merged([a_idx, b_idx]).ii_min()) == \
        (jg.ii_min(), jg.with_merged([ja, jb]).ii_min()) == (2, 3)


# ---------------------------------------------------------------------------
# the II filter in the pass pipeline (tests/test_ii_filter.py)
# ---------------------------------------------------------------------------

def fig5_jax(xs, ys, w):
    """tests/test_ii_filter.py's Fig. 5 scan: int8 adds a = x + y and
    b = x + d_prev feed d = w*a + b, carried."""
    def body(d, xy):
        x, y = xy
        a = x + y
        b = x + d
        c = (w * a).astype(jnp.int8)
        d_new = (c + b).astype(jnp.int8)
        return d_new, d_new
    return jax.lax.scan(body, jnp.int8(0), (xs, ys))


def fig5_torch(xs, ys, w):
    """fig5_jax in torch (`w` is lifted into the scan's additional
    inputs; the per-step output is a copy, since a scan body may not
    return one tensor twice)."""
    def body(d, xy):
        x, y = xy
        a = x + y
        b = x + d
        c = (w * a).to(torch.int8)
        d_new = (c + b).to(torch.int8)
        return d_new, d_new.clone()
    return scan(body, torch.zeros((), dtype=torch.int8), (xs, ys))


def _body_packed(gm):
    """Packed calls inside the graph's HOP bodies."""
    return [n.target.__name__ for _, sub in gm.named_children()
            if isinstance(sub, torch.fx.GraphModule)
            for n in sub.graph.nodes if n.target in tprims.PACKED_PRIMS]


def _same(got, want):
    got, want = jax.tree_util.tree_leaves(got), \
        jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("filter_ii", [False, True])
def test_fig5_filter_matches_reference(filter_ii):
    """Without the filter the pass packs {a, b} in the body (the paper's
    behaviour); with it the tuple is dropped (ii_dropped 1).  The stats,
    the op counts and the outputs equal the reference's."""
    rng = np.random.default_rng(0)
    xs, ys = (rng.integers(-50, 50, (6,)).astype(np.int8)
              for _ in range(2))
    jargs = (jnp.asarray(xs), jnp.asarray(ys), jnp.int8(3))
    targs = (torch.from_numpy(xs), torch.from_numpy(ys),
             torch.tensor(3, dtype=torch.int8))
    spec = dict(op="add", op_size=8, filter_ii=filter_ii)
    jstats, tstats = [], []
    jgot = jsil.optimized_jaxpr(fig5_jax, *jargs,
                                passes=[jsil.PassConfig(**spec)],
                                stats=jstats)
    tgot = tsil.optimized_graph(fig5_torch, *targs,
                                passes=[tsil.PassConfig(**spec)],
                                stats=tstats)
    assert tstats == jstats
    assert tstats[0]["ii_dropped"] == int(filter_ii)
    assert _body_packed(tgot) == ([] if filter_ii else ["packed_add"])
    assert dataclasses.astuple(topcount.count_ops(tgot)) == \
        dataclasses.astuple(jopcount.count_ops(jgot))
    want = fig5_jax(*jargs)
    _same(tsil.optimize(fig5_torch, [tsil.PassConfig(**spec)])(*targs), want)
    _same(fig5_torch(*targs), want)


def test_ii_filter_keeps_safe_tuples():
    """Independent adds with no carried cycle still pack under the
    filter (the filter is not 'no packing in loops')."""
    def safe_scan(xs, ys):
        def body(c, xy):
            x, y = xy
            a = x + y
            b = y + 1
            s = (c + a.to(torch.int32).sum(dtype=torch.int32)
                 + b.to(torch.int32).sum(dtype=torch.int32))
            return s, (a, b)
        return scan(body, torch.zeros((), dtype=torch.int32), (xs, ys))

    rng = np.random.default_rng(1)
    xs, ys = (torch.from_numpy(rng.integers(-50, 50, (4, 8)).astype(np.int8))
              for _ in range(2))
    passes = [tsil.PassConfig(op="add", op_size=8, filter_ii=True)]
    stats = []
    gm = tsil.optimized_graph(safe_scan, xs, ys, passes=passes, stats=stats)
    assert _body_packed(gm) == ["packed_add"]
    assert stats[0]["ii_dropped"] == 0
    _same(tsil.optimize(safe_scan, passes)(xs, ys), safe_scan(xs, ys))
