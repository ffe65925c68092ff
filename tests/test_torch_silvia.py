"""The port's SILVIA passes (src/repro_torch/core) against the JAX
passes (src/repro/core).

Every case runs one program through both: the same numpy inputs, the
same pass list.  The packed-node census, the op counts (`count_ops`,
before and after) and the outputs -- bit for bit -- must agree, and the
optimized program must equal the unoptimized one.  The straight-line
cases of tests/test_silvia_passes.py are written once over both
frameworks (`I32` and `WH` pick the framework from the operand); the
paper's programs compare chip_smoke.py's torch copies with the JAX
originals in benchmarks/.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import table1a, table1b, table2_cnn  # noqa: E402
from repro import core as jsil  # noqa: E402
from repro.core import bounds as jbounds  # noqa: E402
from repro.core import opcount as jopcount  # noqa: E402
from repro_torch import core as tsil  # noqa: E402
from repro_torch.core import bounds as tbounds  # noqa: E402
from repro_torch.core import opcount as topcount  # noqa: E402
from repro_torch.core import prims as tprims  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def I32(x):
    return x.to(torch.int32) if isinstance(x, torch.Tensor) \
        else x.astype(jnp.int32)


def WH(x, bits):
    return tsil.width_hint(x, bits) if isinstance(x, torch.Tensor) \
        else jsil.width_hint(x, bits)


def _tree_map(fn, tree):
    return jax.tree_util.tree_map(fn, tree)


def _jax_args(args):
    return _tree_map(jnp.asarray, args)


def _torch_args(args):
    return _tree_map(lambda a: torch.from_numpy(np.array(a)), args)


def _jax_packed(closed):
    """Packed calls of a jaxpr and of every sub-jaxpr in it."""
    names = []
    for e in closed.jaxpr.eqns:
        if e.primitive.name.startswith("silvia_packed"):
            names.append(e.primitive.name)
        for v in e.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else [v]):
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    names.extend(_jax_packed(sub))
    return sorted(names)


def _torch_packed(gm):
    """Packed calls of a graph and of every body it names."""
    names = []
    for n in gm.graph.nodes:
        if n.op == "call_function" and n.target in tprims.PACKED_PRIMS:
            names.append(f"silvia_{n.target.__name__}")
        elif n.op == "get_attr" and isinstance(
                sub := getattr(gm, n.target), torch.fx.GraphModule):
            names.extend(_torch_packed(sub))
    return sorted(names)


def _leaves(tree):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in jax.tree_util.tree_leaves(tree)]


def _assert_same_leaves(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def compare(jfn, tfn, args, passes):
    """Run one program through both pipelines; returns the port's
    optimized graph after asserting parity."""
    jargs, targs = _jax_args(args), _torch_args(args)
    jp = [jsil.PassConfig(**p) for p in passes]
    tp = [tsil.PassConfig(**p) for p in passes]
    j_before = jax.make_jaxpr(jfn)(*jargs)
    j_after = jsil.optimized_jaxpr(jfn, *jargs, passes=jp)
    t_before = tsil.trace(tfn, *targs)
    t_after = tsil.optimized_graph(tfn, *targs, passes=tp)
    assert _torch_packed(t_after) == _jax_packed(j_after)
    assert dataclasses.astuple(topcount.count_ops(t_before)) == \
        dataclasses.astuple(jopcount.count_ops(j_before))
    assert dataclasses.astuple(topcount.count_ops(t_after)) == \
        dataclasses.astuple(jopcount.count_ops(j_after))
    want = jfn(*jargs)
    _assert_same_leaves(tsil.optimize(tfn, tp)(*targs), want)
    _assert_same_leaves(tfn(*targs), want)
    _assert_same_leaves(jsil.optimize(jfn, jp)(*jargs), want)
    return t_after


def i8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


MUL = [{"op": "muladd"}]


# ---------------------------------------------------------------------------
# the straight-line cases of tests/test_silvia_passes.py, on both
# ---------------------------------------------------------------------------

def fig1(a0, a1, b):
    return I32(a0) * I32(b), I32(a1) * I32(b)


def fig4(a0, a1, b):
    u0 = I32(a0) * I32(b) + 1          # early use of c0 (the "store")
    u1 = I32(a1) * I32(b) + 2
    return u0, u1


def dependent_muls(a0, b):
    c0 = I32(a0) * I32(b)
    narrow = c0.to(torch.int8) if isinstance(c0, torch.Tensor) \
        else c0.astype(jnp.int8)
    return I32(narrow) * I32(b)


def no_shared(a0, a1, b0, b1):
    return I32(a0) * I32(b0), I32(a1) * I32(b1)


def trees(a, b, c):
    ta = [I32(a[i]) * I32(c[i]) for i in range(4)]
    tb = [I32(b[i]) * I32(c[i]) for i in range(4)]
    return (ta[0] + ta[1]) + (ta[2] + ta[3]), (tb[0] + tb[1]) + (tb[2] + tb[3])


def trees_4bit(a, b, c):
    ta = [I32(WH(a[i], 4)) * I32(c[i]) for i in range(4)]
    tb = [I32(WH(b[i], 4)) * I32(c[i]) for i in range(4)]
    return (ta[0] + ta[1]) + (ta[2] + ta[3]), (tb[0] + tb[1]) + (tb[2] + tb[3])


def adds(xs, ys):
    return tuple(x + y for x, y in zip(xs, ys))


def subs(x0, y0, x1, y1):
    return x0 - y0, x1 - y1


def i32_adds(x0, y0, x1, y1):
    return I32(x0) + I32(y0), I32(x1) + I32(y1)


def mul4_fn(a, b):
    b4 = I32(WH(b, 4))
    return tuple(I32(WH(a[i], 4)) * b4 for i in range(4))


def _cases():
    r = np.random.default_rng(0)
    v = lambda n, shape=(16,): [i8(r, shape) for _ in range(n)]
    i16 = lambda: r.integers(-30000, 30000, (8,)).astype(np.int16)
    i4 = lambda: tuple(i8(r, (16,), -8, 8) for _ in range(4))
    return [
        # name, fn, args, passes, packed census
        ("fig1", fig1, v(3), MUL, ["silvia_packed_muladd"]),
        ("fig4_alap", fig4, v(3, (8,)), MUL, ["silvia_packed_muladd"]),
        ("dependent_muls", dependent_muls, v(2, (8,)), MUL, []),
        ("no_shared_operand", no_shared, v(4, (8,)), MUL, []),
        ("wide_operands", fig1, [i16() for _ in range(3)], MUL, []),
        ("chain_split", trees, [tuple(v(4, (32,))) for _ in range(3)], MUL,
         ["silvia_packed_muladd"] * 4),
        ("mad_tree_4bit", trees_4bit, [i4(), i4(), tuple(v(4))],
         [{"op": "muladd", "m_bits": 4}], ["silvia_packed_muladd"]),
        ("four8_full", adds, [tuple(v(4)), tuple(v(4))],
         [{"op": "add", "op_size": 8}], ["silvia_packed_add"]),
        ("two16_sub", subs, [i16() for _ in range(4)],
         [{"op": "add", "op_size": 16, "inst": "sub"}],
         ["silvia_packed_add"]),
        ("partial_tuple", adds, [tuple(v(3)), tuple(v(3))],
         [{"op": "add", "op_size": 8}], ["silvia_packed_add"]),
        ("i32_adds_four8", i32_adds, v(4), [{"op": "add", "op_size": 8}],
         []),
        ("i32_adds_two16", i32_adds, v(4), [{"op": "add", "op_size": 16}],
         ["silvia_packed_add"]),
        ("mul4", mul4_fn, [i4(), i8(r, (16,), -8, 8)], [{"op": "mul4"}],
         ["silvia_packed_mul4"]),
        ("default_pipeline", trees, [tuple(v(4, (32,))) for _ in range(3)],
         [dataclasses.asdict(p) for p in tsil.DEFAULT_PASSES],
         ["silvia_packed_muladd"] * 4),
        # the paper's MAX_CHAIN_LEN: the 4-bit chain of 4 in two segments
        ("max_chain_len", trees_4bit, [i4(), i4(), tuple(v(4))],
         [{"op": "muladd", "m_bits": 4, "max_chain_len": 2}],
         ["silvia_packed_muladd"] * 2),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_pass_case_matches_reference(case):
    _, fn, args, passes, census = case
    gm = compare(fn, fn, args, passes)
    assert _torch_packed(gm) == census


def test_fig1_graph_is_one_packed_call():
    """Fig. 1 / Fig. 4c: the converts die with the muls they fed; one
    packed call and its two results remain."""
    args = _torch_args([i8(np.random.default_rng(1), (16,))
                        for _ in range(3)])
    gm = tsil.optimized_graph(fig1, *args, passes=[tsil.PassConfig("muladd")])
    targets = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert targets[0] is tprims.packed_muladd
    assert [t.__name__ for t in targets[1:]] == ["getitem", "getitem"]


def test_dce_graph_drops_dead_nodes():
    def fn(a, b):
        (I32(a) * I32(b)) + 1           # dead
        return a + b

    args = _torch_args([i8(np.random.default_rng(6), (8,))
                        for _ in range(2)])
    gm = tsil.trace(fn, *args)
    live = tsil.dce.dce_graph(gm)
    assert topcount.count_ops(gm).units == 3
    assert topcount.count_ops(live).units == 1
    assert tsil.dce.dce_graph(live) is live
    _assert_same_leaves(live(*args), fn(*args))


def test_float_code_untouched():
    x = torch.randn(8)
    fn = lambda x, y: x * y + torch.sin(x)
    gm = tsil.trace(fn, x, x)
    assert tsil.optimize_graph(gm, [p.instantiate()
                                    for p in tsil.DEFAULT_PASSES]) is gm


def test_ops_per_unit_metric():
    args = _torch_args([i8(np.random.default_rng(2), (8,))
                        for _ in range(3)])
    before = topcount.count_ops(tsil.trace(fig1, *args))
    after = topcount.count_ops(tsil.optimized_graph(
        fig1, *args, passes=[tsil.PassConfig(op="muladd")]))
    assert before.mul_density == 1.0 and after.mul_density == 2.0
    rep = topcount.density_report(before, after)
    assert rep["unit_reduction"] == 0.5


# ---------------------------------------------------------------------------
# the paper's programs: chip_smoke.py's torch copies vs benchmarks/
# ---------------------------------------------------------------------------

def conv3x3_pair_4b_jax(x, w_even, w_odd):
    """The reference's conv pair with 4-bit weights hinted after indexing
    (as tests/test_silvia_passes.py::test_mad_tree_4bit_single_chain)."""
    taps = table2_cnn._shift_views(x)
    w = lambda v, t: I32(WH(v[t], 4))
    ye = I32(taps[0]) * w(w_even, 0)
    yo = I32(taps[0]) * w(w_odd, 0)
    for t in range(1, 9):
        ye = ye + I32(taps[t]) * w(w_even, t)
        yo = yo + I32(taps[t]) * w(w_odd, t)
    return ye, yo


JAX_PROGRAMS = {
    "vadd": table1a.vadd_unrolled, "SNN": table1a.snn_conv_taps,
    "MVM": table1b.mvm, "MMM": table1b.mmm, "MMM-4b": table1b.mmm_4b,
    "scal": table1b.scal, "axpy": table1b.axpy,
    "GSM": table1b.gsm, "RTM": table1b.rtm, "GAT": table1b.gat,
    "conv-pair": table2_cnn.conv3x3_pair_naive,
    "conv-pair-4b": conv3x3_pair_4b_jax,
    "MobileNet-4b": table2_cnn.pw_conv4_naive,
}


@pytest.mark.parametrize("spec", chip_smoke.program_specs(card=False),
                         ids=lambda s: s[0])
def test_paper_program_matches_reference(spec):
    name, fn, make_args, passes, units_before, units_after, packed, _ = spec
    rng = np.random.default_rng(sum(map(ord, name)))
    args = make_args(lambda *s: i8(rng, s), lambda *s: i8(rng, s, -8, 8),
                     lambda *s: rng.random(s) > 0.7)
    gm = compare(JAX_PROGRAMS[name], fn, args, passes)
    assert topcount.count_ops(tsil.trace(fn, *_torch_args(args))).units \
        == units_before
    after = topcount.count_ops(gm)
    assert after.units == units_after
    assert after.packed_units == packed


def test_manual_split_program_matches_naive():
    """MobileNet-4b packed by hand onto the split unit equals the naive
    program and the reference's hand-packed one."""
    rng = np.random.default_rng(5)
    x, w4 = i8(rng, (300,), -8, 8), i8(rng, (4,), -8, 8)
    got = chip_smoke.pw_conv4_manual_split(*_torch_args([x, w4]))
    _assert_same_leaves(got, table2_cnn.pw_conv4_naive(*_jax_args([x, w4])))
    _assert_same_leaves(got, table2_cnn.pw_conv4_manual(*_jax_args([x, w4])))


def test_hint_before_indexing_packs_nothing():
    """Width does not pass through indexing, in either package: a hint on
    the whole weight vector is lost at w[t], so the 4-bit conv pair packs
    nothing under m_bits=4."""
    def conv(x, w_even, w_odd):
        return chip_smoke.conv3x3_pair_naive(x, WH(w_even, 4), WH(w_odd, 4))

    def conv_jax(x, w_even, w_odd):
        return table2_cnn.conv3x3_pair_naive(x, WH(w_even, 4),
                                             WH(w_odd, 4))

    rng = np.random.default_rng(3)
    args = [i8(rng, (16, 16)), i8(rng, (9,), -8, 8), i8(rng, (9,), -8, 8)]
    gm = compare(conv_jax, conv, args, [{"op": "muladd", "m_bits": 4}])
    assert _torch_packed(gm) == []


# ---------------------------------------------------------------------------
# C-ref1, width hints, the trace cache, Eq. 2
# ---------------------------------------------------------------------------

def _random_program(opcodes):
    """tests/test_silvia_property.py's program generator, in torch."""
    def fn(a, b, c):
        live8, live32 = [a, b, c], []
        for op, i, j in opcodes:
            x, y = live8[i % len(live8)], live8[j % len(live8)]
            if op == 0:
                live32.append(I32(x) * I32(c))
            elif op == 1:
                live32.append(I32(x) * I32(y))
            elif op == 2:
                live8.append(x + y)
            elif op == 3 and len(live32) >= 2:
                live32.append(live32[i % len(live32)]
                              + live32[j % len(live32)])
            elif op == 4:
                live8.append(x - y)
        return tuple(live32[-4:]) + tuple(live8[-4:])
    return fn


def test_cref1_counterexample_packs_without_a_cycle():
    """The reference's committed counterexample: an add tuple and a sub
    tuple each hold a member that depends on the other, and the reference
    builds a cyclic graph.  The port keeps the tuples jointly packable;
    its result equals the unrewritten program."""
    fn = _random_program([(2, 0, 0), (2, 0, 0), (4, 0, 0), (4, 0, 3),
                          (2, 5, 0)])
    rng = np.random.default_rng(0)
    args = _torch_args([i8(rng, (8,)) for _ in range(3)])
    gm = tsil.optimized_graph(fn, *args)
    assert topcount.count_ops(gm).packed_units >= 1
    _assert_same_leaves(tsil.optimize(fn)(*args), fn(*args))


@pytest.mark.parametrize("seed", range(6))
def test_random_programs_match_unrewritten(seed):
    rng = np.random.default_rng(seed)
    ops = [tuple(int(v) for v in (rng.integers(0, 5), rng.integers(0, 8),
                                  rng.integers(0, 8)))
           for _ in range(rng.integers(4, 13))]
    fn = _random_program(ops)
    args = _torch_args([i8(rng, (8,)) for _ in range(3)])
    _assert_same_leaves(tsil.optimize(fn)(*args), fn(*args))


# ---------------------------------------------------------------------------
# unsigned operands (C-ref3): an unsigned b-bit value needs b + 1 bits in a
# signed lane.  The reference fits on `bits` alone and packs these; the
# port packs them only where a signed lane holds every value.
# ---------------------------------------------------------------------------

def mul4_masked(a, b):
    b4 = I32(b & 15)
    return tuple(I32(a[i] & 15) * b4 for i in range(4))


def adds_masked(x0, y0, x1, y1):
    return I32(x0 & 127) + I32(y0 & 127), I32(x1 & 127) + I32(y1 & 127)


def fig1_via_uint8(a0, a1, b):
    """Fig. 1 behind a same-width cast that changes signedness (C-ref4):
    int8 -1 becomes uint8 255, so the cast is not value-preserving."""
    return (I32(a0.to(torch.uint8)) * I32(b),
            I32(a1.to(torch.uint8)) * I32(b))


def _unsigned_cases():
    r = np.random.default_rng(7)
    u8 = lambda: r.integers(128, 256, (16,)).astype(np.uint8)
    hi4 = lambda: r.integers(8, 16, (16,)).astype(np.int8)   # 8..15
    return [
        # name, fn, args, passes, packed census
        ("fig1_uint8", fig1, [u8() for _ in range(3)], MUL, []),
        ("fig1_int8_to_uint8", fig1_via_uint8,
         [i8(r, (16,), -128, 0) for _ in range(3)], MUL, []),
        ("mul4_and15", mul4_masked, [tuple(hi4() for _ in range(4)), hi4()],
         [{"op": "mul4"}], []),
        ("adds_and127_four8", adds_masked, [i8(r, (16,)) for _ in range(4)],
         [{"op": "add", "op_size": 8}], []),
        ("adds_and127_two16", adds_masked, [i8(r, (16,)) for _ in range(4)],
         [{"op": "add", "op_size": 16}], ["silvia_packed_add"]),
    ]


@pytest.mark.parametrize("case", _unsigned_cases(), ids=lambda c: c[0])
def test_unsigned_operands_match_unrewritten(case):
    _, fn, args, passes, census = case
    targs = _torch_args(args)
    tp = [tsil.PassConfig(**p) for p in passes]
    assert _torch_packed(tsil.optimized_graph(fn, *targs, passes=tp)) \
        == census
    _assert_same_leaves(tsil.optimize(fn, tp)(*targs), fn(*targs))


def test_width_hint_survives_make_fx():
    x = torch.tensor([3, -4, 7], dtype=torch.int8)
    gm = tsil.trace(lambda t: tsil.width_hint(t, 4) * 2, x)
    hints = [n for n in gm.graph.nodes if n.target is tprims.WIDTH_HINT]
    assert len(hints) == 1 and hints[0].args[1:] == (4, True)
    assert torch.equal(gm(x), x * 2)
    assert torch.equal(tsil.width_hint(x, 4), x)


def test_trace_cache_counters():
    opt = tsil.optimize(fig1, [tsil.PassConfig(op="muladd")])
    rng = np.random.default_rng(4)
    a = _torch_args([i8(rng, (8,)) for _ in range(3)])
    b = _torch_args([i8(rng, (8,)) for _ in range(3)])
    c = _torch_args([i8(rng, (5, 2)) for _ in range(3)])
    for args in (a, b, c, a):
        _assert_same_leaves(opt(*args), fig1(*args))
    info = opt.cache_info()
    assert (info["trace_misses"], info["trace_hits"], info["traces"]) \
        == (2, 2, 2)
    assert info["rewrite_ms"] > 0
    opt.cache_clear()
    assert opt.cache_info()["traces"] == 0
    # pytree inputs and a non-tensor leaf (part of the key)
    scaled = tsil.optimize(lambda xs, k: (I32(xs[0]) * I32(xs[1]) + k,
                                          I32(xs[2]) * I32(xs[1]) + k),
                           [tsil.PassConfig(op="muladd")])
    for k in (1, 1, 2):
        got = scaled(tuple(a), k)
        assert torch.equal(got[0], I32(a[0]) * I32(a[1]) + k)
    assert scaled.cache_info()["traces"] == 2


def _adds_and_a_write(a0, a1, b0, b1, buf):
    """Two packable int8 adds, and an input written in place between a
    read that must see it before the write and one that must see it
    after (the shape of a decode step's KV-cache update)."""
    s0, s1 = a0 + b0, a1 + b1
    old = buf * 1
    buf.add_(s0.to(buf.dtype))
    return s1, old, buf * 1


def test_packed_graph_keeps_an_input_write_in_order():
    """A pass packs the adds, so the graph is re-emitted in its own
    schedule; the write of `buf` must still come after the read before it
    and before the read after it, and the input must be written."""
    rng = np.random.default_rng(8)
    args = _torch_args([i8(rng, (16,)) for _ in range(4)])
    passes = [tsil.PassConfig(op="add", op_size=8)]
    gm = tsil.optimized_graph(_adds_and_a_write, *args,
                              torch.zeros(16, dtype=torch.int32),
                              passes=passes)
    assert _torch_packed(gm) == ["silvia_packed_add"]
    buf0 = torch.from_numpy(rng.integers(-9, 9, (16,)).astype(np.int32))
    buf_want, buf_got = buf0.clone(), buf0.clone()
    want = _adds_and_a_write(*args, buf_want)
    got = tsil.optimize(_adds_and_a_write, passes)(*args, buf_got)
    _assert_same_leaves(got, want)
    assert torch.equal(buf_got, buf_want)
    assert not torch.equal(want[1], want[2])


def test_bounds_match_reference():
    for m in range(1, 9):
        for n in range(1, 9):
            for low in (8, 16, 18, 24):
                for signed in (True, False):
                    assert tbounds.eq2_max_chain(m, n, low, signed) == \
                        jbounds.eq2_max_chain(m, n, low, signed)
            assert tbounds.muladd2_max_chain(m, n) == \
                jbounds.muladd2_max_chain(m, n)
    assert tbounds.eq2_max_chain(8, 8, 18, signed=True) == 7   # paper 2.2
    assert tbounds.I32_LANE == jbounds.TPU_I32_LANE
    assert tbounds.mul4_layout() == jbounds.mul4_layout()
    mode = lambda b: b if b is None else dataclasses.astuple(b)
    for w in (4, 8, 12, 16, 24, 32):
        assert mode(tbounds.add_mode_for_width(w)) == \
            mode(jbounds.add_mode_for_width(w))


def debias_pair(a, b):
    """The w4a8 unpacking's de-bias pair (common.unpack_w4_words, the
    reference's unpack_w4): a low nibble minus 8, on two streams."""
    return (I32(a) & 0xF) - 8, (I32(b) & 0xF) - 8


def test_cref5_literal_width_packs_only_in_the_port():
    """ROADMAP C-ref5: the de-bias pair packs 1 unit in the port and 0 in
    the reference.  Under JAX 0.9 a jaxpr literal's `.val` is a
    `TypedNdArray`, which the reference's `_literal_width` sizes as 64
    bits and its `and`-with-constant rule never narrows; the port's
    literals are Python ints, sized by value as the reference's code
    intends.  This holds the reason: it fails if a JAX upgrade makes the
    literal an int / np.integer / np.ndarray again, and then the two
    agree.  The outputs agree either way."""
    rng = np.random.default_rng(6)
    args = [i8(rng, (16,)), i8(rng, (16,))]
    jargs, targs = _jax_args(args), _torch_args(args)
    passes = [{"op": "add", "op_size": 8}]
    j_after = jsil.optimized_jaxpr(debias_pair, *jargs,
                                   passes=[jsil.PassConfig(**p)
                                           for p in passes])
    t_after = tsil.optimized_graph(debias_pair, *targs,
                                   passes=[tsil.PassConfig(**p)
                                           for p in passes])
    assert (_torch_packed(t_after), _jax_packed(j_after)) == \
        (["silvia_packed_add"], [])
    closed = jax.make_jaxpr(debias_pair)(*jargs)
    lits = [v.val for e in closed.jaxpr.eqns for v in e.invars
            if e.primitive.name == "and" and hasattr(v, "val")]
    assert len(lits) == 2
    assert not any(isinstance(v, (int, np.integer, np.ndarray))
                   for v in lits), "reference literals are sized again"
    want = debias_pair(*jargs)
    _assert_same_leaves(t_after(*targs), want)
    _assert_same_leaves(jsil.optimize(
        debias_pair, [jsil.PassConfig(**p) for p in passes])(*jargs), want)
