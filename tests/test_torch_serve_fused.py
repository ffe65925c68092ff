"""The port's decode bundles, `silvia_passes` and `fused` against the
reference's `generate` (src/repro/launch/serve.py).

On the CPU `generate(fused=True)` runs the per-step loop (there is no
CUDA graph there); the captured graph itself is held against the
per-step loop on the card, in tests/test_torch_cuda.py.  Here: the
captured step's static buffers, run eagerly, give the per-step loop's
tokens and logits, a bundle keeps one step sized by its calls, the passes leave the tokens alone
and match the reference's under the C2 rule of tests/test_torch_serve.py,
the bundle LRU moves its counters as the reference's does, and the
decode step traced for CUDA (fake tensors) holds each GEMM as one
custom-op node.
"""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import core as jsil  # noqa: E402
from repro.core import opcount as jopcount  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import core as tsil  # noqa: E402
from repro_torch.core import opcount as topcount  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_serve import (LOGIT_TOL, SRC, _reference_logits,  # noqa: E402
                              _setup, assert_tokens_match)
from torch.utils import _pytree as pytree  # noqa: E402

B, S, G = 3, 8, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab, seed=4):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _gen(tp, tcfg, prompts, **kw):
    return tserve.generate(tp, prompts, tcfg, gen=G, cache_len=S + G,
                           device="cpu", return_logits=True, **kw)


@pytest.mark.parametrize("silvia_passes", ["off", "all"])
def test_static_step_matches_stepwise(silvia_passes):
    """The captured step's static buffers, its step run eagerly (the CPU
    has no graph): over two prompts through one step, the prefill's cache
    copied in, token, position and step index advanced on the device, and
    the tokens and logits rows written equal the per-step loop's, bit for
    bit."""
    _, tcfg, _, tp = _setup("bfloat16", "w8a8")
    bundle = tserve._decode_bundle(tcfg, silvia_passes, "cpu")
    for seed in (4, 5):
        prompts = _prompts(tcfg.vocab, seed)
        want, want_logits = _gen(tp, tcfg, prompts,
                                 silvia_passes=silvia_passes, fused=False)
        logits, cache = tlm.prefill(tp, torch.as_tensor(prompts), tcfg,
                                    cache_len=S + G)
        step = bundle.captured(tp, B, S + G, True, G - 1,
                               torch.device("cpu"))
        assert step.graph is None
        toks, seen = step.run(logits[:, -1].argmax(dim=-1)[:, None], cache,
                              S, G - 1)
        assert torch.equal(toks, want[:, 1:])
        assert torch.equal(seen, want_logits[:, 1:])
        assert step.pos.tolist() == [S + G - 1] * B
        assert step.step.tolist() == [G - 1]
    assert bundle.captures == 1


def test_bundle_keeps_one_captured_step():
    """A bundle holds one captured step, sized by the steps asked of it:
    fewer steps reuse it; more steps, another params tree (same shapes,
    new leaves) or another return_logits capture anew in its place."""
    _, tcfg, _, tp = _setup("bfloat16", "w4a8")
    other = pytree.tree_map(torch.clone, tp)
    cpu = torch.device("cpu")
    bundle = tserve._DecodeBundle(tcfg, "off",
                                  dict(registry.fingerprint(cpu)))

    def get(params, n, logits=True):
        return bundle.captured(params, B, S + G, logits, n, cpu)

    first = get(tp, 5)
    assert (first.toks.shape, first.logits.shape) == \
        ((B, 5), (B, 5, tcfg.vocab))
    assert get(tp, 3) is first and bundle.captures == 1
    assert get(tp, 7).n_steps == 7 and bundle.captures == 2
    assert get(other, 7) is bundle.step and bundle.captures == 3
    assert get(other, 7, logits=False).logits is None
    assert get(other, 2, logits=False) is bundle.step
    assert bundle.captures == 4
    with pytest.raises(ValueError, match="buffers for 7"):
        bundle.step.run(None, {}, S, 8)


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_generate_silvia_equals_baseline(fmt):
    """The passes change no token and no logit: every packed op is
    integer-exact (w4a8 packs the unpacking's subtractions on the CPU,
    where the GEMM is plain torch ops; see ROADMAP C6)."""
    _, tcfg, _, tp = _setup("bfloat16", fmt)
    prompts = _prompts(tcfg.vocab, seed=5)
    base = _gen(tp, tcfg, prompts, silvia_passes="off")
    registry.reset_dispatch_counts()
    packed = _gen(tp, tcfg, prompts, silvia_passes="all")
    assert torch.equal(base[0], packed[0])
    assert torch.equal(base[1], packed[1])
    # w4a8: two packed subtractions per decode step ran
    assert registry.dispatch_counts()["simd_add"] == \
        (2 * (G - 1) if fmt == "w4a8" else 0)


def test_generate_silvia_matches_reference():
    """The port's packed decode against the reference's fused, packed
    `generate`, by the C2 rule and LOGIT_TOL of tests/test_torch_serve.py
    (the reference's teacher-forced logits come from its unpacked step,
    which its own tests hold equal to the packed one)."""
    jcfg, tcfg, jp, tp = _setup("bfloat16", "w4a8")
    prompts = _prompts(jcfg.vocab, seed=6)
    want = np.asarray(jserve.generate(jp, jnp.asarray(prompts), jcfg, gen=G,
                                      cache_len=S + G, silvia_passes="all",
                                      fused=True))
    ref_logits = _reference_logits(jp, jcfg, prompts, want)
    got, logits = _gen(tp, tcfg, prompts, silvia_passes="all")
    assert got.dtype == torch.int32
    assert_tokens_match(got.numpy(), logits.numpy(), want, ref_logits,
                        LOGIT_TOL["bfloat16"])


def test_decode_cache_info_tracks_generate(monkeypatch):
    """One sequence of calls through both `generate`s, each with its own
    bundle LRU of maxsize 2: hit, miss (new pass set, new cfg, after an
    eviction, under a forced non-default lowering) and evictions move
    alike after every call."""
    a = _setup("bfloat16", "w8a8")
    b = _setup("float32", "w4a8")
    monkeypatch.setattr(jserve, "_DECODE_CACHE", jserve.LRUCache(2))
    monkeypatch.setattr(tserve, "_DECODE_CACHE", tserve.LRUCache(2))
    prompts = _prompts(a[0].vocab)[:2, :4]

    def both(setup, passes, forced=False):
        jcfg, tcfg, jp, tp = setup
        with jregistry.force("cpu-vector") if forced else \
                contextlib.nullcontext():
            jserve.generate(jp, jnp.asarray(prompts), jcfg, gen=2,
                            cache_len=6, silvia_passes=passes)
        with registry.force("hopper-cuda") if forced else \
                contextlib.nullcontext():
            tserve.generate(tp, prompts, tcfg, gen=2, cache_len=6,
                            silvia_passes=passes, device="cpu")
        got = tserve.decode_cache_info()
        assert got == jserve.decode_cache_info()
        return got

    assert both(a, "off") == dict(hits=0, misses=1, evictions=0, size=1,
                                  maxsize=2)
    assert both(a, "off")["hits"] == 1
    assert both(a, "all")["misses"] == 2
    assert both(b, "off")["evictions"] == 1
    assert both(a, "off") == dict(hits=1, misses=4, evictions=2, size=2,
                                  maxsize=2)
    assert both(a, "off", forced=True)["misses"] == 5
    tserve.decode_cache_clear()
    assert tserve.decode_cache_info()["size"] == 0


def test_decode_cache_size_from_env():
    code = ("from repro_torch.launch import serve\n"
            "print(serve.decode_cache_info()['maxsize'])\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_DECODE_CACHE_SIZE="3")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "3"


def test_get_decode_step_traces_once():
    _, tcfg, _, tp = _setup("bfloat16", "w4a8")
    step = tserve.get_decode_step(tcfg, "all", device="cpu")
    step.cache_clear()
    for seed in (1, 2):
        tserve.generate(tp, _prompts(tcfg.vocab, seed), tcfg, gen=4,
                        cache_len=S + 4, silvia_passes="all", device="cpu")
    assert tserve.get_decode_step(tcfg, "all", device="cpu") is step
    info = step.cache_info()
    assert (info["traces"], info["trace_misses"], info["trace_hits"]) == \
        (1, 1, 5)


def _flat_decode(cfg, params, tok, cache, pos):
    """decode_step over a flat list of tensors (the form `core.trace`
    takes), with the leaves it is called on."""
    leaves, spec = pytree.tree_flatten((params, tok, cache, pos))

    def fn(*ts):
        return pytree.tree_leaves(tlm.decode_step(
            *pytree.tree_unflatten(list(ts), spec), cfg))
    return fn, leaves


@pytest.mark.parametrize("fmt,units", [("w8a8", (0, 0)), ("w4a8", (2, 0))])
def test_decode_packed_units_vs_reference(fmt, units):
    """Packed units of the optimized decode step on the same config and
    the same (plain, CPU) lowering, (port, reference).  They differ under
    w4a8: the port packs the plain GEMM's int4 de-bias pair (two units),
    the reference sizes its literal operands as 64 bits and packs none
    (ROADMAP C-ref5; test_torch_silvia.py::
    test_cref5_literal_width_packs_only_in_the_port)."""
    jcfg, tcfg, jp, tp = _setup("bfloat16", fmt)
    prompts = _prompts(jcfg.vocab)[:2, :4]
    _, jcache = jlm.prefill(jp, jnp.asarray(prompts), jcfg, 8)
    closed = jsil.optimized_jaxpr(
        lambda p, t, k, q: jlm.decode_step(p, t, k, q, jcfg), jp,
        jnp.zeros((2, 1), jnp.int32), jcache, jnp.full((2,), 4, jnp.int32))
    _, tcache = tlm.prefill(tp, torch.as_tensor(prompts), tcfg, cache_len=8)
    fn, leaves = _flat_decode(tcfg, tp, torch.zeros((2, 1), dtype=torch.long),
                              tcache, torch.full((2,), 4))
    got = topcount.count_ops(tsil.optimized_graph(fn, *leaves))
    assert (got.packed_units, jopcount.count_ops(closed).packed_units) == \
        units


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_cuda_gemms_trace_as_custom_ops(fmt):
    """One decode layer's seven projections traced with fake CUDA tensors
    (no card needed): the Hopper lowering launches through custom ops
    with fake implementations, so each weight matmul is one opaque node,
    the trace touches no data pointer, and the passes find nothing to
    pack (the unpacking lives inside the kernel).  (The whole step does
    not trace on a CPU-only build: its fake indexing ops want CUDA.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import mlp
    from repro_torch.quant.qtensor import qmatmul
    _, tcfg, _, tp = _setup("bfloat16", fmt)
    layer = tlm.blocks.tree_idx(tp["blocks"], 0)
    with FakeTensorMode(allow_non_fake_inputs=True):
        layer = pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda"),
            layer)
        x = torch.empty((2, 1, tcfg.d_model), dtype=torch.bfloat16,
                        device="cuda")

    def gemms(p, x):
        a = p["attn"]
        h = qmatmul(x, a["wq"]) + qmatmul(x, a["wo"])
        return h, qmatmul(x, a["wk"]), qmatmul(x, a["wv"]), \
            mlp.mlp(p["mlp"], x, tcfg)

    leaves, spec = pytree.tree_flatten((layer, x))
    gm = tsil.optimized_graph(
        lambda *ts: gemms(*pytree.tree_unflatten(list(ts), spec)), *leaves)
    op = getattr(torch.ops.repro_torch,
                 "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul")
    targets = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert targets.count(op.default) == 7
    assert topcount.count_ops(gm).packed_units == 0
