"""The port's self-speculative decoding (`repro_torch/launch/engine.py`
slice 6: `SpecDecodeConfig`, `_SpecRound`, `slot_state.rollback_select`),
case for case with tests/test_spec_decode.py (its mesh case is in
tests/test_torch_sharded_features.py, on a 2 x 2 mesh).

The invariant every case leans on: the emitted tokens are always the
TARGET's under a teacher-forced prefix, so the port's spec streams equal
the port's non-speculative engine bit for bit whatever the draft
proposes; acceptance only changes the tokens per target dispatch.

* dense (reduced smollm, bf16 w8a8) with the `same` draft (the target's
  weights: everything accepted) and a `weak` one (the reference's init
  from another key: almost nothing accepted), k in {1, 2, 4}; ssm
  (reduced mamba2) and hybrid (reduced jamba, one scan unit) with a
  `near` draft (the target with its final norm perturbed: a part of each
  round accepted), so the rollback of the constant-size state selects
  every snapshot index; a generate / score / embed mix.
* The refusals the reference raises, with its messages; chaos at the
  draft and verify sites and a seeded rate schedule, for every family:
  streams equal the fault-free non-spec run's, `replay_divergence == 0`.
* `rollback_select` bit for bit against the reference's function on the
  same state and indices; the port's spec engine against the reference's
  on the same weights and trace (ROADMAP C2's rule on the tokens, the
  `same` draft's round statistics equal).

Weights are the reference's init, converted (tests/test_torch_serve.py,
test_torch_resilience.py), at reduced sizes, one torch thread.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import engine as jengine  # noqa: E402
from repro.launch import resilience as jres  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import slot_state as jslot  # noqa: E402
from repro.quant.qtensor import \
    quantize_tree_for_serving as jquantize_tree  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import resilience as res  # noqa: E402
from repro_torch.launch import scheduler  # noqa: E402
from repro_torch.launch.engine import (ServeEngine,  # noqa: E402
                                       SpecDecodeConfig)
from repro_torch.models import slot_state  # noqa: E402
from test_torch_resilience import family, requests  # noqa: E402
from test_torch_serve import LOGIT_TOL, _setup, _to_numpy  # noqa: E402

SP = scheduler.SamplingParams(temperature=0.8, top_k=6, seed=5)
MIX = (None, SP, scheduler.GREEDY, SP)
_DRAFTS: dict = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weak_dense():
    """(reference params, port params) of reduced smollm from the
    reference's init under another key (the reference's `weak` draft),
    bf16 w8a8."""
    if "weak" not in _DRAFTS:
        jcfg = _setup("bfloat16", "w8a8")[0]
        jp = jquantize_tree(jlm.init_params(jax.random.PRNGKey(9), jcfg,
                                            max_seq=64), "w8a8", force=True)
        _DRAFTS["weak"] = (jp, convert.from_jax_params(_to_numpy(jp),
                                                       device="cpu"))
    return _DRAFTS["weak"]


def near(params, scale=0.3):
    """The target's weights with the final norm's scale perturbed by
    `scale` x N(0, 1) (seeded): a draft that agrees with the target on a
    part of the tokens only."""
    fn = params["final_norm"]["w"]
    g = torch.Generator().manual_seed(9)
    w = fn.float() * (1 + scale * torch.randn(fn.shape, generator=g))
    return dict(params, final_norm=dict(params["final_norm"],
                                        w=w.to(fn.dtype)))


def draft_of(fam, kind):
    cfg, params = family(fam)
    if kind == "same":
        return params
    if kind == "weak" and fam == "dense":
        return weak_dense()[1]
    return near(params)


def engine(cfg, params, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("segment_len", 4)
    kw.setdefault("chaos", None)
    return ServeEngine(params, cfg, device="cpu", **kw)


def sd(params, cfg, k=3):
    return SpecDecodeConfig(draft_params=params, draft_cfg=cfg, k=k)


def run(eng, reqs):
    return eng.run(reqs, clock=scheduler.FastForwardClock())


def trace(cfg, n=6, stagger=0.0):
    return requests(cfg, n=n, stagger=stagger, mix=MIX)


def assert_same(want, got):
    assert set(want) == set(got)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))


_REFS: dict = {}


def nonspec(fam, n=6):
    """The non-speculative engine's streams of `trace(cfg, n)`."""
    if (fam, n) not in _REFS:
        cfg, params = family(fam)
        _REFS[fam, n] = run(engine(cfg, params), trace(cfg, n))
    return _REFS[fam, n]


# ---------------------------------------------------------------------------
# stream identity, acceptance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam,kind", [("dense", "same"), ("dense", "weak"),
                                      ("ssm", "same"), ("ssm", "near"),
                                      ("hybrid", "same"),
                                      ("hybrid", "near")])
def test_spec_streams_equal_nonspec(fam, kind):
    cfg, params = family(fam)
    eng = engine(cfg, params, spec_decode=sd(draft_of(fam, kind), cfg))
    assert_same(nonspec(fam), run(eng, trace(cfg)))
    info = eng.cache_info()
    s = info["spec_decode"]
    assert s["rounds"] == s["target_dispatches"] > 0 and s["k"] == 3
    assert s["emitted"] == sum(len(r) for r in nonspec(fam).values()) \
        - len(nonspec(fam))       # the first tokens come from prefill
    if kind == "same":
        assert s["acceptance_rate"] == 1.0
        assert s["tokens_per_dispatch"] > 1.3
    else:
        assert s["acceptance_rate"] < 1.0       # the rollback path ran
    if kind == "near":
        # a part of the rounds accepted a part: middle snapshots selected
        assert 0.1 < s["acceptance_rate"] < 0.9
    rollback = any(key[0] == "rollback" for key in info["graph_keys"])
    assert rollback == (fam != "dense")
    assert not any(key[0] == "segment" for key in info["graph_keys"])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_k_is_stream_invariant(k):
    cfg, params = family("dense")
    eng = engine(cfg, params, spec_decode=sd(weak_dense()[1], cfg, k=k))
    assert_same(nonspec("dense", 4), run(eng, trace(cfg, 4)))
    assert eng.cache_info()["spec_decode"]["k"] == k


@pytest.mark.parametrize("k", [1, 4])
def test_k_with_constant_size_state(k):
    cfg, params = family("ssm")
    eng = engine(cfg, params, spec_decode=sd(near(params), cfg, k=k))
    assert_same(nonspec("ssm", 4), run(eng, trace(cfg, 4)))


def test_methods_and_stop_tokens_on_a_spec_engine():
    """score and embed requests beside generate ones, staggered arrivals
    and a stop token: a score completion drains through the replay step
    with the draft in lockstep; every result equals the non-spec run's."""
    cfg, params = family("ssm")
    methods_ = ("generate", "score", "embed", "generate", "score",
                "generate")

    def reqs():
        out = requests(cfg, n=6, stagger=0.01, methods_=methods_, mix=MIX)
        out[0].stop_tokens = (int(want0[3]),)
        return out

    want0 = run(engine(cfg, params), requests(cfg, n=1))[0]
    base = engine(cfg, params)
    run(base, reqs())
    eng = engine(cfg, params, spec_decode=sd(near(params), cfg))
    run(eng, reqs())
    want, got = base.results(), eng.results()
    assert set(want) == set(got)
    for rid, w in want.items():
        g = got[rid]
        assert (g.outcome, g.tokens, g.logprobs) == \
            (w.outcome, w.tokens, w.logprobs), rid
        assert (w.embedding is None) == (g.embedding is None)
        if w.embedding is not None:
            assert np.array_equal(w.embedding, g.embedding), rid
    assert len(got[0].tokens) == 4           # stopped at its stop token
    assert eng.replay_steps > 0 and eng.cache_info()["dispatch_sites"][
        "draft"] > eng.cache_info()["spec_decode"]["rounds"]


def test_warmup_bounds_the_round_grid():
    cfg, params = family("hybrid")
    eng = engine(cfg, params, spec_decode=sd(near(params), cfg),
                 chaos=res.ChaosSchedule(fail_at_sites=("verify:1",)))
    n = eng.warmup(prompt_lens=sorted({r.prompt_len for r in trace(cfg)}))
    warmed = set(eng._graphs)
    assert n == len(warmed) <= eng.graph_bound()
    assert {k[0] for k in warmed} == {"draft", "verify", "rollback",
                                      "chunk", "dchunk", "prefill",
                                      "dprefill"}
    assert_same(nonspec("hybrid"), run(eng, trace(cfg)))
    assert eng._graphs == warmed
    assert eng.cache_info()["robustness"]["faults_injected"] == 1


@pytest.mark.parametrize("fam,warm", [("dense", True), ("ssm", False)])
def test_captured_rounds_leave_the_state(fam, warm, monkeypatch):
    """The card's capture path on the CPU: each of a round's steps is
    'captured' as serve.capture does it -- one eager call on whatever
    the buffers hold, every row inactive, then replays -- for every
    bucket at warmup or at first use mid-run.  The captures must leave
    both slot states and the positions as they were, and keep the step
    indices inside the buffers, so the streams still equal the non-spec
    engine's."""
    import types

    from repro_torch.launch import engine as tengine

    class Graph:
        def __init__(self, fn):
            self.replay = fn

    def capture(step, device):
        step()                                  # the eager call
        return Graph(step), None, 0.0
    monkeypatch.setattr(tengine.serve, "capture", capture)
    init = tengine._SpecRound.__init__

    def as_cuda(self, *a, **kw):
        init(self, *a[:-1], types.SimpleNamespace(type="cuda"), **kw)
    monkeypatch.setattr(tengine._SpecRound, "__init__", as_cuda)
    cfg, params = family(fam)
    eng = engine(cfg, params, spec_decode=sd(draft_of(fam, "near"), cfg))
    if warm:
        eng.warmup(prompt_lens=sorted({r.prompt_len for r in trace(cfg)}))
        assert len(eng._rounds) == len(eng.batch_buckets) * max(
            1, len(eng.len_buckets))
    assert_same(nonspec(fam), run(eng, trace(cfg)))
    assert eng.cache_info()["captured"] == sum(
        len(r.graphs) for r in eng._rounds.values()) > 0


# ---------------------------------------------------------------------------
# refusals (moved here from test_torch_engine.py: spec_decode is ported)
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_spec_decode_config_validation():
    """What the reference refuses, refused with its message."""
    jcfg, cfg, jp, params = _setup("bfloat16", "w8a8")
    assert _message(lambda: SpecDecodeConfig(params, cfg, k=0)) == \
        _message(lambda: jengine.SpecDecodeConfig(jp, jcfg, k=0))
    enc = tconfigs.get_reduced_config("whisper-small")
    jenc = jconfigs.get_reduced_config("whisper-small")
    ssm = tconfigs.get_reduced_config("mamba2-2.7b")
    jssm = jconfigs.get_reduced_config("mamba2-2.7b")
    small_vocab = dataclasses.replace(cfg, vocab=cfg.vocab // 2)
    jsmall_vocab = dataclasses.replace(jcfg, vocab=jcfg.vocab // 2)
    cases = [
        (dict(cfg_=enc, enc_len=16), dict(cfg_=jenc, enc_len=16),
         "encdec"),
        (dict(draft_cfg=ssm), dict(draft_cfg=jssm), "SAME family"),
        (dict(draft_cfg=small_vocab), dict(draft_cfg=jsmall_vocab),
         "vocab"),
        (dict(prefix_cache=64), dict(prefix_cache=64), "full-prefill"),
        (dict(prefill_chunk=4), dict(prefill_chunk=4), "full-prefill"),
    ]

    def make(pkg_engine, pkg_sd, tcfg, tparams, kw):
        kw = dict(kw)
        c = kw.pop("cfg_", tcfg)
        d = kw.pop("draft_cfg", tcfg)
        extra = {"device": "cpu"} if pkg_engine is ServeEngine else {}
        return lambda: pkg_engine(tparams, c, n_slots=4, max_cache_len=64,
                                  segment_len=4, chaos=None,
                                  spec_decode=pkg_sd(tparams, d, 3),
                                  **kw, **extra)

    for kw, jkw, word in cases:
        got = _message(make(ServeEngine, SpecDecodeConfig, cfg, params, kw))
        want = _message(make(jengine.ServeEngine, jengine.SpecDecodeConfig,
                             jcfg, jp, jkw))
        assert got == want and word in got, (got, want)


def test_chaos_sites_of_a_spec_engine(monkeypatch):
    """draft / verify sites parse in both packages to the same schedule,
    the port's engine counts them, a bad site is refused with the
    reference's message, and a device-loss arm names elastic serving
    (ROADMAP A11)."""
    spec = "draft:1;verify:2,rate=0.1,seed=3"
    assert res.ChaosSchedule.parse(spec).fail_at_sites == \
        jres.ChaosSchedule.parse(spec).fail_at_sites == ("draft:1",
                                                         "verify:2")
    assert _message(lambda: res.ChaosSchedule.parse("rollback:1")) == \
        _message(lambda: jres.ChaosSchedule.parse("rollback:1"))
    cfg, params = family("dense")
    monkeypatch.setenv("REPRO_CHAOS", "draft:1;verify:2")
    eng = engine(cfg, params, spec_decode=sd(weak_dense()[1], cfg),
                 chaos="env")
    assert_same(nonspec("dense"), run(eng, trace(cfg)))
    info = eng.cache_info()
    assert sorted(info["resilience"]["chaos"]["fired"]) == ["draft:1",
                                                            "verify:2"]
    assert info["dispatch_sites"]["verify"] > 2
    monkeypatch.setenv("REPRO_CHAOS", "draft:1;lose@verify:2")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        engine(cfg, params, spec_decode=sd(params, cfg), chaos="env")


# ---------------------------------------------------------------------------
# chaos + replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", ["dense", "ssm", "hybrid"])
def test_chaos_on_spec_sites_replays_bit_exact(fam):
    """Faults at the draft and verify sites: recovery replays through the
    replay step with the draft in lockstep, and the streams equal the
    fault-free non-spec run's."""
    cfg, params = family(fam)
    chaos = res.ChaosSchedule(fail_at_sites=("draft:1", "verify:2"))
    eng = engine(cfg, params, spec_decode=sd(draft_of(fam, "weak"), cfg),
                 chaos=chaos)
    assert_same(nonspec(fam), run(eng, trace(cfg)))
    rb = eng.cache_info()["robustness"]
    assert rb["faults_injected"] == rb["recoveries"] == 2
    assert rb["replay_divergence"] == 0 and rb["replayed_tokens"] > 0


def test_chaos_rate_schedule_spec_bit_exact():
    cfg, params = family("dense")
    chaos = res.ChaosSchedule(rate=0.5, seed=7, max_failures=4)
    eng = engine(cfg, params, spec_decode=sd(params, cfg), chaos=chaos)
    assert_same(nonspec("dense"), run(eng, trace(cfg)))
    rb = eng.cache_info()["robustness"]
    assert rb["replay_divergence"] == 0
    assert rb["faults_injected"] == len(chaos.failed) > 0


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", ["dense", "ssm", "hybrid"])
def test_rollback_select_matches_reference(fam):
    """The port's in-place rollback_select against the reference's on the
    same numpy state, snapshots and indices, bit for bit (the two trees
    hold the same leaves under the same names, {k, v, ssm, conv}, though
    the reference nests the hybrid family's); length-axis leaves and
    inactive rows untouched."""
    cfg, _ = family(fam)
    arch = {"dense": "smollm-135m", "ssm": "mamba2-2.7b",
            "hybrid": "jamba-v0.1-52b"}[fam]
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch),
                               n_layers=cfg.n_layers, dtype=cfg.dtype)
    spec, jspec = slot_state.spec_for(cfg), jslot.spec_for(jcfg)
    rng = np.random.default_rng(3)
    n, k1 = 4, 3
    state = spec.init_state(n, 16)
    old, snaps = {}, {}
    for name, leaf, ba, la in zip(state, state.values(), spec.batch_axes,
                                  spec.length_axes):
        leaf.copy_(torch.as_tensor(rng.standard_normal(leaf.shape)))
        old[name] = leaf.clone()
        if la is None:
            snaps[name] = torch.as_tensor(
                rng.standard_normal((k1,) + tuple(leaf.shape)),
                dtype=leaf.dtype)
    idx = np.array([2, 0, 1, 2])
    active = np.array([True, True, False, True])

    def to_jax(t):      # exact: every value is one of t's dtype
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype)

    jstate = jax.tree_util.tree_map_with_path(
        lambda path, _: to_jax(old[path[-1].key]), jspec.init_state(n, 16))
    named = jax.tree_util.tree_flatten_with_path(jstate)[0]
    jsnaps = [to_jax(snaps[path[-1].key])
              for (path, _), la in zip(named, jspec.length_axes)
              if la is None]
    want = {path[-1].key: np.asarray(x, np.float32) for path, x in
            jax.tree_util.tree_flatten_with_path(jspec.rollback_select(
                jstate, jsnaps, jnp.asarray(idx)))[0]}
    spec.rollback_select(state, [snaps[k] for k in state if k in snaps],
                         torch.as_tensor(idx), torch.as_tensor(active))
    assert set(want) == set(state) and bool(snaps) == (fam != "dense")
    for name, ba in zip(state, spec.batch_axes):
        for row in range(n):
            # the reference restores every row; an inactive row keeps
            # its own state here (its snapshots equal it in a real round)
            w = old[name].select(ba, row).float().numpy() \
                if not active[row] else np.take(want[name], row, axis=ba)
            np.testing.assert_array_equal(
                state[name].select(ba, row).float().numpy(), w,
                err_msg=name)


def c2_tokens(jcfg, jp, reqs, want, got):
    """ROADMAP C2's rule per request while the streams agree: the port's
    token equals the reference's where the reference's teacher-forced
    top-two margin exceeds 2 x LOGIT_TOL, and scores within LOGIT_TOL of
    its max elsewhere.  Returns (tokens compared, the rids whose streams
    agree whole)."""
    prefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
    decode = jax.jit(jlm.decode_step, static_argnums=(4,))
    tol, compared, agree = LOGIT_TOL["bfloat16"], 0, set()
    for r in reqs:
        w, g = np.asarray(want[r.rid]), np.asarray(got[r.rid])
        assert len(w) == len(g) == r.max_new_tokens
        lg, c = prefill(jp, jnp.asarray(r.prompt[None]), jcfg,
                        r.prompt_len + len(w))
        for t in range(len(w)):
            if t:
                lg, c = decode(jp, jnp.asarray([[w[t - 1]]], jnp.int32), c,
                               jnp.asarray([r.prompt_len + t - 1],
                                           jnp.int32), jcfg)
            ref = np.asarray(lg[0, -1], np.float32)
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > 2 * tol:
                assert g[t] == w[t], (r.rid, t)
                compared += 1
            else:
                assert ref[g[t]] >= ref.max() - tol, (r.rid, t)
            if g[t] != w[t]:
                break
        else:
            agree.add(r.rid)
    return compared, agree


@pytest.mark.parametrize("kind", ["same", "weak"])
def test_spec_matches_reference_engine(kind):
    """The same greedy trace through both packages' spec engines on the
    same weights (bf16 w8a8): tokens by C2's rule.  With the `same` draft
    both accept every draft, so the rounds depend on the streams' lengths
    only (no stop token here) and their statistics are equal, including
    where a stream parts at a near-tie."""
    jcfg, cfg, jp, params = _setup("bfloat16", "w8a8")
    jd, td = (jp, params) if kind == "same" else weak_dense()
    kw = dict(seed=3, n_requests=5, rate=50.0, prompt_lens=(5, 9, 14),
              gen_lens=(4, 7), vocab=cfg.vocab)
    jeng = jengine.ServeEngine(jp, jcfg, n_slots=2, max_cache_len=64,
                               segment_len=4, chaos=None,
                               spec_decode=jengine.SpecDecodeConfig(
                                   jd, jcfg, 3))
    want = jeng.run(jsched.synthetic_traffic(**kw),
                    clock=jsched.FastForwardClock())
    reqs = scheduler.synthetic_traffic(**kw)
    eng = engine(cfg, params, n_slots=2, spec_decode=sd(td, cfg))
    got = run(eng, reqs)
    compared, agree = c2_tokens(jcfg, jp, reqs, want, got)
    assert compared > 0
    stats = ("rounds", "drafted", "accepted", "emitted",
             "target_dispatches")
    ws, gs = jeng.cache_info()["spec_decode"], \
        eng.cache_info()["spec_decode"]
    assert agree           # at least one stream agrees whole
    if kind == "same":
        assert {k: gs[k] for k in stats} == {k: ws[k] for k in stats}
    assert gs["acceptance_rate"] == 1.0 if kind == "same" else \
        gs["acceptance_rate"] < 1.0
