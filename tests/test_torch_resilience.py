"""The port's fault injection and recovery (`repro_torch/launch/engine.py`
slice 5, `launch/resilience.py`, `checkpoint/ckpt.py`,
`distributed/fault.py`), unit for unit with tests/test_resilience.py
(its elastic mesh test aside: elastic serving's are in
tests/test_torch_elastic.py; the `RestartPolicy` tests are in
tests/test_torch_train.py).

* Faults at segment, prefill, chunk and embed sites mid-traffic: every
  stream (tokens, a score request's logprobs, an embedding) equals the
  fault-free run's, bit for bit, with `replay_divergence == 0`, for
  dense, ssm, hybrid and encdec; under `silvia_passes="all"`, chunked
  prefill and a seeded rate schedule too.  Recovery resets the slot
  state and the device buffers in place (no tensor reallocated, every
  step kept).
* The recovery budget runs out into FAILED; a duplicate rid is refused;
  the loop survives an unexpected error, counted in `errors`; drain
  finishes in-flight requests and keeps queued ones; snapshot / restore
  resumes bit-exactly and keeps every request field; the counters are
  reported; warmup bounds the graphs under chaos.
* `ChaosSchedule.parse` and `chaos_from_env`; the same spec fires the
  same sites in both packages; a snapshot written by either package
  restores in the other with identical fields (dict leaves flatten in
  sorted key order in both), bf16 leaves included.

Weights are the reference's init, converted (the ssm, hybrid and encdec
ones perturbed, as their own test modules do), at reduced sizes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.launch import resilience as jres  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.distributed.fault import (FailureInjector,  # noqa: E402
                                           SimulatedFailure)
from repro_torch.launch import resilience as res  # noqa: E402
from repro_torch.launch import scheduler  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from test_torch_encdec import params_for as encdec_params  # noqa: E402
from test_torch_hybrid import params_for as hybrid_params  # noqa: E402
from test_torch_serve import _setup  # noqa: E402
from test_torch_ssm import params_for as ssm_params  # noqa: E402

FAMILIES = ("dense", "encdec", "hybrid", "ssm")
ENC_LEN = 16
SP = scheduler.SamplingParams(temperature=0.9, top_k=8, seed=11)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family(fam):
    """(port cfg, port params) of a reduced model of `fam`: smollm (bf16
    w8a8), mamba2 and jamba (float32 w8a8, one scan unit), whisper (bf16
    w8a8)."""
    if fam == "dense":
        return _setup("bfloat16", "w8a8")[1::2]
    if fam == "encdec":
        cfg = dataclasses.replace(
            tconfigs.get_reduced_config("whisper-small"), dtype="bfloat16")
        return cfg, encdec_params("bfloat16", "w8a8")[1]
    arch = {"ssm": "mamba2-2.7b", "hybrid": "jamba-v0.1-52b"}[fam]
    cfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                              dtype="float32")
    if fam == "hybrid":
        return dataclasses.replace(cfg, n_layers=8), \
            hybrid_params("float32", "w8a8")[1]
    return cfg, ssm_params("float32", "w8a8")[1]


def _features(cfg, i):
    rng = np.random.default_rng(100 + i)
    frames = (ENC_LEN, 5, 11, 16, 1, 9, 13, 7)[i % 8]
    return rng.standard_normal((frames, cfg.d_model)).astype(np.float32)


def requests(cfg, n=6, stagger=0.0, gens=None, methods_=None, mix=(None,),
             sched=scheduler):
    """n requests of prompts 5-16 tokens: generate by default, or the
    method `methods_[i]` (score: a completion of 2-5 tokens; embed), with
    the sampling policies of `mix` in turn on the generate ones; encdec
    requests carry ragged features."""
    plens = (5, 12, 9, 16, 7, 11, 6, 14)
    gens = gens or (8, 6, 9, 5, 10, 7, 8, 6)
    out = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        m = (methods_ or ("generate",) * n)[i]
        kw = {}
        if cfg.family == "encdec":
            kw["features"] = _features(cfg, i)
        if m == "score":
            kw["score_tokens"] = rng.integers(0, cfg.vocab,
                                              2 + i % 4).tolist()
        elif m == "generate":
            kw["sampling"] = mix[i % len(mix)]
        out.append(sched.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, plens[i % 8])
            .astype(np.int32), max_new_tokens=gens[i % 8],
            arrival_time=stagger * i, method=m, **kw))
    return out


def engine(cfg, params, **kw):
    if cfg.family == "encdec":
        kw.setdefault("enc_len", ENC_LEN)
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("segment_len", 4)
    return ServeEngine(params, cfg, device="cpu", **kw)


def run(eng, reqs):
    eng.run(reqs, clock=scheduler.FastForwardClock())
    return eng.results()


def assert_same_results(want, got):
    """Every result's outcome, tokens, logprobs and embedding, bit for
    bit."""
    assert set(want) == set(got)
    for rid, w in want.items():
        g = got[rid]
        assert (g.outcome, g.tokens, g.logprobs) == \
            (w.outcome, w.tokens, w.logprobs), rid
        assert (g.embedding is None) == (w.embedding is None), rid
        if w.embedding is not None:
            np.testing.assert_array_equal(g.embedding, w.embedding)


MIXED = ("generate", "score", "generate", "embed", "generate", "score")


# ---------------------------------------------------------------------------
# chaos recovery: bit-exact surviving streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_chaos_recovery_bit_exact(fam):
    """Faults at prefill, segment, replay (chunk) and embed sites
    mid-traffic: every result equals the fault-free run's, and the
    engine's own replay check agrees (zero divergence)."""
    cfg, params = family(fam)
    mix = (None, SP)
    want = run(engine(cfg, params, chaos=None),
               requests(cfg, methods_=MIXED, mix=mix))
    chaos = res.ChaosSchedule(fail_at_sites=(
        "prefill:0", "segment:2", "chunk:1", "embed:0", "segment:5"))
    eng = engine(cfg, params, chaos=chaos)
    got = run(eng, requests(cfg, methods_=MIXED, mix=mix))
    rb = eng.cache_info()["robustness"]
    assert {"prefill:0", "segment:2", "chunk:1", "embed:0"} <= chaos.failed
    assert rb["faults_injected"] == len(chaos.failed) >= 4
    assert rb["recoveries"] == rb["faults_injected"] and rb["errors"] == 0
    assert rb["replay_divergence"] == 0 and rb["replayed_tokens"] > 0
    assert all(r.outcome == res.OK for r in got.values())
    assert_same_results(want, got)


def test_chaos_recovery_bit_exact_silvia_all():
    cfg, params = family("dense")
    want = run(engine(cfg, params, silvia_passes="all", chaos=None),
               requests(cfg))
    chaos = res.ChaosSchedule(fail_at_sites=("segment:1", "segment:4"))
    eng = engine(cfg, params, silvia_passes="all", chaos=chaos)
    got = run(eng, requests(cfg))
    assert eng.cache_info()["robustness"]["replay_divergence"] == 0
    assert_same_results(want, got)


@pytest.mark.parametrize("prefix", [None, 64])
def test_chaos_recovery_bit_exact_chunked_prefill(prefix):
    """Chunk-site faults (chunked prefill launches) recover too, with the
    prefix cache's pins released and re-taken."""
    cfg, params = family("dense")
    kw = dict(prefill_chunk=4, prefix_cache=prefix)
    reqs = lambda: requests(cfg, methods_=MIXED)  # noqa: E731
    want = run(engine(cfg, params, chaos=None, **kw), reqs())
    chaos = res.ChaosSchedule(fail_at_sites=("chunk:1", "segment:3"))
    eng = engine(cfg, params, chaos=chaos, **kw)
    got = run(eng, reqs())
    assert "chunk:1" in chaos.failed
    assert eng.cache_info()["robustness"]["replay_divergence"] == 0
    assert_same_results(want, got)
    if prefix is not None:
        assert not any(eng._slot_pins) and not eng._admit_pins
        assert eng.cache_info()["prefix_cache"]["pages_pinned"] == 0


def test_chaos_at_prefill_releases_pinned_prefix_pages():
    """A full-prefill prefix-cache engine whose admission group holds a
    terminal hit (its pooled pages pinned) and a miss, the miss's
    prefill failing: the hit's pins are released with the recovery, and
    the streams are the fault-free run's."""
    cfg, params = family("dense")
    first = requests(cfg, n=2)
    later = [dataclasses.replace(first[0], rid=5, arrival_time=1.0,
                                 tokens=[]),
             dataclasses.replace(first[1], rid=6, arrival_time=1.0,
                                 tokens=[], prompt=first[1].prompt[::-1])]
    for r in later:                 # one admission group (prompt bucket 16)
        r.prompt = np.resize(r.prompt, 12)
    first[0].prompt = later[0].prompt.copy()

    def reqs():
        return [dataclasses.replace(r, tokens=[]) for r in first + later]

    want = run(engine(cfg, params, chaos=None, prefix_cache=64), reqs())
    chaos = res.ChaosSchedule(fail_at_sites=("prefill:1",))
    eng = engine(cfg, params, chaos=chaos, prefix_cache=64)
    got = run(eng, reqs())
    assert chaos.failed == {"prefill:1"}
    pc = eng.cache_info()["prefix_cache"]
    assert pc["hits"] >= 2 and pc["pages_pinned"] == 0
    assert not eng._admit_pins and not any(eng._slot_pins)
    assert_same_results(want, got)


def test_chaos_rate_schedule_bit_exact():
    """Deterministic seeded-rate chaos (the $REPRO_CHAOS form): whatever
    fires, surviving streams stay bit-identical."""
    cfg, params = family("dense")
    want = run(engine(cfg, params, chaos=None),
               requests(cfg, methods_=MIXED))
    chaos = res.ChaosSchedule(rate=0.5, seed=7, max_failures=4)
    eng = engine(cfg, params, chaos=chaos)
    got = run(eng, requests(cfg, methods_=MIXED))
    rb = eng.cache_info()["robustness"]
    assert rb["faults_injected"] >= 1
    assert rb["replay_divergence"] == 0
    assert_same_results(want, got)


def test_recovery_resets_state_in_place():
    """Recovery refills the slot state and zeroes the device buffers in
    place: every tensor keeps its storage, every step object is kept,
    and the state is the init state again."""
    cfg, params = family("dense")
    eng = engine(cfg, params, chaos=None)
    eng.warmup(prompt_lens=[5, 12], methods=("generate", "score"))
    ptrs = [t.data_ptr() for t in (list(eng._cache.values())
                                   + tree_leaves(eng._bufs))]
    steps = dict(eng._segments), dict(eng._replays)
    clock = scheduler.FastForwardClock()
    for r in requests(cfg, n=4):
        eng.submit(r)
    eng.step(clock)
    assert eng.n_active and any(t.any() for t in eng._cache.values())
    eng._recover(SimulatedFailure("drill"), clock.now())
    assert [t.data_ptr() for t in (list(eng._cache.values())
            + tree_leaves(eng._bufs))] == ptrs
    assert (dict(eng._segments), dict(eng._replays)) == steps
    assert not any(t.any() for t in eng._cache.values())
    assert not any(t.any() for t in tree_leaves(eng._bufs))
    assert eng.n_active == 0 and eng.n_queued == 4 - len(eng.finished) > 0
    assert all(r.retries == 1 for r in eng._queue.pending())


def test_recovery_budget_exhaustion():
    """A request that keeps riding recoveries past max_recoveries ends
    FAILED (structured), and the engine still finishes."""
    cfg, params = family("dense")
    chaos = res.ChaosSchedule(fail_at_sites=tuple(
        f"segment:{i}" for i in range(8)))
    eng = engine(cfg, params,
                 resilience=res.ResilienceConfig(max_recoveries=1),
                 chaos=chaos)
    run(eng, requests(cfg, n=2, gens=(12, 12)))
    failed = [r for r in eng.finished if r.outcome == res.FAILED]
    assert failed and all("recovery budget" in r.error for r in failed)
    assert all(r.retries > 1 for r in failed)
    assert eng.cache_info()["robustness"]["failed"] == len(failed)


def test_duplicate_rid_rejected():
    cfg, params = family("dense")
    eng = engine(cfg, params, chaos=None)
    reqs = requests(cfg, n=2)
    assert eng.submit(reqs[0]) == res.QUEUED
    dup = scheduler.Request(rid=reqs[0].rid, prompt=[1, 2, 3],
                            max_new_tokens=2)
    with pytest.raises(ValueError, match="duplicate request id"):
        eng.submit(dup)
    assert eng.cache_info()["robustness"]["duplicate_rejects"] == 1
    assert eng.n_queued == 1


def test_engine_loop_survives_unexpected_error():
    """A real (not injected) launch failure recovers too: its requests
    are requeued and replayed, and it is counted under `errors`."""
    cfg, params = family("dense")
    want = run(engine(cfg, params, chaos=None), requests(cfg, n=2))
    eng = engine(cfg, params, chaos=None)
    calls, real = {"n": 0}, eng._segment_step

    class Boom(RuntimeError):
        pass

    class Broken:
        def replay(self, n_steps):
            raise Boom("transient device error")

    def flaky(bb, t_b):
        calls["n"] += 1
        return Broken() if calls["n"] == 2 else real(bb, t_b)

    eng._segment_step = flaky
    got = run(eng, requests(cfg, n=2))
    rb = eng.cache_info()["robustness"]
    assert rb["errors"] == 1 and rb["faults_injected"] == 0
    assert rb["recoveries"] == 1 and rb["replay_divergence"] == 0
    assert calls["n"] > 2            # the loop went on past the failure
    assert_same_results(want, got)


# ---------------------------------------------------------------------------
# drain + snapshot / restore
# ---------------------------------------------------------------------------

def test_drain_finishes_inflight_keeps_queued():
    cfg, params = family("dense")
    eng = engine(cfg, params, chaos=None, n_slots=2)
    clock = scheduler.FastForwardClock()
    for r in requests(cfg, n=4):
        eng.submit(r)
    eng.step(clock)                      # 2 in flight, 2 queued
    assert eng.n_active == 2 and eng.n_queued == 2
    eng.drain(clock)
    assert eng.n_active == 0 and eng.n_queued == 2
    assert len(eng.finished) == 2
    assert eng.cache_info()["robustness"]["drains"] == 1


@pytest.mark.parametrize("fam", ["dense", "ssm"])
def test_snapshot_restore_resumes_bit_exact(fam, tmp_path):
    """Rolling restart: snapshot mid-flight (partial tokens in slots, a
    sampled request, a score request queued), restore into a FRESH
    engine, finish: the union equals the uninterrupted run bit for bit
    (device state is never serialized; restore replays)."""
    cfg, params = family(fam)
    kinds = ("generate", "generate", "score", "generate")
    reqs = lambda: requests(cfg, n=4, methods_=kinds,  # noqa: E731
                            mix=(None, SP))
    want = run(engine(cfg, params, chaos=None, n_slots=2), reqs())
    eng = engine(cfg, params, chaos=None, n_slots=2)
    clock = scheduler.FastForwardClock()
    for r in reqs():
        eng.submit(r)
    eng.step(clock)                      # partial progress
    assert any(r is not None and r.tokens for r in eng._slot_req)
    eng.snapshot(str(tmp_path), step=1)
    done = eng.results()
    eng2 = engine(cfg, params, chaos=None, n_slots=2)
    assert eng2.restore(str(tmp_path)) + len(done) == 4
    got = {**done, **run(eng2, [])}
    assert_same_results(want, got)
    rb = eng2.cache_info()["robustness"]
    assert rb["restores"] == 1 and rb["replay_divergence"] == 0
    assert eng.cache_info()["robustness"]["snapshots"] == 1
    with pytest.raises(ValueError, match="already tracked"):
        eng2.restore(str(tmp_path))


def test_snapshot_roundtrip_preserves_request_fields(tmp_path):
    reqs = [scheduler.Request(rid=5, prompt=[1, 2, 3], max_new_tokens=9,
                              arrival_time=1.5, stop_tokens=(7,),
                              deadline=4.0, sampling=SP),
            scheduler.Request(rid=6, prompt=[4, 5], max_new_tokens=1,
                              method="score", score_tokens=(8, 9, 10),
                              features=np.ones((3, 4), np.float32)),
            scheduler.Request(rid=7, prompt=[6], max_new_tokens=1,
                              method="embed")]
    reqs[0].tokens = [11, 12]
    reqs[0].retries = 2
    res.snapshot_requests(str(tmp_path), 0, reqs)
    back = res.restore_requests(str(tmp_path))
    assert [_fields(r) for r in back] == [_fields(r) for r in reqs]
    assert res.restore_requests(str(tmp_path / "empty")) == []


def _fields(r) -> tuple:
    """Every field a snapshot carries, comparable across packages."""
    sp = None if r.sampling is None else dataclasses.astuple(r.sampling)
    return (r.rid, np.asarray(r.prompt).tolist(), r.max_new_tokens,
            r.arrival_time, r.stop_tokens, r.deadline, r.method,
            r.score_tokens, sp, list(r.tokens), r.retries,
            None if r.features is None
            else np.asarray(r.features).tolist())


# ---------------------------------------------------------------------------
# observability: counters + warm census under chaos
# ---------------------------------------------------------------------------

def test_robustness_counters_reported():
    cfg, params = family("dense")
    info = engine(cfg, params, chaos=None).cache_info()
    assert set(info["robustness"]) >= {
        "shed", "expired_queued", "expired_inflight", "failed",
        "quarantined", "faults_injected", "errors", "recoveries",
        "replayed_tokens", "replay_divergence", "duplicate_rejects",
        "snapshots", "restores", "drains"}
    assert info["resilience"]["chaos"] is None
    assert info["resilience"]["shed_policy"] == "reject-new"
    assert info["resilience"]["max_recoveries"] == 8
    chaos = res.ChaosSchedule.parse("segment:1,rate=0.1,seed=3")
    info = engine(cfg, params, chaos=chaos).cache_info()["resilience"]
    assert info["chaos"] == {"sites": ["segment:1"], "rate": 0.1, "seed": 3,
                             "max_failures": None, "fired": []}


def test_warmup_bounds_graphs_under_chaos():
    """A chaos-armed engine's warmup captures the replay grid too: after
    a faulty run no graph key falls outside the warmed set, and the
    census stays within graph_bound()."""
    cfg, params = family("dense")
    chaos = res.ChaosSchedule(fail_at_sites=("segment:1", "segment:3"))
    eng = engine(cfg, params, chaos=chaos)
    reqs = requests(cfg)
    eng.warmup(prompt_lens=sorted({r.prompt_len for r in reqs}))
    warmed = set(eng._graphs)
    assert any(k[0] == "chunk" and k[2] == 1 for k in warmed)
    run(eng, reqs)
    assert eng.cache_info()["robustness"]["faults_injected"] == 2
    assert eng._graphs == warmed
    assert len(eng._graphs) <= eng.graph_bound()


# ---------------------------------------------------------------------------
# units: ChaosSchedule parsing, the env, the two packages' schedules
# ---------------------------------------------------------------------------

def test_chaos_schedule_parse():
    cs = res.ChaosSchedule.parse("segment:1;prefill:0,rate=0.25,seed=3,max=2")
    assert cs.fail_at_sites == ("segment:1", "prefill:0")
    assert (cs.rate, cs.seed, cs.max_failures) == (0.25, 3, 2)
    with pytest.raises(ValueError, match="bad site"):
        res.ChaosSchedule.parse("decode:1")
    with pytest.raises(ValueError, match="unknown key"):
        res.ChaosSchedule.parse("pace=0.5")
    with pytest.raises(SimulatedFailure):
        res.ChaosSchedule.parse("chunk:0").check_site("chunk:0")
    cs2 = res.ChaosSchedule.parse("embed:0")       # fires at most once
    with pytest.raises(SimulatedFailure):
        cs2.check_site("embed:0")
    cs2.check_site("embed:0")
    cs3 = res.ChaosSchedule(rate=1.0, max_failures=1)
    with pytest.raises(SimulatedFailure):
        cs3.check_site("segment:0")
    cs3.check_site("segment:1")
    inj = FailureInjector(fail_at_steps=(3,), fail_at_sites=("prefill:1",))
    with pytest.raises(SimulatedFailure):
        inj.check(3)
    inj.check(3)
    with pytest.raises(SimulatedFailure):
        inj.check_site("prefill:1")
    assert inj.failed == {3, "prefill:1"}


def test_chaos_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    assert res.chaos_from_env() is None
    monkeypatch.setenv("REPRO_CHAOS", "rate=0.1,seed=2")
    cs = res.chaos_from_env()
    assert cs.rate == 0.1 and cs.seed == 2
    cfg, params = family("dense")
    monkeypatch.setenv("REPRO_CHAOS", "segment:0")
    eng = engine(cfg, params)               # chaos="env", the default
    want = run(engine(cfg, params, chaos=None), requests(cfg, n=2))
    assert_same_results(want, run(eng, requests(cfg, n=2)))
    assert eng.cache_info()["robustness"]["faults_injected"] == 1
    # a device-loss arm parses into the reference's injector
    monkeypatch.setenv("REPRO_CHAOS", "lose@segment:1")
    mine, ref = res.chaos_from_env(), jres.chaos_from_env()
    assert type(mine).__name__ == type(ref).__name__ == "DeviceLossInjector"
    assert (mine.lose_at_sites, mine.fail_at_sites, mine.lose_rate) \
        == (ref.lose_at_sites, ref.fail_at_sites, ref.lose_rate) \
        == ((("segment:1", 1),), (), 0.0)


@pytest.mark.parametrize("spec", [
    "segment:1,rate=0.04,seed=11,max=4;prefill:2;chunk:1;embed:0",
    "rate=0.3,seed=7", "rate=0.05,seed=0;segment:3"])
def test_same_spec_fires_same_sites_in_both_packages(spec):
    mine, ref = res.ChaosSchedule.parse(spec), jres.ChaosSchedule.parse(spec)
    assert (mine.fail_at_sites, mine.rate, mine.seed, mine.max_failures) \
        == (ref.fail_at_sites, ref.rate, ref.seed, ref.max_failures)
    sites = [f"{k}:{i}" for k in sorted(res.ChaosSchedule.SITE_KINDS)
             for i in range(200)]
    fired = []
    for sched in (mine, ref):
        out = []
        for site in sites:
            try:
                sched.check_site(site)
            except Exception as e:  # noqa: BLE001 -- either package's
                assert type(e).__name__ == "SimulatedFailure"
                out.append(site)
        fired.append(out)
    assert fired[0] == fired[1] and fired[0]
    assert [res._hash_frac(s, x) for s in (0, 11) for x in sites[:50]] == \
        [jres._hash_frac(s, x) for s in (0, 11) for x in sites[:50]]


# ---------------------------------------------------------------------------
# snapshots across the two packages
# ---------------------------------------------------------------------------

def _trace(sched):
    """Requests with every optional field, built by `sched`."""
    rs = [sched.Request(rid=3, prompt=[5, 6, 7], max_new_tokens=6,
                        arrival_time=0.25, stop_tokens=(2, 9), deadline=9.5,
                        sampling=sched.SamplingParams(temperature=0.7,
                                                      top_p=0.9, seed=4)),
          sched.Request(rid=4, prompt=[1], max_new_tokens=1,
                        method="score", score_tokens=(3, 1, 4),
                        features=np.arange(12, dtype=np.float32)
                        .reshape(3, 4)),
          sched.Request(rid=8, prompt=[2, 2], max_new_tokens=3,
                        features=np.full((2, 4), 0.5, np.float32)),
          sched.Request(rid=9, prompt=[8, 8, 8, 8], max_new_tokens=1,
                        method="embed")]
    rs[0].tokens, rs[0].retries = [4, 4, 1], 1
    rs[2].tokens = [7]
    return rs


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshots_cross_the_two_packages(writer, tmp_path):
    """A snapshot written by one package's snapshot_requests restores in
    the other's restore_requests with identical fields: the request
    leaves {prompt, tokens, features, score_tokens} get the same
    leaf_%05d numbers in both (sorted dict keys)."""
    write, read = (jres, res) if writer == "reference" else (res, jres)
    sched = jsched if writer == "reference" else scheduler
    write.snapshot_requests(str(tmp_path), 2, _trace(sched))
    back = read.restore_requests(str(tmp_path))
    assert [_fields(r) for r in back] == \
        [_fields(r) for r in _trace(sched)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_leaves_cross_the_two_packages(writer, tmp_path):
    """Dict keys in insertion order that is not sorted, and a bf16 leaf:
    the same leaf numbers and bits whichever package wrote them."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    z, a = rng.integers(0, 9, 4).astype(np.int32), np.float32(2.5)
    if writer == "reference":
        tree = {"z": jnp.asarray(z), "a": jnp.asarray(a),
                "m": {"w": jnp.asarray(bf, jnp.bfloat16)}}
        jckpt.save_checkpoint(str(tmp_path), 4, tree, extra_meta={"k": 1})
        like = {"z": np.zeros(0, np.int32), "a": np.float32(0),
                "m": {"w": torch.zeros(0, dtype=torch.bfloat16)}}
        got, step = ckpt.restore_checkpoint(str(tmp_path), like)
        w = got["m"]["w"]
        assert w.dtype == torch.bfloat16 and step == 4
        want_bits = np.asarray(jnp.asarray(bf, jnp.bfloat16)).view(np.uint16)
        np.testing.assert_array_equal(w.view(torch.uint16).numpy(),
                                      want_bits)
    else:
        tree = {"z": torch.from_numpy(z), "a": a,
                "m": {"w": torch.from_numpy(bf).to(torch.bfloat16)}}
        ckpt.save_checkpoint(str(tmp_path), 4, tree, extra_meta={"k": 1})
        like = {"z": jnp.zeros(0, jnp.int32), "a": jnp.float32(0),
                "m": {"w": jnp.zeros(0, jnp.bfloat16)}}
        got, step = jckpt.restore_checkpoint(str(tmp_path), like)
        w = np.asarray(got["m"]["w"])
        assert w.dtype == jnp.bfloat16 and step == 4
        np.testing.assert_array_equal(
            w.view(np.uint16),
            tree["m"]["w"].view(torch.uint16).numpy())
    np.testing.assert_array_equal(np.asarray(got["z"]), z)
    assert float(np.asarray(got["a"])) == 2.5
    for mod in (ckpt, jckpt):
        assert mod.load_meta(str(tmp_path)) == ({"k": 1}, 4)
        assert mod.latest_step(str(tmp_path)) == 4


def test_checkpoint_keeps_the_last_three_and_skips_uncommitted(tmp_path):
    for step in range(5):
        ckpt.save_checkpoint(str(tmp_path), step, {"x": np.arange(step)})
    (tmp_path / "step_000000009.tmp").mkdir()     # a preempted save
    (tmp_path / "step_000000007").mkdir()         # no commit marker
    assert ckpt._committed_steps(str(tmp_path)) == [2, 3, 4]
    got, step = ckpt.restore_checkpoint(str(tmp_path),
                                        {"x": np.zeros(0, np.int64)})
    assert step == 4 and got["x"].tolist() == [0, 1, 2, 3]
    assert ckpt.restore_checkpoint(str(tmp_path / "none"), {}) == \
        (None, None)
