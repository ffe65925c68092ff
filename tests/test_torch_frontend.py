"""The port's async streaming front-end (`repro_torch/launch/frontend.py`),
case for case with tests/test_frontend.py (its mesh cases are in
tests/test_torch_sharded_features.py).

* Streamed tokens, score logprobs and embeddings equal the port's batch
  engine on the same trace, bit for bit, for dense, ssm, hybrid and
  encdec, with and without overlap, under `--silvia all`, and through a
  warm prefix cache (== the cold pass); score equals the batch-1
  teacher-forced decode float for float.
* Cancellation: a client that disconnects mid-stream cancels its request
  (its partial tokens kept) and its batch mates stream the solo run's
  tokens; a stream that overflows its bounded queue is cancelled; a
  validation error surfaces at the await; an error that ends the worker
  reaches every client and `stop()`.
* A speculative engine under the front-end: its rounds are synchronous,
  so nothing overlaps, and the streams equal the non-spec batch run's.
* One dense trace's streams against the reference's `AsyncFrontend` on
  the same weights, by ROADMAP C2's rule.

Engines run on the CPU (`device="cpu"`) with the default `chaos="env"`,
as the reference's tests do.  Every async scenario runs in a plain
`asyncio.run()` inside a sync test.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import engine as jengine  # noqa: E402
from repro.launch import frontend as jfrontend  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro_torch.launch import methods, scheduler  # noqa: E402
from repro_torch.launch.engine import (ServeEngine,  # noqa: E402
                                       SpecDecodeConfig)
from repro_torch.launch.frontend import (AsyncFrontend,  # noqa: E402
                                         serve_requests)
from repro_torch.models import lm  # noqa: E402
from test_torch_resilience import family  # noqa: E402
from test_torch_serve import _setup  # noqa: E402
from test_torch_spec_decode import c2_tokens, near  # noqa: E402

FAMILIES = ("dense", "encdec", "hybrid", "ssm")
ENC_LEN = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_engine(cfg, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("segment_len", 4)
    if cfg.family == "encdec":
        kw.setdefault("enc_len", ENC_LEN)
    return ServeEngine(params, cfg, device="cpu", **kw)


def _traffic(cfg, n=8, seed=0, sched=scheduler):
    reqs = sched.method_traffic(
        seed=seed, n_requests=n, rate=200.0, prompt_lens=(4, 7, 12),
        gen_lens=(3, 6), vocab=cfg.vocab)
    feats = None
    if cfg.family == "encdec":
        frng = np.random.default_rng(seed + 1)
        # ragged encoder lengths, one short enough (<= 8) for a smaller
        # enc-length bucket than ENC_LEN
        feats = {r.rid: frng.standard_normal(
            (int(frng.integers(3, ENC_LEN + 1)) if r.rid else 5,
             cfg.d_model)).astype(np.float32) for r in reqs}
    return reqs, feats


def _batch_reference(cfg, params, reqs, feats, **engine_kw):
    """The oracle: the same trace through a plain engine step loop."""
    eng = _make_engine(cfg, params, **engine_kw)
    clock = scheduler.FastForwardClock()
    for r in reqs:
        if feats:
            r.features = feats.get(r.rid)
        eng.submit(r)
    while len(eng.results()) < len(reqs):
        if not eng.step(clock):
            nxt = eng.next_arrival(clock.now())
            if nxt is not None:
                clock.wait_until(nxt)
    return {r.rid: eng.result(r.rid) for r in reqs}


async def _run_frontend(eng, reqs, feats, *, overlap=True, fe_cls=None,
                        sched=scheduler):
    """Serve `reqs` through a front-end: every generate request STREAMED,
    score / embed awaited.  Returns ({rid: result}, {rid: streamed
    tokens}, the front-end's stats)."""
    fe = (fe_cls or AsyncFrontend)(eng, clock=sched.FastForwardClock(),
                                   overlap=overlap)
    results, stream_toks = {}, {}
    async with fe:
        async def stream_one(req):
            toks = []
            async for t in fe.generate_stream(
                    req.prompt, req.max_new_tokens, rid=req.rid,
                    features=feats.get(req.rid) if feats else None):
                toks.append(t)
            stream_toks[req.rid] = toks

        plain, coros = [], []
        for r in reqs:
            if r.method == "generate":
                coros.append(stream_one(r))
            else:
                if feats:
                    r.features = feats.get(r.rid)
                plain.append(r)
        serve = jfrontend.serve_requests if fe_cls is not None \
            else serve_requests

        async def call_plain():
            results.update(await serve(fe, plain))

        await asyncio.gather(call_plain(), *coros)
    for r in reqs:
        if r.method == "generate":
            results[r.rid] = eng.result(r.rid)
    return results, stream_toks, fe.stats


def _assert_results_equal(ref, got, stream_toks=None):
    assert set(ref) == set(got)
    for rid, a in ref.items():
        b = got[rid]
        assert a is not None and b is not None, rid
        assert a.outcome == b.outcome == "ok", (rid, a.outcome, b.outcome)
        assert list(a.tokens) == list(b.tokens), rid
        if stream_toks is not None and rid in stream_toks:
            assert stream_toks[rid] == list(a.tokens), rid
        if a.logprobs is not None:
            assert b.logprobs == a.logprobs, rid
        if a.embedding is not None:
            assert np.array_equal(a.embedding, b.embedding), rid


# ---------------------------------------------------------------------------
# streamed == batch, all four families, with and without overlap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_stream_matches_batch(fam):
    """Mixed generate / score / embed traffic streamed through the
    front-end equals the plain batch engine, bit for bit."""
    cfg, params = family(fam)
    reqs, feats = _traffic(cfg)
    ref = _batch_reference(cfg, params, *_traffic(cfg))
    got, stream_toks, stats = asyncio.run(
        _run_frontend(_make_engine(cfg, params), reqs, feats))
    _assert_results_equal(ref, got, stream_toks)
    assert any(len(v) > 0 for v in stream_toks.values())
    assert stats["overlapped_segments"] > 0 and stats["submitted"] == 8


def test_stream_matches_batch_silvia_all():
    cfg, params = family("dense")
    reqs, feats = _traffic(cfg, seed=23)
    ref = _batch_reference(cfg, params, *_traffic(cfg, seed=23),
                           silvia_passes="all")
    got, stream_toks, _ = asyncio.run(_run_frontend(
        _make_engine(cfg, params, silvia_passes="all"), reqs, feats))
    _assert_results_equal(ref, got, stream_toks)


@pytest.mark.parametrize("fam", ["dense", "ssm"])
def test_stream_no_overlap_matches_batch(fam):
    """overlap=False (the sync loop) gives the same bits: the pipeline
    changes latency only; and it overlaps nothing."""
    cfg, params = family(fam)
    reqs, feats = _traffic(cfg, seed=3)
    ref = _batch_reference(cfg, params, *_traffic(cfg, seed=3))
    got, stream_toks, stats = asyncio.run(_run_frontend(
        _make_engine(cfg, params), reqs, feats, overlap=False))
    _assert_results_equal(ref, got, stream_toks)
    assert stats["overlapped_segments"] == 0 == stats["hidden_host_s"]


def test_stream_prefix_warm_matches_cold():
    """A second serving of the same trace on one engine goes through a
    warm prefix cache, hits it, and streams the cold pass's tokens."""
    cfg, params = family("dense")
    eng = _make_engine(cfg, params, prefill_chunk=4, prefix_cache=64)
    cold, cold_toks, _ = asyncio.run(
        _run_frontend(eng, _traffic(cfg, seed=5)[0], None))
    warm_reqs = _traffic(cfg, seed=5)[0]
    for r in warm_reqs:       # same prompts, fresh rids (one live engine)
        r.rid += 100
    warm, warm_toks, _ = asyncio.run(_run_frontend(eng, warm_reqs, None))
    assert eng.cache_info()["prefix_cache"]["hits"] > 0
    for rid, toks in cold_toks.items():
        assert warm_toks[rid + 100] == toks, rid
    for rid, a in cold.items():
        assert list(warm[rid + 100].tokens) == list(a.tokens), rid


def test_spec_engine_streams_and_overlaps_nothing():
    """A speculative engine behind the front-end: a round is synchronous,
    so no segment overlaps, and every result equals the non-spec batch
    engine's."""
    cfg, params = family("ssm")
    reqs, feats = _traffic(cfg, seed=7)
    ref = _batch_reference(cfg, params, *_traffic(cfg, seed=7))
    eng = _make_engine(cfg, params, spec_decode=SpecDecodeConfig(
        near(params), cfg, 3))
    got, stream_toks, stats = asyncio.run(_run_frontend(eng, reqs, feats))
    _assert_results_equal(ref, got, stream_toks)
    assert stats["overlapped_segments"] == 0
    assert eng.cache_info()["spec_decode"]["rounds"] > 0


# ---------------------------------------------------------------------------
# score == decode path
# ---------------------------------------------------------------------------

def test_score_matches_decode_path():
    """Per-token logprobs of a completion from the front-end equal a
    teacher-forced batch-1 prefill + decode_step, float for float."""
    cfg, params = family("dense")
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, cfg.vocab, 9).astype(np.int32)
    comp = rng.integers(1, cfg.vocab, 5).astype(np.int32)

    async def score():
        fe = AsyncFrontend(_make_engine(cfg, params),
                           clock=scheduler.FastForwardClock())
        async with fe:
            return await fe.score(prompt, comp)

    got = asyncio.run(score())
    logits, cache = lm.prefill(params, torch.as_tensor(prompt[None]).long(),
                               cfg, cache_len=32)
    want = [methods.logprob_from_logits(
        logits[0, -1].float().numpy(), int(comp[0]))]
    for i in range(len(comp) - 1):
        logits, cache = lm.decode_step(
            params, torch.tensor([[int(comp[i])]]), cache,
            torch.tensor([len(prompt) + i]), cfg)
        want.append(methods.logprob_from_logits(
            logits[0, -1].float().numpy(), int(comp[i + 1])))
    assert got == want


# ---------------------------------------------------------------------------
# cancellation: disconnect, backlog; errors
# ---------------------------------------------------------------------------

def test_cancellation_under_load():
    """A client disconnecting mid-stream cancels its request (partial
    tokens kept, slot freed) while its batch mates finish with the solo
    run's tokens."""
    cfg, params = family("dense")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab, 8).astype(np.int32)
               for _ in range(3)]

    async def go():
        eng = _make_engine(cfg, params)
        fe = AsyncFrontend(eng, clock=scheduler.FastForwardClock())
        async with fe:
            agen = fe.generate_stream(prompts[0], 40, rid=0)
            partial = []
            async for t in agen:
                partial.append(t)
                if len(partial) == 3:
                    break
            await agen.aclose()       # client disconnect -> cancel
            survivors = await asyncio.gather(
                fe.generate(prompts[1], 6, rid=1),
                fe.generate(prompts[2], 6, rid=2))
            for _ in range(400):      # let the cancel land in the loop
                if eng.result(0) is not None:
                    break
                await asyncio.sleep(0.005)
        return eng, fe, partial, survivors

    eng, fe, partial, survivors = asyncio.run(go())
    cancelled = eng.result(0)
    assert cancelled is not None and cancelled.outcome == "cancelled"
    assert list(cancelled.tokens)[:3] == partial
    assert fe.stats["disconnect_cancels"] == 1
    assert eng.cache_info()["robustness"]["cancelled_inflight"] >= 1
    for i, r in enumerate(survivors, start=1):
        solo = _batch_reference(
            cfg, params,
            [methods.generate_request(0, prompts[i], 6)], None)[0]
        assert r.outcome == "ok" and list(r.tokens) == list(solo.tokens)


def test_stream_backlog_evicts_slow_client():
    cfg, params = family("dense")
    rng = np.random.default_rng(13)

    async def go():
        eng = _make_engine(cfg, params)
        fe = AsyncFrontend(eng, clock=scheduler.FastForwardClock(),
                           stream_queue=2)
        async with fe:
            agen = fe.generate_stream(
                rng.integers(1, cfg.vocab, 8).astype(np.int32), 40, rid=7)
            it = agen.__aiter__()
            await it.__anext__()      # first token, then stop draining
            for _ in range(400):
                if eng.result(7) is not None:
                    break
                await asyncio.sleep(0.005)
            await agen.aclose()
        return eng, fe

    eng, fe = asyncio.run(go())
    r = eng.result(7)
    assert r is not None and r.outcome == "cancelled"
    assert fe.stats["backlog_cancels"] >= 1


def test_validation_error_surfaces_at_await():
    cfg, params = family("dense")

    async def go():
        fe = AsyncFrontend(_make_engine(cfg, params),
                           clock=scheduler.FastForwardClock())
        async with fe:
            with pytest.raises(ValueError, match="max_cache_len"):
                await fe.generate(np.arange(1, 200, dtype=np.int32), 5)

    asyncio.run(go())


def test_worker_error_reaches_clients_and_stop():
    """An exception the engine does not recover from ends the worker: the
    waiting client and the open stream raise it, and so does stop()."""
    cfg, params = family("dense")
    eng = _make_engine(cfg, params)

    def broken(clock=None):
        raise RuntimeError("device lost")
    eng.step_begin = broken
    prompt = np.arange(1, 9, dtype=np.int32)

    async def go():
        fe = AsyncFrontend(eng, clock=scheduler.FastForwardClock())
        await fe.start()

        async def stream():
            return [t async for t in fe.generate_stream(prompt, 4, rid=1)]
        outs = await asyncio.gather(fe.generate(prompt, 4, rid=0), stream(),
                                    return_exceptions=True)
        with pytest.raises(RuntimeError, match="device lost"):
            await fe.stop()
        return outs

    outs = asyncio.run(go())
    assert [type(o) for o in outs] == [RuntimeError, RuntimeError]


# ---------------------------------------------------------------------------
# ragged encoder lengths
# ---------------------------------------------------------------------------

def test_ragged_encdec_cross_enc_len_exact():
    """A short encoder feature served under a LARGER enc_len streams the
    tokens of an engine whose capacity is the snug bucket."""
    cfg, params = family("encdec")
    rng = np.random.default_rng(17)
    prompt = rng.integers(1, cfg.vocab, 6).astype(np.int32)
    feat = rng.standard_normal((5, cfg.d_model)).astype(np.float32)

    def stream(enc_len):
        async def go():
            fe = AsyncFrontend(_make_engine(cfg, params, enc_len=enc_len),
                               clock=scheduler.FastForwardClock())
            async with fe:
                return [t async for t in fe.generate_stream(
                    prompt, 6, rid=0, features=feat)]

        return asyncio.run(go())

    assert stream(ENC_LEN) == stream(8)


# ---------------------------------------------------------------------------
# property: any traffic shape streams the batch engine's bits
# ---------------------------------------------------------------------------

def test_stream_property_random_traffic():
    """Random method mixes x random mid-stream disconnects: surviving
    streams equal the batch engine's, disconnected ones end as a prefix
    (cancelled) or whole (finished first: the disconnect raced
    completion)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    cfg, params = family("dense")

    @hyp.settings(max_examples=4, deadline=None, database=None,
                  suppress_health_check=list(hyp.HealthCheck))
    @hyp.given(seed=st.integers(0, 10_000), n=st.integers(2, 6),
               cut=st.integers(0, 2))
    def prop(seed, n, cut):
        reqs, _ = _traffic(cfg, n=n, seed=seed)
        ref = _batch_reference(cfg, params, *_traffic(cfg, n=n, seed=seed))
        eng = _make_engine(cfg, params)
        drop = {r.rid for r in reqs if r.method == "generate"}
        drop = set(sorted(drop)[:cut])

        async def go():
            fe = AsyncFrontend(eng, clock=scheduler.FastForwardClock())
            stream_toks = {}
            async with fe:
                async def stream_one(req):
                    agen = fe.generate_stream(req.prompt,
                                              req.max_new_tokens,
                                              rid=req.rid)
                    toks = []
                    async for t in agen:
                        toks.append(t)
                        if req.rid in drop:
                            break
                    await agen.aclose()
                    stream_toks[req.rid] = toks

                plain = [r for r in reqs if r.method != "generate"]
                await asyncio.gather(
                    serve_requests(fe, plain),
                    *(stream_one(r) for r in reqs
                      if r.method == "generate"))
                for _ in range(400):   # let raced cancels land
                    if all(eng.result(r.rid) is not None for r in reqs):
                        break
                    await asyncio.sleep(0.005)
            return stream_toks

        stream_toks = asyncio.run(go())
        for r in reqs:
            got, want = eng.result(r.rid), ref[r.rid]
            assert got is not None, r.rid
            if r.rid in drop:
                assert got.outcome in ("ok", "cancelled"), got.outcome
                assert list(want.tokens)[:len(got.tokens)] \
                    == list(got.tokens), r.rid
            else:
                assert got.outcome == "ok"
                assert list(got.tokens) == list(want.tokens), r.rid
                if r.method == "generate":
                    assert stream_toks[r.rid] == list(want.tokens), r.rid

    prop()


# ---------------------------------------------------------------------------
# against the reference's front-end
# ---------------------------------------------------------------------------

def test_streams_match_reference_frontend():
    """One dense trace (generate only, greedy) streamed through both
    packages' front-ends on the same weights (bf16 w8a8): the port's
    streamed tokens against the reference's by ROADMAP C2's rule."""
    jcfg, cfg, jp, params = _setup("bfloat16", "w8a8")
    mix = (("generate", 1.0),)
    kw = dict(seed=29, n_requests=6, rate=200.0, prompt_lens=(4, 7, 12),
              gen_lens=(3, 6), vocab=cfg.vocab, method_mix=mix)
    jeng = jengine.ServeEngine(jp, jcfg, n_slots=2, max_cache_len=64,
                               segment_len=4)
    _, want, _ = asyncio.run(_run_frontend(
        jeng, jsched.method_traffic(**kw), None,
        fe_cls=jfrontend.AsyncFrontend, sched=jsched))
    reqs = scheduler.method_traffic(**kw)
    _, got, _ = asyncio.run(_run_frontend(_make_engine(cfg, params), reqs,
                                          None))
    compared, agree = c2_tokens(jcfg, jp, reqs, want, got)
    assert compared > 0 and agree
