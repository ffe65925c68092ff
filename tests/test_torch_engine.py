"""The port's continuous-batching engine (`repro_torch/launch/engine.py`)
and its scheduler, against the port's static `generate` and against
`repro`'s engine.

* The scheduler is the reference's: bucket functions, the queue, and
  `synthetic_traffic` / `shared_prefix_traffic` / `method_traffic`
  request for request from the same seed.
* Engine == the port's static `generate` of each request alone, bit for
  bit, on the CPU (where the engine's step runs eagerly over the same
  views and buffers it captures on the card): reduced smollm w8a8 with
  `silvia_passes` off and all, mixed lengths, stop tokens, compaction,
  a cache-length bucket boundary, a request that ends mid-segment at
  max_cache_len (its slot runs on past the cache for the rest of the
  segment: the clamped write), sampled requests against
  `generate(sampling=, rids=)`; reduced mamba2 (ssm) and jamba (hybrid)
  on ragged traffic.  Weights are the reference's init, converted.
* The port's engine against the reference's engine on the same weights
  and trace (bf16 w8a8): ROADMAP C2's rule on the reference's
  teacher-forced logits.
* Inactive slots' pages stay bit-identical across a segment; the graph
  census stays within `graph_bound()` and warmup covers the traffic;
  admission control (shedding, deadlines, cancellation), chaos's
  device-loss arms parsed as the reference parses them, and the
  refusal of a missing CUDA (the methods and chaos:
  tests/test_torch_engine_methods.py, tests/test_torch_resilience.py;
  speculative decoding and its refusals:
  tests/test_torch_spec_decode.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import engine as jengine  # noqa: E402
from repro.launch import resilience as jres  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import resilience as res  # noqa: E402
from repro_torch.launch import scheduler, serve  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.launch.methods import generate_request  # noqa: E402
from test_torch_hybrid import params_for as hybrid_params  # noqa: E402
from test_torch_serve import LOGIT_TOL, _setup  # noqa: E402
from test_torch_ssm import params_for as ssm_params  # noqa: E402

SP = scheduler.SamplingParams(temperature=0.9, top_k=8, seed=11)
SP_NUCLEUS = scheduler.SamplingParams(temperature=0.7, top_p=0.9, seed=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _engine(cfg, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("segment_len", 4)
    return ServeEngine(params, cfg, device="cpu", **kw)


def _static(cfg, params, req, silvia="off"):
    return serve.generate(
        params, req.prompt[None], cfg, gen=req.max_new_tokens,
        cache_len=req.prompt_len + req.max_new_tokens, device="cpu",
        silvia_passes=silvia, sampling=[req.sampling], rids=[req.rid])[0] \
        .numpy()


def _requests(vocab, plens, gens, mix=(None,), seed=10, **kw):
    return [scheduler.Request(rid=i, prompt=_prompt(vocab, s, seed + i),
                              max_new_tokens=g, sampling=mix[i % len(mix)],
                              **kw)
            for i, (s, g) in enumerate(zip(plens, gens))]


def _assert_each_equals_static(cfg, params, reqs, out, silvia="off"):
    for r in reqs:
        want = _static(cfg, params, r, silvia)
        if r.stop_tokens:
            hit = np.nonzero(np.isin(want, r.stop_tokens))[0]
            if hit.size:
                want = want[:hit[0] + 1]
        np.testing.assert_array_equal(out[r.rid], want, err_msg=str(r.rid))


# ---------------------------------------------------------------------------
# scheduler: the reference's, function for function
# ---------------------------------------------------------------------------

def test_buckets_match_reference():
    for n in range(0, 130):
        for lo, hi in ((1, None), (8, 128), (32, 96), (1, 6)):
            try:
                want = jsched.bucket_pow2(n, minimum=lo, maximum=hi)
            except ValueError:
                with pytest.raises(ValueError):
                    scheduler.bucket_pow2(n, minimum=lo, maximum=hi)
                continue
            assert scheduler.bucket_pow2(n, minimum=lo, maximum=hi) == want
    for lo, hi in ((1, 8), (32, 96), (8, 256), (4, 4)):
        assert scheduler.bucket_set(lo, hi) == jsched.bucket_set(lo, hi)
    for n, d in ((8, 3), (12, 16), (16, 8)):
        assert scheduler.largest_valid_dp(n, d) == \
            jsched.largest_valid_dp(n, d)
    with pytest.raises(ValueError):
        scheduler.validate_slot_sharding(6, 4)


def test_queue_gating_and_removal():
    reqs = [scheduler.Request(rid=i, prompt=[1, 2], max_new_tokens=2,
                              arrival_time=t, deadline=d)
            for i, (t, d) in enumerate([(0.5, None), (0.0, 0.2),
                                        (2.0, None)])]
    q = scheduler.RequestQueue(reqs)
    assert [r.rid for r in q.pending()] == [1, 0, 2]
    assert [r.rid for r in q.pop_expired(0.3)] == [1]
    assert q.next_arrival(0.0) == 0.5
    assert [r.rid for r in q.pop_ready(1.0, limit=5)] == [0]
    assert q.remove(2).rid == 2 and q.remove(2) is None
    assert q.pop_oldest() is None and len(q) == 0


def _fields(r):
    return (r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival_time,
            r.deadline, r.method, r.score_tokens,
            None if r.sampling is None else dataclasses.astuple(r.sampling))


def test_traffic_generators_match_reference():
    """The same seed gives the reference's requests, field for field (the
    chip smoke's engine trace among them)."""
    mix_t = (None, None, scheduler.SamplingParams(temperature=0.8,
                                                  top_p=0.95, seed=1),
             scheduler.SamplingParams(temperature=1.0, top_k=50, seed=2))
    mix_j = tuple(None if p is None else jsched.SamplingParams(
        **dataclasses.asdict(p)) for p in mix_t)
    kw = dict(seed=0, n_requests=24, rate=1000.0,
              prompt_lens=(16, 48, 96, 128), gen_lens=(8, 32, 64),
              vocab=49152)
    pairs = [(scheduler.synthetic_traffic(sampling_mix=mix_t, **kw),
              jsched.synthetic_traffic(sampling_mix=mix_j, **kw)),
             (scheduler.synthetic_traffic(ttls=(None, 0.5), **kw),
              jsched.synthetic_traffic(ttls=(None, 0.5), **kw))]
    kw2 = dict(seed=4, n_requests=9, rate=50.0, n_prefixes=3, prefix_len=8,
               tail_lens=(3, 5), gen_lens=(6, 8), vocab=256)
    pairs.append((scheduler.shared_prefix_traffic(**kw2),
                  jsched.shared_prefix_traffic(**kw2)))
    kw3 = dict(seed=2, n_requests=12, rate=10.0, prompt_lens=(4, 9),
               gen_lens=(2, 5), vocab=300)
    pairs.append((scheduler.method_traffic(**kw3),
                  jsched.method_traffic(**kw3)))
    for got, want in pairs:
        assert [_fields(r) for r in got] == [_fields(r) for r in want]


def test_fast_forward_clock_skips_waits():
    clock = scheduler.FastForwardClock()
    t0 = clock.now()
    clock.wait_until(t0 + 100.0)
    assert clock.now() >= t0 + 100.0


# ---------------------------------------------------------------------------
# engine == static generate, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("silvia", ["off", "all"])
def test_engine_matches_static_generate(silvia):
    """Ragged prompts and gens through 2 slots (evictions, re-admissions,
    compaction), one request with a stop token it emits, two sampled."""
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    reqs = _requests(cfg.vocab, (5, 12, 9, 16, 7), (3, 8, 1, 6, 9),
                     mix=(None, SP, None, SP_NUCLEUS))
    stop = _static(cfg, params, reqs[4], silvia)
    reqs[4].stop_tokens = (int(stop[3]),)
    eng = _engine(cfg, params, silvia_passes=silvia)
    out = eng.run(reqs)
    _assert_each_equals_static(cfg, params, reqs, out, silvia)
    assert len(out[4]) <= 4
    assert eng.compactions >= 1
    info = eng.cache_info()
    assert info["graphs"] <= info["graph_bound"]
    assert info["captured"] == 0           # no graph on the CPU
    assert {r.outcome for r in eng.finished} == {res.OK}


def test_engine_bucket_boundary_and_cache_end():
    """A segment ending exactly on a cache-length bucket boundary keeps
    advancing (the reference's regression); a request whose prompt +
    max_new_tokens is exactly max_cache_len ends mid-segment, and its
    slot runs on past the cache for the rest of that segment (the write
    clamped to the cache's last row) while a batch mate keeps decoding."""
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    a = scheduler.Request(rid=0, prompt=_prompt(cfg.vocab, 48, 5),
                          max_new_tokens=32)
    eng = ServeEngine(params, cfg, n_slots=1, max_cache_len=128,
                      segment_len=16, min_len_bucket=32, device="cpu")
    _assert_each_equals_static(cfg, params, [a], eng.run([a]))
    reqs = [scheduler.Request(rid=1, prompt=_prompt(cfg.vocab, 21, 6),
                              max_new_tokens=11),       # 21 + 11 = 32
            scheduler.Request(rid=2, prompt=_prompt(cfg.vocab, 9, 7),
                              max_new_tokens=20)]
    eng = ServeEngine(params, cfg, n_slots=2, max_cache_len=32,
                      segment_len=8, device="cpu")
    out = eng.run(reqs)
    # rid 1's last token came from step 2 of its second segment: steps
    # 3-7 ran past the cache
    assert (11 - 1) % 8 != 0
    _assert_each_equals_static(cfg, params, reqs, out)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_engine_matches_static_per_family(family):
    """Ragged traffic on the sequential-state families: prompt-bucket
    padding is invisible to the state (identity steps), the constant-size
    pages are reset on admit, compaction moves them."""
    params = ssm_params("float32", "w8a8")[1] if family == "ssm" else \
        hybrid_params("float32", "w8a8")[1]
    arch = "mamba2-2.7b" if family == "ssm" else "jamba-v0.1-52b"
    cfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                              dtype="float32")
    if family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=8)
    reqs = _requests(cfg.vocab, (5, 12, 9, 16), (3, 6, 1, 4),
                     mix=(None, SP))
    eng = _engine(cfg, params)
    out = eng.run(reqs)
    _assert_each_equals_static(cfg, params, reqs, out)
    if family == "ssm":
        seg = [k for k in eng._graphs if k[0] == "segment"]
        assert seg and all(k[2] is None for k in seg)
        assert eng.len_buckets == () and not eng._spec.has_length_axis


def test_inactive_slots_unchanged_across_a_segment():
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    eng = _engine(cfg, params, n_slots=4)
    for r in _requests(cfg.vocab, (6, 10), (9, 9)):
        eng.submit(r)
    clock = scheduler.FastForwardClock()
    eng._admit(clock.now(), clock)
    assert eng._active.tolist() == [True, True, False, False]
    for k, t in eng._cache.items():                # stale, not zero
        t[:, 2:].normal_()
    before = {k: t.clone() for k, t in eng._cache.items()}
    eng._finish_segment(eng._begin_segment(), clock)
    for k, t in eng._cache.items():
        assert torch.equal(t[:, 2:], before[k][:, 2:])
        assert not torch.equal(t[:, :2], before[k][:, :2])


def test_engine_steps_are_the_static_paths_captured_step():
    """Each (bb, t_b) segment step is `serve._CapturedStep`, the static
    path's class, over views of the first bb rows of the engine's slot
    state and device buffers (no copies: the step writes through them)."""
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    eng = _engine(cfg, params, n_slots=4)
    eng.warmup()
    assert eng._segments and all(
        type(s) is serve._CapturedStep and s.graph is None
        for s in eng._segments.values())
    (_, bb, t_b, _), s = next((k, s) for k, s in eng._segments.items()
                              if k[1] == 2)
    b = eng._bufs
    for mine, full in ((s.tok, b["tok"]), (s.pos, b["pos"]),
                       (s.toks, b["toks"]), (s.step, b["step"])):
        assert mine.data_ptr() == full.data_ptr() and \
            mine.shape[0] == min(bb, full.shape[0])
    assert [t.data_ptr() for t in s.samp] == \
        [t.data_ptr() for t in b["samp"]]
    assert s.logits is None and s.n_steps == eng.segment_len
    for k, t in s.cache.items():
        assert t.data_ptr() == eng._cache[k].data_ptr()


@pytest.mark.parametrize("op, shape", [
    ("mean", (1, 1, 576)), ("mean", (3, 1, 576)), ("mean", (2, 48, 576)),
    ("mean", (1, 5, 2560)), ("sum", (2, 8, 4, 128)), ("sum", (1, 8, 4, 16)),
    ("cumsum", (1, 1000)), ("cumsum", (3, 1000))])
def test_row_reduce_pins_rows_bit_for_bit(op, shape):
    """`common.row_reduce` with the row count pinned (as on CUDA: zero rows
    padding the call to `min_rows(d)`) gives each row what the unpinned
    op gives it, in its shape; on the CPU, where every row is reduced
    alone, bit for bit."""
    from repro_torch.models import common
    fn = {"mean": common.row_mean, "sum": common.row_sum,
          "cumsum": common.row_cumsum}[op]
    want = {"mean": lambda x: x.mean(-1, keepdim=True),
            "sum": lambda x: x.sum(-1),
            "cumsum": lambda x: x.cumsum(-1)}[op]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape)
                         .astype(np.float32))
    got, plain = fn(x, pin=True), fn(x, pin=False)
    assert got.shape == plain.shape == want(x).shape
    assert torch.equal(got, plain) and torch.equal(plain, want(x))


@pytest.mark.parametrize("n", [1, 3, 8, 100, 160])
def test_tail_sum_ignores_appended_zeros(n):
    """`common.tail_sum_` over a key axis of n entries: the sum (float64
    within rounding), and in float32 bit for bit the sum of the same
    entries with zeros appended up to a longer axis (the engine's cache
    bucket against the static path's cache_len) and in a batch."""
    from repro_torch.models import common
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (3, n, 4)))
    assert torch.allclose(common.tail_sum_(x.clone(), dim=1), x.sum(1))
    y = x.float()
    longer = torch.cat([y, torch.zeros(3, 300 - n, 4)], dim=1)
    alone = common.tail_sum_(y[:1].clone(), dim=1)
    assert torch.equal(common.tail_sum_(longer, dim=1)[:1], alone)


def test_min_rows_saturates_reduce_block_height():
    """The pinned row count: 16 rows once a row spans a warp's 32 lanes
    (rows of d > 128 read 4 floats per lane), 512 / lanes below."""
    from repro_torch.models import common
    assert [common.min_rows(d) for d in (576, 8192, 5120, 256, 128, 32)] \
        == [16] * 6
    assert [common.min_rows(d) for d in (16, 8, 1)] == [32, 64, 512]


# ---------------------------------------------------------------------------
# the port's engine against the reference's
# ---------------------------------------------------------------------------

def test_engine_matches_reference_engine():
    """The same trace through both engines on the same weights (bf16,
    w8a8): per request, while the streams agree, the port's token equals
    the reference's wherever the reference's teacher-forced top-two
    margin exceeds 2 x LOGIT_TOL, and elsewhere scores within LOGIT_TOL
    of its max (ROADMAP C2)."""
    jcfg, tcfg, jp, tp = _setup("bfloat16", "w8a8")
    kw = dict(seed=3, n_requests=5, rate=50.0, prompt_lens=(5, 9, 14),
              gen_lens=(4, 7), vocab=tcfg.vocab)
    want = jengine.ServeEngine(jp, jcfg, n_slots=2, max_cache_len=64,
                               segment_len=4, chaos=None).run(
        jsched.synthetic_traffic(**kw), clock=jsched.FastForwardClock())
    reqs = scheduler.synthetic_traffic(**kw)
    got = _engine(tcfg, tp).run(reqs, clock=scheduler.FastForwardClock())
    prefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
    decode = jax.jit(jlm.decode_step, static_argnums=(4,))
    tol, compared = LOGIT_TOL["bfloat16"], 0
    for r in reqs:
        w, g = np.asarray(want[r.rid]), got[r.rid]
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
    assert compared > 0


# ---------------------------------------------------------------------------
# census, admission control, refusals
# ---------------------------------------------------------------------------

def test_warmup_bounds_graphs_and_covers_traffic():
    _, cfg, _, params = _setup("bfloat16", "w4a8")
    plens, gens = (4, 8, 12), (2, 4, 8)
    eng = _engine(cfg, params)
    n = eng.warmup(prompt_lens=plens)
    warmed = set(eng._graphs)
    assert n == len(warmed) <= eng.graph_bound()
    reqs = scheduler.synthetic_traffic(seed=1, n_requests=6, rate=100.0,
                                       prompt_lens=plens, gen_lens=gens,
                                       vocab=cfg.vocab)
    eng.run(reqs, clock=scheduler.FastForwardClock())
    assert eng._graphs == warmed
    assert eng.cache_info()["segments"] == eng.segments > 0


def test_slot_invariants_through_a_run():
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    eng = _engine(cfg, params, max_cache_len=32, segment_len=2,
                  min_len_bucket=16)
    for r in _requests(cfg.vocab, (6,) * 5, (2, 5, 1, 7, 3)):
        eng.submit(r)
    clock = scheduler.FastForwardClock()
    for _ in range(64):
        progressed = eng.step(clock)
        live = [r for r in eng._slot_req if r is not None]
        assert len(live) == eng.n_active == int(np.sum(eng._active))
        for slot in range(eng.n_slots):
            if eng._active[slot]:
                assert 0 < eng._pos[slot] <= eng.max_cache_len
                assert eng._remaining[slot] > 0
            else:
                assert eng._slot_req[slot] is None
        if not progressed and not eng.n_queued and not eng.n_active:
            break
    assert len(eng.finished) == 5
    for r in eng.finished:
        assert len(r.tokens) == r.max_new_tokens
        assert r.finish_time >= r.first_token_time >= r.arrival_time


def test_admission_control_and_cancel():
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    mk = lambda i, **kw: generate_request(          # noqa: E731
        i, _prompt(cfg.vocab, 5, i), 4, **kw)
    eng = _engine(cfg, params, resilience=res.ResilienceConfig(
        max_queue=2, shed_policy="reject-new"))
    assert [eng.submit(mk(i)) for i in range(3)] == \
        [res.QUEUED, res.QUEUED, res.SHED]
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(mk(0))
    with pytest.raises(ValueError, match="max_cache_len"):
        eng.submit(generate_request(9, np.zeros(62, np.int32), 8))
    assert eng.cancel(1) and not eng.cancel(42)
    eng.run()
    outcomes = {rid: r.outcome for rid, r in eng.results().items()}
    assert outcomes == {0: res.OK, 1: res.CANCELLED, 2: res.SHED}
    eng = _engine(cfg, params, resilience=res.ResilienceConfig(
        max_queue=2, shed_policy="drop-oldest", default_ttl_s=1000.0))
    eng.submit(mk(0))
    eng.submit(mk(1, arrival_time=0.1))
    # the queue is full: the oldest (0) is shed; 2 expires in the queue
    eng.submit(mk(2, arrival_time=100.0, deadline=50.0))
    eng.run(clock=scheduler.FastForwardClock())
    outcomes = {rid: r.outcome for rid, r in eng.results().items()}
    assert outcomes == {0: res.SHED, 1: res.OK, 2: res.EXPIRED}
    assert eng.result(1).tokens and eng.result(7) is None
    assert eng.finished[-1].deadline == 50.0
    assert [r.deadline for r in eng.finished if r.rid == 1] == [1000.1]


def test_refusals_name_their_roadmap_item(monkeypatch):
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    # speculative decoding, the mesh and elastic serving are ported:
    # spec_decode's refusals are the reference's
    # (tests/test_torch_spec_decode.py), and a device-loss arm arms the
    # engine with the injector the reference's engine gets
    # (tests/test_torch_elastic.py holds its degrade)
    monkeypatch.setenv("REPRO_CHAOS", "segment:1;lose@segment:2")
    chaos, ref = _engine(cfg, params)._chaos, jres.chaos_from_env()
    assert type(chaos).__name__ == type(ref).__name__ == \
        "DeviceLossInjector"
    assert (chaos.fail_at_sites, chaos.lose_at_sites, chaos.arms_loss) \
        == (ref.fail_at_sites, ref.lose_at_sites, ref.arms_loss) \
        == (("segment:1",), (("segment:2", 1),), True)
    monkeypatch.delenv("REPRO_CHAOS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(params, cfg)
