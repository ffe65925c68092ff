"""The port's engine admission paths (`repro_torch/launch/engine.py`):
chunked prefill, the cross-request prefix cache
(`repro_torch/launch/prefix_cache.py`) and the admission token budget,
against the port's own cold paths and against `repro`'s engine.

* `PrefixCache`, unit for unit with tests/test_prefix_cache.py (rolling
  chain keys, features in the terminal key, peek, LRU that skips pinned
  entries, duplicate inserts), and its chain and terminal keys equal to
  `repro.launch.prefix_cache`'s bytes.
* `extract_row_pages` / `write_row_pages` against the reference's on the
  same state, and round trips in place (encdec and hybrid constant-size
  leaves whole).
* C12's key-blocked output product: a chunk over a long prefill state
  against full prefill of the prompt alone, bit for bit.
* The port's invariants, bit for bit: chunked == full-prefill engine ==
  the port's static `generate` of each request alone; warm == cold,
  chunked and full; a terminal repeat makes no prefill or chunk launch
  (dense, ssm, hybrid; encdec in tests/test_torch_engine_encdec.py);
  the budget defers, stays exact and always admits the head request.
* The port's engine against the reference's engine on the same weights
  and trace (bf16 w8a8), with `prefill_chunk=4` and with
  `prefix_cache=64`: ROADMAP C2's rule on the reference's teacher-forced
  logits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import engine as jengine  # noqa: E402
from repro.launch import prefix_cache as jpfx  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import slot_state as jslot  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import prefix_cache as pfx  # noqa: E402
from repro_torch.launch import resilience as res  # noqa: E402
from repro_torch.launch import scheduler, serve  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.models import slot_state  # noqa: E402
from test_torch_hybrid import params_for as hybrid_params  # noqa: E402
from test_torch_serve import LOGIT_TOL, _setup  # noqa: E402
from test_torch_ssm import params_for as ssm_params  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

TRAFFIC = dict(n_prefixes=2, prefix_len=8, tail_lens=(2, 4, 6),
               gen_lens=(4, 6), zipf_a=1.3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(cfg, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("segment_len", 4)
    return ServeEngine(params, cfg, device="cpu", **kw)


def _zipf(cfg, n=10, seed=0, rate=300.0, sched=scheduler):
    """Shared-prefix traffic (the reference test's): chain sharing
    engages on chunked engines."""
    return sched.shared_prefix_traffic(seed=seed, n_requests=n, rate=rate,
                                       vocab=cfg.vocab, **TRAFFIC)


def _repeats(cfg, n_unique=3, repeats=1, stagger=0.05, gen=5):
    """`n_unique` staggered prompts, each repeated exactly `repeats` more
    times later in the trace: the terminal-hit shape."""
    plens = (6, 11, 9, 14)[:n_unique]
    reqs = []
    for rep in range(repeats + 1):
        for i, pl in enumerate(plens):
            prompt = np.random.default_rng(30 + i).integers(
                0, cfg.vocab, pl).astype(np.int32)
            reqs.append(scheduler.Request(
                rid=len(reqs), prompt=prompt, max_new_tokens=gen,
                arrival_time=stagger * (rep * n_unique + i)))
    return reqs


def _run(eng, reqs):
    return eng.run(reqs, clock=scheduler.FastForwardClock())


def _same(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], err_msg=str(rid))


def _static(cfg, params, r):
    return serve.generate(params, r.prompt[None], cfg, gen=r.max_new_tokens,
                          cache_len=r.prompt_len + r.max_new_tokens,
                          device="cpu", sampling=[r.sampling],
                          rids=[r.rid])[0].numpy()


# ---------------------------------------------------------------------------
# PrefixCache: the reference's units, and its keys' bytes
# ---------------------------------------------------------------------------

def test_chain_keys_roll_over_exact_prefix():
    pc = pfx.PrefixCache(8, chunk=4)
    a = pc.chain_keys(np.arange(10, dtype=np.int32))
    assert len(a) == 2                      # only fully-real chunks
    b = pc.chain_keys(np.arange(12, dtype=np.int32))
    assert a == b[:2] and len(b) == 3
    mutated = np.arange(10, dtype=np.int32)
    mutated[1] = 99
    m = pc.chain_keys(mutated)
    assert m[0] != a[0] and m[1] != a[1]    # divergence cascades
    other = pfx.PrefixCache(8, chunk=4, salt="other")
    assert other.chain_keys(np.arange(10, dtype=np.int32))[0] != a[0]


def test_chain_disabled_without_chunk_or_const_leaves():
    assert pfx.PrefixCache(8).chain_ok is False
    assert pfx.PrefixCache(8).chain_keys(np.arange(8)) == []
    pc = pfx.PrefixCache(8, chunk=4, chain_ok=False)
    assert pc.chain_ok is False
    pc.insert_chain(b"k", [torch.zeros(2)])         # silently refused
    assert pc.info()["pages_resident"] == 0
    with pytest.raises(ValueError, match="max_pages"):
        pfx.PrefixCache(0)


def test_terminal_key_covers_features():
    pc = pfx.PrefixCache(8)
    prompt = np.arange(6, dtype=np.int32)
    r1 = scheduler.Request(rid=0, prompt=prompt, max_new_tokens=2,
                           features=np.ones((4, 8), np.float32))
    r2 = scheduler.Request(rid=1, prompt=prompt, max_new_tokens=2,
                           features=np.zeros((4, 8), np.float32))
    pc.insert_terminal(r1, [torch.zeros(2)], tok0=7)
    assert pc.lookup(r1).terminal is not None
    assert pc.lookup(r2).terminal is None


def test_peek_does_not_mutate():
    pc = pfx.PrefixCache(8, chunk=4)
    r = scheduler.Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                          max_new_tokens=2)
    pc.insert_terminal(r, [torch.zeros(2)], tok0=1)
    before = pc.info()
    assert pc.peek_cached_tokens(r) == 8
    after = pc.info()
    assert (after["hits"], after["misses"]) == (before["hits"],
                                                before["misses"])
    assert pc.warm_digest(r) and not pc.warm_digest(r)
    assert pc.peek_cached_tokens(r) == 8            # the memo's key


def test_lru_eviction_skips_pinned():
    pc = pfx.PrefixCache(2, chunk=4)
    keys = [bytes([i]) * 4 for i in range(3)]
    pc.insert_chain(keys[0], [torch.zeros(1)])
    pc.insert_chain(keys[1], [torch.zeros(1)])
    pinned = pc.pin([keys[0]])
    assert pinned == (keys[0],)
    pc.insert_chain(keys[2], [torch.zeros(1)])
    # the LRU victim would be keys[0], but it is pinned: keys[1] goes
    assert pc.info()["pages_evicted"] == 1
    assert pc.pin([keys[0]]) == (keys[0],)
    assert pc.pin([keys[1]]) == ()
    pc.release(pinned)
    pc.release((keys[0],))
    pc.insert_chain(bytes([9]) * 4, [torch.zeros(1)])
    assert pc.info()["pages_resident"] <= 2


def test_duplicate_insert_is_touch_not_growth():
    pc = pfx.PrefixCache(4, chunk=4)
    pc.insert_chain(b"a", [torch.zeros(1)])
    pc.insert_chain(b"a", [torch.ones(1)])
    info = pc.info()
    assert info["insertions"] == 1 and info["pages_resident"] == 1


@pytest.mark.parametrize("chunk,salt", [(4, "dense:4"), (None, "encdec:None"),
                                        (16, "")])
def test_keys_equal_reference_bytes(chunk, salt):
    """The same prompt (and features), chunk and salt give the
    reference's chain and terminal keys, byte for byte."""
    rng = np.random.default_rng(chunk or 1)
    for n in (3, 16, 37):
        prompt = rng.integers(0, 50000, n).astype(np.int32)
        feats = rng.standard_normal((5, 8)).astype(np.float32) \
            if chunk is None else None
        mine = pfx.PrefixCache(8, chunk=chunk, salt=salt)
        theirs = jpfx.PrefixCache(8, chunk=chunk, salt=salt)
        assert mine.chain_keys(prompt) == theirs.chain_keys(prompt)
        r = scheduler.Request(rid=0, prompt=prompt, max_new_tokens=1,
                              features=feats)
        jr = jsched.Request(rid=0, prompt=prompt, max_new_tokens=1,
                            features=feats)
        assert mine._terminal_key(r) == theirs._terminal_key(jr)
        assert pfx._features_digest(feats) == jpfx._features_digest(feats)


# ---------------------------------------------------------------------------
# slot-state page ops
# ---------------------------------------------------------------------------

def _noise(spec, n, t, seed=3):
    state = spec.init_state(n, t)
    g = torch.Generator().manual_seed(seed)
    for leaf in pytree.tree_leaves(state):
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=g))
        else:
            leaf.copy_(torch.randint(-3, 4, leaf.shape, generator=g))
    return state


def test_row_pages_match_reference():
    """The dense state's pages of a row, [lo, hi), equal the reference's
    `extract_row_pages` of the same state; writing them into another row
    in place equals the reference's `write_row_pages`."""
    cfg = tconfigs.get_reduced_config("smollm-135m")
    spec = slot_state.spec_for(cfg)
    jspec = jslot.spec_for(jconfigs.get_reduced_config("smollm-135m"))
    state = _noise(spec, 4, 32)
    jstate = {k: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for k, t in state.items()}
    mine = spec.extract_row_pages(state, 2, 5, 19)
    theirs = jspec.extract_row_pages(jstate, 2, 5, 19)
    assert len(mine) == len(theirs) == 2
    for a, b in zip(mine, theirs):
        assert a.device.type == "cpu" and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    ptrs = {k: t.data_ptr() for k, t in state.items()}
    assert spec.write_row_pages(state, 0, 7, mine) is state
    jout = jspec.write_row_pages(jstate, 0, 7, theirs)
    for k, t in state.items():
        assert t.data_ptr() == ptrs[k]
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(jout[k], np.float32))


@pytest.mark.parametrize("arch,kw", [("whisper-small", {"s_enc": 12}),
                                     ("jamba-v0.1-52b", {})])
def test_row_pages_round_trip_with_constant_leaves(arch, kw):
    """Constant-size leaves (cross K/V and lengths; SSM and conv state)
    come whole, or None without with_const; a round trip into another
    row copies exactly those bits and touches no other row."""
    spec = slot_state.spec_for(tconfigs.get_reduced_config(arch), **kw)
    state = _noise(spec, 3, 16)
    orig = {k: t.clone() for k, t in state.items()}
    pages = spec.extract_row_pages(state, 1, 0, 9)
    bare = spec.extract_row_pages(state, 1, 0, 9, with_const=False)
    for p, q, la, ba in zip(pages, bare, spec.length_axes,
                            spec.batch_axes):
        assert p.shape[ba] == 1
        assert (q is None) == (la is None)
        if la is not None:
            assert p.shape[la] == 9 and torch.equal(p, q)
    assert len(spec.const_leaves(state)) == \
        sum(la is None for la in spec.length_axes)
    spec.write_row_pages(state, 2, 0, pages)
    for i, (k, t) in enumerate(state.items()):
        ba, la = spec.batch_axes[i], spec.length_axes[i]
        assert torch.equal(t.select(ba, 0), orig[k].select(ba, 0))
        assert torch.equal(t.select(ba, 1), orig[k].select(ba, 1))
        got, src = t.select(ba, 2), orig[k].select(ba, 1)
        if la is None:
            assert torch.equal(got, src)
        else:
            lax = la - (la > ba)
            assert torch.equal(got.narrow(lax, 0, 9), src.narrow(lax, 0, 9))
            assert torch.equal(got.narrow(lax, 9, 7),
                               orig[k].select(ba, 2).narrow(lax, 9, 7))


# ---------------------------------------------------------------------------
# the port's invariants, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("silvia", ["off", "all"])
def test_chunked_equals_full_and_static(silvia):
    """prefill_chunk feeds prompts through the decode step 4 tokens at a
    time: every stream equals the full-prefill engine's and the static
    `generate` of the request alone (two of them sampled)."""
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    sp = scheduler.SamplingParams(temperature=0.9, top_k=8, seed=11)
    reqs = lambda: [dataclasses.replace(r, sampling=sp) if r.rid % 3 == 1  # noqa: E731,E501
                    else r for r in _zipf(cfg, n=6)]
    full = _run(_engine(cfg, params, silvia_passes=silvia), reqs())
    eng = _engine(cfg, params, silvia_passes=silvia, prefill_chunk=4)
    chunked = _run(eng, reqs())
    _same(full, chunked)
    for r in reqs():
        np.testing.assert_array_equal(chunked[r.rid],
                                      _static(cfg, params, r))
    info = eng.cache_info()
    assert info["dispatch_sites"]["prefill"] == 0
    assert info["dispatch_sites"]["chunk"] > 0
    assert all(k[0] != "prefill" for k in info["graph_keys"])
    assert info["graphs"] <= info["graph_bound"]
    assert info["captured"] == 0 and eng.min_prompt_bucket == 4


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen1.5-0.5b"])
def test_chunk_attention_over_key_blocks_equals_full(arch):
    """ROADMAP C12: a chunk of 16 queries over a prefill state of 768
    keys (three key blocks; past the row's own 300 positions, garbage
    masked causally) in a batch of 4 equals the same positions of a
    causal prefill of the 300 tokens alone (two blocks, the last
    zero-padded), bit for bit; and the key-blocked output product is
    the exact one within float32 rounding."""
    from repro_torch.models import attention
    cfg = tconfigs.get_config(arch)
    h, kv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = torch.Generator().manual_seed(12)
    length, t, c = 300, 768, 16

    def randn(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)
    q, k, v = randn(4, t, h, d), randn(4, t, kv, d), randn(4, t, kv, d)
    pos = torch.arange(t)
    one = attention._attend(q[:1, :length], k[:1, :length], v[:1, :length],
                            cfg, torch.bfloat16, pos[None, :length],
                            pos[None, :length])
    for c0 in range(0, length, c):
        qp = (c0 + torch.arange(c)).expand(4, -1)
        many = attention._attend(q[:, c0:c0 + c], k, v, cfg, torch.bfloat16,
                                 qp, pos.expand(4, -1))
        m = min(c, length - c0)
        assert torch.equal(one[:, c0:c0 + m], many[:1, :m]), c0
    w = torch.softmax(torch.randn((2, kv, h // kv, 5, t), generator=g), -1)
    vf = torch.randn((2, t, kv, d), generator=g)
    exact = torch.einsum("bkgst,btkd->bskgd", w.double(), vf.double())
    torch.testing.assert_close(attention._key_blocked_out(w, vf),
                               exact.float(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [4, None])
def test_warm_equals_cold(chunk):
    """Zipfian shared-prefix traffic through a pooled engine streams what
    the cold engine streams, bit for bit, chunked (chain and terminal
    hits) and full (terminal hits)."""
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    reqs = lambda: _zipf(cfg) + [  # noqa: E731
        dataclasses.replace(r, rid=100 + r.rid, arrival_time=5.0 + r.rid)
        for r in _zipf(cfg)[:3]]
    cold = _run(_engine(cfg, params, prefill_chunk=chunk), reqs())
    eng = _engine(cfg, params, prefill_chunk=chunk, prefix_cache=64)
    warm = _run(eng, reqs())
    _same(cold, warm)
    info = eng.cache_info()["prefix_cache"]
    assert info["chain_ok"] is (chunk is not None)
    assert info["hits"] > 0 and info["tokens_skipped"] > 0
    assert info["pages_resident"] > 0 and info["pages_pinned"] == 0
    assert eng.admission_plan() == 0                # nothing queued


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_terminal_repeat_makes_no_prefill_launch(family):
    """An exact repeat admits from the pool: pages and first token, no
    prefill or chunk launch, the stream of its first serving."""
    if family == "dense":
        _, cfg, _, params = _setup("bfloat16", "w8a8")
    else:
        params = (ssm_params if family == "ssm" else hybrid_params)(
            "float32", "w8a8")[1]
        arch = "mamba2-2.7b" if family == "ssm" else "jamba-v0.1-52b"
        cfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                                  dtype="float32")
        if family == "hybrid":
            cfg = dataclasses.replace(cfg, n_layers=8)
    kws = [{}] if family != "dense" else [{}, {"prefill_chunk": 4}]
    for kw in kws:
        eng = _engine(cfg, params, prefix_cache=64, **kw)
        first = _run(eng, _repeats(cfg, n_unique=2, repeats=0))
        sites = dict(eng._site_counts)
        again = [dataclasses.replace(r, rid=100 + r.rid, tokens=[])
                 for r in _repeats(cfg, n_unique=2, repeats=0)]
        second = _run(eng, again)
        assert eng._site_counts["prefill"] == sites["prefill"]
        assert eng._site_counts["chunk"] == sites["chunk"]
        for r in _repeats(cfg, n_unique=2, repeats=0):
            np.testing.assert_array_equal(first[r.rid], second[100 + r.rid])
            np.testing.assert_array_equal(first[r.rid],
                                          _static(cfg, params, r))
        info = eng.cache_info()["prefix_cache"]
        assert info["hits"] == 2
        assert info["chain_ok"] is ("prefill_chunk" in kw)


def test_budget_defers_and_stays_exact():
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    reqs = lambda: _zipf(cfg, n=8, rate=500.0)  # noqa: E731
    ref = _run(_engine(cfg, params, prefill_chunk=4), reqs())
    eng = _engine(cfg, params, prefill_chunk=4, prefix_cache=64,
                  admit_token_budget=8)
    _same(ref, _run(eng, reqs()))               # deferral reorders nothing
    adm = eng.cache_info()["admission"]
    assert adm["token_budget"] == 8 and adm["deferrals"] > 0
    assert all(r.outcome == res.OK for r in eng.finished)


def test_budget_head_request_always_admitted():
    """A prompt wider than the whole budget must not starve, and the
    budget counts only uncached tokens."""
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    big = scheduler.Request(rid=0, prompt=np.arange(20, dtype=np.int32) % 7,
                            max_new_tokens=3)
    small = scheduler.Request(rid=1, prompt=np.arange(5, dtype=np.int32),
                              max_new_tokens=3)
    eng = _engine(cfg, params, admit_token_budget=4, prefix_cache=8)
    out = _run(eng, [big, small])
    assert len(out[0]) == 3 and len(out[1]) == 3
    assert eng.cache_info()["admission"]["deferrals"] == 1
    again = [dataclasses.replace(r, rid=r.rid + 2, tokens=[])
             for r in (big, small)]
    assert [eng._prefix.peek_cached_tokens(r) for r in again] == [20, 5]
    out = _run(eng, again)              # both cached: cost 0, no deferral
    assert eng.cache_info()["admission"]["deferrals"] == 1
    np.testing.assert_array_equal(out[2], out[0])
    np.testing.assert_array_equal(out[3], out[1])


def test_admission_checks_match_reference():
    _, cfg, _, params = _setup("bfloat16", "w8a8")
    for kw, msg in (({"prefill_chunk": 3}, "power of two"),
                    ({"prefill_chunk": 128}, "multiple of prefill_chunk"),
                    ({"enc_len": 8}, "encdec-only")):
        with pytest.raises(ValueError, match=msg):
            _engine(cfg, params, **kw)
    ssm = dataclasses.replace(tconfigs.get_reduced_config("mamba2-2.7b"),
                              dtype="float32")
    with pytest.raises(ValueError, match="prefill-chunkable"):
        _engine(ssm, ssm_params("float32", "w8a8")[1], prefill_chunk=4)


# ---------------------------------------------------------------------------
# the port's engine against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"prefill_chunk": 4}, {"prefix_cache": 64}],
                         ids=["chunked", "prefix"])
def test_engine_matches_reference_engine(kw):
    """The same shared-prefix trace through both engines on the same
    weights (bf16, w8a8): per request, while the streams agree, the
    port's token equals the reference's wherever the reference's
    teacher-forced top-two margin exceeds 2 x LOGIT_TOL, and elsewhere
    scores within LOGIT_TOL of its max (ROADMAP C2)."""
    jcfg, tcfg, jp, tp = _setup("bfloat16", "w8a8")
    want = jengine.ServeEngine(jp, jcfg, n_slots=2, max_cache_len=64,
                               segment_len=4, chaos=None, **kw).run(
        _zipf(tcfg, n=6, sched=jsched), clock=jsched.FastForwardClock())
    reqs = _zipf(tcfg, n=6)
    got = _run(_engine(tcfg, tp, **kw), reqs)
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
