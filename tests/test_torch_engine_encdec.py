"""The encoder-decoder family (whisper) through the port's engine
(`repro_torch/launch/engine.py`): `enc_len`, per-request ragged
`features`, encoder-length buckets and the encdec slot state.

* Engine == the port's static `generate` of each request alone, bit for
  bit: 3 requests over 2 slots (eviction, re-admission), with SILVIA
  passes off and all; a ragged mix of frame counts (every encoder
  bucket, one request of a single frame) and prompt lengths.
* The encoder's attention in a bucket equals the frames alone, bit for
  bit (ROADMAP C12's key-blocked output product).
* A terminal repeat (same prompt, same features) makes no prefill
  launch and streams what its first serving streamed; the same prompt
  with other features does not hit.
* The port's engine against the reference's engine on the same weights
  and ragged trace (bf16 w8a8): ROADMAP C2's rule on the reference's
  teacher-forced logits.
* warmup() covers every encoder bucket, within `graph_bound()`; the
  reference's checks on `enc_len`, `features` and chunking.
Weights are the reference's init (tests/test_torch_encdec.py's, its
norms and biases perturbed), converted.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.launch import engine as jengine  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro_torch.launch import scheduler, serve  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.models import slot_state  # noqa: E402
from test_torch_encdec import (_cfgs, _jit_decode, _jit_prefill,  # noqa: E402
                               _logit_tol, params_for)

ENC_LEN = 24
D = 64                          # the reduced whisper's d_model


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dtype="bfloat16", fmt="w8a8"):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    return jcfg, tcfg, jp, tp


def _features(frames, seed):
    return np.random.default_rng(seed).standard_normal(
        (frames, D)).astype(np.float32)


def _requests(shape, sched=scheduler, rid0=0, stagger=0.0):
    """One request per (frames, prompt_len, gen), seeded per index."""
    return [sched.Request(
        rid=rid0 + i, max_new_tokens=g, arrival_time=stagger * i,
        prompt=np.random.default_rng(50 + i).integers(0, 256, s)
        .astype(np.int32), features=_features(f, 60 + i))
        for i, (f, s, g) in enumerate(shape)]


THREE = [(ENC_LEN, 12, 8)] * 3
# every encoder bucket (8, 16, 24), a single frame, ragged prompts
RAGGED = [(24, 5, 6), (17, 9, 4), (9, 3, 7), (1, 12, 3), (16, 8, 5),
          (3, 4, 6), (20, 16, 2)]


def _engine(cfg, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_cache_len", 32)
    kw.setdefault("segment_len", 4)
    kw.setdefault("enc_len", ENC_LEN)
    return ServeEngine(params, cfg, device="cpu", **kw)


def _run(eng, reqs):
    return eng.run(reqs, clock=scheduler.FastForwardClock())


def _static(cfg, params, r, silvia="off"):
    return serve.generate(
        params, (r.features[None], r.prompt[None]), cfg,
        gen=r.max_new_tokens, cache_len=r.prompt_len + r.max_new_tokens,
        device="cpu", silvia_passes=silvia)[0].numpy()


@pytest.mark.parametrize("silvia", ["off", "all"])
def test_three_requests_two_slots_match_static(silvia):
    _, cfg, _, params = _setup()
    reqs = _requests(THREE)
    eng = _engine(cfg, params, silvia_passes=silvia)
    out = _run(eng, reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid],
                                      _static(cfg, params, r, silvia))
    info = eng.cache_info()
    assert info["family"] == "encdec" and info["enc_buckets"] == [8, 16, 24]
    assert info["graphs"] <= info["graph_bound"]
    # the cross K/V pages are constant-size leaves, padded to enc_len
    assert tuple(eng._cache["cross_k"].shape[2:]) == (ENC_LEN, cfg.n_kv,
                                                      cfg.head_dim)


def test_ragged_mix_matches_static_and_warmup_covers_it():
    """Ragged frame counts and prompts through 2 slots: each stream is
    the static `generate` of its request alone (its frames unpadded);
    warmup() walks every (batch, prompt, encoder) bucket the traffic
    meets, and serving adds no graph."""
    _, cfg, _, params = _setup()
    reqs = _requests(RAGGED, stagger=0.01)
    eng = _engine(cfg, params)
    n = eng.warmup(prompt_lens=sorted({r.prompt_len for r in reqs}))
    warmed = set(eng._graphs)
    assert n == len(warmed) <= eng.graph_bound()
    assert {k[-1] for k in warmed if k[0] == "prefill"} == {8, 16, 24}
    out = _run(eng, reqs)
    assert eng._graphs == warmed
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], _static(cfg, params, r),
                                      err_msg=str(r.rid))


@pytest.mark.parametrize("length,eb", [(300, 512), (500, 512),
                                       (1000, 1024)])
def test_encoder_attention_in_bucket_equals_frames_alone(length, eb):
    """ROADMAP C12: whisper-small's encoder attention over a row's frames
    padded to its bucket in a batch of 2 (`kv_lengths` masking the
    padding) equals the frames alone, bit for bit, at full width: the
    output product sums over key blocks (`attention._key_blocked_out`).
    One einsum over the keys gave 6-41 other elements here on the CPU."""
    from repro_torch import configs
    from repro_torch.models import attention
    cfg = configs.get_config("whisper-small")
    h, kv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = torch.Generator().manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)
    lens = torch.tensor([length, eb - 7])
    q, k, v = randn(2, eb, h, d), randn(2, eb, kv, d), randn(2, eb, kv, d)
    many = attention._attend(q, k, v, cfg, torch.bfloat16,
                             valid=attention._valid(lens, eb, "cpu"))
    one = attention._attend(q[:1, :length], k[:1, :length],
                            v[:1, :length], cfg, torch.bfloat16)
    assert torch.equal(one, many[:1, :length])


def test_terminal_repeat_makes_no_prefill_launch():
    """The repeat of a (prompt, features) pair admits from the pool: no
    prefill launch, its first serving's stream; the same prompt with
    other features is a miss."""
    _, cfg, _, params = _setup()
    eng = _engine(cfg, params, prefix_cache=8)
    first = _requests(RAGGED[:3])
    out = _run(eng, first)
    n_pre = eng._site_counts["prefill"]
    again = [dataclasses.replace(r, rid=r.rid + 10, tokens=[])
             for r in first]
    out2 = _run(eng, again)
    assert eng._site_counts["prefill"] == n_pre
    for r in first:
        np.testing.assert_array_equal(out2[r.rid + 10], out[r.rid])
    other = dataclasses.replace(first[0], rid=20, tokens=[],
                                features=_features(24, 99))
    _run(eng, [other])
    assert eng._site_counts["prefill"] == n_pre + 1
    info = eng.cache_info()["prefix_cache"]
    assert info["hits"] == 3 and info["chain_ok"] is False
    np.testing.assert_array_equal(eng.result(20).tokens,
                                  _static(cfg, params, other))


def test_checks_match_reference():
    _, cfg, _, params = _setup()
    with pytest.raises(ValueError, match="needs enc_len"):
        ServeEngine(params, cfg, device="cpu")
    with pytest.raises(ValueError, match="prefill-chunkable"):
        _engine(cfg, params, prefill_chunk=4)
    eng = _engine(cfg, params)
    for feats in (None, np.zeros((ENC_LEN + 1, D), np.float32),
                  np.zeros((4, D + 1), np.float32),
                  np.zeros((0, D), np.float32)):
        with pytest.raises(ValueError, match="features of shape"):
            eng.submit(scheduler.Request(rid=len(eng._rids), prompt=[1, 2],
                                         max_new_tokens=2, features=feats))
    spec = slot_state.spec_for(cfg, s_enc=ENC_LEN)
    assert eng._spec is spec and not spec.prefill_chunkable


def test_engine_matches_reference_engine():
    """Five requests of the ragged mix (every encoder bucket) through both
    engines (bf16, w8a8), ROADMAP C2's rule per request on the
    reference's teacher-forced logits of that request alone."""
    jcfg, tcfg, jp, tp = _setup()
    want = jengine.ServeEngine(jp, jcfg, n_slots=2, max_cache_len=32,
                               segment_len=4, enc_len=ENC_LEN,
                               chaos=None).run(
        _requests(RAGGED[:5], sched=jsched, stagger=0.01),
        clock=jsched.FastForwardClock())
    reqs = _requests(RAGGED[:5], stagger=0.01)
    got = _run(_engine(tcfg, tp), reqs)
    compared = 0
    for r in reqs:
        w, g = np.asarray(want[r.rid]), got[r.rid]
        assert len(w) == len(g) == r.max_new_tokens
        inputs = (jnp.asarray(r.features[None]), jnp.asarray(r.prompt[None]))
        lg, c = _jit_prefill(jp, inputs, jcfg, r.prompt_len + len(w))
        rows = [np.asarray(lg[0, -1], np.float32)]
        for t in range(1, len(w)):
            lg, c = _jit_decode(jp, jnp.asarray([[w[t - 1]]], jnp.int32), c,
                                jnp.asarray([r.prompt_len + t - 1],
                                            jnp.int32), jcfg)
            rows.append(np.asarray(lg[0, -1], np.float32))
        tol = _logit_tol("bfloat16", "w8a8", np.stack(rows))
        for t, ref in enumerate(rows):
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > 2 * tol:
                assert g[t] == w[t], (r.rid, t)
                compared += 1
            else:
                assert ref[g[t]] >= ref.max() - tol, (r.rid, t)
            if g[t] != w[t]:
                break
    assert compared > 0
