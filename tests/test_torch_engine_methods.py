"""The port's score and embed methods (`repro_torch/launch/engine.py`
slice 4, `launch/methods.py`, `models/lm.py::embed_pool`).

* Score: each request's logprobs equal, float for float, the port's own
  teacher-forced `lm.prefill` + `lm.decode_step` at batch 1 over prompt +
  completion through `methods.logprob_from_logits` (the reference's
  tests/test_frontend.py::test_score_matches_decode_path), for dense,
  ssm, hybrid and encdec, and with `prefill_chunk` and `prefix_cache`
  (a score request never takes the pool's terminal-hit shortcut).
* Embed: each vector equals `lm.embed_pool` of its prompt alone at its
  own length, bit for bit, whatever its batch mates and prompt bucket;
  an embed takes no slot and is served while every slot is busy.
* `logprob_from_logits` gives the reference's float on the same row,
  bit for bit.
* Against the reference's engine (`repro.launch.engine.ServeEngine` with
  `score_request` / `embed_request`) on the same weights and trace,
  dense (bf16 w8a8) and encdec (bf16 w8a8): logprobs within twice C1's
  logit tolerance of the reference's row (`test_torch_serve.LOGIT_TOL`,
  scaled for encdec as tests/test_torch_encdec.py scales it; a logprob
  is a logit less the row's logsumexp, each within the tolerance);
  embeddings within the tolerance tests/test_torch_model.py holds its
  caches to (EMBED_TOL: float32 2e-3, bf16 0.125).
  Score is teacher-forced in both engines by construction: the
  completion is the input, so an int8 rounding tie (C8) moves a logit by
  its step, inside the tolerance, and never a later context.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.launch import engine as jengine  # noqa: E402
from repro.launch import methods as jmethods  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro_torch.launch import methods  # noqa: E402
from repro_torch.launch import resilience as res  # noqa: E402
from repro_torch.launch import scheduler  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_encdec import _cfgs as encdec_cfgs  # noqa: E402
from test_torch_encdec import (_jit_decode, _jit_prefill,  # noqa: E402
                               _logit_tol)
from test_torch_encdec import params_for as encdec_params  # noqa: E402
from test_torch_model import CACHE_TOL  # noqa: E402
from test_torch_resilience import (ENC_LEN, FAMILIES, engine,  # noqa: E402
                                   family, requests, run)
from test_torch_serve import LOGIT_TOL, _setup  # noqa: E402

# embeddings against the reference: the tolerance tests/test_torch_model.py
# holds the hidden-state-sized values of its caches to, per dtype (a
# post-norm hidden state is O(1), where one bf16 step is ~0.008)
EMBED_TOL = CACHE_TOL
SCORES = ("score", "generate", "score", "score", "embed", "score")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, r, tokens):
    t = torch.as_tensor(np.asarray(tokens, np.int64)[None])
    if cfg.family != "encdec":
        return t
    return torch.as_tensor(r.features[None]), t


def teacher_forced(cfg, params, r) -> list:
    """The logprobs of r's completion from the port's lm.prefill of the
    prompt and lm.decode_step of each completion token, at batch 1."""
    comp = list(r.score_tokens)
    lg, cache = lm.prefill(params, _inputs(cfg, r, r.prompt), cfg,
                           cache_len=r.prompt_len + len(comp))
    out = [methods.logprob_from_logits(lg[0, -1].numpy(), comp[0])]
    for t in range(1, len(comp)):
        lg, cache = lm.decode_step(
            params, torch.tensor([[comp[t - 1]]]), cache,
            torch.tensor([r.prompt_len + t - 1]), cfg)
        out.append(methods.logprob_from_logits(lg[0, -1].numpy(), comp[t]))
    return out


def embed_alone(cfg, params, r) -> np.ndarray:
    enc = None if cfg.family != "encdec" else \
        torch.tensor([r.features.shape[0]])
    return lm.embed_pool(params, _inputs(cfg, r, r.prompt), cfg,
                         enc_lengths=enc)[0].numpy()


def _check(cfg, params, reqs, got) -> None:
    n = {"score": 0, "embed": 0}
    for r in reqs:
        g = got[r.rid]
        assert g.outcome == res.OK, r.rid
        if r.method == "score":
            assert methods.completion_logprobs(g) == \
                teacher_forced(cfg, params, r), r.rid
        elif r.method == "embed":
            np.testing.assert_array_equal(methods.embedding(g),
                                          embed_alone(cfg, params, r))
        n[r.method] = n.get(r.method, 0) + 1
    assert n["score"] and n["embed"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_score_and_embed_equal_the_single_request_paths(fam):
    cfg, params = family(fam)
    reqs = requests(cfg, methods_=SCORES)
    eng = engine(cfg, params, chaos=None)
    got = run(eng, reqs)
    _check(cfg, params, reqs, got)
    admits = eng.cache_info()["methods"]["admits"]
    assert admits == {"generate": 1, "score": 4, "embed": 1}
    assert eng.replay_steps > 0 and eng.cache_info()["robustness"][
        "replayed_tokens"] == 0


@pytest.mark.parametrize("kw", [{"prefill_chunk": 4},
                                {"prefix_cache": 64},
                                {"prefill_chunk": 4, "prefix_cache": 64}])
def test_score_with_chunked_prefill_and_prefix_cache(kw):
    """Score requests through the chunked and the pooled admissions; a
    score request repeating a pooled prompt takes no terminal hit (its
    first logprob needs the prefill's logits row), and is not looked up."""
    cfg, params = family("dense")
    reqs = requests(cfg, methods_=SCORES)
    again = [dataclasses.replace(r, rid=r.rid + 10, tokens=[],
                                 logprobs=[], embedding=None)
             for r in reqs]
    eng = engine(cfg, params, chaos=None, **kw)
    got = run(eng, reqs)
    lookups = None if "prefix_cache" not in kw else \
        eng.cache_info()["prefix_cache"]
    got.update(run(eng, again))
    _check(cfg, params, reqs + again, got)
    for r, a in zip(reqs, again):
        assert got[a.rid].logprobs == got[r.rid].logprobs
        assert got[a.rid].tokens == got[r.rid].tokens
    if lookups is not None:
        pc = eng.cache_info()["prefix_cache"]
        n_gen = sum(r.method == "generate" for r in again)
        # only the generate repeat looked the pool up, and hit
        assert pc["hits"] + pc["misses"] == \
            lookups["hits"] + lookups["misses"] + n_gen
        assert pc["hits"] == lookups["hits"] + n_gen


def test_embed_is_invariant_and_takes_no_slot():
    """Every slot busy with long generates: embeds of several prompt
    buckets, in groups with mates, are served (n_slots of them a step),
    each vector bit for bit its prompt alone at its own length; no slot
    was taken."""
    cfg, params = family("dense")
    eng = engine(cfg, params, chaos=None, n_slots=2)
    gens = requests(cfg, n=2, gens=(40, 40))
    for r in gens:
        eng.submit(r)
    clock = scheduler.FastForwardClock()
    eng.step(clock)
    assert eng.n_active == 2
    busy = [r.rid for r in eng._slot_req]
    rng = np.random.default_rng(3)
    embeds = [methods.embed_request(10 + i, rng.integers(0, cfg.vocab, n))
              for i, n in enumerate((3, 5, 9, 13, 8, 2, 16))]
    for r in embeds:
        eng.submit(r)
    for _ in range(4):
        eng.step(clock)
        assert [r.rid for r in eng._slot_req] == busy
    for r in embeds:
        v = methods.embedding(eng.result(r.rid))
        np.testing.assert_array_equal(v, embed_alone(cfg, params, r))
    keys = sorted(k for k in eng._graphs if k[0] == "embed")
    assert keys == [("embed", 1, 16), ("embed", 2, 8), ("embed", 2, 16)]
    # the same prompt alone and beside mates of another length
    lone = engine(cfg, params, chaos=None)
    got = run(lone, [dataclasses.replace(embeds[2], rid=0, embedding=None)])
    np.testing.assert_array_equal(got[0].embedding,
                                  methods.embedding(eng.result(12)))
    with pytest.raises(RuntimeError, match="not an embed request"):
        methods.embedding(res.RequestResult(0, res.OK, [1]))
    with pytest.raises(RuntimeError, match="outcome"):
        methods.completion_logprobs(res.RequestResult(0, res.FAILED, []))


@pytest.mark.parametrize("fam", ["dense", "ssm"])
def test_embed_pool_ignores_padding_and_batch_mates(fam):
    """lm.embed_pool itself: a row padded to a bucket in a batch of 8
    mates equals the row alone, bit for bit."""
    cfg, params = family(fam)
    g = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab, (8, 16), generator=g)
    lens = torch.tensor([7, 16, 3, 12, 1, 9, 16, 5])
    batch = lm.embed_pool(params, prompts, cfg, last_positions=lens - 1)
    for i in (0, 2, 4):
        one = lm.embed_pool(params, prompts[i:i + 1, :int(lens[i])], cfg)
        assert torch.equal(one[0], batch[i]), i
    assert batch.dtype == torch.float32 and batch.shape == (8, cfg.d_model)


def test_logprob_from_logits_matches_reference():
    rng = np.random.default_rng(0)
    for scale in (0.1, 3.0, 40.0):
        rows = (rng.standard_normal((20, 513)) * scale).astype(np.float32)
        for row in rows:
            for tok in (0, int(row.argmax()), 512):
                assert methods.logprob_from_logits(row, tok) == \
                    jmethods.logprob_from_logits(row, tok)


def _reference_rows(jcfg, jp, r) -> list:
    """The reference's teacher-forced logits rows of r's completion (their
    largest logit scales the encdec tolerance)."""
    comp = list(r.score_tokens)
    toks = jnp.asarray(r.prompt[None])
    inputs = toks if r.features is None else \
        (jnp.asarray(r.features[None]), toks)
    lg, cache = _jit_prefill(jp, inputs, jcfg, r.prompt_len + len(comp))
    rows = [np.asarray(lg[0, -1], np.float32)]
    for t in range(1, len(comp)):
        lg, cache = _jit_decode(jp, jnp.asarray([[comp[t - 1]]], jnp.int32),
                                cache, jnp.asarray([r.prompt_len + t - 1],
                                                   jnp.int32), jcfg)
        rows.append(np.asarray(lg[0, -1], np.float32))
    return rows


@pytest.mark.parametrize("fam,dtype", [("dense", "float32"),
                                       ("dense", "bfloat16"),
                                       ("encdec", "bfloat16")])
def test_score_and_embed_match_reference_engine(fam, dtype):
    """The port's engine against the reference's on the same weights and
    trace.  A logprob is the token's logit less the row's logsumexp, and
    the logsumexp moves by at most the row's largest logit error, so a
    logprob is held within twice the logit tolerance of its reference
    row: C1's LOGIT_TOL (dense), scaled by the row's largest logit as
    tests/test_torch_encdec.py scales it (`_logit_tol`, encdec).
    Embeddings within EMBED_TOL."""
    if fam == "dense":
        jcfg, cfg, jp, params = _setup(dtype, "w8a8")
    else:
        jcfg = encdec_cfgs(dtype="bfloat16")[0]
        jp, params = encdec_params("bfloat16", "w8a8")
        cfg = family("encdec")[0]
    mine = requests(cfg, methods_=SCORES)
    ref_reqs = []
    for r in mine:
        kw = dict(arrival_time=r.arrival_time, features=r.features)
        if r.method == "score":
            ref_reqs.append(jmethods.score_request(r.rid, r.prompt,
                                                   r.score_tokens, **kw))
        elif r.method == "embed":
            ref_reqs.append(jmethods.embed_request(r.rid, r.prompt, **kw))
        else:
            ref_reqs.append(jmethods.generate_request(
                r.rid, r.prompt, r.max_new_tokens, **kw))
    kw = {"enc_len": ENC_LEN} if fam == "encdec" else {}
    jeng = jengine.ServeEngine(jp, jcfg, n_slots=4, max_cache_len=64,
                               segment_len=4, chaos=None, **kw)
    jeng.run(ref_reqs, clock=jsched.FastForwardClock())
    want = jeng.results()
    got = run(engine(cfg, params, chaos=None), mine)
    n = 0
    for r in mine:
        if r.method == "score":
            rows = _reference_rows(jcfg, jp, r)
            logit_tol = LOGIT_TOL[dtype] if fam == "dense" else \
                _logit_tol(dtype, "w8a8", np.stack(rows))
            np.testing.assert_allclose(got[r.rid].logprobs,
                                       want[r.rid].logprobs, rtol=0,
                                       atol=2 * logit_tol,
                                       err_msg=str(r.rid))
            n += 1
        elif r.method == "embed":
            np.testing.assert_allclose(got[r.rid].embedding,
                                       want[r.rid].embedding, rtol=0,
                                       atol=EMBED_TOL[dtype],
                                       err_msg=str(r.rid))
            n += 1
    assert n == 5
