"""The port's per-request sampling (`repro_torch/launch/sampling.py`)
against `repro/launch/sampling.py` and JAX's PRNG.

* threefry2x32 in torch: `prng_key`, `fold_in`, the random bits behind
  `jax.random.bits` / `uniform` (partitionable form, JAX's default) bit
  for bit; the Gumbel floats within GUMBEL_ATOL: `-log(-log(u))` runs
  through torch's `log`, the reference through XLA's, whose inner log
  differs by one ulp on ~14% of inputs (measured: at most 4.8e-7
  absolute on 50000 draws).
* `sample` against the reference's jitted `sample`: greedy rows equal
  (the argmax); sampled rows equal wherever the reference's top-two gap
  of `where(keep, x + gumbel, -inf)` exceeds 2 x GUMBEL_ATOL (ROADMAP C2's
  rule; the top-p prefix sum is summed in another order too), and
  elsewhere the port's pick scores within that of the reference's best.
* Port-internal invariants bit for bit: a row sampled alone equals the
  same row in a batch; the captured step's sampled variant (its buffers
  run eagerly on the CPU) equals the per-step loop; an all-greedy
  `sampling=` list is the greedy path.
* `generate(sampling=, rids=)` against the reference's, teacher-forced,
  under the same rule with the logits' tolerance divided by the
  temperature added.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import sampling as jsampling  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import sampling  # noqa: E402
from repro_torch.launch import scheduler  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from test_torch_serve import LOGIT_TOL, _reference_logits, _setup  # noqa: E402

GUMBEL_ATOL = 1e-6
SP = scheduler.SamplingParams(temperature=0.9, top_k=8, seed=11)
SP_NUCLEUS = scheduler.SamplingParams(temperature=0.7, top_p=0.9, seed=3)
SP_BOTH = scheduler.SamplingParams(temperature=1.3, top_k=20, top_p=0.6,
                                   seed=5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jparams(p):
    return jsched.SamplingParams(temperature=p.temperature, top_k=p.top_k,
                                 top_p=p.top_p, seed=p.seed)


def _words(key):
    return [int(w) for w in np.asarray(key, np.uint32)]


# ---------------------------------------------------------------------------
# threefry2x32
# ---------------------------------------------------------------------------

def test_prng_key_and_fold_in_match_jax():
    for seed in (0, 1, 7, 12345, -3, 2 ** 31 - 1):
        assert _words(jax.random.PRNGKey(seed)) == \
            sampling.prng_key(seed).tolist()
    for seed, rid in ((0, 0), (1, 5), (11, 3), (2, 123456), (9, 2 ** 32 - 1)):
        want = jax.random.fold_in(jax.random.PRNGKey(seed), rid)
        assert tuple(_words(want)) == sampling.base_key(seed, rid)
    # row-wise fold_in of [B, 2] keys with [B] data (the per-token key)
    keys = [jax.random.fold_in(jax.random.PRNGKey(s), r)
            for s, r in ((0, 1), (3, 4), (8, 2))]
    t = np.array([0, 5, 77])
    want = [_words(jax.random.fold_in(k, int(i))) for k, i in zip(keys, t)]
    got = sampling.fold_in(torch.tensor([_words(k) for k in keys]),
                           torch.from_numpy(t))
    assert got.tolist() == want


@pytest.mark.parametrize("n", [1, 1000, 4099])
def test_random_bits_and_uniform_match_jax(n):
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), i) for i in (9, 10)]
    tk = torch.tensor([_words(k) for k in keys])
    bits = sampling.random_bits(tk, n).numpy().astype(np.uint32)
    u = sampling.uniform(tk, n).numpy()
    tiny = np.finfo(np.float32).tiny
    for row, k in enumerate(keys):
        np.testing.assert_array_equal(
            bits[row], np.asarray(jax.random.bits(k, (n,), jnp.uint32)))
        np.testing.assert_array_equal(u[row], np.asarray(jax.random.uniform(
            k, (n,), jnp.float32, minval=tiny, maxval=1.0)))


def test_gumbel_within_tolerance():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    want = np.asarray(jax.random.gumbel(key, (50000,), jnp.float32))
    got = sampling.gumbel(torch.tensor([_words(key)]), 50000)[0].numpy()
    assert np.abs(got - want).max() <= GUMBEL_ATOL
    assert (got == want).mean() > 0.5


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def _operand(params, rids, t):
    key = torch.tensor([sampling.base_key(p.seed, r)
                        for p, r in zip(params, rids)])
    return (key, torch.tensor([p.temperature for p in params]),
            torch.tensor([p.top_k for p in params]),
            torch.tensor([p.top_p for p in params]), torch.as_tensor(t))


def _reference_scores(rows, params, rids, t):
    """The reference's `where(keep, x + gumbel, -inf)` per row (the
    quantity its Gumbel-max argmax picks from), from its own ops."""
    out = []
    for row, p, r, i in zip(rows, params, rids, t):
        x = jnp.asarray(row)[None] / jnp.maximum(
            jnp.float32(p.temperature), 1e-6)
        v = x.shape[-1]
        srt = jnp.sort(x, axis=-1)[:, ::-1]
        kk = p.top_k if 0 < p.top_k <= v else v
        keep = x >= srt[:, kk - 1:kk]
        probs = jax.nn.softmax(srt, axis=-1)
        excl = jnp.cumsum(probs, axis=-1) - probs
        thr_p = jnp.min(jnp.where(excl < p.top_p, srt, jnp.inf))
        keep = keep & (x >= thr_p)
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(p.seed), r), int(i))
        g = jax.random.gumbel(k, (v,), jnp.float32)
        out.append(np.asarray(jnp.where(keep, x + g, -jnp.inf))[0])
    return np.stack(out)


def assert_sampled_match(got, want, scores, tol):
    """ROADMAP C2's rule for sampled tokens: equal where the reference's
    top-two gap of its scores exceeds 2 * tol; elsewhere the port's pick
    within tol of the reference's best.  Returns the rows compared."""
    compared = 0
    for g, w, z in zip(got, want, scores):
        top2 = np.sort(z)[-2:]
        if top2[1] - top2[0] > 2 * tol:
            assert g == w
            compared += 1
        else:
            assert z[g] >= z.max() - tol
    return compared


def test_sample_matches_reference():
    rng = np.random.default_rng(0)
    mix = [SP, scheduler.GREEDY, SP_NUCLEUS, SP_BOTH,
           scheduler.SamplingParams(temperature=0.5, seed=2),
           scheduler.SamplingParams(temperature=2.0, top_k=1000, seed=9)]
    compared = 0
    for trial in range(6):
        rows = (rng.normal(size=(len(mix), 512)) * 3).astype(np.float32)
        rids = list(range(10 * trial, 10 * trial + len(mix)))
        t = rng.integers(0, 50, len(mix))
        got = sampling.sample(torch.from_numpy(rows),
                              *_operand(mix, rids, t)).numpy()
        jop = jsampling.static_operand([_jparams(p) for p in mix], 0, rids)
        want = np.asarray(jax.jit(jsampling.sample)(
            jnp.asarray(rows), jop[0], jop[1], jop[2], jop[3],
            jnp.asarray(t, jnp.int32)))
        assert got[1] == want[1] == rows[1].argmax()
        compared += assert_sampled_match(
            got, want, _reference_scores(rows, mix, rids, t), GUMBEL_ATOL)
    assert compared >= 30


def test_sample_row_alone_equals_batch_row():
    rows = torch.randn((4, 300), generator=torch.Generator().manual_seed(5))
    params = [SP, SP_NUCLEUS, scheduler.GREEDY, SP_BOTH]
    batch = sampling.sample(rows, *_operand(params, range(4), range(4)))
    for r in range(4):
        assert int(batch[r]) == sampling.sample_host(rows[r], params[r], r, r)
        req = scheduler.Request(rid=r, prompt=[1], max_new_tokens=2,
                                sampling=params[r])
        assert sampling.expected_token(req, rows[r], r) == int(batch[r])


def test_host_page_round_trip():
    page = sampling.host_page(4)
    req = scheduler.Request(rid=7, prompt=[1, 2, 3], max_new_tokens=2,
                            sampling=SP)
    sampling.write_row(page, 2, req)
    assert page[1][2] == np.float32(SP.temperature)
    assert page[2][2] == SP.top_k and page[4][2] == 3
    assert tuple(page[0][2]) == sampling.base_key(SP.seed, 7)
    page = sampling.permute(page, np.asarray([2, 0, 1, 3]))
    assert page[2][0] == SP.top_k          # the row moved with its slot
    sampling.clear_row(page, 0)
    assert page[1][0] == 0.0 and page[3][0] == 1.0
    op = sampling.operand(page, 2)
    assert [tuple(t.shape) for t in op] == [(2, 2), (2,), (2,), (2,), (2,)]
    assert sampling.static_operand([None, scheduler.GREEDY], 5) is None


# ---------------------------------------------------------------------------
# generate(sampling=, rids=)
# ---------------------------------------------------------------------------

B, S, G = 3, 8, 8


def test_generate_sampled_matches_reference():
    """The port's sampled generate against the reference's on the same
    weights (bf16, w8a8): per row and step, while the contexts agree, the
    C2 rule on the reference's teacher-forced scores, with the logits'
    tolerance over the temperature added to the Gumbel one."""
    jcfg, tcfg, jp, tp = _setup("bfloat16", "w8a8")
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    mix = [SP, SP_NUCLEUS, scheduler.SamplingParams(temperature=0.6,
                                                    seed=1)]
    rids = [3, 8, 1]
    want = np.asarray(jserve.generate(
        jp, jnp.asarray(prompts), jcfg, gen=G, cache_len=S + G,
        sampling=[_jparams(p) for p in mix], rids=rids))
    got = tserve.generate(tp, prompts, tcfg, gen=G, cache_len=S + G,
                          device="cpu", sampling=mix, rids=rids).numpy()
    ref_logits = _reference_logits(jp, jcfg, prompts, want)
    compared = 0
    for b in range(B):
        tol = LOGIT_TOL["bfloat16"] / mix[b].temperature + GUMBEL_ATOL
        for t in range(G):
            z = _reference_scores(ref_logits[b, t][None], [mix[b]],
                                  [rids[b]], [t])
            compared += assert_sampled_match(got[b, t:t + 1],
                                             want[b, t:t + 1], z, tol)
            if got[b, t] != want[b, t]:
                break
    assert compared >= B * 2


def test_sampled_captured_step_matches_stepwise():
    """The captured step's sampled variant, its buffers run eagerly (the
    CPU has no graph), equals the per-step loop; greedy rows of the
    sampled batch, and an all-greedy `sampling=` list, are the greedy
    stream."""
    _, tcfg, _, tp = _setup("bfloat16", "w4a8")
    prompts = np.random.default_rng(6).integers(0, tcfg.vocab, (B, S))
    mix = [SP, scheduler.GREEDY, SP_BOTH]
    want, want_logits = tserve.generate(
        tp, prompts, tcfg, gen=G, cache_len=S + G, device="cpu",
        sampling=mix, rids=[4, 5, 6], return_logits=True, fused=False)
    bundle = tserve._decode_bundle(tcfg, "off", "cpu")
    logits, cache = tserve.lm.prefill(tp, torch.as_tensor(prompts), tcfg,
                                      cache_len=S + G)
    samp = sampling.static_operand(mix, S, [4, 5, 6])
    step = bundle.captured(tp, B, S + G, True, G - 1, torch.device("cpu"),
                           sampled=True)
    assert step.graph is None and step.samp is not None
    toks, seen = step.run(want[:, :1].long(), cache, S, G - 1, samp)
    assert torch.equal(toks, want[:, 1:])
    assert torch.equal(seen, want_logits[:, 1:])
    greedy = tserve.generate(tp, prompts, tcfg, gen=G, cache_len=S + G,
                             device="cpu")
    assert torch.equal(want[1], greedy[1])
    assert torch.equal(tserve.generate(
        tp, prompts, tcfg, gen=G, cache_len=S + G, device="cpu",
        sampling=[None, scheduler.GREEDY, None]), greedy)
    with pytest.raises(ValueError, match="sampling operand"):
        step.run(want[:, :1].long(), cache, S, 2)
