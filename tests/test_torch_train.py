"""Training's substrate in the port against `repro`: the schedule, AdamW,
the global norm, gradient compression, the data pipeline, the fault
tools, one train step, microbatching, the fault-tolerant loop
(`launch/train.py`), checkpoints of {params, opt}, and the refusals of
what waits for training's multi-rank half (ROADMAP A12).

Every input is numpy from a seed; the reference's functions run as the
reference runs them (its optimizer and compression op by op, its train
step under `jax.jit`, unsharded: ROADMAP C-ref2).

Tolerances and why (measured on these inputs):
* `warmup_cosine`, `compress_grads` / `decompress_grads`, `batch_at`
  and the fault tools: bit for bit (exact equality).
* `adamw_update` and `global_norm`: the global norm sums each leaf's
  squares in torch's order, not XLA's (<= 1 ulp here), and torch's
  float32 `pow` may round the bias corrections another way than
  XLA's: params, moments and metrics within OPT_RTOL 1e-6 of their
  largest magnitude (measured <= 2.4e-7).
* One train step (float32 reduced smollm and granite-moe): the
  gradients carry the forward's float32 reordering
  (tests/test_torch_forward.py) into AdamW, whose update at step 4 is
  close to sign(g) * lr, g / (|g| + eps), sensitive where |g| nears
  eps: loss and metrics within STEP_RTOL 1e-5, m within 1e-5 and v
  within 2e-5 of their largest magnitude, params within STEP_PARAM_ATOL
  1e-5, 5% of the step's size (lr 1e-3 times the lr scale 0.2 at step 3
  of 15 warmup steps; measured <= 2.4e-7 smollm, 1.3e-6 granite-moe,
  2.3e-7 with two microbatches).
* Microbatching: 1 against 2 microbatches at the reference's own bounds
  (tests/test_train_infra.py: loss rel 1e-3, params 2e-2).
* `train.run` with failures against the same run without: bit for bit.
"""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.distributed import fault as jfault  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402
from test_torch_model import jax_to_numpy  # noqa: E402

OPT_RTOL = 1e-6
STEP_RTOL = 1e-5
STEP_V_RTOL = 2e-5
STEP_PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16) \
                .view(jnp.bfloat16).astype(np.float32)
        return t.detach().numpy()
    return np.asarray(t.astype(jnp.float32) if hasattr(t, "astype") and
                      t.dtype == jnp.bfloat16 else t)


def _rel(a, b) -> float:
    a, b = np.asarray(_np(a), np.float32), np.asarray(_np(b), np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bits(t) -> np.ndarray:
    """A tensor's or an array's values as a numpy array of the same
    width (bf16 as its int16 view), for exact comparisons."""
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _same(a, b) -> bool:
    """Same shape, width and bits."""
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize \
        and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# schedule, AdamW, global norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total,min_ratio", [
    (200, 10000, 0.1), (10, 100, 0.1), (3, 24, 0.0), (0, 50, 0.3),
    (50, 50, 0.1)])
def test_warmup_cosine_matches_reference(warmup, total, min_ratio):
    for step in (0, 1, 2, 3, 9, 10, 11, 24, 49, 50, 77, 99, 100, 5000,
                 10000, 12000):
        want = jsched.warmup_cosine(step, warmup=warmup, total=total,
                                    min_ratio=min_ratio)
        got = tsched.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                   warmup=warmup, total=total,
                                   min_ratio=min_ratio)
        assert got.dtype == torch.float32 and got.shape == ()
        assert _same(got, np.asarray(want)), (step, float(got), want)


def test_schedule_shape():
    assert float(tsched.warmup_cosine(0, warmup=10, total=100)) == 0.0
    assert float(tsched.warmup_cosine(10, warmup=10, total=100)) == \
        pytest.approx(1.0)
    assert float(tsched.warmup_cosine(100, warmup=10, total=100)) == \
        pytest.approx(0.1, abs=1e-5)


def _opt_tree(rng):
    """A params-shaped numpy tree: a stacked [L, K, N] float32 leaf, a
    bf16 matrix, a stacked norm scale [L, d] (ndim 2: decayed, as the
    reference decays it), a 1-D bias, in nested dicts."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)    # noqa: E731
    return {"blocks": {"w": f(3, 8, 6), "ln": {"w": 1 + 0.1 * f(3, 6)}},
            "head": f(6, 10).astype(jnp.bfloat16),
            "bias": f(10)}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    return from_jax_params(jax_to_numpy(_jtree(tree)), device="cpu")


def _assert_trees_close(got, want, rtol, what=""):
    gl = tadamw.leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape), what
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), what
        assert _rel(g, w) <= rtol, (what, _rel(g, w))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])      # clip off / on
def test_adamw_update_matches_reference(state_dtype, grad_scale):
    """Three updates from a shared start: params, m, v (state_dtype),
    step and the metrics; grad_scale 10 makes the global norm clip."""
    rng = np.random.default_rng(5)
    cfg_kw = dict(lr=1e-2, state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    jp, tp = _jtree(_opt_tree(rng)), _ttree(_opt_tree(
        np.random.default_rng(5)))
    jst, tst = jadamw.adamw_init(jp, jcfg), tadamw.adamw_init(tp, tcfg)
    for i in range(3):
        g = jax.tree_util.tree_map(lambda x: x * grad_scale,
                                   _opt_tree(np.random.default_rng(10 + i)))
        lr_scale = np.float32(0.5 + 0.25 * i)
        jp, jst, jm = jadamw.adamw_update(jp, _jtree(g), jst, jcfg, lr_scale)
        tp, tst, tm = tadamw.adamw_update(tp, _ttree(g), tst, tcfg,
                                          torch.tensor(lr_scale))
        _assert_trees_close(tp, jp, OPT_RTOL, f"params {i}")
        _assert_trees_close(tst["m"], jst["m"], OPT_RTOL, f"m {i}")
        _assert_trees_close(tst["v"], jst["v"], OPT_RTOL, f"v {i}")
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        assert tst["step"].dtype == torch.int32 and tst["step"].shape == ()
        for k in ("grad_norm", "clip_scale"):
            assert _rel(tm[k], jm[k]) <= OPT_RTOL, k
    assert (float(tm["clip_scale"]) < 1.0) == (grad_scale > 1)


def test_global_norm_matches_reference():
    tree = _opt_tree(np.random.default_rng(2))
    tree["ids"] = np.arange(5, dtype=np.int32)       # not a float leaf
    want = jadamw.global_norm(_jtree(tree))
    got = tadamw.global_norm(_ttree(tree))
    assert got.dtype == torch.float32 and _rel(got, want) <= OPT_RTOL


def test_adamw_decreases_quadratic():
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = tadamw.adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = tadamw.adamw_update(
            params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_init_and_state_dtypes():
    """bf16 moments under state_dtype bfloat16; None moments at a
    non-float leaf, which the update passes through."""
    cfg = tadamw.AdamWConfig(state_dtype="bfloat16")
    params = {"w": torch.ones((4, 4)), "ids": torch.arange(3)}
    state = tadamw.adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    assert state["m"]["ids"] is None and state["v"]["ids"] is None
    new, state2, _ = tadamw.adamw_update(
        params, {"w": torch.ones((4, 4)), "ids": None}, state, cfg)
    assert state2["v"]["w"].dtype == torch.bfloat16
    assert torch.equal(new["ids"], params["ids"])


def test_grad_clipping():
    cfg = tadamw.AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = tadamw.adamw_init(params, cfg)
    _, _, m = tadamw.adamw_update(params, {"w": torch.full((3,), 100.0)},
                                  state, cfg)
    assert float(m["clip_scale"]) < 0.01


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _grad_tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(64, 33)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(257,)) * scale).astype(
                jnp.bfloat16),
                "d": np.array(rng.normal() * scale, np.float32),
                "z": np.zeros((7,), np.float32)},
            "n": np.arange(4, dtype=np.int32)}


def test_compress_decompress_bit_for_bit():
    """int8 q, the float32 scale and the error-feedback residual bit for
    bit over three steps of feedback (round half to even: the gradients
    include exact ties q + 0.5), then decompress."""
    rng = np.random.default_rng(0)
    jerr = terr = None
    for i in range(3):
        g = _grad_tree(rng, scale=10.0 ** (i - 1))
        g["a"][0, :4] = [63.5, -63.5, 0.5, -127.0]    # ties, the amax
        jq, js, jerr = jcomp.compress_grads(_jtree(g), jerr)
        tq, ts, terr = tcomp.compress_grads(_ttree(g), terr)
        for got, want in ((tq, jq), (ts, js), (terr, jerr)):
            gl, wl = (tadamw.leaves(got),
                      jax.tree_util.tree_leaves(want))
            assert len(gl) == len(wl)
            for x, y in zip(gl, wl):
                assert _same(x, np.asarray(y)), (i, x, y)
        assert tq["a"].dtype == torch.int8 and tq["n"].dtype == torch.int32
        want = jcomp.decompress_grads(jq, js)
        got = tcomp.decompress_grads(tq, ts)
        for x, y in zip(tadamw.leaves(got), jax.tree_util.tree_leaves(want)):
            assert _same(x, np.asarray(y))


def test_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.normal(0, 1, (256,)).astype(
        np.float32))}
    acc = torch.zeros(256)
    err = None
    for _ in range(64):
        q, s, err = tcomp.compress_grads(g_true, err)
        acc = acc + tcomp.decompress_grads(q, s)["w"]
    np.testing.assert_allclose((acc / 64).numpy(), g_true["w"].numpy(),
                               atol=0.02)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_synthetic_batches_match_reference(n_hosts):
    for host in range(n_hosts):
        kw = dict(seq_len=16, global_batch=8, vocab=1000, seed=7,
                  n_hosts=n_hosts, host_id=host)
        js = jdata.make_stream(jdata.DataConfig(**kw))
        ts = tdata.make_stream(tdata.DataConfig(**kw))
        for step in (0, 1, 13, 1000):
            got = ts.batch_at(step)
            assert got.dtype == np.int32 and got.shape == (8 // n_hosts, 17)
            np.testing.assert_array_equal(got, js.batch_at(step))


def test_data_host_sharding_and_steps_differ():
    h0 = tdata.make_stream(tdata.DataConfig(16, 4, 100, seed=1, n_hosts=2,
                                            host_id=0))
    h1 = tdata.make_stream(tdata.DataConfig(16, 4, 100, seed=1, n_hosts=2,
                                            host_id=1))
    assert h0.batch_at(5).shape == (2, 17)
    assert not np.array_equal(h0.batch_at(5), h1.batch_at(5))
    assert not np.array_equal(h0.batch_at(5), h0.batch_at(6))


def test_mmap_batches_match_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 500, 10007).astype(
        np.int32).tofile(path)
    for n_hosts, host in ((1, 0), (2, 1)):
        kw = dict(seq_len=16, global_batch=4, vocab=500, source="mmap",
                  path=str(path), n_hosts=n_hosts, host_id=host)
        js = jdata.make_stream(jdata.DataConfig(**kw))
        ts = tdata.make_stream(tdata.DataConfig(**kw))
        for step in (0, 3, 200):
            np.testing.assert_array_equal(ts.batch_at(step),
                                          js.batch_at(step))
    s = tdata.mmap_stream(str(path), 16, 2, 500)
    np.arange(10000, dtype=np.int32).tofile(path)
    assert np.all(np.diff(tdata.mmap_stream(str(path), 16, 2, 500)
                          .batch_at(0), axis=1) == 1)
    assert s.local_batch == 2


def test_iterate_resumes_at_a_step():
    s = tdata.synthetic_stream(8, 2, 50, seed=3)
    it = s.iterate(start_step=5)
    for step in (5, 6, 7):
        np.testing.assert_array_equal(next(it), s.batch_at(step))


# ---------------------------------------------------------------------------
# fault tools
# ---------------------------------------------------------------------------

def test_straggler_detector_matches_reference():
    times = np.random.default_rng(4).uniform(0.5, 1.0, (40, 4))
    times[:, 2] *= 4.0
    times[25:, 0] *= 2.0
    dets = [tfault.StragglerDetector(n_hosts=4, window=8, threshold=1.5),
            jfault.StragglerDetector(n_hosts=4, window=8, threshold=1.5)]
    for step, row in enumerate(times):
        outs = []
        for d in dets:
            for h, dt in enumerate(row):
                d.report(step, h, float(dt))
            outs.append(d.stragglers(step))
        assert outs[0] == outs[1], step
    assert dets[0].flagged == dets[1].flagged
    assert 2 in dets[0].stragglers(40)


def test_restart_policy_matches_reference():
    kw = dict(max_restarts=4, backoff_s=1.0, max_backoff_s=5.0, seed=3)
    policies = [tfault.RestartPolicy(**kw), jfault.RestartPolicy(**kw)]
    for i in range(6):
        backoffs = [p.next_backoff() for p in policies]
        assert backoffs[0] == backoffs[1] and backoffs[0] >= 1.0
        for p in policies:
            p.streak += 1
        if i == 2:
            for p in policies:
                p.reset()
    p = tfault.RestartPolicy(max_restarts=2)
    exc = tfault.SimulatedFailure("x")
    assert p.should_restart(exc) and p.should_restart(exc)
    assert not p.should_restart(exc)
    assert p.restarts == 2 and p.streak == 2
    p.reset()
    assert p.streak == 0 and tfault.RestartPolicy().next_backoff() == 0.0


def test_heartbeat_dead_hosts():
    hb = tfault.Heartbeat(n_hosts=3, timeout_s=10.0)
    now = max(hb.last_seen.values())
    hb.beat(0, t=now + 15)
    assert hb.dead_hosts(now=now + 20) == [1, 2]


def test_refusals_name_roadmap_a8():
    """What ROADMAP A8 left out when it split: training's multi-rank half
    (A12) raises; elastic re-sharding is ported, and re-shards as the
    reference's rules say on the new mesh (here a (2, 2) mesh over world
    ranks 0, 2, 3 and 5: "embed" splits over ("model", "data"), "w"
    stays whole)."""
    g = {"w": torch.ones(3)}
    q, s, _ = tcomp.compress_grads(g)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        tcomp.compressed_psum(q, s, "data")
    from jax.sharding import AbstractMesh
    from repro.distributed import sharding as jshard
    from repro_torch.launch import mesh as tmesh
    tree = {"embed": torch.arange(32.0).reshape(8, 4), "w": torch.ones(3)}
    specs = jshard.param_pspecs(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
         for k, v in tree.items()}, AbstractMesh((2, 2), ("data", "model")))
    assert tuple(specs["embed"]) == ("model", "data")
    assert tuple(specs["w"]) == ()
    ranks = (0, 2, 3, 5)
    for pos, rank in enumerate(ranks):
        mesh = tmesh.Mesh((2, 2), ("data", "model"), rank=rank,
                          ranks=ranks)
        d, m = divmod(pos, 2)
        got = tfault.elastic_remesh(tree, mesh)
        assert torch.equal(got["embed"], tree["embed"][4 * m:4 * m + 4,
                                                       2 * d:2 * d + 2])
        assert torch.equal(got["w"], tree["w"])
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        ttrain.main(["--arch", "smollm-135m", "--reduced", "--mesh", "2x1",
                     "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA: the default device must fail there")
def test_train_cli_needs_a_device_it_can_have():
    """No GPU and no --device cpu: `main` fails, and does not train
    on the CPU instead."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# checkpoints of {params, opt}
# ---------------------------------------------------------------------------

def _ref_state():
    """The reference's {params, opt} for a tree with an int leaf (its
    moments None) after two updates: float32 and bf16 leaves, a 0-d
    int32 step."""
    tree = _jtree(_opt_tree(np.random.default_rng(8)))
    tree["ids"] = jnp.arange(4, dtype=jnp.int32)
    cfg = jadamw.AdamWConfig()
    opt = jadamw.adamw_init(tree, cfg)
    for i in range(2):
        g = jax.tree_util.tree_map(
            lambda x: jnp.ones_like(x) * (i + 1) if x.dtype != jnp.int32
            else x, tree)
        tree, opt, _ = jadamw.adamw_update(tree, g, opt, cfg)
    return {"params": tree, "opt": opt}


def test_checkpoint_roundtrips_params_and_opt_across_packages(tmp_path):
    """A {params, opt} written by the reference restores into the port's
    template bit for bit (None moments stay None, the step a 0-d int32
    tensor), and the port's write restores into the reference's."""
    ref = _ref_state()
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2, ref)
    params = _ttree(_opt_tree(np.random.default_rng(0)))
    params["ids"] = torch.zeros(4, dtype=torch.int32)
    like = {"params": params,
            "opt": tadamw.adamw_init(params, tadamw.AdamWConfig())}
    got, step = tckpt.restore_checkpoint(str(tmp_path / "ref"), like)
    assert step == 2
    assert got["opt"]["m"]["ids"] is None and got["opt"]["v"]["ids"] is None
    assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 2
    assert got["opt"]["step"].dtype == torch.int32
    flat_ref = jax.tree_util.tree_leaves(ref)
    assert len(tadamw.leaves(got)) == len(flat_ref) + 2      # the Nones
    for x, y in zip([x for x in tadamw.leaves(got) if x is not None],
                    flat_ref):
        assert str(x.dtype).removeprefix("torch.") == str(y.dtype)
        assert _same(x, y)
    tckpt.save_checkpoint(str(tmp_path / "port"), 3, got)
    back, step = jckpt.restore_checkpoint(
        str(tmp_path / "port"), jax.tree_util.tree_map(jnp.zeros_like, ref))
    assert step == 3
    for x, y in zip(jax.tree_util.tree_leaves(back), flat_ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _same(x, y)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_STEP = {}


def _step_case(arch):
    """(reference inputs, port inputs, the reference's jitted step's
    output): reduced float32 `arch`, opt state at step 3 of a 15-step
    warmup (lr scale 0.2), tokens [4, 17]."""
    if arch not in _STEP:
        jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch),
                                   dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                                   dtype="float32")
        kw = dict(schedule_warmup=15, schedule_total=40, remat=False)
        jt = jstep.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-3), **kw)
        tt = tstep.TrainConfig(optimizer=tadamw.AdamWConfig(lr=1e-3), **kw)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg, max_seq=64)
        tp = from_jax_params(jax_to_numpy(jp), device="cpu")
        jo = dict(jadamw.adamw_init(jp, jt.optimizer), step=jnp.int32(3))
        to = dict(tadamw.adamw_init(tp, tt.optimizer),
                  step=torch.tensor(3, dtype=torch.int32))
        toks = np.random.default_rng(1).integers(0, jcfg.vocab, (4, 17))
        toks = toks.astype(np.int32)
        want = jax.device_get(jax.jit(jstep.make_train_step(jcfg, jt))(
            jp, jo, {"tokens": jnp.asarray(toks)}))
        _STEP[arch] = ((jcfg, jt, jp, jo, toks),
                       (tcfg, tt, tp, to, torch.from_numpy(toks)), want)
    return _STEP[arch]


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_train_step_matches_reference(arch):
    _, (tcfg, tt, tp, to, toks), (jp2, jo2, jm) = _step_case(arch)
    tp2, to2, tm = tstep.make_train_step(tcfg, tt)(tp, to, {"tokens": toks})
    assert set(tm) == set(jm) == {"loss", "z_loss", "aux_loss", "grad_norm",
                                  "clip_scale", "lr_scale"}
    for k in tm:
        assert tm[k].dtype == torch.float32 and tm[k].shape == ()
        assert abs(float(tm[k]) - float(jm[k])) <= \
            STEP_RTOL * max(abs(float(jm[k])), 1.0), k
    assert float(tm["lr_scale"]) == pytest.approx(0.2)
    assert int(to2["step"]) == 4
    _assert_trees_close(to2["m"], jo2["m"], STEP_RTOL, "m")
    _assert_trees_close(to2["v"], jo2["v"], STEP_V_RTOL, "v")
    for got, want in zip(tadamw.leaves(tp2), jax.tree_util.tree_leaves(jp2)):
        assert np.abs(_np(got) - np.asarray(want)).max() <= STEP_PARAM_ATOL
    # the step moved every matrix (lr 1e-3 x 0.2, decay or gradient)
    moved = [not torch.equal(a, b) for a, b in
             zip(tadamw.leaves(tp2), tadamw.leaves(tp))]
    assert sum(moved) >= len(moved) - 2


def test_microbatches_equal_one_batch():
    """2 microbatches against 1 on the same batch, at the reference's own
    bounds (loss rel 1e-3, params 2e-2), and the port's 2 against the
    reference's 2."""
    (jcfg, jt, jp, jo, toks), (tcfg, tt, tp, to, ttoks), _ = \
        _step_case("smollm-135m")
    outs = {}
    for mb in (1, 2):
        t2 = dataclasses.replace(tt, microbatches=mb)
        outs[mb] = tstep.make_train_step(tcfg, t2)(tp, to, {"tokens": ttoks})
    (pa, _, ma), (pb, _, mb_) = outs[1], outs[2]
    assert float(ma["loss"]) == pytest.approx(float(mb_["loss"]), rel=1e-3)
    assert max(float((a.float() - b.float()).abs().max()) for a, b in
               zip(tadamw.leaves(pa), tadamw.leaves(pb))) < 2e-2
    j2 = dataclasses.replace(jt, microbatches=2)
    jp2, _, jm2 = jax.jit(jstep.make_train_step(jcfg, j2))(
        jp, jo, {"tokens": jnp.asarray(toks)})
    for k in ("loss", "z_loss", "grad_norm"):
        assert abs(float(mb_[k]) - float(jm2[k])) <= \
            STEP_RTOL * abs(float(jm2[k])), k
    for got, want in zip(tadamw.leaves(pb), jax.tree_util.tree_leaves(jp2)):
        assert np.abs(_np(got) - np.asarray(want)).max() <= STEP_PARAM_ATOL


def test_train_step_remat_equals_no_remat():
    _, (tcfg, tt, tp, to, toks), _ = _step_case("granite-moe-1b-a400m")
    outs = [tstep.make_train_step(tcfg, dataclasses.replace(tt, remat=r))(
        tp, to, {"tokens": toks}) for r in (False, True)]
    for a, b in zip(tadamw.leaves(outs[0]), tadamw.leaves(outs[1])):
        assert torch.equal(a, b)


def test_make_serve_fns_run_prefill_and_decode():
    cfg = tconfigs.get_reduced_config("smollm-135m")
    params = ttrain.lm.init_params(cfg, 0, device="cpu")
    prefill_fn, decode_fn = tstep.make_serve_fns(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    logits, cache = prefill_fn(params, toks, 8)
    want, _ = ttrain.lm.prefill(params, toks, cfg, cache_len=8)
    assert torch.equal(logits, want)
    nxt = logits.argmax(-1)
    step_logits, _ = decode_fn(params, nxt, cache,
                               torch.full((2,), 6, dtype=torch.int64))
    assert step_logits.shape == (2, 1, cfg.vocab)


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------

def _run_args(ckpt_dir, failures="", **kw):
    """The reference test's arguments (tests/test_train_infra.py)."""
    a = dict(arch="smollm-135m", reduced=True, steps=24, batch=2, seq=16,
             lr=1e-3, microbatches=1, mesh="1x1", seed=0,
             ckpt_dir=str(ckpt_dir), ckpt_every=8, log_every=8,
             simulate_failures=failures, max_restarts=5, sim_hosts=2,
             device="cpu")
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_train_run_with_failures_ends_where_the_unfailed_run_ends(tmp_path,
                                                              arch):
    """Failures at steps 10 and 18 (checkpoints after every 8 steps): two
    restores, the last checkpoint at step 24, and the final params,
    optimizer state and loss bit for bit those of the run without
    failures."""
    failed = ttrain.run(_run_args(tmp_path / "a", "10,18", arch=arch))
    clean = ttrain.run(_run_args(tmp_path / "b", arch=arch))
    assert failed["restores"] == 2 and clean["restores"] == 0
    assert tckpt.latest_step(str(tmp_path / "a")) == 24
    assert np.isfinite(failed["final_loss"])
    assert failed["final_loss"] == clean["final_loss"]
    assert failed["history"] == clean["history"]
    assert len(failed["step_ms"]) == 24 + (10 - 9) + (18 - 17)
    for key in ("params", "opt"):
        a, b = tadamw.leaves(failed[key]), tadamw.leaves(clean[key])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(x, y), key
    assert int(failed["opt"]["step"]) == 24
    saved, step = tckpt.restore_checkpoint(
        str(tmp_path / "a"), {"params": clean["params"],
                              "opt": clean["opt"]})
    assert step == 24
    assert all(torch.equal(x, y) for x, y in
               zip(tadamw.leaves(saved), tadamw.leaves(
                   {"params": clean["params"], "opt": clean["opt"]})))


def test_train_run_gives_up_past_its_restart_budget(tmp_path):
    with pytest.raises(tfault.SimulatedFailure):
        ttrain.run(_run_args(tmp_path, "2,3,4", steps=6, ckpt_every=2,
                                max_restarts=2))
