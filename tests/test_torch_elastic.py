"""Elastic degraded-mesh serving of the port (`distributed/elastic.py`,
`launch/mesh.py` `reform`, `fault.elastic_remesh`, chaos's ``lose@``
arms and the engine's `_degrade`), unit for unit with
tests/test_elastic.py and tests/test_elastic_property.py:

* the planner (`plan_shape`) against the JAX package's on the reference
  test's table, its reduced-mamba2 preference case, smollm-135m's
  chain on 3 ranks, and the same refusal; `plan_degraded_mesh` on a
  bare mesh;
* the health registry's kill order and floor, the injector's grammar,
  rejects (the same messages), firing once under the cap, the
  `$REPRO_CHAOS` round trip and loss sites independent of fault sites,
  each against the reference's; a hypothesis tape walked through both
  packages' injectors gives equal logs;
* `elastic_remesh` against the reference's `param_pspecs` on the new
  mesh;
* the engine on spawned `gloo` CPU ranks (tests/torch_mesh_workers.py),
  reduced configs under forced w8a8, each case losing ranks mid-traffic:
  (2, 1) -> (1, 1) dense and encdec; (1, 2) -> (1, 1) qwen (attention
  tensor parallelism) and ssm (SSD tensor parallelism); (2, 2) -> (2, 1)
  hybrid, one healthy rank left out; a repeated loss (2, 2) -> (2, 1) ->
  (1, 1); a speculative engine losing at a ``verify:`` site; the prefix
  cache on (1, 2), its pool dropped, and on (2, 1), its pool kept; a
  snapshot on a degraded mesh
  restored on one device; admission re-bucketed to the new dp floor.
  Every stream equals the port's unsharded engine's bit for bit (which
  the rest of the suite holds against the JAX package), with
  `replay_divergence == 0` and the reference test's counters; the
  degraded dense streams also equal the JAX package's single-device
  engine on the same weights.  In the repeated-loss case every rank a
  degrade leaves out exits its process at once, under a 30 s
  collective timeout: the survivors finish without them.
* the unmeshed engine, where a loss is a plain fault.
"""
import functools
import tempfile
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402,F401
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import elastic as jelastic  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.distributed.fault import SimulatedFailure as JFailure  # noqa: E402,E501
from repro.launch import engine as jengine  # noqa: E402
from repro.launch import resilience as jres  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.quant.qtensor import quantize_tree_for_serving as jquant  # noqa: E402,E501

import torch_mesh_workers as W  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.distributed import elastic  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from repro_torch.distributed.fault import SimulatedFailure  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import resilience as res  # noqa: E402
from repro_torch.launch import scheduler  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from test_torch_mesh_rules import _by_path_jax, _key  # noqa: E402
from test_torch_serve import _setup  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _message(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("old,healthy,n_slots,want", [
    ((8, 1), 4, 8, (4, 1)), ((2, 4), 4, 8, (2, 2)), ((2, 4), 2, 8, (2, 1)),
    ((8, 1), 7, 8, (4, 1)), ((8, 1), 1, 8, (1, 1)), ((8, 1), 5, 6, (2, 1)),
    ((2, 4), 8, 8, (2, 4)),
])
def test_plan_shape_matches_reference(old, healthy, n_slots, want):
    assert elastic.plan_shape(old, healthy, n_slots) == want \
        == jelastic.plan_shape(old, healthy, n_slots)


@pytest.mark.parametrize("arch,old,healthy,want", [
    ("mamba2-2.7b", (2, 4), 4, (2, 2)),      # keeps SSD tp active
    ("smollm-135m", (1, 3), 2, (2, 1)),      # the card's chain ...
    ("smollm-135m", (2, 1), 1, (1, 1)),      # ... to one rank
    ("smollm-135m", (2, 2), 3, (2, 1)),      # one healthy rank unused
])
def test_plan_shape_with_config_matches_reference(arch, old, healthy, want):
    full = arch == "smollm-135m"
    cfg = configs.get_config(arch) if full \
        else configs.get_reduced_config(arch)
    jcfg = jconfigs.get_config(arch) if full \
        else jconfigs.get_reduced_config(arch)
    assert elastic.plan_shape(old, healthy, 8, cfg) == want \
        == jelastic.plan_shape(old, healthy, 8, jcfg)


def test_plan_shape_no_healthy_raises_as_reference():
    assert _message(lambda: elastic.plan_shape((8, 1), 0, 8)) \
        == _message(lambda: jelastic.plan_shape((8, 1), 0, 8))


def test_plan_degraded_mesh_on_a_bare_mesh():
    """The first d x m healthy ranks in the old order, the old axis
    names; extra dp axes collapse to 1 (the reference's layout)."""
    reg = elastic.DeviceHealthRegistry(range(8))
    reg.kill(4)
    new = elastic.plan_degraded_mesh(
        tmesh.make_mesh((2, 4), ("data", "model")), reg.healthy(),
        dp_axes=("data",), model_axis="model", n_slots=8)
    assert new.axis_names == ("data", "model") and new.rank is None
    assert new.shape == {"data": 2, "model": 2}
    assert new.ranks == (0, 1, 2, 3)
    pod = elastic.plan_degraded_mesh(
        tmesh.make_mesh((2, 2, 2), ("pod", "data", "model")), range(5),
        dp_axes=("pod", "data"), model_axis="model", n_slots=8)
    assert pod.shape == {"pod": 4, "data": 1, "model": 1}
    assert pod.ranks == (0, 1, 2, 3)


# ---------------------------------------------------------------------------
# the health registry and the loss injector
# ---------------------------------------------------------------------------

def test_health_registry_kill_order_and_floor_match_reference():
    n = 6
    mine = elastic.DeviceHealthRegistry(range(n))
    ref = jelastic.DeviceHealthRegistry(
        [types.SimpleNamespace(id=i) for i in range(n)])
    for k in (2, 1, n + 5, 3):
        assert mine.kill(k) == ref.kill(k)
        assert mine.healthy() == [int(d.id) for d in ref.healthy()]
        assert mine.dead_ids == ref.dead_ids
        assert mine.n_healthy == ref.n_healthy
    assert mine.healthy() == [0] and mine.dead_ids == (4, 5, 3, 1, 2)


SPECS = ["lose@segment:1=4;rate=0.5,seed=3,max=2;lose_rate=0.25,"
         "lose_seed=7,lose_n=2,lose_max=1", "lose@chunk:0",
         "draft:1;lose@verify:2=3", "lose_rate=0.1,lose_seed=5,segment:4"]


def _fields(inj):
    return (inj.fail_at_sites, inj.rate, inj.seed, inj.max_failures,
            inj.lose_at_sites, inj.lose_rate, inj.lose_seed, inj.lose_n,
            inj.lose_max, inj.arms_loss)


@pytest.mark.parametrize("spec", SPECS)
def test_injector_parse_matches_reference(spec):
    assert _fields(elastic.DeviceLossInjector.parse(spec)) \
        == _fields(jelastic.DeviceLossInjector.parse(spec))


@pytest.mark.parametrize("bad", ["lose@warp:1", "lose@segment:x",
                                 "lose@segment:1=y", "lose_frobnicate=3",
                                 "lose@segment:1;bogus:2"])
def test_injector_parse_rejects_as_reference(bad):
    assert _message(lambda: elastic.DeviceLossInjector.parse(bad)) \
        == _message(lambda: jelastic.DeviceLossInjector.parse(bad))


def test_injector_fires_once_and_caps():
    for pkg in (elastic, jelastic):
        inj = pkg.DeviceLossInjector.parse("lose@segment:1=2;lose@chunk:0;"
                                           "lose_max=1")
        with pytest.raises(pkg.DeviceLoss) as ei:
            inj.check_site("segment:1")
        assert ei.value.n_lost == 2 and ei.value.site == "segment:1"
        assert str(ei.value) == "injected loss of 2 device(s) at segment:1"
        inj.check_site("segment:1")         # at most once per site
        inj.check_site("chunk:0")           # lose_max caps loss events
        assert inj.lost_sites == {"segment:1": 2}
    assert issubclass(elastic.DeviceLoss, SimulatedFailure)


def test_injector_env_roundtrip(monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "lose@segment:2=3,rate=0.1,seed=5")
    inj, ref = res.chaos_from_env(), jres.chaos_from_env()
    assert isinstance(inj, elastic.DeviceLossInjector)
    assert _fields(inj) == _fields(ref)
    monkeypatch.setenv("REPRO_CHAOS", "rate=0.1,seed=5")
    assert not isinstance(res.chaos_from_env(), elastic.DeviceLossInjector)


def test_loss_and_fault_sites_independent():
    """Arming loss does not move where plain faults fire, and each
    package's decisions are the other's, site for site."""
    plain = res.ChaosSchedule(rate=0.3, seed=9)
    armed = elastic.DeviceLossInjector(rate=0.3, seed=9, lose_rate=0.2,
                                       lose_seed=4)
    ref = jelastic.DeviceLossInjector(rate=0.3, seed=9, lose_rate=0.2,
                                      lose_seed=4)
    sites = [f"{k}:{i}" for k in sorted(res.ChaosSchedule.SITE_KINDS)
             for i in range(40)]
    assert [plain.should_fail(s) for s in sites] \
        == [armed.should_fail(s) for s in sites] \
        == [ref.should_fail(s) for s in sites]
    assert [armed.loss_at(s) for s in sites] \
        == [ref.loss_at(s) for s in sites]
    assert any(armed.loss_at(s) for s in sites)


_KINDS = sorted(res.ChaosSchedule.SITE_KINDS)
_LOSS = st.lists(st.tuples(st.sampled_from(_KINDS), st.integers(0, 7),
                           st.integers(1, 4)),
                 min_size=1, max_size=3, unique_by=lambda t: t[:2])
_FAULTS = st.lists(st.tuples(st.sampled_from(_KINDS), st.integers(0, 7)),
                   min_size=0, max_size=3, unique=True)


def _tape_log(pkg, failure, loss, faults, rate, n_sites):
    inj = pkg.DeviceLossInjector(
        fail_at_sites=tuple(f"{k}:{i}" for k, i in faults),
        lose_at_sites=tuple((f"{k}:{i}", n) for k, i, n in loss),
        rate=rate, seed=3, lose_rate=rate / 2, lose_seed=8)
    log = []
    for site in (f"{k}:{i}" for i in range(n_sites) for k in _KINDS):
        try:
            inj.check_site(site)
            log.append((site, "ok", 0))
        except pkg.DeviceLoss as e:
            log.append((site, "lose", e.n_lost))
        except failure:
            log.append((site, "fail", 0))
    return log, dict(inj.lost_sites), sorted(inj.failed)


@given(loss=_LOSS, faults=_FAULTS, rate=st.sampled_from([0.0, 0.1, 0.3]),
       n_sites=st.integers(1, 10))
@settings(max_examples=30, deadline=None)
def test_injector_tape_equals_reference(loss, faults, rate, n_sites):
    """The same counted-site tape through both packages' injectors,
    identically armed: every loss and every plain fault fires at the same
    site with the same rank count."""
    mine = _tape_log(elastic, SimulatedFailure, loss, faults, rate, n_sites)
    assert mine == _tape_log(jelastic, JFailure, loss, faults, rate,
                             n_sites)
    assert set(mine[1]) <= set(mine[2])


# ---------------------------------------------------------------------------
# elastic_remesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_elastic_remesh_matches_reference_pspecs(shape):
    """Each position's blocks of a reduced qwen w4a8 tree on a degraded
    mesh over world ranks (0, 2, 3, 5)[:n] are the slices the
    reference's `param_pspecs` on that mesh's shape give, leaf by path."""
    cfg, params = W.build("qwen", "w4a8")
    jcfg = jconfigs.get_reduced_config("qwen1.5-0.5b")
    jtree = jax.eval_shape(lambda: jquant(jlm.init_params(
        jax.random.PRNGKey(0), jcfg), "w4a8", force=True))
    want_specs = _by_path_jax(jshard.param_pspecs(
        jtree, AbstractMesh(shape, ("data", "model")), jcfg))
    flat, _ = pytree.tree_flatten_with_path(params)
    whole = {"/".join(_key(e) for e in path): t for path, t in flat}
    assert set(whole) == set(want_specs)
    ranks = (0, 2, 3, 5)[:shape[0] * shape[1]]
    n_split = 0
    for rank in ranks:
        mesh = tmesh.Mesh(shape, ("data", "model"), rank=rank, ranks=ranks)
        flat, _ = pytree.tree_flatten_with_path(
            tfault.elastic_remesh(params, mesh, cfg))
        for path, got in flat:
            key = "/".join(_key(e) for e in path)
            want = whole[key]
            for dim, entry in enumerate(want_specs[key]):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                idx, n = 0, 1
                for a in axes:
                    idx = idx * mesh.shape[a] + mesh.coords[a]
                    n *= mesh.shape[a]
                width = want.shape[dim] // n
                want = want.narrow(dim, idx * width, width)
            assert got.dtype == want.dtype and torch.equal(got, want), key
            n_split += got.shape != whole[key].shape
    assert n_split > 0


# ---------------------------------------------------------------------------
# the engine on spawned gloo ranks
# ---------------------------------------------------------------------------

GROUP2 = ("dense", "encdec", "qwen", "ssm", "prefix", "prefix_dp", "spec",
          "snapshot")
GROUP4 = ("hybrid", "repeat")

# label: (shape after, dead ranks, losses, ranks left out with the
# site each left at); the shapes before are ELASTIC_CASES'
WANT = {
    "dense": ((1, 1), [1], 1, {1: "segment:1"}),
    "encdec": ((1, 1), [1], 1, {1: "segment:1"}),
    "qwen": ((1, 1), [1], 1, {1: "segment:1"}),
    "ssm": ((1, 1), [1], 1, {1: "segment:1"}),
    "hybrid": ((2, 1), [3], 1, {2: "segment:1", 3: "segment:1"}),
    "repeat": ((1, 1), [3, 1, 2], 2,
               {1: "segment:3", 2: "segment:1", 3: "segment:1"}),
}


@functools.lru_cache(maxsize=None)
def _dense_weights() -> str:
    """The JAX package's reduced smollm init, float32 w8a8, converted:
    the dense case's weights, saved for the rank processes."""
    _, tcfg, _, tp = _setup("float32", "w8a8")
    path = tempfile.mkdtemp(prefix="elastic_w_") + "/dense.pt"
    torch.save((tcfg, tp), path)
    return path


@functools.lru_cache(maxsize=None)
def _groups():
    d2 = tempfile.mkdtemp(prefix="elastic2_")
    d4 = tempfile.mkdtemp(prefix="elastic4_")
    weights = {"dense": _dense_weights()}
    g2 = W.spawn_elastic(2, GROUP2, d2, weights)
    g4 = W.spawn_elastic(4, GROUP4, d4, weights, timeout_s=30.0,
                         exit_label="repeat")
    return g2, g4, d2


def _ranks(label):
    g2, g4, _ = _groups()
    return g4 if label in GROUP4 else g2


@functools.lru_cache(maxsize=None)
def _baseline(label):
    return W.elastic_baseline(label, {"dense": _dense_weights()})


def _check(label, n_losses):
    got = _ranks(label)[0][label]
    info = got["info"]
    rb = info["robustness"]
    assert got["outcomes"] == ["ok"], got
    assert rb["degraded"] == n_losses == info["degraded"]
    assert rb["faults_injected"] == n_losses == rb["recoveries"]
    assert rb["errors"] == 0 and rb["replay_divergence"] == 0
    assert rb["replayed_tokens"] > 0
    assert info["reshard_s"] > 0 and len(info["degrade_at"]) == n_losses
    assert info["graphs"][0] <= info["graphs"][1]
    assert info["left_at"] is None
    return got, info


@pytest.mark.parametrize("label", ["dense", "encdec", "qwen", "ssm",
                                   "hybrid", "repeat"])
def test_degraded_streams_equal_unsharded(label):
    after, dead, n_losses, left = WANT[label]
    got, info = _check(label, n_losses)
    assert got["streams"] == _baseline(label)
    assert info["shape"] == after and info["dead"] == dead
    assert info["ranks"] == list(range(after[0] * after[1]))
    spec = W.ELASTIC_CASES[label][2]
    assert info["chaos"]["lost_sites"] == {
        s.split("=")[0][5:]: int(s.split("=")[1]) if "=" in s else 1
        for s in spec.split(";")}
    ranks = _ranks(label)
    # each follower left follow() at its own loss's site, or served on
    assert {r: ranks[r][label]["info"]["left_at"]
            for r in ranks if r} == {r: left.get(r) for r in ranks if r}


@pytest.mark.parametrize("label", ["qwen", "ssm", "hybrid"])
def test_tensor_parallelism_was_active_before_the_loss(label):
    """The tp cases do not pass vacuously: the loss takes the layout from
    attention / SSD tensor parallelism to replication."""
    got = _ranks(label)[0][label]
    want = {"qwen": (True, False), "ssm": (False, True),
            "hybrid": (True, True)}[label]
    assert got["before"][3:] == want
    assert got["info"]["tp"] == (False, False)


def test_degrade_rebuckets_admission():
    """(2, 1) -> (1, 1): the dp floor of the batch buckets and of
    admission drops from 2 to 1 with the mesh."""
    got = _ranks("dense")[0]["dense"]
    assert got["before"][:3] == (2, 2, (2,))
    assert got["after"] == (1, 1, (1, 2))


def test_lost_ranks_exit_and_survivors_finish():
    """In the repeated loss every rank a degrade leaves out exits its
    process as soon as `follow()` returns (ranks 2 and 3 at the first
    loss, rank 1 at the second); the survivors' groups hold none of
    them, so the run finishes inside the 30 s collective timeout."""
    ranks = _ranks("repeat")
    assert set(ranks) == {0, 1, 2, 3}
    assert all("repeat" in ranks[r] for r in ranks)
    assert ranks[0]["repeat"]["streams"] == _baseline("repeat")
    # the healthy-but-unused rank 2 left at the first loss, unkilled
    assert ranks[2]["repeat"]["info"]["dead"] == [3]


def test_spec_engine_loses_at_a_verify_site():
    got, info = _check("spec", 1)
    assert got["streams"] == _baseline("spec")
    assert info["chaos"]["lost_sites"] == {"verify:4": 1}
    assert info["shape"] == (1, 1) and info["dead"] == [1]
    assert got["spec"]["rounds"] > 0 and got["spec"]["accepted"] > 0


def test_prefix_pool_dropped_when_heads_change():
    """(1, 2) -> (1, 1) under attention tensor parallelism: every pooled
    page held one rank's heads, so the pool is dropped; the misses
    recompute and the streams stay the unsharded engine's."""
    got, info = _check("prefix", 1)
    assert got["streams"] == _baseline("prefix")
    assert got["before"][3] is True
    pfx = info["prefix"]
    assert pfx["pages_dropped"] > 0 and pfx["remeshes"] == 1
    assert pfx["hits"] > 0


def test_prefix_pool_kept_on_a_dp_only_loss():
    """(2, 1) -> (1, 1) with no tensor parallelism: every rank pooled
    every entry with all its heads, so the survivor keeps the pool and
    its hits go on; the streams stay the unsharded engine's."""
    got, info = _check("prefix_dp", 1)
    assert got["streams"] == _baseline("prefix_dp")
    assert got["before"][3:] == (False, False)
    pfx = info["prefix"]
    assert pfx["pages_dropped"] == 0 and pfx["remeshes"] == 1
    assert pfx["hits"] > 0 and pfx["pages_resident"] > 0


def test_snapshot_on_degraded_mesh_restores_on_one_device():
    """Taken after a (2, 1) -> (1, 1) degrade, the snapshot is stamped
    with the new shape and the dead rank, and restores on one device:
    the streams merged are the fault-free ones."""
    g2, _, d2 = _groups()
    got = g2[0]["snapshot"]
    info = got["info"]
    assert info["degraded"] == 1 and info["dead"] == [1]
    meta, _ = ckpt.load_meta(f"{d2}/snap")
    assert meta["mesh"]["dead_devices"] == [1]
    assert meta["mesh"]["shape"] == {"data": 1, "model": 1}
    cfg, params = W.elastic_model("snapshot", {})
    eng = ServeEngine(params, cfg, **W.elastic_kwargs("snapshot", cfg))
    n = eng.restore(f"{d2}/snap")
    assert n + len(got["done"]) == 5 and n > 0
    merged = dict(got["done"])
    merged.update(W.streams(eng.run((), scheduler.FastForwardClock())))
    assert merged == _baseline("snapshot")
    assert eng.cache_info()["robustness"]["replay_divergence"] == 0


def test_degraded_dense_streams_equal_jax_engine():
    """The degraded (2, 1) -> (1, 1) dense streams against the JAX
    package's single-device engine on the same weights (its reduced
    smollm init, float32 w8a8, converted)."""
    jcfg, tcfg, jp, _ = _setup("float32", "w8a8")
    reqs = W.requests(tcfg, stagger=0.0)
    jreqs = [jsched.Request(rid=r.rid, prompt=np.asarray(r.prompt),
                            max_new_tokens=r.max_new_tokens,
                            arrival_time=r.arrival_time) for r in reqs]
    kw = W.engine_kwargs("dense", tcfg)
    want = jengine.ServeEngine(
        jp, jcfg, n_slots=kw["n_slots"], max_cache_len=kw["max_cache_len"],
        segment_len=kw["segment_len"], chaos=None).run(
        jreqs, clock=jsched.FastForwardClock())
    got = _ranks("dense")[0]["dense"]["streams"]
    assert got == {int(r): [int(t) for t in v] for r, v in want.items()}


def test_unmeshed_engine_treats_loss_as_plain_fault():
    """One device has no mesh to shrink: a DeviceLoss recovers through the
    plain fault path (it is a SimulatedFailure), the streams unchanged."""
    cfg, params = W.build("dense")
    kw = W.engine_kwargs("dense", cfg)
    want = W.elastic_serve(ServeEngine(params, cfg, **kw), "dense", cfg)
    kw["chaos"] = elastic.DeviceLossInjector.parse("lose@segment:1=4")
    eng = ServeEngine(params, cfg, **kw)
    got = W.elastic_serve(eng, "dense", cfg)
    info = eng.cache_info()
    rb = info["robustness"]
    assert got == want and "mesh" not in info
    assert rb["degraded"] == 0 and rb["faults_injected"] == 1
    assert rb["replay_divergence"] == 0 and rb["replayed_tokens"] > 0
    assert info["resilience"]["chaos"]["lost_sites"] == {"segment:1": 4}
