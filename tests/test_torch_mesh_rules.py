"""The port's sharding rules and tensor-parallel plan against the JAX
package's, evaluated on a `jax.sharding.AbstractMesh` (no devices) and on
the port's `launch.mesh.make_mesh` of the same shape:

* `sanitize_spec`;
* `param_pspecs` in the "2d" and "pure_dp" modes over every family's
  reduced params tree and its w8a8 and w4a8 serving trees (the port's
  from its own init, the reference's from `jax.eval_shape` of its own:
  the rules read paths and shapes only);
* `cache_pspecs` and `slot_state_pspecs` over each family's slot state;
* `tp_plan`, `tp_viable_sizes` and `tp_axes_for` for every family at
  model-axis sizes 1-8;
* `validate_slot_sharding` and `largest_valid_dp`, which accept and
  reject the same cases with the same messages;
* the mesh helpers (`dp_axes`, `fsdp_axes`, coordinates), the spawn
  helper's failure path, the NCCL refusal, and the prefix cache's mesh
  fingerprint.

A spec compares as a tuple: the port's `PSpec` and JAX's
`PartitionSpec` with the same entries are equal tuples.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import slot_state as jslot  # noqa: E402
from repro.quant.qtensor import quantize_tree_for_serving as jquant  # noqa: E402,E501
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import prefix_cache as tpfx  # noqa: E402
from repro_torch.launch import scheduler as tsched  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import slot_state as tslot  # noqa: E402
from repro_torch.quant.qtensor import quantize_tree_for_serving  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCHS = list(configs.ARCHS)
MESHES = [((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 8), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
mesh_ids = [f"{'x'.join(map(str, s))}" for s, _ in MESHES]


def _key(entry):
    k = getattr(entry, "key", getattr(entry, "name", None))
    return str(k if k is not None else getattr(entry, "idx", entry))


def _port_path(keys) -> str:
    """A reference leaf path as the port names it: the port's hybrid and
    encdec caches are flat dicts (models/lm.py `init_cache`), so the
    reference's attn/k, mamba/ssm and self/k are k, ssm and k, and its
    cross/k is cross_k; every other path is the same."""
    if len(keys) == 2 and keys[0] in ("attn", "mamba", "self"):
        return keys[1]
    if len(keys) == 2 and keys[0] == "cross":
        return f"cross_{keys[1]}"
    return "/".join(keys)


def _by_path_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {_port_path([_key(e) for e in path]): tuple(leaf)
            for path, leaf in flat}


def _by_path_torch(tree):
    flat, _ = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tshard.PSpec))
    return {"/".join(_key(e) for e in path): tuple(leaf)
            for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _trees(arch, quant):
    jcfg = jconfigs.get_reduced_config(arch)
    cfg = configs.get_reduced_config(arch)

    def jinit():
        p = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        return p if quant == "bf16" else jquant(p, quant, force=True)
    jtree = jax.eval_shape(jinit)
    tree = tlm.init_params(cfg, 0, device="cpu")
    if quant != "bf16":
        tree = quantize_tree_for_serving(tree, quant, force=True)
    return jtree, tree


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_ids)
@pytest.mark.parametrize("quant", ["bf16", "w8a8", "w4a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_the_reference(arch, quant, mesh):
    shape, axes = mesh
    jtree, tree = _trees(arch, quant)
    jm, tm = AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)
    for mode in ("2d", "pure_dp"):
        want = _by_path_jax(jshard.param_pspecs(jtree, jm, None, mode))
        got = _by_path_torch(tshard.param_pspecs(tree, tm, None, mode))
        assert got == want, (arch, quant, mode)


def _slot_trees(arch, n=4, t=32):
    jcfg = jconfigs.get_reduced_config(arch)
    cfg = configs.get_reduced_config(arch)
    kw = {"s_enc": 16} if cfg.family == "encdec" else {}
    jstate = jax.eval_shape(
        lambda: jslot.get_family(jcfg.family).init(jcfg, n, t, **kw))
    state = tslot.get_family(cfg.family).init(cfg, n, t, device="meta",
                                              **kw)
    return jcfg, cfg, jstate, state, kw


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_slot_state_pspecs_match(arch, mesh):
    shape, axes = mesh
    jcfg, cfg, jstate, state, kw = _slot_trees(arch)
    jm, tm = AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)
    for seq_shard in (False, True):
        assert _by_path_torch(tshard.cache_pspecs(
            state, tm, cfg, seq_shard=seq_shard)) == _by_path_jax(
            jshard.cache_pspecs(jstate, jm, jcfg, seq_shard=seq_shard))
    m = tm.shape["model"]
    jspec = jslot.spec_for(jcfg, **kw)
    spec = tslot.spec_for(cfg, **kw)
    jtp = jslot.tp_axes_for(jcfg, m, **kw)
    tp = tslot.tp_axes_for(cfg, m, **kw)
    # per-leaf axes in each package's flatten order (jax sorts dict keys,
    # torch keeps their order): compared by leaf path
    assert _leafwise(state, zip(spec.batch_axes, tp)) == _leafwise(
        jstate, zip(jspec.batch_axes, jtp), jax_tree=True)
    dp = tmesh.dp_axes(tm)
    assert dp == tuple(n for n in axes if n in ("pod", "data"))
    want = _by_path_jax(jshard.slot_state_pspecs(
        jspec.treedef, jspec.batch_axes, jtp, dp, "model"))
    got = _by_path_torch(tshard.slot_state_pspecs(
        spec.treedef, spec.batch_axes, tp, dp, "model"))
    assert got == want


def _leafwise(tree, values, jax_tree=False):
    """{leaf path: value} for per-leaf values in the tree's flatten
    order."""
    if jax_tree:
        paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    else:
        paths = [p for p, _ in pytree.tree_flatten_with_path(tree)[0]]
    return {_port_path([_key(e) for e in p]): v
            for p, v in zip(paths, values)}


def _tp_axes_by_path(cfg, size, kw, jax_pkg=False):
    fam = (jslot if jax_pkg else tslot).get_family(cfg.family)
    if jax_pkg:
        tree = jax.eval_shape(lambda: fam.init(cfg, 2, 16, **kw))
        return _leafwise(tree, jslot.tp_axes_for(cfg, size, **kw), True)
    tree = fam.init(cfg, 2, 16, device="meta", **kw)
    return _leafwise(tree, tslot.tp_axes_for(cfg, size, **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_plan_matches_the_reference(arch):
    jcfg = jconfigs.get_reduced_config(arch)
    cfg = configs.get_reduced_config(arch)
    kw = {"s_enc": 16} if cfg.family == "encdec" else {}
    for size in range(1, 9):
        jp, tp = jslot.tp_plan(jcfg, size), tslot.tp_plan(cfg, size)
        assert (tp.size, tp.attn, tp.ssm, tp.active) == \
            (jp.size, jp.attn, jp.ssm, jp.active), size
        assert _tp_axes_by_path(cfg, size, kw) == \
            _tp_axes_by_path(jcfg, size, kw, jax_pkg=True), size
    assert tslot.tp_viable_sizes(cfg, 8) == jslot.tp_viable_sizes(jcfg, 8)
    # full widths too (only the probe's shapes are built)
    full, jfull = configs.get_config(arch), jconfigs.get_config(arch)
    for size in (2, 4, 8, 16):
        jp, tp = jslot.tp_plan(jfull, size), tslot.tp_plan(full, size)
        assert (tp.attn, tp.ssm) == (jp.attn, jp.ssm), size


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


def test_slot_sharding_validation_matches_the_reference():
    for n_slots in range(1, 17):
        for dp in range(0, 17):
            assert _outcome(lambda: tsched.validate_slot_sharding(
                n_slots, dp)) == _outcome(
                lambda: jsched.validate_slot_sharding(n_slots, dp))
            assert tsched.largest_valid_dp(n_slots, dp) == \
                jsched.largest_valid_dp(n_slots, dp)


@pytest.mark.parametrize("spec, shape", [
    (("data", "model"), (4, 6)), (("data", "model"), (3, 6)),
    ((("data", "model"),), (8, 2)), ((("data", "model"),), (6, 2)),
    ((None, "model", None), (2, 3, 5)), (("model",), (7,)),
    ((), (4, 4)), ((None, None), (2, 2))])
def test_sanitize_spec_matches_the_reference(spec, shape):
    jm = AbstractMesh((2, 4), ("data", "model"))
    tm = tmesh.make_mesh((2, 4), ("data", "model"))
    got = tshard.sanitize_spec(tshard.PSpec(*spec), shape, tm)
    want = jshard.sanitize_spec(PartitionSpec(*spec), shape, jm)
    assert tuple(got) == tuple(want) and isinstance(got, tshard.PSpec)


def test_shard_tensor_takes_this_ranks_block():
    """`shard_tensor` takes this rank's block, major axis first; on a
    mesh of one rank it is the whole tensor."""
    m = tmesh.Mesh((2, 2), ("data", "model"), rank=3)
    assert m.coords == {"data": 1, "model": 1}
    assert m.axis_index(("data", "model")) == 3
    t = torch.arange(4 * 6).reshape(4, 6)
    blk = tshard.shard_tensor(t, tshard.PSpec("data", "model"), m)
    assert torch.equal(blk, t[2:4, 3:6]) and blk.is_contiguous()
    blk = tshard.shard_tensor(t, tshard.PSpec(("data", "model")), m)
    assert torch.equal(blk, t[3:4])


def test_mesh_helpers_match_the_reference():
    for shape, axes in MESHES:
        jm, tm = AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)
        assert tmesh.dp_axes(tm) == tuple(
            n for n in jm.axis_names if n in ("pod", "data"))
        assert tmesh.fsdp_axes(tm) == tmesh.dp_axes(tm)
        assert tm.size == int(np.prod(shape))
    prod = tmesh.make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}


def test_nccl_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="one card per rank"):
        tmesh.init_mesh((1, 2), ("data", "model"))


def _fail(rank):
    if rank == 1:
        raise SystemExit(3)


def test_spawn_raises_when_a_rank_fails():
    with pytest.raises(Exception, match="exit code 3"):
        tmesh.spawn(_fail, 2)


def test_prefix_cache_notes_its_mesh():
    pc = tpfx.PrefixCache(4, chunk=None)
    assert pc.info()["mesh_fingerprint"] is None
    pc.note_remesh(("a", 1))
    fp = pc.info()["mesh_fingerprint"]
    pc.note_remesh(("a", 1))
    assert pc.remeshes == 0 and pc.info()["mesh_fingerprint"] == fp
    pc.note_remesh(("b", 2))
    assert pc.info()["remeshes"] == 1 and pc.info()["mesh_fingerprint"] != fp
