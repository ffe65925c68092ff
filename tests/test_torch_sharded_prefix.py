"""The port's prefix cache on a mesh, the weight placement rules and the
engine's device on a mesh.

Three `gloo` rank groups on the CPU (tests/torch_mesh_workers.py):

* the prefix cache (launch/prefix_cache.py) under a mesh-aware engine,
  full prefill and chunked (reduced qwen1.5-0.5b, its attention split
  at 2 on a model axis of 2) and reduced mamba2 (SSD split at 2), over
  two waves of traffic: terminal repeats and shared-prefix chains hit
  on whichever data shard owns the slot, the pool counts the same hits
  as on one device, and every stream equals the port's unsharded
  engine with the same cache, and the cold engine, bit for bit;
* `shard_tree` / `gather_sharded` (distributed/sharding.py) under
  `param_pspecs`: each rank's block has its spec's shape, and the
  gathered tree is the whole one, bit for bit;
* an engine asked for "cuda" on a mesh whose ranks run on the CPU
  raises, naming the mesh's device.
"""
import functools
import tempfile

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_workers as W  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402

CASES = {
    (2, 1): ("prefix", "prefix_chunked", "shard_gather", "device"),
    (1, 2): ("prefix", "prefix_chunked", "prefix_ssm", "shard_gather"),
    (2, 2): ("prefix", "prefix_chunked", "prefix_ssm", "shard_gather",
             "device"),
}
SHAPES = list(CASES)


@functools.lru_cache(maxsize=None)
def _groups():
    d = tempfile.mkdtemp(prefix="mesh_prefix_")
    return {shape: W.spawn_group(shape, cases, f"{d}/{i}.pkl", f"{d}/snap")
            for i, (shape, cases) in enumerate(CASES.items())}


def _got(shape, case):
    return _groups()[shape][case]


@functools.lru_cache(maxsize=None)
def _unsharded(case, prefix: bool):
    """The port's unsharded engine on the case's requests, with the
    prefix cache or cold."""
    kind, quant = W.model_of(case)
    cfg, params = W.build(kind, quant)
    kw = W.engine_kwargs(case, cfg)
    if not prefix:
        kw.pop("prefix_cache")
    eng = ServeEngine(params, cfg, **kw)
    out = W.serve(eng, case, cfg)
    assert {r.outcome for r in eng.finished} == {"ok"}
    return out, eng.cache_info().get("prefix_cache")


ids = lambda s: f"{s[0]}x{s[1]}"  # noqa: E731
PREFIX = [(s, c) for s, cases in CASES.items() for c in cases
          if c.startswith("prefix")]


@pytest.mark.parametrize("shape,case", PREFIX,
                         ids=[f"{ids(s)}-{c}" for s, c in PREFIX])
def test_prefix_cache_on_the_mesh_matches_unsharded(shape, case):
    got = _got(shape, case)
    assert got["errors"] == 0 and got["outcomes"] == ["ok"], got
    want, info = _unsharded(case, True)
    assert got["streams"] == want
    assert got["streams"] == _unsharded(case, False)[0]
    pc = got["prefix"]
    # the same lookups, hits and insertions as on one device
    for k in ("hits", "misses", "tokens_skipped", "insertions"):
        assert pc[k] == info[k], (k, pc, info)
    assert pc["hits"] > 0 and pc["tokens_skipped"] > 0
    assert pc["mesh_fingerprint"] is not None and pc["remeshes"] == 0
    m = got["info"]
    assert m["dp_size"] == shape[0]
    assert m["tp_ssm" if case == "prefix_ssm" else "tp_attn"] == \
        (shape[1] == 2)


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_chunked_prefix_cache_chains_on_the_mesh(shape):
    """Full prefill skips only the three repeats' prompts (terminal
    hits); a chunked engine also serves the shared 8-token prefix of
    the second wave's three requests from chain pages."""
    repeats = 6 + 11 + 9
    assert _got(shape, "prefix")["prefix"]["tokens_skipped"] == repeats
    assert _got(shape, "prefix_chunked")["prefix"]["tokens_skipped"] == \
        repeats + 3 * 8


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_shard_tree_blocks_gather_back_whole(shape):
    got = _got(shape, "shard_gather")
    assert got["shapes_ok"] and got["equal"], got
    assert 0 < got["n_sharded"] <= got["n_leaves"]


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=ids)
def test_engine_device_must_be_the_mesh_device(shape):
    """A "cuda" engine on ranks the mesh placed on the CPU raises: the
    engine never replaces the device it was asked for."""
    msg = _got(shape, "device")
    assert msg is not None and "device='cuda'" in msg and "cpu" in msg
