"""Mesh serving of the port: the sharded engine's streams against its
unsharded engine's, bit for bit, for every family the reference shards.

Each mesh -- (2, 1) data shards only, (1, 2) tensor parallelism only,
(2, 2) both -- is one group of `gloo` rank processes on the CPU
(`launch.mesh.spawn`, one torch thread each) that serves every family's
case in turn (tests/torch_mesh_workers.py; rank 0 drives the engine,
the others follow it).  The traffic is the reference test's ragged mix
(tests/test_sharded_serve.py:57-76): more requests than slots,
staggered arrivals, a FastForwardClock.  The oracle is the port's own
unsharded engine, which the rest of the suite holds against the JAX
package; the models are reduced configs under forced w8a8 weights:
smollm-135m (one KV head: data shards only), qwen1.5-0.5b (4 heads and
4 KV heads: attention tensor parallelism), mamba2 (SSD tensor
parallelism), jamba (both) and whisper (encoder, decoder and cross
attention).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_workers as W  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import slot_state  # noqa: E402

MESHES = [(2, 1), (1, 2), (2, 2)]
KINDS = ["dense", "qwen", "ssm", "hybrid", "encdec"]


@functools.lru_cache(maxsize=None)
def _group(shape):
    import tempfile
    d = tempfile.mkdtemp(prefix="mesh_serve_")
    return W.spawn_group(shape, tuple(KINDS), f"{d}/out.pkl", f"{d}/snap")


@functools.lru_cache(maxsize=None)
def _baseline(kind):
    return W.baseline(kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_matches_single_device(shape, kind):
    got = _group(shape)[kind]
    assert got["errors"] == 0 and got["outcomes"] == ["ok"], got
    assert got["streams"] == _baseline(kind)
    assert got["graphs"][0] <= got["graphs"][1]
    info = got["info"]
    assert info["dp_size"] == shape[0] and info["tp_size"] == shape[1]
    assert info["n_devices"] == shape[0] * shape[1]
    assert info["backend"] == "gloo" and info["captured"] is False


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_actually_activates(shape):
    """The matrix above must not pass vacuously: where the model axis is
    2, attention shards for qwen, jamba and whisper, SSD for mamba2 and
    jamba, and smollm's 3 heads / 1 KV head replicate -- as tp_plan says,
    and as each engine's cache_info reports."""
    got = _group(shape)
    want = {"dense": (False, False), "qwen": (True, False),
            "ssm": (False, True), "hybrid": (True, True),
            "encdec": (True, False)}
    for kind in KINDS:
        info = got[kind]["info"]
        plan = slot_state.tp_plan(
            configs.get_reduced_config(W.FAMILIES[kind]), shape[1])
        assert (info["tp_attn"], info["tp_ssm"]) == (plan.attn, plan.ssm)
        assert (plan.attn, plan.ssm) == (want[kind] if shape[1] > 1
                                         else (False, False)), kind
