"""Mesh serving of the port beyond plain generation: the reference's
other sharded cases (tests/test_sharded_serve.py, test_spec_decode.py
:164-177, test_frontend.py:354-368), each held bit for bit against the
port's unsharded engine on the same requests.

Three `gloo` rank groups on the CPU (tests/torch_mesh_workers.py), run
once in this order: (2, 2) -- w4a8 column slices, `--silvia all`,
chunked prefill, compaction mid-run, speculative rounds (held against
the NON-speculative engine), the front-end over the sharded engine
(score and embed requests beside streamed generate), a snapshot taken
mid-flight, the refusal of a slot count the data shards do not divide,
and an engine built outside any mesh scope; then (2, 1), which restores
the (2, 2) snapshot; then (1, 2).  The same snapshot also restores onto
one device here, in the test process.
"""
import functools
import tempfile

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_workers as W  # noqa: E402
from repro_torch.launch import scheduler  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402

CASES = {
    (2, 2): ("w4a8", "silvia", "chunked", "compact", "spec", "frontend",
             "snapshot", "reject", "unmeshed"),
    (2, 1): ("restore", "w4a8", "chunked", "compact", "reject"),
    (1, 2): ("w4a8", "chunked", "compact", "frontend"),
}


@functools.lru_cache(maxsize=None)
def _groups():
    d = tempfile.mkdtemp(prefix="mesh_features_")
    snap = f"{d}/snap"
    return {shape: W.spawn_group(shape, cases, f"{d}/{i}.pkl", snap)
            for i, (shape, cases) in enumerate(CASES.items())}, snap


def _got(shape, case):
    return _groups()[0][shape][case]


@functools.lru_cache(maxsize=None)
def _baseline(case):
    return W.baseline(case)


def _check_streams(got, case):
    assert got["errors"] == 0 and got["outcomes"] == ["ok"], got
    assert got["streams"] == _baseline(case)


ids = lambda s: f"{s[0]}x{s[1]}"  # noqa: E731


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2)], ids=ids)
def test_w4a8_column_slices_match(shape):
    """w4a8 packs two logical columns per stored byte: the tensor-
    parallel slice cuts whole bytes (an even head width)."""
    got = _got(shape, "w4a8")
    _check_streams(got, "w4a8")
    assert got["info"]["tp_attn"] == (shape[1] == 2)


def test_silvia_all_on_the_mesh():
    _check_streams(_got((2, 2), "silvia"), "silvia")


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2)], ids=ids)
def test_chunked_prefill_on_the_mesh(shape):
    _check_streams(_got(shape, "chunked"), "chunked")


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2)], ids=ids)
def test_compaction_mid_run(shape):
    """Two short requests finish first; the two long ones left at the top
    of the batch move down within their data shards."""
    got = _got(shape, "compact")
    _check_streams(got, "compact")
    assert got["compactions"] >= 1


def test_spec_rounds_on_2x2_match_non_speculative():
    got = _got((2, 2), "spec")
    _check_streams(got, "spec")
    assert got["spec"]["rounds"] > 0
    assert got["spec"]["emitted"] == sum(
        len(v) - 1 for v in got["streams"].values())


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=ids)
def test_frontend_over_sharded_engine_matches_batch(shape):
    got = _got(shape, "frontend")
    assert got["results"] == _baseline("frontend")
    for rid, toks in got["streamed"].items():
        assert toks == got["results"][rid][1]


def _snapshotted():
    """The rids the (2, 2) snapshot holds (mid-stream or queued) and
    their unsharded streams."""
    rids = _got((2, 2), "snapshot")["in_flight"]
    assert rids == [1, 3, 4]
    return rids, {r: _baseline("snapshot")[r] for r in rids}


def test_snapshot_on_2x2_restores_on_2x1():
    rids, want = _snapshotted()
    got = _got((2, 1), "restore")
    assert got["restored"] == len(rids)
    assert got["errors"] == 0 and got["outcomes"] == ["ok"]
    assert got["streams"] == want


def test_snapshot_on_2x2_restores_on_one_device():
    rids, want = _snapshotted()
    _, snap_dir = _groups()
    cfg, params = W.build("qwen")
    eng = ServeEngine(params, cfg, **W.engine_kwargs("snapshot", cfg))
    assert eng.restore(snap_dir) == len(rids)
    eng.run((), scheduler.FastForwardClock())
    assert W.streams({r.rid: r.tokens for r in eng.finished}) == want
    assert eng.cache_info()["robustness"]["errors"] == 0


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)], ids=ids)
def test_indivisible_slot_counts_are_rejected(shape):
    assert "not a multiple of the data-shard count 2" in \
        _got(shape, "reject")


def test_unmeshed_engine_is_unchanged():
    got = _got((2, 2), "unmeshed")
    assert not got["has_mesh"]
    assert got["streams"] == _baseline("unmeshed")
