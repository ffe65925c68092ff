"""The port's slot-state layer (`repro_torch/models/slot_state.py`) and the
masked decode writes it rests on, against `repro`.

* The probed slot and length axes of every registered family equal the
  reference's, leaf for leaf by name (the hybrid family's flat cache
  against the reference's nesting {"attn": {k, v}, "mamba": {ssm,
  conv}}).
* slice / merge / admit / permute round trips, in place: slice_live
  returns views, so merging them back copies nothing.
* An inactive slot's state is bit-identical after a decode step, for the
  dense, moe, ssm and hybrid families.
* The repaired `attn_decode` (every row computes its write; an inactive
  row writes back what it held) equals the boolean-indexed write it
  replaced, bit for bit, on a mixed mask, for a bf16 and an int8 cache;
  and the reference's masked `decode_step` within tests/test_torch_model
  .py's tolerances (float32 and bf16; bf16 and int8 caches).
* A write past the cache clamps its start as XLA's dynamic_update_slice
  does, so only the overrunning row's last positions change.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import slot_state as jslot  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import sampling  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import slot_state  # noqa: E402
from test_torch_model import CACHE_TOL, TOL, params_for, _f32  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCHS = {"dense": "smollm-135m", "moe": "granite-moe-1b-a400m",
         "ssm": "mamba2-2.7b", "hybrid": "jamba-v0.1-52b",
         "vlm": "qwen2-vl-72b"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise_state(spec, n_slots, t, seed=3):
    """A slot state filled with noise, so "unchanged" is a real check."""
    state = spec.init_state(n_slots, t)
    g = torch.Generator().manual_seed(seed)
    for leaf in pytree.tree_leaves(state):
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=g))
        else:
            leaf.copy_(torch.randint(-3, 4, leaf.shape, generator=g))
    return state


# ---------------------------------------------------------------------------
# probing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(ARCHS))
def test_probed_axes_match_reference(family):
    """Slot and length axes per leaf, by leaf name, equal the reference's
    (`jax.eval_shape` probing there, the meta device here)."""
    arch = ARCHS[family]
    jspec = jslot.spec_for(jconfigs.get_reduced_config(arch))
    tspec = slot_state.spec_for(tconfigs.get_reduced_config(arch))
    jpaths = [p[-1].key for p, _ in jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: jspec.init_state(2, 16)))[0]]
    want = {k: (b, la) for k, b, la in zip(jpaths, jspec.batch_axes,
                                           jspec.length_axes)}
    names = list(tspec.init_state(2, 16))
    got = {k: (b, la) for k, b, la in zip(names, tspec.batch_axes,
                                          tspec.length_axes)}
    assert got == want
    assert tspec.has_length_axis == jspec.has_length_axis
    assert tspec.prefill_chunkable == jspec.prefill_chunkable


def test_registry_guidance_and_sampling_page():
    cfg = dataclasses.replace(tconfigs.get_reduced_config("smollm-135m"),
                              family="rwkv")
    with pytest.raises(ValueError, match="slot_state.register"):
        slot_state.spec_for(cfg)
    # encdec is registered with its engine path: probed at a fixed s_enc,
    # its cross K/V and lengths are constant-size leaves
    enc = slot_state.spec_for(tconfigs.get_reduced_config("whisper-small"),
                              s_enc=24)
    assert not enc.prefill_chunkable and enc.has_length_axis
    assert dict(zip(enc.init_state(2, 16), enc.length_axes)) == {
        "k": 2, "v": 2, "cross_k": None, "cross_v": None, "cross_len": None}
    assert {"dense", "moe", "ssm", "hybrid", "vlm", "encdec",
            "sampling"} <= set(slot_state.families())
    spec = sampling.page_spec()
    assert spec.batch_axes == (0,) * 5 and spec.length_axes == (None,) * 5
    assert [tuple(t.shape) for t in spec.init_state(4, 1)] == \
        [(4, 2), (4,), (4,), (4,), (4,)]


# ---------------------------------------------------------------------------
# state operations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_slice_merge_admit_permute_round_trip(family):
    spec = slot_state.spec_for(tconfigs.get_reduced_config(ARCHS[family]))
    state = _noise_state(spec, 4, 32)
    orig = {k: t.clone() for k, t in state.items()}
    # slice_live: views; merging them back copies nothing
    sub = spec.slice_live(state, 2, 16)
    for k, t in sub.items():
        assert t.data_ptr() == state[k].data_ptr()
        ba = spec.batch_axes[list(state).index(k)]
        assert t.shape[ba] == 2
    assert spec.merge_live(state, sub, 2, 16) is state
    for k in state:
        assert torch.equal(state[k], orig[k])
    # a sub that is not a view is written back, in place
    copied = {k: t.clone().fill_(7) for k, t in sub.items()}
    ptrs = {k: t.data_ptr() for k, t in state.items()}
    spec.merge_live(state, copied, 2, 16)
    for k, t in state.items():
        assert t.data_ptr() == ptrs[k]
        assert torch.equal(spec.slice_live(state, 2, 16)[k], copied[k])
    for k in state:
        state[k].copy_(orig[k])
    # admit one fresh 1-row group into slot 3: only slot 3 changes; the
    # length-paged leaves only up to t_pre
    rows = spec.init_state(1, 16)
    spec.admit(state, rows, [3], 1, t_pre=16)
    for i, (k, t) in enumerate(state.items()):
        ba, la = spec.batch_axes[i], spec.length_axes[i]
        for slot in range(3):
            assert torch.equal(t.select(ba, slot), orig[k].select(ba, slot))
        s3 = t.select(ba, 3)
        if la is None:
            assert not s3.any()
        else:
            la3 = la - (la > ba)
            assert not s3.narrow(la3, 0, 16).any()
            assert torch.equal(s3.narrow(la3, 16, 16),
                               orig[k].select(ba, 3).narrow(la3, 16, 16))
    # permute and its inverse restore the state, in place
    for k in state:
        state[k].copy_(orig[k])
    perm = np.asarray([2, 0, 3, 1])
    spec.permute_slots(state, perm)
    for i, (k, t) in enumerate(state.items()):
        ba = spec.batch_axes[i]
        assert torch.equal(t.select(ba, 0), orig[k].select(ba, 2))
        assert t.data_ptr() == ptrs[k]
    spec.permute_slots(state, np.argsort(perm))
    for k in state:
        assert torch.equal(state[k], orig[k])


# ---------------------------------------------------------------------------
# masked updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_masked_update_leaves_inactive_slots_bit_identical(family):
    cfg = tconfigs.get_reduced_config(ARCHS[family])
    params = tlm.init_params(cfg, 1, device="cpu", max_seq=64)
    spec = slot_state.spec_for(cfg)
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)))
    pos = torch.from_numpy(rng.integers(0, 24, (4,)))
    for active in ([True, False, True, False], [False] * 4,
                   [False, True, True, True]):
        state = _noise_state(spec, 4, 32)
        before = {k: t.clone() for k, t in state.items()}
        tlm.decode_step(params, toks, state, pos, cfg,
                        active=torch.tensor(active))
        for i, (k, t) in enumerate(state.items()):
            ba = spec.batch_axes[i]
            for slot in np.nonzero(~np.asarray(active))[0]:
                assert torch.equal(t.select(ba, int(slot)),
                                   before[k].select(ba, int(slot))), \
                    (family, k, slot)
            if any(active) and family != "ssm" and k in ("k", "v"):
                assert not torch.equal(t, before[k])


def _boolean_indexed_decode(p, x_t, cache, pos, cfg, active):
    """attn_decode as it was before the masked write: the active rows
    selected by boolean indexing, only they written."""
    b, c = x_t.shape[:2]
    qpos = pos[:, None] + torch.arange(c, dtype=pos.dtype)
    q = tattn._project_q(p, x_t, cfg)
    k_t, v_t = tattn._project_kv(p, x_t, cfg)
    q = tattn.common.apply_rope(q, qpos, cfg.rope_theta)
    k_t = tattn.common.apply_rope(k_t, qpos, cfg.rope_theta)
    rows = torch.arange(b)[active]
    at = (rows[:, None], qpos[rows])
    for name, new in (("k", k_t), ("v", v_t)):
        if f"{name}_s" in cache:
            new, scale = tattn._kv_quantize(new)
            cache[f"{name}_s"][at] = scale[rows]
        cache[name][at] = new[rows]
    if "k_s" in cache:
        k = tattn._kv_dequant(cache["k"], cache["k_s"], x_t.dtype)
        v = tattn._kv_dequant(cache["v"], cache["v_s"], x_t.dtype)
    else:
        k, v = cache["k"], cache["v"]
    kpos = torch.arange(k.shape[1]).expand(b, -1)
    return tattn.qmatmul(tattn._attend(q, k, v, cfg, x_t.dtype, qpos, kpos),
                         p["wo"])


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_masked_write_equals_boolean_indexed_write(kv):
    cfg = dataclasses.replace(tconfigs.get_reduced_config("smollm-135m"),
                              serve_kv_dtype=kv)
    params = tlm.init_params(cfg, 2, device="cpu", max_seq=64)
    p = {k: t[0] for k, t in params["blocks"]["attn"].items()}
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    pos = torch.tensor([3, 9, 0, 17])
    active = torch.tensor([True, False, True, False])
    spec = slot_state.spec_for(cfg)
    base = {k: t[0] for k, t in _noise_state(spec, 4, 24).items()}
    if kv == "int8":
        base["k_s"].abs_()
        base["v_s"].abs_()
    c_new = {k: t.clone() for k, t in base.items()}
    c_old = {k: t.clone() for k, t in base.items()}
    out_new = tattn.attn_decode(p, x, c_new, pos, cfg, active=active)
    out_old = _boolean_indexed_decode(p, x, c_old, pos, cfg, active)
    assert torch.equal(out_new, out_old)
    for k in base:
        assert torch.equal(c_new[k], c_old[k]), k
        assert torch.equal(c_new[k][~active], base[k][~active]), k


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_decode_step_matches_reference(dtype, kv):
    """decode_step with a mixed `active` mask after a ragged prefill,
    against the reference's (jitted): logits of the active rows and the
    caches within tests/test_torch_model.py's tolerances; the inactive
    row's pages bit-identical to what the prefill left, in both."""
    jcfg = dataclasses.replace(jconfigs.get_reduced_config("smollm-135m"),
                               dtype=dtype, serve_kv_dtype=kv)
    tcfg = dataclasses.replace(tconfigs.get_reduced_config("smollm-135m"),
                               dtype=dtype, serve_kv_dtype=kv)
    jp, tp = params_for("reduced", dtype, "w8a8")
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, jcfg.vocab, (3, 8)).astype(np.int32)
    last = np.array([7, 3, 5], np.int32)
    jl, jc = jax.jit(jlm.prefill, static_argnums=(2, 3))(
        jp, jnp.asarray(prompts), jcfg, 16, last_positions=jnp.asarray(last))
    _, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, 16,
                        last_positions=torch.from_numpy(last))
    before = {k: t.clone() for k, t in tc.items()}
    jbefore = {k: np.asarray(t.astype(jnp.float32)) for k, t in jc.items()}
    tok = rng.integers(0, jcfg.vocab, (3, 1)).astype(np.int32)
    pos = last + 1
    active = np.array([True, False, True])
    jl, jc = jax.jit(jlm.decode_step, static_argnums=(4,))(
        jp, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg,
        active=jnp.asarray(active))
    tl, tc = tlm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                             torch.from_numpy(pos).long(), tcfg,
                             active=torch.from_numpy(active))
    np.testing.assert_allclose(_f32(tl)[active], np.asarray(jl, np.float32)
                               [active], rtol=0, atol=TOL[dtype]["w8a8"])
    for k in tc:
        assert torch.equal(tc[k][:, 1], before[k][:, 1]), k
        assert np.array_equal(np.asarray(jc[k].astype(jnp.float32))[:, 1],
                              jbefore[k][:, 1]), k
    for k in ("k", "v"):
        # an int8 cache compared dequantized: its values move by int8 steps
        # where the two frameworks' bf16 keys differ (C1)
        got, want = _f32(tc[k]), np.asarray(jc[k].astype(jnp.float32))
        if kv == "int8":
            got = got * _f32(tc[f"{k}_s"])[..., None]
            want = want * np.asarray(jc[f"{k}_s"])[..., None]
        np.testing.assert_allclose(got, want, rtol=0, atol=CACHE_TOL[dtype],
                                   err_msg=k)


def test_write_past_the_cache_clamps_like_xla():
    """A row whose position runs past the cache (a slot that finished
    mid-segment at max_cache_len) writes at S_max - 1, as XLA clamps the
    start of the reference's dynamic_update_slice: only that row's last
    position changes, and the reference's cache agrees there."""
    jcfg = dataclasses.replace(jconfigs.get_reduced_config("smollm-135m"),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced_config("smollm-135m"),
                               dtype="float32")
    jp, tp = params_for("reduced", "float32", "bf16")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, jcfg.vocab, (2, 8)).astype(np.int32)
    jl, jc = jlm.prefill(jp, jnp.asarray(prompts), jcfg, 16)
    _, tc = tlm.prefill(tp, torch.from_numpy(prompts), tcfg, 16)
    for p0 in (16, 19):
        tok = rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
        pos = np.array([8, p0], np.int32)
        before = {k: t.clone() for k, t in tc.items()}
        jl, jc = jax.jit(jlm.decode_step, static_argnums=(4,))(
            jp, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg)
        _, tc = tlm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                                torch.from_numpy(pos).long(), tcfg)
        for k in ("k", "v"):
            changed = (tc[k] != before[k]).any(dim=(0, 3, 4))   # [B, S]
            assert changed[1].nonzero().flatten().tolist() == [15], k
            assert changed[0].nonzero().flatten().tolist() == [8], k
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=0, atol=1e-5)
