"""Training's forward in the port against `repro`: `lm.forward` /
`lm.encdec_forward` (mode "train" in every block), the gradient of
`training.loss_fn` at every leaf, the MoE capacity dispatch
(`mlp.moe(per_token=False)`, global and grouped) and the SSD mixer's
adaptive chunk grid (`ssm.ssd_forward(lengths=None)`).

Each family at its reduced config (dense: smollm, moe: granite-moe,
ssm: mamba2, hybrid: jamba, encdec: whisper, vlm: qwen2-vl on stub
embeddings), plus dense with `attn_q_chunk` set; weights from the
reference's `lm.init_params`, imported through numpy; batches numpy
from a seed.  The reference runs jitted (`jax.jit` of its forward and of
`jax.value_and_grad(loss_fn)`, no remat), unsharded (ROADMAP C-ref2).

Tolerances and why (measured on these inputs):
* float32 checks the algorithm.  The port's sums run in other orders
  (torch's GEMMs and reductions against XLA's): logits within 3.5e-6 of
  their largest magnitude (jamba; the others <= 7.6e-7), aux within
  5e-7, the loss within 1e-6; every leaf's gradient within 6.9e-6 of
  that leaf's largest magnitude (jamba's expert weights; the others <=
  2.7e-6).  Held at F32_LOGIT_RTOL 1e-5, F32_GRAD_RTOL 5e-5, AUX_ATOL and
  LOSS_ATOL 1e-5.
* bfloat16 (the training dtype) rounds at the same places on both sides
  but XLA may drop intermediate roundings inside a fused computation and
  sums in other orders (ROADMAP C1), and a moved bf16 step can flip a
  router's top-k: the port's loss is held to BF16_RATIO (2.5) times the
  reference's own bf16 distance from its float32 loss, plus BF16_ABS
  (measured: the port 3.0e-4 / 9.1e-4 / 2.9e-4 / 1.1e-3 from the float32
  loss, the reference 3.5e-4 / 1.1e-3 / 2.8e-4 / 2.5e-3, dense / moe /
  ssm / encdec).
* The MoE dispatch and the SSD grid alone, in float32: RTOL 1e-5 of the
  output's largest magnitude (the dispatch measured <= 1.9e-7, 49-60
  assignments dropped where capacity_factor is 0.5).
* Port-internal: remat on == off, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.training import step as tstep  # noqa: E402
from test_torch_model import jax_to_numpy  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

F32_LOGIT_RTOL = 1e-5
F32_GRAD_RTOL = 5e-5
AUX_ATOL = 1e-5
LOSS_ATOL = 1e-5
BF16_RATIO = 2.5
BF16_ABS = 1e-3
RTOL = 1e-5

# family -> (arch, config overrides)
FAMILIES = {
    "dense": ("smollm-135m", {}),
    "dense_qchunk": ("smollm-135m", {"attn_q_chunk": 4}),
    "moe": ("granite-moe-1b-a400m", {}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": ("jamba-v0.1-52b", {}),
    "encdec": ("whisper-small", {}),
    "vlm": ("qwen2-vl-72b", {}),
}
B, S = 2, 20            # 20 tokens: mamba2's chunk 16 pads a second chunk


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(family, dtype):
    arch, kw = FAMILIES[family]
    kw = dict(kw, dtype=dtype)
    return (dataclasses.replace(jconfigs.get_reduced_config(arch), **kw),
            dataclasses.replace(tconfigs.get_reduced_config(arch), **kw))


def _batches(family, cfg, seed=0):
    """(jax batch, torch batch): the loss_fn batch form of the family."""
    rng = np.random.default_rng(seed)
    if family == "encdec":
        b = {"audio": rng.normal(size=(B, 12, cfg.d_model)).astype(
            np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, 9)).astype(np.int32)}
    elif family == "vlm":
        b = {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(
            np.int32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _inputs(family, batch):
    if family == "encdec":
        return batch["audio"], batch["tokens"][:, :-1]
    if family == "vlm":
        return batch["embeds"]
    return batch["tokens"][:, :-1]


_RUNS = {}


def reference_run(family, dtype):
    """(jax params, port params, torch batch, the reference's (logits,
    aux) and ((loss, metrics), grads)); one jit per (family, dtype)."""
    key = (family, dtype)
    if key not in _RUNS:
        jcfg, tcfg = _cfgs(family, dtype)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg, max_seq=64)
        tp = from_jax_params(jax_to_numpy(jp), device="cpu")
        jb, tb = _batches(family, jcfg)
        jt = jstep.TrainConfig(remat=False)

        @jax.jit
        def run(p, b):
            fwd = jlm.forward(p, _inputs(family, b), jcfg, remat=False)
            return fwd, jax.value_and_grad(
                lambda q: jstep.loss_fn(q, b, jcfg, jt), has_aux=True)(p)

        _RUNS[key] = (jp, tp, tb, jax.device_get(run(jp, jb)))
    return _RUNS[key]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_matches_reference(family):
    _, tp, tb, ((logits, aux), _) = reference_run(family, "float32")
    _, tcfg = _cfgs(family, "float32")
    got, got_aux = tlm.forward(tp, _inputs(family, tb), tcfg, remat=False)
    assert got.dtype == torch.float32 and got.shape == logits.shape
    assert _rel(_np(got), logits) <= F32_LOGIT_RTOL
    assert abs(float(got_aux) - float(aux)) <= AUX_ATOL
    if family in ("moe", "hybrid"):
        assert float(aux) > 0.5          # the MoE's aux reaches the output


def _grad_leaves(tree):
    """{key path: float32 numpy} of a port tree or the reference's numpy
    tree (bf16 as its uint16 view)."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if isinstance(a, torch.Tensor):
            a = _np(a)
        elif a.dtype == np.uint16:
            a = a.view(jnp.bfloat16).astype(np.float32)
        out[tuple(k.key for k in path)] = np.asarray(a, np.float32)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_gradients_match_reference(family):
    """loss, z_loss, aux_loss and the gradient of the total at every leaf
    against jax.value_and_grad of the reference's loss_fn."""
    _, tp, tb, (_, ((_, metrics), grads)) = reference_run(family, "float32")
    _, tcfg = _cfgs(family, "float32")
    got_m, got_g = tstep._grads(tp, tb, tcfg, tstep.TrainConfig(remat=False))
    for k in ("loss", "z_loss", "aux_loss"):
        assert abs(float(got_m[k]) - float(metrics[k])) <= LOSS_ATOL, k
    want = _grad_leaves(jax_to_numpy(grads))
    got = _grad_leaves(pytree.tree_map(lambda t: t, got_g))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert _rel(got[k], w) <= F32_GRAD_RTOL, (k, _rel(got[k], w))


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "encdec"])
def test_bf16_loss_within_the_references_own_noise(family):
    """bf16 params (the training dtype): the port's NLL against the
    reference's float32 NLL on the same weights, held to BF16_RATIO times
    the reference's own bf16 distance from it."""
    jp32, _, tb, (_, ((_, m32), _)) = reference_run(family, "float32")
    _, _, _, (_, ((_, m16), _)) = reference_run(family, "bfloat16")
    jp16 = reference_run(family, "bfloat16")[0]
    _, tcfg = _cfgs(family, "bfloat16")
    tp16 = from_jax_params(jax_to_numpy(jp16), device="cpu")
    got = tstep.loss_fn(tp16, tb, tcfg, tstep.TrainConfig(remat=False))[1]
    ref_err = abs(float(m16["loss"]) - float(m32["loss"]))
    err = abs(float(got["loss"]) - float(m32["loss"]))
    assert err <= BF16_RATIO * ref_err + BF16_ABS, (err, ref_err)


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "encdec"])
def test_remat_equals_no_remat(family):
    """Every unit under a checkpoint recomputes the same activations:
    the loss and every gradient bit for bit."""
    _, tp, tb, _ = reference_run(family, "float32")
    _, tcfg = _cfgs(family, "float32")
    outs = [tstep._grads(tp, tb, tcfg, tstep.TrainConfig(remat=r))
            for r in (False, True)]
    (ma, ga), (mb, gb) = outs
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in
               zip(pytree.tree_leaves(ga), pytree.tree_leaves(gb)))


# ---------------------------------------------------------------------------
# the MoE capacity dispatch
# ---------------------------------------------------------------------------

def _moe_case(dispatch="global", capacity_factor=1.25, groups=32, seed=3):
    """(jax cfg, port cfg, jax layer params, port layer params, x numpy
    [B, S, d]) for reduced granite's first MoE layer in float32."""
    kw = dict(dtype="float32")
    jcfg, tcfg = _cfgs("moe", "float32")
    moe_kw = dict(dispatch=dispatch, capacity_factor=capacity_factor,
                  dispatch_groups=groups)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **moe_kw), **kw)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             **moe_kw), **kw)
    jp = jmlp.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).normal(
        size=(2, 32, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, jax_to_numpy(jp), x


def _moe_both(jcfg, tcfg, jp, np_params, x):
    want, want_aux = jax.jit(lambda p, v: jmlp.moe(p, v, jcfg))(
        jp, jnp.asarray(x))
    tp = from_jax_params(np_params, device="cpu")
    got, got_aux = tmlp.moe(tp, torch.from_numpy(x), tcfg, per_token=False)
    return (np.asarray(want), float(want_aux)), (_np(got), float(got_aux))


def _dropped(cfg, np_params, x, groups: int) -> int:
    """Assignments past their group's capacity, from the routing."""
    m = cfg.moe
    logits = x.reshape(-1, x.shape[-1]) @ np_params["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :m.top_k]
    t = top.shape[0] // groups
    cap = int(m.capacity_factor * m.top_k * t / m.n_experts) + 1
    return sum(int(np.maximum(np.bincount(g.ravel(), minlength=m.n_experts)
                              - cap, 0).sum())
               for g in top.reshape(groups, t, m.top_k))


@pytest.mark.parametrize("dispatch,capacity_factor,groups", [
    ("global", 1.25, 32), ("global", 0.5, 32), ("grouped", 1.25, 4),
    ("grouped", 0.5, 4), ("shard_map", 0.5, 32)])
def test_moe_capacity_dispatch_matches_reference(dispatch, capacity_factor,
                                                 groups):
    """Global and grouped dispatch, with capacity to spare and with tokens
    dropped at capacity (which ones: the stable sort's order); the
    "shard_map" dispatch outside a mesh runs the global one, as the
    reference's does."""
    case = _moe_case(dispatch, capacity_factor, groups)
    (want, want_aux), (got, got_aux) = _moe_both(*case)
    assert _rel(got, want) <= RTOL
    assert abs(got_aux - want_aux) <= AUX_ATOL
    n_groups = groups if dispatch == "grouped" else 1
    dropped = _dropped(case[1], case[3], case[4], n_groups)
    assert (dropped > 0) == (capacity_factor < 1), dropped


def test_moe_router_ties_order_as_lax_top_k():
    """Two experts with the same router column tie on every token for the
    k-th place: `lax.top_k` takes the lower index, and so must the port
    (its dispatch keeps that expert's assignments)."""
    jcfg, tcfg, jp, np_params, x = _moe_case("global", 0.5)
    r = np.array(np_params["router"])
    r[:, 0] = 3.0 * np.abs(r[:, 0]).max() * np.sign(x.mean(axis=(0, 1)))
    r[:, 2] = r[:, 1] * 2.0
    r[:, 3] = r[:, 1] * 2.0
    np_params = dict(np_params, router=r)
    jp = dict(jp, router=jnp.asarray(r))
    (want, want_aux), (got, got_aux) = _moe_both(jcfg, tcfg, jp, np_params, x)
    assert _rel(got, want) <= RTOL
    assert abs(got_aux - want_aux) <= AUX_ATOL


def test_moe_dispatch_gradient_matches_reference():
    """The capacity dispatch differentiates as the reference's: x and
    every expert weight, with tokens dropped."""
    jcfg, tcfg, jp, np_params, x = _moe_case("global", 0.5)

    def jloss(p, v):
        y, aux = jmlp.moe(p, v, jcfg)
        return jnp.sum(y * jnp.cos(v)) + aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = from_jax_params(np_params, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmlp.moe(leaves, xt, tcfg, per_token=False)
    (torch.sum(y * torch.cos(xt)) + aux).backward()
    assert _rel(_np(xt.grad), jg[1]) <= F32_GRAD_RTOL
    for k, v in leaves.items():
        assert _rel(_np(v.grad), jg[0][k]) <= F32_GRAD_RTOL, k


# ---------------------------------------------------------------------------
# the SSD mixer's adaptive chunk grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [8, 16, 20, 32, 37])
def test_ssd_adaptive_grid_matches_reference(length):
    """lengths=None: chunks of min(chunk, L) (chunk 16), the last padded
    with identity steps when L is not a multiple; the final state too."""
    jcfg, tcfg = _cfgs("ssm", "float32")
    jp = jssm.init_ssm(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(length)
    noisy = {k: np.asarray(v) + rng.normal(0, 0.3, v.shape).astype(
        np.float32) if k in ("dt_bias", "conv_b", "D") else np.asarray(v)
        for k, v in jp.items()}
    jp = {k: jnp.asarray(v) for k, v in noisy.items()}
    x = rng.normal(size=(2, length, jcfg.d_model)).astype(np.float32)
    want, wstate = jax.jit(lambda p, v: jssm.ssd_forward(
        p, v, jcfg, return_state=True))(jp, jnp.asarray(x))
    tp = from_jax_params(noisy, device="cpu")
    got = tssm.ssd_forward(tp, torch.from_numpy(x), tcfg)
    got_s, state = tssm.ssd_forward(tp, torch.from_numpy(x), tcfg,
                                    return_state=True)
    assert torch.equal(got, got_s)
    assert got.shape == (2, length, jcfg.d_model)
    assert _rel(_np(got), want) <= RTOL
    for k in ("ssm", "conv"):
        assert _rel(_np(state[k]), wstate[k]) <= RTOL, k


def test_ssd_gradient_finite_where_the_reference_overflows():
    """mamba2's own chunk of 256 on a 256-token sequence: the decay's
    differences above the diagonal reach ~177 and exp overflows.  The
    reference takes the exp before its where, so its gradient is NaN
    (inf times the where's zero; ROADMAP C-ref10); the port masks before
    the exp (exp(-inf) is the 0 the where puts there): the same forward
    and a finite gradient."""
    jcfg, tcfg = _cfgs("ssm", "float32")
    jcfg, tcfg = (dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, chunk=256)) for c in (jcfg, tcfg))
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).normal(size=(1, 256, jcfg.d_model)).astype(
        np.float32)
    jg = jax.jit(jax.grad(lambda p, v: jnp.sum(jssm.ssd_forward(
        p, v, jcfg))))(jp, jnp.asarray(x))
    assert not np.isfinite(np.asarray(jg["A_log"])).all()
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    y = tssm.ssd_forward(tp, torch.from_numpy(x), tcfg)
    y.sum().backward()
    assert all(torch.isfinite(v.grad).all() for v in tp.values())
    want = jax.jit(lambda p, v: jssm.ssd_forward(p, v, jcfg))(
        jp, jnp.asarray(x))
    assert _rel(_np(y), want) <= RTOL
