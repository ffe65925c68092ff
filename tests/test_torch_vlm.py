"""The vlm family in the port against `repro`: qwen2-vl-72b at its reduced
config (2 layers, d_model 64, 4 heads of 16 over 2 KV heads, d_ff 128,
vocab 256, q/k/v biases, untied head; M-RoPE sections (2, 3, 3) of the
8 frequency slots, theta 1e6).  The vision frontend is a stub, in the
reference too: an image arrives as precomputed patch embeddings.

An image prompt here is what a served one is: per row, text embeddings
gathered from the embedding table, then one image's patch rows (seeded
with numpy at the table's scale), then text again, with Qwen2-VL's 3-row
positions (`image_positions`, arXiv:2409.12191): text has t = h = w =
its index; the image's patches share t = its offset, with h and w the
offset plus the patch's row and column; the text after it resumes at
the offset plus the grid's larger side.  The causal mask reads the
temporal row alone (the reference's `attention.py:210`), so the patches
of one image attend to each other both ways; only an image span shows
a mask on the cache index or on another row.

Weights come from the reference (`repro.models.lm.init_params`, its
q/k/v biases, zeros at init, given seeded values, then
`quantize_tree_for_serving(force=True)`), imported through numpy; the
reference is compared jitted, the form it serves (ROADMAP C7).

Tolerances are the dense family's (tests/test_torch_dense.py, ROADMAP
C1): tests/test_torch_model.py's TOL and CACHE_TOL, logits scaled by
max|logit| / 0.47 for the untied head (measured on the image prompt's
prefill and 4 decode steps, logits of max ~3.1: float32 within 1.6e-6
unquantized and 7.2e-7 under w8a8 and w4a8, against 6.5e-5 and 0.013;
bf16 within 0.024 / 0.078 / 0.078 against ~0.19; the caches within
1.9e-6 in float32 and one bf16 step, 0.0625, in bf16).  RoPE is held
at that file's 1e-5 (measured: float32 within 4.8e-7 of the
reference, XLA's cos and sin being its own), and three equal rows give
standard RoPE bit for bit.  Port-internal invariants are bit for bit:
token ids and their gathered embeddings, explicit equal rows and the
default positions, the captured step and the per-step loop, `--silvia
all` and off, `build_params` and whole-tree quantization.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.quant import qtensor as jqt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.quant import qtensor as tqt  # noqa: E402
from test_torch_model import CACHE_TOL, TOL, jax_to_numpy  # noqa: E402
from test_torch_serve import assert_tokens_match  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

ARCH = "qwen2-vl-72b"
SMOLLM_MAX_LOGIT = 0.47
ROPE_TOL = 1e-5
F32_TOL = 1e-5
B, G = 2, 4
# per row: text tokens before the image, the image's (rows, cols) of
# merged patches, text tokens after it; both rows of S = 20
LAYOUT = [(3, (3, 4), 5), (6, (2, 3), 8)]
S = 20
FORMATS = ["bf16", "w8a8", "w4a8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return tuple(dataclasses.replace(c.get_reduced_config(ARCH), **kw)
                 for c in (jconfigs, tconfigs))


_PARAMS = {}


def params_for(dtype, fmt):
    """(jax params, port params) on the same weights, the q/k/v biases
    drawn nonzero (the reference inits them to zeros); memoized
    (read-only use)."""
    if (dtype, fmt) not in _PARAMS:
        jcfg, _ = _cfgs(dtype=dtype)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg, max_seq=64)
        rng = np.random.default_rng(7)
        attn = jp["blocks"]["attn"]
        for name in ("bq", "bk", "bv"):
            assert not np.asarray(attn[name]).any()
            attn[name] = jnp.asarray(rng.normal(0, 0.5, attn[name].shape),
                                     jnp.dtype(dtype))
        jp = jqt.quantize_tree_for_serving(jp, fmt, force=True)
        _PARAMS[dtype, fmt] = (jp, from_jax_params(jax_to_numpy(jp),
                                                   device="cpu"))
    return _PARAMS[dtype, fmt]


def image_positions(layout):
    """Qwen2-VL's M-RoPE positions [3, B, S] (int32 numpy) of rows laid
    out as `layout` [(n_before, (gh, gw), n_after)] (module docstring)."""
    rows = []
    for n0, (gh, gw), n1 in layout:
        t = list(range(n0)) + [n0] * (gh * gw) + list(
            range(n0 + max(gh, gw), n0 + max(gh, gw) + n1))
        h = list(range(n0)) + [n0 + r for r in range(gh)
                               for _ in range(gw)] + t[n0 + gh * gw:]
        w = list(range(n0)) + [n0 + c for _ in range(gh)
                               for c in range(gw)] + t[n0 + gh * gw:]
        rows.append([t, h, w])
    return np.array(rows, np.int32).transpose(1, 0, 2)


def image_prompt(embed, layout, seed):
    """[B, S, d] float32 stub embeddings: each row's text positions the
    embedding rows of seeded tokens, its image's patch rows seeded
    normals at the table's scale (its std)."""
    table = np.asarray(embed, np.float32)
    rng = np.random.default_rng(seed)
    out = []
    for n0, (gh, gw), n1 in layout:
        toks = rng.integers(0, table.shape[0], n0 + n1)
        patches = rng.standard_normal((gh * gw, table.shape[1])) \
            * table.std()
        out.append(np.concatenate([table[toks[:n0]], patches,
                                   table[toks[n0:]]]).astype(np.float32))
    return np.stack(out)


def _embed_table(jp):
    return np.asarray(jp["embed"].astype(jnp.float32))


def _logit_tol(dtype, fmt, ref_logits):
    return TOL[dtype][fmt] * max(1.0, float(np.abs(ref_logits).max())
                                 / SMOLLM_MAX_LOGIT)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=tol,
                               err_msg=what)


_jit_prefill = jax.jit(jlm.prefill, static_argnums=(2, 3))
_jit_decode = jax.jit(jlm.decode_step, static_argnums=(4,))


# ---------------------------------------------------------------------------
# config, M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(reduced):
    """Every field the port carries equals the reference's (the M-RoPE
    sections, the vision frontend, the q/k/v biases, theta 1e6); the one
    it does not carry (subquadratic) is at its default there; the
    derived widths and param_count equal the reference's: 72.70 B at
    full width, the family counted as dense."""
    get = "get_reduced_config" if reduced else "get_config"
    j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    carried = {f.name for f in dataclasses.fields(t)}
    for name in carried:
        assert getattr(t, name) == getattr(j, name), name
    for f in dataclasses.fields(j):
        if f.name not in carried:
            assert getattr(j, f.name) == f.default, f.name
    for name in ("head_dim", "q_dim", "kv_dim"):
        assert getattr(t, name) == getattr(j, name)
    assert t.param_count() == j.param_count()
    assert sum(t.m_rope_sections) == t.head_dim // 2
    if not reduced:
        assert t.param_count() == 72704065536
        assert (t.family, t.frontend, t.m_rope_sections) == \
            ("vlm", "vision", (16, 24, 24))
    assert tlm.blocks.BLOCK_FNS["vlm"] is tblocks.dense_block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("secs,d", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_rope_sections_match_reference(secs, d, dtype):
    """M-RoPE over [3, B, S] positions (each row its own, up to 4000, as
    a long prompt's) against the reference's `apply_rope` at theta 1e6,
    within the RoPE test's 1e-5 (module docstring).  In bf16 an output
    whose float32 value sits within an ulp of a bf16 rounding boundary
    may round to the other side (measured: 1 of 18432 at D 128, one
    step of 0.00049 at 0.0938): there one bf16 step is allowed, at no
    more than 0.1% of the outputs."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 24, 3, d)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 24)).astype(np.int32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = jcommon.apply_rope(jx, jnp.asarray(pos), 1e6, secs)
    got = tcommon.apply_rope(torch.from_numpy(np.array(
        jx.astype(jnp.float32))).to(getattr(torch, dtype)),
        torch.from_numpy(pos), 1e6, secs)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, ROPE_TOL)
    else:
        g, w = _f32(got), _f32(want)
        off = np.abs(g - w) > ROPE_TOL
        assert off.mean() <= 1e-3
        np.testing.assert_array_less(np.abs(g - w)[off],
                                     2 ** -7 * np.abs(w)[off] + ROPE_TOL)
    with pytest.raises(ValueError, match="M-RoPE"):
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                           1e6, secs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_equal_rows_are_standard_rope(dtype):
    """Three equal position rows give standard RoPE bit for bit: each
    slot's angle is the same float32 product."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 128)).astype(
        np.float32)).to(getattr(torch, dtype))
    pos = torch.from_numpy(rng.integers(0, 5000, (2, 9)))
    got = tcommon.apply_rope(x, pos.expand(3, 2, 9), 1e6, (16, 24, 24))
    assert torch.equal(got, tcommon.apply_rope(x, pos, 1e6))


def test_image_positions_rule():
    """The positions rule of the module docstring, and chip_smoke.py's copy
    of it (`image_positions`) at the card's layout (8 text tokens, one
    16 x 16 grid, 120 text tokens: text resumes at 24) and at this
    file's."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    pos = image_positions(LAYOUT)
    assert pos.shape == (3, B, S)
    np.testing.assert_array_equal(pos[:, 0, :3], [[0, 1, 2]] * 3)
    np.testing.assert_array_equal(pos[:, 0, 3:7], [[3, 3, 3, 3],
                                                   [3, 3, 3, 3],
                                                   [3, 4, 5, 6]])
    np.testing.assert_array_equal(pos[:, 0, 15:], [[7, 8, 9, 10, 11]] * 3)
    card = [(8, (16, 16), 120)] * 3
    want = image_positions(card)
    assert want.shape == (3, 3, 384) and want[0, 0, 264] == 24
    got = chip_smoke.image_positions(3, 8, (16, 16), 120, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    n0, grid, n1 = LAYOUT[0]
    got = chip_smoke.image_positions(1, n0, grid, n1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), pos[:, :1])


# ---------------------------------------------------------------------------
# attention with an image span
# ---------------------------------------------------------------------------

def test_attn_full_image_span_matches_reference():
    """One attention layer (float32, unquantized, nonzero biases) on the
    image prompt's 3-row positions against the reference's `attn_full`:
    within F32_TOL.  And what only an image span shows: the patches of
    one image attend to each other both ways (a later patch's input moves
    an earlier patch's output), the text before the image sees none of
    it (bit for bit unchanged), as the temporal-row mask says."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = params_for("float32", "bf16")
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    tl = tblocks.tree_idx(tp["blocks"]["attn"], 0)
    pos = image_positions(LAYOUT)
    x = np.random.default_rng(4).standard_normal((B, S, 64)).astype(
        np.float32)
    want = jax.jit(functools.partial(jattn.attn_full, cfg=jcfg))(
        jl, jnp.asarray(x), positions=jnp.asarray(pos))
    got = tattn.attn_full(tl, torch.from_numpy(x), tcfg,
                          torch.from_numpy(pos).long())
    _close(got, want, F32_TOL)
    n0, (gh, gw), _ = LAYOUT[0]
    last = n0 + gh * gw - 1                       # row 0's last patch
    x2 = x.copy()
    x2[0, last] += 1.0
    got2 = tattn.attn_full(tl, torch.from_numpy(x2), tcfg,
                           torch.from_numpy(pos).long())
    assert torch.equal(got2[0, :n0], got[0, :n0])
    assert (got2[0, n0] - got[0, n0]).abs().max() > 1e-3
    assert torch.equal(got2[1], got[1])
    # the same layer under default (causal by index) positions differs
    plain = tattn.attn_full(tl, torch.from_numpy(x), tcfg)
    assert (plain[0, n0] - got[0, n0]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# prefill on stub embeddings, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_prefill_and_decode_match_reference(fmt, dtype):
    """lm.prefill on an image prompt (stub embeddings and 3-row positions)
    and G teacher-forced decode_steps on tokens against the jitted
    reference's: logits at every step, the KV cache after the prefill
    and at the end (module docstring's tolerances)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    emb = image_prompt(_embed_table(jp), LAYOUT, 11)
    pos = image_positions(LAYOUT)
    forced = np.random.default_rng(12).integers(0, 256, (B, G)).astype(
        np.int32)
    jl, jc = _jit_prefill(jp, jnp.asarray(emb), jcfg, S + G,
                          positions=jnp.asarray(pos))
    tl, tc = tlm.prefill(tp, torch.from_numpy(emb), tcfg, S + G,
                         positions=torch.from_numpy(pos))
    tol = _logit_tol(dtype, fmt, np.asarray(jl))
    ctol = CACHE_TOL[dtype]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 1, 256)
    _close(tl, jl, tol, "prefill")
    assert set(tc) == set(jc) == {"k", "v"}
    for k in ("k", "v"):
        _close(tc[k], jc[k], ctol, f"prefill cache {k}")
    for i in range(G):
        p = np.full((B,), S + i, np.int32)
        jl, jc = _jit_decode(jp, jnp.asarray(forced[:, i:i + 1]), jc,
                             jnp.asarray(p), jcfg)
        tl, tc = tlm.decode_step(tp, torch.from_numpy(forced[:, i:i + 1]),
                                 tc, torch.from_numpy(p).long(), tcfg)
        _close(tl, jl, tol, f"decode step {i}")
    for k in ("k", "v"):
        _close(tc[k], jc[k], ctol, f"end cache {k}")


def test_stub_embeddings_and_default_positions():
    """Port-internal, bit for bit (bf16, w4a8): token ids and their
    gathered embedding rows give the same prefill; explicit equal 3-row
    positions give the default's; image positions move the logits; a
    decode step on a stub embedding equals the step on its token."""
    _, tcfg = _cfgs()
    _, tp = params_for("bfloat16", "w4a8")
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (B, S)))
    emb = tp["embed"][toks].float()
    base, cache = tlm.prefill(tp, toks, tcfg, S + 1)
    for inputs, pos in ((emb, None), (toks, torch.arange(S).expand(3, B, S)),
                        (emb, torch.arange(S).expand(3, B, S))):
        got, c = tlm.prefill(tp, inputs, tcfg, S + 1, positions=pos)
        assert torch.equal(got, base)
        assert all(torch.equal(c[k], cache[k]) for k in cache)
    img, _ = tlm.prefill(tp, emb, tcfg, S + 1,
                         positions=torch.from_numpy(image_positions(LAYOUT)))
    assert (img - base).abs().max() > 1e-3
    pos = torch.full((B,), S)
    nxt = base[:, -1].argmax(-1)[:, None]
    c2 = {k: t.clone() for k, t in cache.items()}
    a, _ = tlm.decode_step(tp, nxt, cache, pos, tcfg)
    b, _ = tlm.decode_step(tp, tp["embed"][nxt].float(), c2, pos, tcfg)
    assert torch.equal(a, b) and torch.equal(cache["k"], c2["k"])


def _reference_logits(jp, jcfg, prompts, toks):
    """The reference's logits at each generate step, teacher-forced on its
    own tokens [B, g]: [B, g, V]."""
    b, g = toks.shape
    s = prompts.shape[1]
    lg, cache = _jit_prefill(jp, jnp.asarray(prompts), jcfg, s + g)
    out = [np.asarray(lg[:, -1])]
    for i in range(g - 1):
        lg, cache = _jit_decode(jp, jnp.asarray(toks[:, i:i + 1]), cache,
                                jnp.full((b,), s + i, jnp.int32), jcfg)
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("dtype,fmt", [("bfloat16", "w8a8"),
                                       ("float32", "w4a8")])
def test_generate_matches_reference(dtype, fmt):
    """Greedy generate from tokens (fused=True: the per-step loop on the
    CPU) against the reference's served `generate` (its positions the
    3-row arange), by ROADMAP C2's rule (tests/test_torch_serve.py), 3
    rows of 6 tokens; 7 GEMM dispatches per layer and the head's per
    token."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = params_for(dtype, fmt)
    g, s = 6, 10
    prompts = np.random.default_rng(15).integers(0, 256, (3, s)).astype(
        np.int32)
    want = np.asarray(jserve.generate(jp, jnp.asarray(prompts), jcfg, gen=g,
                                      cache_len=s + g))
    ref_logits = _reference_logits(jp, jcfg, prompts, want)
    np.testing.assert_array_equal(ref_logits.argmax(-1), want)
    registry.reset_dispatch_counts()
    got, logits = tserve.generate(tp, prompts, tcfg, gen=g, cache_len=s + g,
                                  device="cpu", return_logits=True)
    assert sum(registry.dispatch_counts().values()) == (7 * 2 + 1) * g
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, g)
    assert_tokens_match(got.numpy(), logits.numpy(), want, ref_logits,
                        _logit_tol(dtype, fmt, ref_logits))


# ---------------------------------------------------------------------------
# serving: the captured step, --silvia, build_params, the card's check
# ---------------------------------------------------------------------------

def test_captured_step_after_an_image_prefill():
    """The image traffic of chip_smoke.py phase 12 on the CPU: the
    captured step (run eagerly: no graph here) from an image prompt's
    prefill gives the per-step loop's tokens, logits and cache, bit for
    bit, over its static KV buffers (updated in place)."""
    _, tcfg = _cfgs()
    _, tp = params_for("bfloat16", "w8a8")
    emb = torch.from_numpy(image_prompt(_embed_table(params_for(
        "bfloat16", "w8a8")[0]), LAYOUT, 16))
    pos = torch.from_numpy(image_positions(LAYOUT))
    logits, cache = tlm.prefill(tp, emb, tcfg, S + G, positions=pos)
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    step = tserve._decode_bundle(tcfg, "off", "cpu").captured(
        tp, B, S + G, True, G - 1, torch.device("cpu"))
    ptrs = {k: t.data_ptr() for k, t in step.cache.items()}
    toks, seen = step.run(tok, cache, S, G - 1)
    assert {k: t.data_ptr() for k, t in step.cache.items()} == ptrs
    t, want, want_logits = tok, [], []
    for i in range(G - 1):
        lg, cache = tlm.decode_step(tp, t, cache, torch.full((B,), S + i),
                                    tcfg)
        t = lg[:, -1].argmax(dim=-1)[:, None]
        want.append(t)
        want_logits.append(lg[:, -1])
    assert torch.equal(toks, torch.cat(want, 1).to(torch.int32))
    assert torch.equal(seen, torch.stack(want_logits, 1))
    for k in cache:
        assert torch.equal(step.cache[k], cache[k]), k


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_generate_silvia_equals_off(fmt):
    """--silvia all changes no token and no logit on the vlm path."""
    _, tcfg = _cfgs()
    _, tp = params_for("bfloat16", fmt)
    prompts = np.random.default_rng(17).integers(0, 256, (B, 6))

    def gen(passes):
        return tserve.generate(tp, prompts, tcfg, gen=3, cache_len=9,
                               device="cpu", return_logits=True,
                               silvia_passes=passes)

    base, packed = gen("off"), gen("all")
    assert torch.equal(base[0], packed[0])
    assert torch.equal(base[1], packed[1])


@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_build_params_equals_whole_tree_quantization(fmt):
    """build_params gives bit for bit the tree of
    quantize_tree_for_serving(lm.init_params(...)) for reduced qwen2-vl,
    forced and not; and full-width qwen2-vl-72b's unforced formats: the
    seven projection and MLP weights and the [8192, 152064] head in the
    format, the embedding and the biases float."""
    _, cfg = _cfgs()
    for force in (True, False):
        got = tserve.build_params(cfg, fmt, seed=5, quant_force=force,
                                  device="cpu")
        want = tqt.quantize_tree_for_serving(
            tlm.init_params(cfg, 5, device="cpu"), fmt, force=force)
        g, gs = pytree.tree_flatten_with_path(got)
        w, ws = pytree.tree_flatten_with_path(want)
        assert gs == ws
        for (path, a), (_, b) in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b), \
                pytree.keystr(path)
        assert got["blocks"]["attn"]["bq"].dtype == torch.bfloat16
    full = tconfigs.get_config(ARCH)
    specs = tlm.param_specs(full, "meta")
    fmts = {pytree.keystr(p): tqt.serving_format(
        "/".join(k.key for k in p), s.shape, fmt)
        for p, s in pytree.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, tlm.Draw))
        if isinstance(s, tlm.Draw)}
    assert fmts.pop("['embed']") is None
    assert set(fmts.values()) == {fmt} and len(fmts) == 8
    assert specs["lm_head"].shape == (8192, 152064)
    assert tuple(specs["blocks"]["attn"]["bk"].shape) == (80, 1024)


def test_card_check_teacher_forces_each_gemm():
    """chip_smoke.py's card-against-CPU check (`teacher_forced_vs_cpu`) on
    an image prompt (stub embeddings and 3-row positions), both sides on
    the CPU, on the float32 w4a8 tree: the same tree twice agrees
    exactly; the prefill's 14 GEMMs and each decode step's 14, and the
    head each time, are compared, with the logits and the 2 cache
    tensors; a key bias moved by 0.5 fails (at the attention output's
    GEMM input), as does one int4 weight moved (at that GEMM's
    output)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    _, tcfg = _cfgs(dtype="float32")
    tp = tserve.build_params(tcfg, "w4a8", seed=0, quant_force=True,
                             device="cpu")
    emb = torch.from_numpy(image_prompt(tp["embed"].numpy(), LAYOUT, 18))
    pos = torch.from_numpy(image_positions(LAYOUT))
    check = functools.partial(chip_smoke.teacher_forced_vs_cpu,
                              cpu_params=tp, prompts=emb, cfg=tcfg, steps=2)
    st = check(tp, positions=pos)
    assert (st["gemms"], st["moes"], st["worst"]) == (3 * (14 + 1), 0, 0.0)
    assert st["tensors"] == 3 * (14 + 1) + 3 * (1 + 2)
    attn = tp["blocks"]["attn"]
    bk = attn["bk"].clone()
    bk[0, 0] += 0.5
    with pytest.raises(AssertionError, match="GEMM .*'s input"):
        check({**tp, "blocks": {**tp["blocks"],
                                "attn": {**attn, "bk": bk}}},
              positions=pos)
    wo = tp["blocks"]["mlp"]["wo"]
    q = wo.q.clone()
    q[1, 0, 0] ^= 1                      # one int4 weight moved by one
    mlp = {**tp["blocks"]["mlp"], "wo": tqt.QTensor(q, wo.scale, wo.fmt)}
    with pytest.raises(AssertionError, match="not the host's, bit for bit"):
        check({**tp, "blocks": {**tp["blocks"], "mlp": mlp}},
              positions=pos)
