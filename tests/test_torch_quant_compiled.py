"""The port's activation quantization in the form the reference serves
(ROADMAP C7): `repro_torch.quant.quantize.quantize_compiled` against
`repro.quant.quantize.quantize` compiled by XLA, and the GEMM sites that
use it (`qtensor._q2d`, `qtensor._q_experts`) against the reference's
`_q2d` / `vmap(_q2d)` under `jax.jit`.

The reference quantizes weights eagerly (outside jit) and activations
compiled: its layers run inside `lax.scan` in prefill and decode, where
XLA rewrites the per-row scale `amax / 127 + 1e-8` (float32:
`fma(amax, float32(1/127), 1e-8)`; bf16: the divide rounded to bf16,
the add in float32).  So the compiled form is held against both places
it is served from, `jax.jit` and a `lax.scan` body, bit for bit, and
the eager `quantize` stays held against the eager reference
(tests/test_torch_kernels.py::test_quantize_bit_exact).

Inputs: random rows scaled by 0.1-8, an all-zero row (the scale is eps
alone) and a row scaled by 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import packed_matmul as jpmm  # noqa: E402
from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro.quant import qtensor as jqt  # noqa: E402
from repro.quant.quantize import quantize as jquantize  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.quant import qtensor as tqt  # noqa: E402
from repro_torch.quant import quantize as tquant  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed, m, k):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k))
         * (0.1 + 7.9 * rng.random((m, 1)))).astype(np.float32)
    a[0] = 0.0                     # an all-zero row: scale is eps alone
    a[1] *= 1e-3
    return a


def _as(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _jit_quantize(x):
    return jax.jit(lambda t: jquantize(t, bits=8, axis=0))(x)


def _scan_quantize(x):
    """quantize inside an unjitted lax.scan, as lm.prefill runs it."""
    _, out = jax.lax.scan(lambda c, t: (c, jquantize(t, bits=8, axis=0)),
                          0, x[None])
    return out[0][0], out[1][0]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("served", ["jit", "scan"])
def test_quantize_compiled_bit_exact(served, dtype):
    """int8 values and float32 scales, bit for bit, against the reference
    compiled both ways it is served; the zero row's scale is eps alone
    (float32(1e-8), or bf16(1e-8) in float32 for bf16 input)."""
    j, t = _as(_rows(1, 1024, 576), dtype)
    jq, js = (_jit_quantize if served == "jit" else _scan_quantize)(j)
    tq, ts = tquant.quantize_compiled(t)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (1024, 1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    eps = np.float32(1e-8) if dtype == "f32" else np.float32(
        np.asarray(jnp.asarray(1e-8, jnp.bfloat16), np.float32))
    assert ts[0, 0].item() == eps and not bool(tq[0].any())


def test_compiled_form_differs_from_eager():
    """The two forms are different functions (why C7 needed both): on bf16
    rows most scales differ, by one bf16 rounding of the add; weights,
    quantized eagerly by the reference, keep the eager `quantize`."""
    j, t = _as(_rows(2, 512, 576), "bf16")
    _, eager = tquant.quantize(t, bits=8, axis=0)
    _, compiled = tquant.quantize_compiled(t)
    _, jeager = jquantize(j, bits=8, axis=0)
    np.testing.assert_array_equal(eager.numpy(), np.asarray(jeager))
    assert (eager != compiled).sum().item() > 256


def _weight(seed, k, n, fmt, e=None):
    rng = np.random.default_rng(seed)
    shape = (k, n) if e is None else (e, k, n)
    w = (rng.standard_normal(shape) / np.sqrt(k)).astype(np.float32)
    return (jqt.quantize_weight(jnp.asarray(w), fmt),
            tqt.quantize_weight(torch.from_numpy(w), fmt))


def _jacc(packed):
    """The reference's int32 accumulator: its Pallas kernel, interpreted."""
    if packed:
        return lambda x, w: jpmm.packed_w4_matmul_acc(
            x, w, block=(8, 256, 128), interpret=True)
    return lambda x, w: jqmm.quant_matmul_acc(x, w, block=(8, 128, 128),
                                              interpret=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_q2d_bit_exact(fmt, dtype):
    """qtensor._q2d against jax.jit of the reference's: the int8 rows and
    their scales, the int32 accumulators (the reference's Pallas kernel,
    interpreted) and the f32 output."""
    j, t = _as(_rows(3, 24, 96), dtype)
    jw, tw = _weight(4, 96, 40, fmt)
    want = jax.jit(jqt._q2d)(j, jw)
    got = tqt._q2d(t, tw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jq, _ = _jit_quantize(j)
    tq, _ = tquant.quantize_compiled(t)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    acc_t = (tref.quant_matmul_acc_ref if fmt == "w8a8"
             else tref.packed_w4_matmul_acc_ref)(tq, tw.q)
    np.testing.assert_array_equal(
        acc_t.numpy(), np.asarray(_jacc(fmt == "w4a8")(jq, jw.q)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_q_experts_bit_exact(fmt, shared, dtype):
    """qtensor._q_experts (one dispatch for E experts) against jax.jit of
    the reference's vmap(_q2d): the int8 rows, the int32 accumulators and
    the f32 output; shared: one x broadcast to every expert (expert
    stride 0, quantized once)."""
    e, m, k, n = 3, 10, 64, 24
    a = _rows(5, m if shared else e * m, k)
    j, t = _as(a, dtype)
    if shared:
        j = jnp.broadcast_to(j[None], (e, m, k))
        t = t[None].expand(e, m, k)
    else:
        j, t = j.reshape(e, m, k), t.reshape(e, m, k)
    jw, tw = _weight(6, k, n, fmt, e)
    want = jax.jit(jax.vmap(jqt._q2d))(j, jw)
    registry.reset_dispatch_counts()
    got = tqt._q_experts(t, tw)
    assert sum(registry.dispatch_counts().values()) == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jq, _ = jax.jit(jax.vmap(lambda x: jquantize(x, bits=8, axis=0)))(j)
    tq, _ = tquant.quantize_compiled(t.reshape(e * m, k))
    tq = tq.reshape(e, m, k)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    acc_t = (tref.quant_matmul_acc_ref if fmt == "w8a8"
             else tref.packed_w4_matmul_acc_ref)(tq, tw.q)
    np.testing.assert_array_equal(
        acc_t.numpy(), np.asarray(jax.vmap(_jacc(fmt == "w4a8"))(jq, jw.q)))
