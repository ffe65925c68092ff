"""The port's quantized linear layers (src/repro_torch/quant/linear.py)
and `quantize_int4` / `dequantize` against `repro.quant`.

The quantized formats are integer GEMMs with the reference's
dequantization order, so they match bit for bit (the reference pinned to
its plain lowering, the port's CPU wrappers running theirs).  The bf16
format sums bf16 products in float32 on both sides, in different
orders: each product of two bf16 values is exact in float32, so the two
sums differ by at most K rounding steps of the largest partial sum,
K * 2^-24 * sum_k |x_k w_k| (`_bf16_bound`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402
from repro_torch import quant as tquant  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

K, N = 64, 48


def _inputs(seed, x_dtype="float32"):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, (K, N)).astype(np.float32)
    x = rng.normal(0, 1, (3, 5, K)).astype(np.float32)
    bias = rng.normal(0, 1, (N,)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(x_dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, x_dtype))
    return w, bias, jx, tx


def _bf16_bound(x, w):
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32),
                    np.float64).reshape(-1, K)
    wb = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32),
                    np.float64)
    return xb, wb, K * 2.0 ** -24 * (np.abs(xb) @ np.abs(wb))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("fmt", ["w8a8", "w4a8"])
def test_quant_linear_matches_reference_bit_for_bit(fmt, with_bias, x_dtype):
    """Params (q, scales) and outputs equal the reference's with its plain
    lowering, bit for bit; one GEMM dispatch per call."""
    w, bias, jx, tx = _inputs(0, x_dtype)
    jp = jquant.quantize_linear_params(jnp.asarray(w), fmt,
                                       jnp.asarray(bias) if with_bias
                                       else None)
    tp = tquant.quantize_linear_params(torch.from_numpy(w), fmt,
                                       torch.from_numpy(bias) if with_bias
                                       else None)
    assert tp.fmt == fmt and tp.w.dtype == torch.int8
    assert tuple(tp.w.shape) == ((K, N // 2) if fmt == "w4a8" else (K, N))
    np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
    np.testing.assert_array_equal(tp.w_scale.numpy(), np.asarray(jp.w_scale))
    with jregistry.force("ref"):
        want = np.asarray(jquant.quant_linear(jx, jp))
    registry.reset_dispatch_counts()
    got = tquant.quant_linear(tx, tp)
    op = "quant_matmul" if fmt == "w8a8" else "packed_w4_matmul"
    assert registry.dispatch_counts()[op] == 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 5, N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_bias", [False, True])
def test_quant_linear_bf16_matches_reference(with_bias):
    """bf16 operands, float32 accumulation (the reference's
    preferred_element_type=float32): within `_bf16_bound` of the exact sum
    of the bf16-rounded operands, as the reference is; a bf16 @ bf16
    product, rounded to bf16, would not be."""
    w, bias, jx, tx = _inputs(1)
    b = bias if with_bias else None
    jp = jquant.quantize_linear_params(
        jnp.asarray(w), "bf16", None if b is None else jnp.asarray(b))
    tp = tquant.quantize_linear_params(
        torch.from_numpy(w), "bf16", None if b is None else
        torch.from_numpy(b))
    assert tp.w.dtype == torch.bfloat16 and tp.w_scale is None
    want = np.asarray(jquant.quant_linear(jx, jp)).reshape(-1, N)
    got = tquant.quant_linear(tx, tp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 5, N)
    got = got.numpy().reshape(-1, N)
    xb, wb, bound = _bf16_bound(np.asarray(jx), w)
    exact = xb @ wb + (0.0 if b is None else b)
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(want - exact) <= bound).all()
    assert (np.abs(got - want) <= 2 * bound).all()
    rounded = (tx.reshape(-1, K).to(torch.bfloat16)
               @ torch.from_numpy(w).to(torch.bfloat16)).float().numpy()
    assert (np.abs(rounded + (0.0 if b is None else b) - exact)
            > bound).any()


@pytest.mark.parametrize("fmt,tol", [("bf16", 0.02), ("w8a8", 0.05),
                                     ("w4a8", 0.35)])
def test_quant_linear_accuracy(fmt, tol):
    """Port of tests/test_quant.py::test_quant_linear_accuracy: the error
    against the float32 product, relative to its largest value."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(0, 0.1, (64, 48)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (3, 5, 64)).astype(np.float32))
    y = tquant.quant_linear(x, tquant.quantize_linear_params(w, fmt))
    want = x @ w
    rel = ((y.float() - want).abs().max() / want.abs().max()).item()
    assert rel < tol


def test_quant_linear_unknown_format():
    with pytest.raises(ValueError):
        tquant.quantize_linear_params(torch.zeros((4, 4)), "w2a8")


def test_quantize_int4_and_dequantize_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (16, 32)).astype(np.float32)
    for axis in (None, 0, 1):
        jq, js = jquant.quantize_int4(jnp.asarray(x), axis=axis)
        tq, ts = tquant.quantize_int4(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert int(tq.min()) >= -8 and int(tq.max()) <= 7
        d = tquant.dequantize(tq, ts)
        assert d.dtype == torch.float32
        np.testing.assert_array_equal(d.numpy(),
                                      np.asarray(jquant.dequantize(jq, js)))
    packed = tquant.pack_int4(tq)
    assert torch.equal(tquant.unpack_int4(packed), tq)
