"""QTensor: quantized weight leaves + the matmul they dispatch to.

Port of `repro/quant/qtensor.py`.  `qmatmul(x, w)` accepts a plain
tensor (bf16 path) or a QTensor (serving path): a [K, N] weight, or the
MoE family's expert-stacked [E, K, N], all E experts in one GEMM launch.

A QTensor is a pytree node, as the reference's is: `q` and `scale` are
its children, `fmt` its context.  So `torch.utils._pytree` flattens a
params tree down to tensors, and a function traced over it
(`core.optimize`) takes the weights as graph inputs, not as constants.

Formats:
  w8a8  q: int8 [..., K, N],    scale: f32 [..., 1, N]
  w4a8  q: int8 [..., K, N//2] (two int4/word), scale: f32 [..., 1, N]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import registry
from repro_torch.quant.quantize import pack_int4, quantize_compiled


@dataclasses.dataclass
class QTensor:
    q: Any
    scale: Any
    fmt: str

    @property
    def logical_shape(self):
        s = tuple(self.q.shape)
        if self.fmt == "w4a8":
            return s[:-1] + (2 * s[-1],)
        return s

    def __getitem__(self, i):
        """Slice the leading (stacked-layer) axis of q and scale."""
        return QTensor(self.q[i], self.scale[i], self.fmt)


pytree.register_pytree_node(
    QTensor,
    lambda t: ([t.q, t.scale], t.fmt),
    lambda children, fmt: QTensor(*children, fmt),
    serialized_type_name="repro_torch.quant.qtensor.QTensor",
    flatten_with_keys_fn=lambda t: ([(pytree.GetAttrKey("q"), t.q),
                                     (pytree.GetAttrKey("scale"), t.scale)],
                                    t.fmt))


def quantize_weight(w, fmt: str) -> QTensor:
    """w: [..., K, N] float -> QTensor (per-output-channel scales; leading
    axes, e.g. stacked layers or experts, keep independent scales)."""
    bits = 4 if fmt == "w4a8" else 8
    qmax = 2 ** (bits - 1) - 1
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-2, keepdim=True)                # [..., 1, N]
    scale = (amax / qmax + 1e-8).to(torch.float32)
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax).to(torch.int8)
    if fmt == "w4a8":
        q = pack_int4(q)
    return QTensor(q, scale, fmt)


def _q2d(x2, w: QTensor):
    """x2 [M, K] against a 2-D QTensor -> f32 [M, N].  Each row of x2 is
    quantized in the form the reference serves activations in
    (`quantize_compiled`: its layers run compiled, inside `lax.scan`)."""
    x_q, x_s = quantize_compiled(x2)
    op = "quant_matmul" if w.fmt == "w8a8" else "packed_w4_matmul"
    return registry.dispatch(op, x_q, w.q, x_s, w.scale)


def _q_experts(xe, w: QTensor):
    """xe [E, M, K] against QTensor [E, K, N] -> f32 [E, M, N]: each
    expert's rows quantized per row, as the reference's vmap(_q2d) does,
    and one dispatch for all experts.  An xe whose expert axis has
    stride 0 (one x broadcast to every expert: the per-token MoE path's
    wi / wg) is quantized once and passed expanded, which gives every
    expert the same int8 rows and scales bit for bit; the kernel reads
    it once for all experts."""
    e, m, k = xe.shape
    if xe.stride(0) == 0:
        x_q, x_s = quantize_compiled(xe.select(0, 0))
        x_q, x_s = x_q.expand(e, m, k), x_s.expand(e, m, 1)
    else:
        x_q, x_s = quantize_compiled(xe.reshape(e * m, k))
        x_q, x_s = x_q.reshape(e, m, k), x_s.reshape(e, m, 1)
    op = "quant_matmul" if w.fmt == "w8a8" else "packed_w4_matmul"
    return registry.dispatch(op, x_q, w.q, x_s, w.scale)


def qmatmul(x, w):
    """x: [..., K]; w: tensor [K, N] | QTensor [K, N] | QTensor [E, K, N]
    (batched expert weights, x then [E, ..., K])."""
    if not isinstance(w, QTensor):
        return x @ w
    if w.q.ndim == 2:
        lead = x.shape[:-1]
        y = _q2d(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*lead, y.shape[-1]).to(x.dtype)
    e = w.q.shape[0]
    if w.q.ndim != 3 or x.ndim < 3 or x.shape[0] != e:
        raise ValueError(f"qmatmul: x {tuple(x.shape)} against a "
                         f"{tuple(w.logical_shape)} QTensor (expert-stacked "
                         "weights take x [E, ..., K])")
    lead = x.shape[1:-1]
    ye = _q_experts(x.reshape(e, -1, x.shape[-1]), w)
    return ye.reshape(e, *lead, ye.shape[-1]).to(x.dtype)


SKIP_KEYS = ("router", "embed", "pos", "conv", "ln", "norm", "A_log",
             "dt_bias", "D")


def serving_format(keys: str, shape, fmt: str, *, min_size: int = 1 << 16,
                   skip_keys=SKIP_KEYS, force: bool = False):
    """The format `quantize_tree_for_serving` gives a float leaf of this
    WHOLE shape at key path `keys` ("blocks/attn/wq"), or None where the
    leaf stays float.  Leaves whose key path contains any of `skip_keys`,
    1-D leaves and small leaves stay in bf16/f32.  force=True drops the
    SIZE floors (`min_size` and the min(shape[-2:]) >= 64 width check)
    but keeps the structural rules: every weight of the reduced test
    configs sits under the floors, so quantized smoke runs pass
    force=True and check the dispatch census.  A w4a8 leaf with an odd
    column count falls back to w8a8 (two int4 columns share a word)."""
    shape = tuple(shape)
    if fmt == "bf16" or len(shape) < 2 or \
            any(k in keys for k in skip_keys):
        return None
    if not force and (math.prod(shape) < min_size
                      or min(shape[-2:]) < 64):
        return None   # stacked vectors / tiny weights
    if len(shape) == 2 and "lm_head" not in keys:
        # 2-D leaves inside the stacked block tree are per-layer vectors
        # (norms etc.) -- only the unstacked lm_head matmul weight is a
        # real 2-D GEMM operand
        return None
    if shape[-1] % 2 and fmt == "w4a8":
        return "w8a8"
    return fmt


def quantize_tree_for_serving(params, fmt: str, min_size: int = 1 << 16,
                              skip_keys=SKIP_KEYS, force: bool = False):
    """Replace every large >=2D float weight leaf with a QTensor, in the
    format `serving_format` decides from the leaf's path and shape.

    Walks the nested-dict params by path; other leaves (QTensors, integer
    tensors) pass through unchanged."""
    if fmt == "bf16":
        return params

    def visit(path, leaf):
        is_float = isinstance(leaf, torch.Tensor) and leaf.dtype in (
            torch.float32, torch.bfloat16, torch.float16)
        leaf_fmt = serving_format("/".join(path), leaf.shape, fmt,
                                  min_size=min_size, skip_keys=skip_keys,
                                  force=force) if is_float else None
        return leaf if leaf_fmt is None else quantize_weight(leaf, leaf_fmt)

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (str(k),), v) for k, v in node.items()}
        return visit(path, node)

    return walk((), params)
