"""Import params from the JAX reference package.

`from_jax_params(tree)` turns the reference's param pytree, already
flattened to numpy by the caller, into the port's params.  The caller
(the parity tests) does the JAX side with `jax.tree_util`, so the port
itself never imports JAX:

  * nested dicts stay nested dicts;
  * a bfloat16 array travels as its uint16 view (numpy has no bfloat16)
    and comes back as a torch.bfloat16 tensor with the same bits;
  * a QTensor leaf travels as a tuple (q, scale, fmt) and comes back as
    the port's QTensor.

No model here has a uint16 parameter, so every uint16 array is a bf16
carrier.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.quant.qtensor import QTensor


def _tensor(a, dev):
    a = np.array(a, copy=True, order="C")   # own, writable memory
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def from_jax_params(tree, *, device="cuda"):
    dev = device_lib.resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and len(node) == 3 \
                and isinstance(node[2], str):
            q, scale, fmt = node
            return QTensor(_tensor(q, dev), _tensor(scale, dev), fmt)
        return _tensor(node, dev)

    return walk(tree)
