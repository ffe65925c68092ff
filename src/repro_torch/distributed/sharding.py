"""Sharding rules: param / batch / cache specs for every family (port of
`repro/distributed/sharding.py`).

A spec is a `PSpec`: one entry per tensor dimension -- a mesh axis name,
a tuple of axis names (the dimension laid out over them, the first
major), or None (replicated) -- with trailing Nones dropped.  It is a
tuple, so it compares equal to the reference's `PartitionSpec` with the
same entries (`tuple(P("data", None)) == ("data", None)`), and a leaf of
`torch.utils._pytree` (a plain tuple would be a node).

The rules are the reference's, by leaf-path suffix and rank, so the same
table serves plain tensors and QTensor leaves (.../wq/q, .../wq/scale)
and any leading stack axes (layers, super-blocks, experts):

* FSDP over the dp axes ("pod", "data"): every large weight's input
  dimension is sharded;
* TP over "model": attention heads, FFN hidden, vocab; row-parallel
  outputs (wo, out_proj, an MLP's down) contract over the sharded
  dimension;
* EP over "model": the MoE expert dimension.

`shard_tree` takes each rank's block of every weight under these rules
(the reference's `to_shardings` placement) and `gather_sharded` gathers
the blocks back whole: every all-gather is an exact concatenation, so
the gathered weights are bitwise the originals and no float contraction
is ever partitioned.  The serve engine keeps each rank's weights whole
instead (launch/engine.py `_place_params`): its captured graphs read
static buffers, where the reference gathers the shards at every
dispatch.
"""
from __future__ import annotations

from typing import Any

from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import dp_axes, fsdp_axes


class PSpec(tuple):
    """A partition spec: a tuple of per-dimension entries (module
    docstring).  `PSpec("data", None)`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


P = PSpec

# suffix -> (spec for the last two dims of the weight)
# "col": [K, N] -> (FSDP, model)   (column / head / ffn-up parallel)
# "row": [K, N] -> (model, FSDP)   (row parallel: contract dim sharded)
_COL = {"wq", "wk", "wv", "wi", "wg", "in_proj", "lm_head", "router"}
_ROW = {"wo", "out_proj"}
_EXPERT_STACKED = {"wi", "wg", "wo"}   # under a "moe" parent: [E, K, N]


def _keys(path) -> list:
    keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
    return [k for k in keys if isinstance(k, str)]


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def sanitize_spec(spec, shape, mesh) -> PSpec:
    """Drop sharding on dimensions the mesh axes don't divide (e.g. odd
    vocab sizes, head counts smaller than the model axis)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim_size, axis in zip(shape, dims):
        if axis is not None and dim_size % _axis_size(mesh, axis) != 0:
            axis = None
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return PSpec(*out)


def _is_spec(x) -> bool:
    return isinstance(x, PSpec)


def param_pspecs(params, mesh, cfg=None, mode: str = "2d"):
    """Tree of PSpecs matching `params` (tensors or QTensors).

    mode="2d" (default): FSDP over (pod, data) + TP / EP over model.
    mode="pure_dp": no tensor parallelism -- weights sharded over ALL
    mesh axes on their input dim (models whose head counts do not divide
    the model axis)."""
    if mode == "pure_dp":
        all_axes = tuple(mesh.axis_names)
        fs = all_axes if len(all_axes) > 1 else all_axes[0]
        tp = None
    else:
        fsdp = fsdp_axes(mesh)
        fs = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
        tp = "model"

    def spec_for(path, leaf) -> PSpec:
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return P()
        keys = _keys(path)
        name = next((k for k in reversed(keys)
                     if k not in ("q", "scale")), "")
        in_moe = "moe" in keys
        lead = leaf.ndim - 2
        if name == "embed":
            return P(tp, fs)
        if name == "pos_embed" or name == "enc_pos":
            return P(None, None)
        if leaf.ndim == 1:
            return P(None)
        if name == "conv_w":
            return P(*([None] * lead), None, tp)
        if in_moe and name in _EXPERT_STACKED:
            # [..., E, K, N]: experts over model (EP), K or N over FSDP
            lead_e = leaf.ndim - 3
            if name == "wo":
                return P(*([None] * lead_e), tp, None, fs)
            return P(*([None] * lead_e), tp, fs, None)
        if name == "scale" or keys and keys[-1] == "scale":
            # QTensor scale [..., 1, N]: follow the weight's N sharding
            base = next((k for k in reversed(keys) if k not in ("scale",)),
                        "")
            if base in _ROW:
                return P(*([None] * lead), None, fs if tp is None else None)
            return P(*([None] * lead), None, tp)
        if name in _ROW:
            return P(*([None] * lead), tp, fs)
        if name in _COL:
            if name == "router":
                return P(*([None] * lead), fs, None)
            return P(*([None] * lead), fs, tp)
        # unknown leaves (stacked norms, biases, A_log, ...): replicate
        return P(*([None] * leaf.ndim))

    def wrapped(path, leaf):
        s = spec_for(path, leaf)
        if hasattr(leaf, "shape"):
            return sanitize_spec(s, leaf.shape, mesh)
        return s

    return pytree.tree_map_with_path(wrapped, params)


def batch_pspec(mesh, kind: str = "train", mode: str = "2d") -> Any:
    """Spec factory for input batches (batch dim over the dp axes)."""
    dp = tuple(mesh.axis_names) if mode == "pure_dp" else dp_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)

    def spec_for(leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return P()
        return P(dp, *([None] * (leaf.ndim - 1)))

    return spec_for


def cache_pspecs(cache, mesh, cfg, *, seq_shard: bool = False,
                 mode: str = "2d", seq_axis=None):
    """Specs for decode caches: leaves [L(stack), B, S, ...] for
    attention KV, [L, B, H, P, N] for SSD state.  seq_shard=True (batch
    1, long context) puts the sequence dim on the dp axes instead of the
    batch dim; seq_axis (e.g. "model") ALSO shards the KV sequence dim
    over that axis.  The port's caches are flat dicts (models/lm.py
    `init_cache`): the encdec family's cross_k / cross_v take the rule of
    the reference's nested cross/k, cross/v."""
    dp = tuple(mesh.axis_names) if mode == "pure_dp" else dp_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)

    def spec_for(path, leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim <= 1:
            return P()
        keys = [k[len("cross_"):] if k.startswith("cross_") else k
                for k in _keys(path)]
        if keys and keys[-1] in ("k_s", "v_s") and leaf.ndim >= 3:
            # [L, B, S, KV] per-position scales: follow the kv sharding
            if seq_shard:
                return P(None, None, dp, None)
            return P(None, dp, seq_axis, None)
        is_kv = any(k in ("k", "v") for k in keys[-1:])
        if is_kv and leaf.ndim >= 4:
            # [L, B, S, KV, D]
            if seq_shard:
                return P(None, None, dp, *([None] * (leaf.ndim - 3)))
            return P(None, dp, seq_axis, *([None] * (leaf.ndim - 3)))
        if keys and keys[-1] == "ssm" and leaf.ndim >= 4:
            # [L(, M), B, H, P, N]: heads over model
            lead = leaf.ndim - 4
            if seq_shard:
                return P(*([None] * lead), None, "model", None, None)
            return P(*([None] * lead), dp, "model", None, None)
        if keys and keys[-1] == "conv":
            lead = leaf.ndim - 3
            if seq_shard:
                return P(*([None] * lead), None, None, "model")
            return P(*([None] * lead), dp, None, "model")
        return P(*([None] * leaf.ndim))

    def wrapped(path, leaf):
        s = spec_for(path, leaf)
        if hasattr(leaf, "shape"):
            return sanitize_spec(s, leaf.shape, mesh)
        return s

    return pytree.tree_map_with_path(wrapped, cache)


# ---------------------------------------------------------------------------
# placement: each rank's block, and back
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_tensor(t, spec, mesh):
    """This rank's block of `t` under `spec` (the reference's
    `device_put(t, NamedSharding(mesh, spec))`, seen from one device): a
    contiguous copy.  A dimension over a tuple of axes is laid out
    major-first."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for a in _entry_axes(entry):
            idx = idx * mesh.shape[a] + mesh.coords[a]
            n *= mesh.shape[a]
        width = t.shape[dim] // n
        t = t.narrow(dim, idx * width, width)
    return t.contiguous()


def shard_tree(tree, specs, mesh):
    """`shard_tensor` over a tree and its specs (the reference's
    `to_shardings` + `device_put`)."""
    flat_t, treedef = pytree.tree_flatten(tree)
    flat_s = pytree.tree_leaves(specs, is_leaf=_is_spec)
    return pytree.tree_unflatten(
        [shard_tensor(t, s, mesh) for t, s in zip(flat_t, flat_s)], treedef)


def gather_sharded(tree, specs, mesh):
    """All-gather every sharded dim of `tree` back to the whole value.

    The explicit FSDP / ZeRO-3 gather of the serve path: pure data
    movement, so each gathered leaf is bitwise the original -- what keeps
    the sharded engine exact where a partitioned contraction (partial
    products + a float all-reduce) would not be.  A dim sharded over a
    tuple of axes is laid out major-first, so the minor axis is gathered
    first, then the major one."""
    flat_t, treedef = pytree.tree_flatten(tree)
    flat_s = pytree.tree_leaves(specs, is_leaf=_is_spec)
    if len(flat_t) != len(flat_s):
        raise ValueError(
            f"gather_sharded: {len(flat_t)} leaves vs {len(flat_s)} specs")

    def gather(leaf, spec):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for ax in reversed(_entry_axes(entry)):
                leaf = mesh.all_gather(leaf, ax, dim)
        return leaf

    return pytree.tree_unflatten(
        [gather(t, s) for t, s in zip(flat_t, flat_s)], treedef)


# ---------------------------------------------------------------------------
# serve-engine slot state
# ---------------------------------------------------------------------------

def dp_spec_entry(dp_axes):
    """The spec entry for a dim sharded over the dp axes."""
    dp = tuple(dp_axes)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def slot_state_pspecs(treedef, slot_axes, tp_axes, dp_axes,
                      model_axis=None):
    """Specs for the engine's slot-state tree, from the probed per-leaf
    axis descriptors alone (tree_flatten order): slot axis over the dp
    axes, tp axis (models/slot_state.py `tp_axes_for`) over
    `model_axis`; entries of None leave the leaf replicated over model.
    Divisibility is the engine's invariant (scheduler.validate_slot_
    sharding and the tp_plan head checks), so no shape sanitizing here.
    The port's engine deals the slot axis over the dp shards cyclically
    (launch/engine.py); the spec says which axes shard, not how."""
    dp = dp_spec_entry(dp_axes)
    specs = []
    for ba, ta in zip(slot_axes, tp_axes):
        n = 1 + max(ba, ta if ta is not None else 0)
        dims = [None] * n
        dims[ba] = dp
        if ta is not None and model_axis is not None:
            dims[ta] = model_axis
        specs.append(P(*dims))
    return pytree.tree_unflatten(specs, treedef)
