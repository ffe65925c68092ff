"""Checkpointing (port of `repro/checkpoint/ckpt.py`), in the reference's
on-disk layout, so that a checkpoint written by either package reads back
in the other:

    <dir>/step_000000123/
        index.json            tree structure + leaf manifest + metadata
        shard_h000.npz        this host's leaf arrays (leaf_%05d -> array)
        _COMMITTED            written LAST; restore ignores dirs without it

* **Atomicity**: writes go to `step_X.tmp/` and are renamed into place
  after the commit marker, so a preempted save is never half-restored.
* **Keep-last-k** garbage collection (`keep=3`).
* **Leaf order**: the tree is flattened with `torch.utils._pytree`, every
  dict's keys in sorted order -- the order `jax.tree_util` flattens a
  dict in (torch's pytree keeps insertion order), so `leaf_%05d` numbers
  the same leaf in both packages.  A leaf is a tensor, an array or a
  scalar; a None (the optimizer's moment at a non-float leaf) is no
  leaf, as JAX flattens it to nothing: it takes no number and comes
  back as None.
* **Dtypes numpy lacks** (bfloat16, float8): the raw bits are stored as
  the unsigned integer of their width under ``<key>__<dtype name>``, the
  reference's encoding for ml_dtypes, and come back as torch tensors.

Sharded save and restore onto a mesh (the reference's `shardings`) are
training's multi-rank half, ROADMAP A12; here a restored tensor leaf
lands on its template's device, or on `device`.  Serve snapshots hold
request state alone, which carries no mesh: one taken on a mesh
restores onto another mesh or onto one device (launch/engine.py).
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

_COMMIT = "_COMMITTED"


def _sorted(tree):
    """`tree` with every dict's keys in sorted order (lists and tuples
    keep theirs)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_sorted(x) for x in tree)
    return tree


def _flatten_with_paths(tree):
    """(leaves, their keys, spec): the keys number the leaves that are
    not None (None's key is None)."""
    flat, spec = pytree.tree_flatten(_sorted(tree))
    n = 0
    keys = []
    for x in flat:
        keys.append(None if x is None else f"leaf_{n:05d}")
        n += x is not None
    return flat, keys, spec


def _to_numpy(leaf) -> tuple:
    """(array numpy can store, dtype name to encode in the key or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        try:
            return t.numpy(), None
        except TypeError:           # bfloat16 / float8: store the bits
            raw = getattr(torch, f"uint{8 * t.element_size()}")
            return t.view(raw).numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":      # an ml_dtypes array
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), arr.dtype.name
    return arr, None


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    host_id: int = 0, keep: int = 3,
                    extra_meta: Optional[dict] = None) -> str:
    """Serialize `tree` (any pytree of tensors / arrays / scalars)
    atomically; returns the step's directory."""
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat, paths, spec = _flatten_with_paths(tree)
    arrays, manifest = {}, []
    for key, leaf in zip(paths, flat):
        if key is None:
            continue
        arr, dt_name = _to_numpy(leaf)
        arrays[key if dt_name is None else f"{key}__{dt_name}"] = arr
        manifest.append({"key": key, "shape": list(arr.shape),
                         "dtype": dt_name or str(arr.dtype)})
    np.savez(os.path.join(tmp, f"shard_h{host_id:03d}.npz"), **arrays)
    if host_id == 0:
        # the tree structure is informational: restore rebuilds from `like`
        index = {"step": step, "treedef": str(spec), "manifest": manifest,
                 "meta": extra_meta or {}}
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _committed_steps(ckpt_dir: str) -> list:
    """Committed step numbers, ascending.  Foreign step_* dirs (a bad
    suffix) are skipped with a warning, never raised on."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, _COMMIT)):
                try:
                    steps.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    warnings.warn(f"ignoring malformed checkpoint dir "
                                  f"{name!r} in {ckpt_dir}")
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_meta(ckpt_dir: str, step: int) -> Optional[dict]:
    """The index.json meta of one committed step, or None (with a
    warning) when the index is missing or corrupt."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}", "index.json")
    try:
        with open(path) as f:
            return json.load(f)["meta"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        warnings.warn(f"checkpoint step {step} in {ckpt_dir} has a "
                      f"missing/corrupt index.json ({e}); skipping it")
        return None


def load_meta(ckpt_dir: str, *, step: Optional[int] = None):
    """(extra_meta dict, step) of the latest (or given) committed
    checkpoint, or (None, None); readable before a `like` template is
    built.  With no step pinned, a damaged newest checkpoint falls back
    to the earlier committed ones."""
    if step is not None:
        meta = _read_meta(ckpt_dir, step)
        return (None, None) if meta is None else (meta, step)
    for s in reversed(_committed_steps(ckpt_dir)):
        meta = _read_meta(ckpt_dir, s)
        if meta is not None:
            return meta, s
    return None, None


def _leaf_like(arr: np.ndarray, dt_name: Optional[str], like, device):
    # np.ascontiguousarray makes a 0-d array 1-d: keep the shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dt_name is not None:
        t = torch.from_numpy(arr).view(
            getattr(torch, dt_name))
    elif isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
    else:
        want = getattr(like, "dtype", arr.dtype)
        return np.asarray(arr, want)
    if isinstance(like, torch.Tensor):
        t = t.to(device=device or like.device, dtype=like.dtype)
    elif device is not None:
        t = t.to(device)
    return t


def restore_checkpoint(ckpt_dir: str, like: Any, *,
                       step: Optional[int] = None, host_id: int = 0,
                       device=None):
    """Restore into the structure of `like` (a template tree): (tree,
    step), or (None, None) with no committed checkpoint.  Tensor leaves
    come back as tensors of the template's dtype on its device (or on
    `device`), array leaves as numpy arrays of the template's dtype."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None, None
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with np.load(os.path.join(d, f"shard_h{host_id:03d}.npz")) as data:
        by_key = {}
        for k in data.files:
            base, _, dt_name = k.partition("__")
            by_key[base] = (data[k], dt_name or None)
    flat_like, paths, spec = _flatten_with_paths(like)
    flat = [None if key is None else _leaf_like(*by_key[key], leaf, device)
            for key, leaf in zip(paths, flat_like)]
    return pytree.tree_unflatten(flat, spec), step


def _gc(ckpt_dir: str, keep: int):
    steps = _committed_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
