"""Family-agnostic slot-state layer for the continuous-batching engine.

Port of `repro/models/slot_state.py` (:1-410; the tensor-parallel
probing, `TPPlan` / `tp_plan` / `tp_axes_for`, comes with distributed
serving, and the prefix-cache page ops and speculative rollback with
those engine paths).  Every model family's decode-time state -- KV
pages, SSM recurrent state, conv windows, the hybrid family's flat mix
-- is served through ONE "slot state" interface, so the engine
(launch/engine.py) never special-cases a family.

A family registers an `init(cfg, n_slots, max_cache_len, *, device,
**kw)` function (the registrations at the bottom of models/lm.py).  From
it a `SlotStateSpec` is derived by **shape probing**: that function runs
on `device="meta"` (shapes, no memory: the reference's
`jax.eval_shape`) at two slot counts and two cache lengths, and each
leaf's

* **slot axis** -- the axis that scales with `n_slots` (exactly one per
  leaf), and
* **length axis** -- the axis that scales with `max_cache_len` (`None`
  for constant-size pages: SSM state, conv windows)

are read off the shape differences.

The spec's state operations work IN PLACE on the engine's one slot
state, so its tensors keep their addresses for the engine's lifetime
(the captured segment graphs read and write them there):

  init_state(n_slots, t)        fresh slot pages
  slice_live(state, n, t_b)     views of the bucketed live prefix
  merge_live(big, sub, n, t_b)  write a segment's result back (nothing
                                to copy when `sub` is slice_live's views)
  admit(big, rows, slots, g, t) scatter freshly prefilled requests into
                                free slots -- leaves WITHOUT a length axis
                                are overwritten whole (reset-on-admit);
                                leaves with one are written up to the
                                prefill bucket, the rest stale-but-masked
  permute_slots(state, perm)    slot compaction (gather along slot axes)

Masked per-step updates (inactive slots bit-identical) live with the
models themselves: `attention.attn_decode`, `ssm.ssd_decode` and the
blocks take an `active` mask.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class FamilyState:
    """Registry entry: how to build one family's slot state.

    prefill_chunkable: whether prompts may be fed through the decode path
    C tokens at a time (the engine's chunked prefill).  True only for
    families whose decode step consumes multi-token chunks with the same
    summation order as full prefill (attention KV); sequential-state
    families (SSM, hybrid) would change the reduction order."""
    family: str
    init: Callable[..., Any]
    prefill_chunkable: bool = True


_REGISTRY: Dict[str, FamilyState] = {}


def register(family: str, init: Callable[..., Any], *,
             prefill_chunkable: bool = True) -> None:
    """Register `init(cfg, n_slots, max_cache_len, *, device, **kw) ->
    state tree` for a family.  Axis layout is probed, not declared."""
    _REGISTRY[family] = FamilyState(family, init, prefill_chunkable)


def families() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_family(family: str) -> FamilyState:
    try:
        return _REGISTRY[family]
    except KeyError:
        raise ValueError(
            f"no slot-state implementation registered for family "
            f"{family!r} (registered: {list(families())}).  Add one with "
            f"repro_torch.models.slot_state.register({family!r}, init_fn) "
            f"-- init_fn(cfg, n_slots, max_cache_len, *, device, **kw) "
            f"must return the family's stacked decode cache; see "
            f"models/slot_state.py and the registrations at the bottom of "
            f"models/lm.py.") from None


def _idx(ndim: int, ba: int, slot_sel, la: Optional[int], length_sel):
    idx = [slice(None)] * ndim
    idx[ba] = slot_sel
    if la is not None and length_sel is not None:
        idx[la] = length_sel
    return tuple(idx)


@dataclasses.dataclass(frozen=True)
class SlotStateSpec:
    """Probed per-leaf axis layout + the engine's state operations."""
    family: str
    cfg: Any
    init_kwargs: Tuple[Tuple[str, Any], ...]
    treedef: Any
    batch_axes: Tuple[int, ...]
    length_axes: Tuple[Optional[int], ...]
    prefill_chunkable: bool

    @property
    def has_length_axis(self) -> bool:
        """False => constant-size pages: the engine skips cache-length
        bucketing entirely (batch-bucket-only graph growth)."""
        return any(a is not None for a in self.length_axes)

    # -- construction -------------------------------------------------------

    def init_state(self, n_slots: int, max_cache_len: int, device="cpu"):
        fam = get_family(self.family)
        return fam.init(self.cfg, n_slots, max_cache_len, device=device,
                        **dict(self.init_kwargs))

    # -- leaf-wise application ---------------------------------------------

    def _leaves(self, state) -> list:
        leaves, td = pytree.tree_flatten(state)
        if td != self.treedef:
            raise ValueError(
                f"state tree mismatch for family {self.family!r}: "
                f"got {td}, spec has {self.treedef}")
        return leaves

    def _apply(self, fn, *states):
        flats = [self._leaves(st) for st in states]
        out = [fn(ba, la, *ls)
               for ba, la, *ls in zip(self.batch_axes, self.length_axes,
                                      *flats)]
        return pytree.tree_unflatten(out, self.treedef)

    # -- engine operations --------------------------------------------------

    def slice_live(self, state, n_live: int, t_b: Optional[int] = None):
        """Views of the [.., :n_live, (:t_b)] live prefix a decode segment
        runs on: writes through them land in `state`."""
        return self._apply(
            lambda ba, la, leaf: leaf[_idx(leaf.ndim, ba, slice(0, n_live),
                                           la, slice(0, t_b)
                                           if t_b is not None else None)],
            state)

    def merge_live(self, big, sub, n_live: int, t_b: Optional[int] = None):
        """Write a segment's updated prefix back into the full slot state,
        in place.  A leaf of `sub` that IS the view slice_live made (same
        storage, offset, shape and strides) was updated in place already:
        nothing to copy."""
        def f(ba, la, bleaf, sleaf):
            dst = bleaf[_idx(bleaf.ndim, ba, slice(0, n_live), la,
                             slice(0, t_b) if t_b is not None else None)]
            if not (dst.data_ptr() == sleaf.data_ptr()
                    and dst.shape == sleaf.shape
                    and dst.stride() == sleaf.stride()):
                dst.copy_(sleaf)
            return bleaf
        self._apply(f, big, sub)
        return big

    def admit(self, big, rows, slots, n_new: int,
              t_pre: Optional[int] = None):
        """Scatter the first n_new prefilled rows into slot indices `slots`
        ([n_new] int), in place.  Constant-size leaves are replaced whole
        for those slots; length-paged ones up to t_pre."""
        def f(ba, la, bleaf, rleaf):
            idx = torch.as_tensor(slots, dtype=torch.int64,
                                  device=bleaf.device)
            src = rleaf.narrow(ba, 0, n_new)
            dst = bleaf
            if la is not None and t_pre is not None:
                src, dst = src.narrow(la, 0, t_pre), dst.narrow(la, 0, t_pre)
            dst.index_copy_(ba, idx, src.to(bleaf.device))
            return bleaf
        self._apply(f, big, rows)
        return big

    def permute_slots(self, state, perm):
        """Reorder slots (compaction), in place: gather `perm` along each
        slot axis and write the result back."""
        def f(ba, la, leaf):
            idx = torch.as_tensor(perm, dtype=torch.int64,
                                  device=leaf.device)
            leaf.copy_(leaf.index_select(ba, idx))
            return leaf
        self._apply(f, state)
        return state


def _leaf_axis_diff(base, other, what: str, family: str):
    diff = [i for i, (x, y) in enumerate(zip(base, other)) if x != y]
    if len(diff) > 1:
        raise ValueError(
            f"slot-state probe for family {family!r}: leaf {base} has "
            f"{len(diff)} {what} axes {diff}; exactly one slot axis and at "
            f"most one length axis per leaf are supported")
    return diff


@functools.lru_cache(maxsize=64)
def _spec_cached(family: str, cfg,
                 kw_items: Tuple[Tuple[str, Any], ...]) -> SlotStateSpec:
    fam = get_family(family)
    kwargs = dict(kw_items)

    def shapes(n, t):
        tree = fam.init(cfg, n, t, device="meta", **kwargs)
        leaves, td = pytree.tree_flatten(tree)
        return [tuple(leaf.shape) for leaf in leaves], td

    # prime-ish probe sizes: only dims derived from the varied argument
    # change between probes, so fixed dims can never alias
    s0, td0 = shapes(2, 16)
    sb, tdb = shapes(3, 16)
    sl, tdl = shapes(2, 48)
    if not (td0 == tdb == tdl):
        raise ValueError(
            f"slot-state init for family {family!r} changes tree structure "
            f"with n_slots/max_cache_len; it must be shape-polymorphic")
    batch_axes, length_axes = [], []
    for base, b_sh, l_sh in zip(s0, sb, sl):
        bd = _leaf_axis_diff(base, b_sh, "slot", family)
        if len(bd) != 1:
            raise ValueError(
                f"slot-state probe for family {family!r}: leaf {base} does "
                f"not scale with n_slots; every leaf needs a slot axis")
        ld = _leaf_axis_diff(base, l_sh, "length", family)
        batch_axes.append(bd[0])
        length_axes.append(ld[0] if ld else None)
    return SlotStateSpec(
        family=family, cfg=cfg, init_kwargs=kw_items, treedef=td0,
        batch_axes=tuple(batch_axes), length_axes=tuple(length_axes),
        prefill_chunkable=fam.prefill_chunkable)


def spec_for(cfg, **init_kwargs) -> SlotStateSpec:
    """The (cached) SlotStateSpec for cfg's family.  Raises with registry
    guidance when the family has no registered slot-state impl."""
    return _spec_cached(cfg.family, cfg, tuple(sorted(init_kwargs.items())))
