"""Family-agnostic slot-state layer for the continuous-batching engine.

Port of `repro/models/slot_state.py`, with the tensor-parallel plan
(`TPPlan`, `tp_plan`, `tp_axes_for`) of mesh serving.  Every model
family's decode-time state -- KV
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
  rollback_select(state, snaps, idx)
                                speculative decoding's rollback: each
                                constant-size leaf restored from its
                                per-step snapshot at each row's index
  extract_row_pages / write_row_pages
                                one slot's prefix pages off the state to
                                the host, and back into a slot in place
                                (the prefix cache, launch/prefix_cache.py)

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

    # -- speculative-decode rollback (launch/engine.py) ----------------------
    #
    # Accepting m of k drafted tokens: leaves WITH a length axis need no
    # rollback (rows written past the accepted position are stale but
    # masked), constant-size leaves (SSM state, conv windows) are restored
    # from per-step snapshots.

    def const_leaves(self, state) -> tuple:
        """The constant-size (length_axis=None) leaves of `state` in
        tree_flatten order: what a speculative step snapshots, and what a
        terminal prefix page holds whole."""
        return tuple(leaf for leaf, la in zip(self._leaves(state),
                                              self.length_axes)
                     if la is None)

    def rollback_select(self, state, snaps, idx, active):
        """Roll `state` back to per-row snapshot index `idx` ([rows]
        int), IN PLACE: length-axis leaves are left as they are, each
        constant-size leaf i takes `snaps[i][idx[row]]` per row.  The
        snapshot leaves carry a LEADING step axis over const_leaves'
        shapes (the reference's `lax.scan` stack; here static buffers the
        captured steps write at their step index).  Only the `active`
        rows ([rows] bool) change: the reference restores every row, and
        an inactive row's snapshots all equal its state in a round, but a
        capture's eager step runs over snapshots of whatever the buffers
        held.  Returns `state`."""
        it = iter(snaps)
        idx = idx.to(torch.int64)
        for leaf, ba, la in zip(self._leaves(state), self.batch_axes,
                                self.length_axes):
            if la is not None:
                continue
            snap = next(it)
            shape = [1] * snap.ndim
            shape[ba + 1] = snap.shape[ba + 1]
            sel = torch.take_along_dim(snap, idx.reshape(shape),
                                       dim=0).squeeze(0)
            shape = [1] * leaf.ndim
            shape[ba] = leaf.shape[ba]
            leaf.copy_(torch.where(active.reshape(shape), sel, leaf))
        return state

    # -- prefix pages (launch/prefix_cache.py) ------------------------------
    #
    # A "prefix page" is the per-slot, per-leaf slice of state that a token
    # prefix fully determines: for leaves WITH a length axis, positions
    # [lo:hi) (KV written at each row's own position, a pure function of
    # the token prefix); for constant-size leaves (SSM state, conv
    # windows, cross-KV) the whole leaf, a state SNAPSHOT.  Pages go to
    # the host (the reference keeps host numpy; bfloat16 has no numpy
    # dtype, so the port keeps host tensors, pinned when they come off the
    # card) and come back bit for bit.

    def _extract_prog(self, size: int, with_const: bool):
        """The reference's one jitted slicing program per page size: here
        a function (leaves, row, lo) -> each leaf's [row, lo:lo+size)
        view (None for a constant-size leaf unless with_const); nothing
        is compiled."""
        axes = tuple(zip(self.batch_axes, self.length_axes))

        def prog(leaves, row: int, lo: int):
            out = []
            for (ba, la), leaf in zip(axes, leaves):
                if la is None and not with_const:
                    out.append(None)
                    continue
                page = leaf.narrow(ba, row, 1)
                out.append(page if la is None else page.narrow(la, lo, size))
            return out
        return prog

    def _write_prog(self):
        """Counterpart of _extract_prog: (leaves, pages, row, lo) writes
        every page into its leaf's [row, lo:lo+len) in place (None pages
        leave their leaf untouched)."""
        axes = tuple(zip(self.batch_axes, self.length_axes))

        def prog(leaves, pages, row: int, lo: int):
            for (ba, la), leaf, page in zip(axes, leaves, pages):
                if page is None:
                    continue
                dst = leaf.narrow(ba, row, 1)
                if la is not None:
                    dst = dst.narrow(la, lo, page.shape[la])
                dst.copy_(page, non_blocking=page.is_pinned())
        return prog

    def extract_row_pages(self, state, row: int, lo: int, hi: int,
                          with_const: bool = True) -> list:
        """Per-leaf host pages of ONE slot row (tree_flatten order).

        Length-axis leaves are sliced [lo:hi) along the length axis; the
        slot axis is kept as a singleton so axis numbering is the
        leaf's, as write_row_pages expects.  Constant-size leaves are
        taken whole when `with_const`, else None.  Off the card the
        copies go into pinned host memory, all queued before one wait."""
        views = self._extract_prog(hi - lo, with_const)(
            self._leaves(state), row, lo)
        cuda = [v for v in views if v is not None and v.is_cuda]
        out = []
        for v in views:
            if v is None:
                out.append(None)
                continue
            page = torch.empty(v.shape, dtype=v.dtype,
                               pin_memory=v.is_cuda)
            page.copy_(v, non_blocking=v.is_cuda)
            out.append(page)
        if cuda:
            torch.cuda.current_stream(cuda[0].device).synchronize()
        return out

    def write_row_pages(self, state, row: int, lo: int, pages: list):
        """Write extract_row_pages output into slot `row` of `state`, in
        place (the captured graphs hold the state's addresses):
        length-axis leaves at [lo:lo+page_len), constant-size leaves
        whole; None pages leave their leaf untouched.  The written bits
        are exactly the extracted bits, which is what makes a prefix hit
        reproduce the cold prefill's stream."""
        self._write_prog()(self._leaves(state), pages, row, lo)
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


# ---------------------------------------------------------------------------
# tensor-parallel plan (mesh serving, launch/engine.py)
# ---------------------------------------------------------------------------
#
# Which slot-state axis shards over the model axis under tensor
# parallelism is PROBED the way the slot and length axes are: the family
# init runs on the meta device with a head-localized config (head counts
# divided by the shard count, head_dim pinned so nothing else moves), and
# the axis that shrank by exactly the shard count is the tp axis.  Leaves
# that change by another ratio (the SSD conv window, whose channels mix
# per-head x channels with shared B / C channels) or not at all stay
# replicated over the model axis -- what the compute side (attention.py /
# ssm.py `tp_current()` paths) keeps local vs replicated.

_ATTN_FAMILIES = ("dense", "vlm", "moe", "hybrid", "encdec")


def _ssm_heads(cfg) -> int:
    if cfg.ssm is None:
        return 0
    from repro_torch.models import ssm as ssm_mod
    return ssm_mod.dims(cfg)[2]


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Which mixers a serve engine can tensor-parallelize over `size`
    model shards for this config (bit-exactness-preserving only: local
    heads + all_gather, never a partitioned float contraction)."""
    size: int
    attn: bool
    ssm: bool

    @property
    def active(self) -> bool:
        return self.size > 1 and (self.attn or self.ssm)


def tp_plan(cfg, size: int) -> TPPlan:
    """What can shard over a model axis of `size` for cfg.  Attention
    needs head counts divisible by the axis; SSD needs its derived head
    count divisible (and d_model, for the shape probe).  Anything that
    does not divide stays replicated -- graceful, never an error."""
    if size <= 1:
        return TPPlan(size, False, False)
    attn = (cfg.family in _ATTN_FAMILIES
            and cfg.n_heads % size == 0 and cfg.n_kv % size == 0)
    hs = _ssm_heads(cfg)
    ssm = (cfg.family in ("ssm", "hybrid") and hs > 0 and hs % size == 0
           and cfg.d_model % size == 0)
    return TPPlan(size, attn, ssm)


def tp_viable_sizes(cfg, limit: int) -> tuple:
    """Model-axis sizes in [2, limit] whose tp_plan is ACTIVE for cfg
    (shards something instead of replicating everything): what a
    degraded-mesh planner prefers to shrink onto."""
    return tuple(m for m in range(2, max(1, limit) + 1)
                 if tp_plan(cfg, m).active)


def _tp_probe_cfg(cfg, plan: TPPlan):
    kw: Dict[str, Any] = {}
    if plan.attn:
        kw.update(n_heads=cfg.n_heads // plan.size,
                  n_kv=cfg.n_kv // plan.size)
    if plan.ssm:
        kw["d_model"] = cfg.d_model // plan.size
    if kw:
        # pin head_dim: it is otherwise derived from d_model / n_heads and
        # would drag unrelated axes along with the probe
        kw["d_head"] = cfg.head_dim
    return dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=64)
def _tp_axes_cached(family: str, cfg, size: int,
                    kw_items: Tuple[Tuple[str, Any], ...]) -> tuple:
    fam = get_family(family)
    kwargs = dict(kw_items)
    plan = tp_plan(cfg, size)

    def shapes(c):
        leaves, td = pytree.tree_flatten(
            fam.init(c, 2, 16, device="meta", **kwargs))
        return [tuple(leaf.shape) for leaf in leaves], td

    base, b_td = shapes(cfg)
    if not plan.active:
        return (None,) * len(base)
    probe, p_td = shapes(_tp_probe_cfg(cfg, plan))
    if b_td != p_td:
        raise ValueError(
            f"tp probe for family {family!r}: init changes tree structure "
            f"under head localization; it must be shape-polymorphic")
    axes = []
    for bl, pl in zip(base, probe):
        exact = [i for i, (b, p) in enumerate(zip(bl, pl))
                 if b != p and p * size == b]
        if len(exact) > 1:
            raise ValueError(
                f"tp probe for family {family!r}: leaf {bl} has "
                f"{len(exact)} head-localized axes {exact}; at most one "
                f"tp axis per leaf is supported")
        axes.append(exact[0] if exact else None)
    return tuple(axes)


def tp_axes_for(cfg, size: int, **init_kwargs) -> tuple:
    """Per-leaf model-shard axis (tree_flatten order, matching
    SlotStateSpec.batch_axes); None = replicated over the model axis."""
    return _tp_axes_cached(cfg.family, cfg, size,
                           tuple(sorted(init_kwargs.items())))
