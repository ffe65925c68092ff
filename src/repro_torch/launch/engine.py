"""Continuous-batching serve engine over captured decode steps.

Port of the core of `repro/launch/engine.py` (`ServeEngine`).  SILVIA
packs independent narrow ops into one wide DSP; this engine packs
independent requests into one decode dispatch.  Decode runs in
fixed-length **segments** (`segment_len` tokens across all slots);
between segments the scheduler admits queued requests into free slots
and evicts finished ones, so a handful of captured graphs serve an
ever-changing request mix:

* **family-agnostic slot state** -- the engine never touches a concrete
  cache layout: it slices, scatters and compacts through the probed
  `models/slot_state.py` spec (dense, vlm and moe KV pages, the ssm
  family's recurrent state, the hybrid family's flat mix).  The engine
  holds ONE slot state for its lifetime; every operation on it is in
  place, so its tensors keep their addresses.
* **bucketed captured segments** -- a segment's batch size and (for
  families with a cache-length axis) attended cache length are rounded
  up to power-of-two buckets (launch/scheduler.py).  Per (batch bucket,
  length bucket) the engine keeps one decode step captured in a CUDA
  graph (`serve._CapturedStep`, the static path's step) over views of
  the slot state and of its own per-slot device buffers -- token,
  position, active flag, sampling page, the segment's token block and
  the non-finite flag -- and replays it
  `segment_len` times per segment: the reference's one `lax.scan`
  dispatch.  One step replayed, not the whole segment captured: a
  graph's private memory pool then holds one step's intermediates, and
  capture costs one step's trace, while a replay costs the host ~10 us
  against a decode step of milliseconds.  Constant-size-state families
  (ssm) skip length bucketing: their graph count grows with batch
  buckets only.  `warmup()` captures the grid; `graph_bound()` bounds
  it.  On the CPU there is no graph and the same step runs eagerly.  On
  CUDA a failed capture or replay raises; nothing falls back to eager.
* **slot-based paged state** -- each slot is a page with its own
  position and active flag, threaded through `lm.decode_step`, so
  inactive slots neither mutate their page nor contribute tokens (the
  masked writes of `attention.attn_decode`, `ssm.ssd_decode`).  KV pages
  are reused WITHOUT scrubbing (the causal mask zeroes stale positions
  exactly); constant-size pages are reset on admit.
* **admission**: full prefill per (batch bucket, prompt bucket[,
  encoder bucket]), eager, as the static path's (capturing it is ROADMAP
  B2), then one scatter into the free slots; or, with `prefill_chunk`,
  **chunked prefill**: the prompt fed through the decode step
  `prefill_chunk` tokens at a time, one chunk step captured per (batch
  bucket, chunk, prefill cache length) over a static prefill state of
  that shape (`_ChunkStep`), so one long prompt holds the slots for
  chunk-sized launches only.  The **encdec family** (whisper) takes
  per-request ragged `features`: grouped by encoder-length bucket, the
  encoder runs at the bucket's width with the real frame counts masking
  the padding, and the cross K/V page is padded to the engine's
  `enc_len` (one constant page shape per slot).
* **the cross-request prefix cache** (launch/prefix_cache.py,
  `prefix_cache`): an exact repeat copies its pooled pages and first
  token into the slot and makes no prefill launch; on a chunked engine a
  request resumes at its first uncached chunk, and a chunk launch is
  skipped once every row is past it.  Pooled pages are written into the
  live slot state in place.  `admit_token_budget` caps the uncached
  prompt tokens one admission round prefills (the head request always
  proceeds), deferring the rest in arrival order.
* **per-request sampling** (launch/sampling.py) inside the captured step;
  greedy rows take the argmax.
* **stop tokens**, **slot compaction** (surviving slots remapped downward
  when holes inflate the batch bucket), **admission control** (bounded
  queue, shedding, deadlines; launch/resilience.py), cancellation and
  the non-finite quarantine (a slot whose logits went non-finite fails
  with the tokens it had, and its pages are scrubbed).
* **the score and embed methods** (launch/methods.py): an embed request
  is one pooled-embedding launch per (batch bucket, prompt bucket[,
  encoder bucket]) group (`lm.embed_pool`, eager as prefill) and takes
  no slot; a score request prefills like a generate one, takes its first
  logprob from the prefill's last logits row and teacher-forces the rest
  of its completion through the replay step below.
* **fault injection and recovery as replay** (launch/resilience.py):
  every launch funnels through `_guarded`, which gives the chaos schedule
  its site; any exception in a step -- injected or real -- is counted
  (`faults_injected` or `errors`) and recovered: the in-flight and
  mid-admission requests are requeued with their emitted tokens, and the
  engine's state is reset IN PLACE (every slot-state leaf refilled with
  its init value, the device buffers zeroed, the prefix pins released),
  so every captured step keeps reading it at its addresses.  A requeued
  request re-prefills its prompt and replays its tokens through the
  **replay step**: one decode step (S = 1, no sampler) over the live slot
  state's (bb, t_b) slice, t_b bucketing pos + 1, with the replaying and
  scoring rows active, captured per (bb, t_b) on CUDA over views of the
  slot state and the device buffers, counted as ("chunk", bb, 1, t_b).
  Its logits equal the segment's that first produced the token although
  its key length differs, because decode attention sums its masked key
  axis in `tail_sum_`'s tree (ROADMAP C10).  `drain`, `snapshot` and
  `restore` build rolling restarts on the same path.
* **self-speculative decoding** (`spec_decode=SpecDecodeConfig(...)`):
  a draft model of the same family and vocab, with a slot state of its
  own, free-runs k + 1 sampled steps per slot, then the target verifies
  the pending token and the k drafts teacher-forced, and both states
  roll back to the accepted prefix on the device (`_SpecRound`: per
  (bb, t_b, k + 1) the draft step, the verify step, the settle and the
  draft's rollback, each captured on CUDA; one host read per round).
  The emitted tokens are always the target's own under a teacher-forced
  prefix, and the verify step is the segment's decode step at another
  key length (the replay step's argument), so the streams equal the
  non-speculative engine's bit for bit whatever the draft proposes;
  acceptance only changes how many target dispatches they take.  A
  round is synchronous: `step_begin` returns no pending segment.
  Recovery replays the draft in lockstep with the target.

Exactness: an active row's tokens are a pure function of its request.
An attention row attends only cache positions <= its own position, all
written by its own request, and masked scores are exact zeros after the
softmax; SSM state is masked wholesale; the MoE routes per token; the
GEMM kernels accumulate in int32; and no reduction on the path changes
its order with the number of rows (CUDA's reduce, scan and batched-GEMM
kernels do: RMSNorm's and LayerNorm's means, the SSD decode
contraction, top-p's prefix sum and decode attention's sums go through
`common.row_sum` / `row_mean` / `row_cumsum`, which pin the row count
the kernel sees and sum a masked key axis in a tree that zeros appended
to it do not change; scripts/batch_invariance.py gates them).  So every
request's stream equals `serve.generate` of that request alone, bit for
bit (tests/test_torch_engine.py, test_torch_engine_prefix.py,
test_torch_engine_encdec.py; chip_smoke.py phases 13-14 on the card).

Chunked prefill, warm (prefix-cache) admission and ragged encoder
features keep the exactness: a chunk's attention rows, a page copied
from the pool and a padded encoder row are bitwise what the cold, full
and unpadded runs compute.  Their attention has many queries (S > 1)
over a key length that differs from the static path's, and one product
over the whole key axis changed its sums with that length on the card
(ROADMAP C12).  So full prefill, the chunk step and the encoder sum
their output product over the keys in blocks of 256, each block one
GEMM of the same K, the blocks added in `tail_sum_`'s tree
(`attention._key_blocked_out`); the encdec decoder's prefill attention
sums scores and output in the decode step's fixed order
(`attention._attend(fixed=True)`).  The scores' product keeps one GEMM
over the head dimension.  scripts/batch_invariance.py's `attention_s`
cases gate both products on these paths, and find no
differing bit on the card: a chunk of 16 queries over t_pre = 32 to
4096 keys at every chunkable head layout; whisper's encoder at 200,
500, 1000 and 1500 frames in their buckets of up to 1500; its decoder's
cross-attention over the 1500-frame page.  On the CPU the same cases
hold with t_pre up to 256.  Other chunk sizes and a t_pre past 4096 are
not gated.

**Mesh-aware serving** (DESIGN.md sec. 7).  Constructed under a
`distributed.context.mesh_scope` over a `launch.mesh.Mesh`, the engine
is one process per rank:

* slots shard over the dp axes, CYCLICALLY: slot s lives on dp shard
  s % dp, at local row s // dp, so every batch bucket's prefix [:bb]
  (bb a multiple of dp) is each shard's own prefix [:bb / dp] -- the
  captured steps keep running over fixed views, and no segment moves a
  page between ranks.  Admission sends each request's prefill to the
  shard that owns its slot (a shard prefills its own rows, bucketed by
  the largest shard's count), an embed batch is dealt cyclically, and
  compaction packs each shard's live slots downward within the shard;
  no page ever crosses ranks;
* head and state axes (`slot_state.tp_axes_for`) shard over the model
  axis where the config's head counts divide it (`slot_state.tp_plan`):
  attention and SSD mixers compute their local heads and all-gather
  them (distributed/context.py `tp_scope`, entered around every model
  call and held while a step is captured);
* every rank keeps the whole weights it was given, but under
  attention tensor parallelism contiguous copies of its wq / wk / wv
  column slices instead of the whole projections (`_place_params`).
  The reference stores the weights as shards under the
  distributed/sharding.py rules and gathers them whole at every
  dispatch; the port's captured graphs read static buffers, so it
  keeps the whole copy (PERF.md gives each rank's bytes);
* each step's sampled tokens, positions and flags, a prefill's first
  tokens and last logits rows, a replay step's logits rows and an
  embed's vectors reach every rank by an all-gather over the dp axes,
  an exact concatenation.  Over NCCL the gathers and the tensor-
  parallel collectives are captured inside the steps' CUDA graphs;
  over `gloo` (ranks on the CPU, or sharing one card) every step runs
  eagerly (`cache_info()["mesh"]["captured"]`).

**One controller, many processes.**  Every rank runs this same
scheduler -- admission, buckets, compaction, eviction, cancels,
recovery -- on inputs that rank 0 broadcasts, so no two ranks ever take
a different host decision: rank 0 (the leader) sends each call of
`submit`, `cancel`, `step`, `step_begin`, `step_finish`, `drain`,
`warmup` and `restore`'s requests over the mesh's `gloo` control group
before running it, and every other rank runs `follow()`, which receives
and runs them until the leader's `release()`.  The clock is read on
rank 0 alone: inside such a call every `clock.now()` of the leader is
broadcast, and the followers' clock returns the broadcast value.
Device results enter host decisions only after the dp all-gather, so
they are the same bits on every rank.  The front-end
(launch/frontend.py) runs on rank 0 over the leader.  Every collective
is a gather, so the sharded streams equal the single-device engine's
bit for bit (tests/test_torch_sharded_serve.py).

The prefix cache on a mesh: every rank keeps a pool of the same
entries, since the same scheduler looks them up, inserts, pins and
evicts them; each page holds that rank's own heads.  A hit is written
by the shard that owns the slot; a miss prefills there, and its pages
reach every rank of its model column by a dp all-gather of the prefill
rows (`_every_row`), so a later repeat hits on any shard
(tests/test_torch_sharded_prefix.py).  Host pages re-enter the state
on the owning rank alone, so the port needs no counterpart of the
reference's `_reshard_state`.

**Elastic degraded-mesh serving** (distributed/elastic.py).  A
mesh-aware engine keeps a `DeviceHealthRegistry` over its mesh's world
ranks.  A `DeviceLoss` (chaos's ``lose@site`` arms) fires at the same
site on every rank, since every rank counts the same sites: `_recover`
calls `_degrade` first, which kills the same ranks everywhere, plans the
largest valid healthy sub-mesh, and has the survivors re-form their
process groups among themselves (`launch.mesh.reform`).  A rank the
plan leaves out leaves `follow()` and takes part in no collective after
it; the survivors rebuild the engine on the new mesh (weights placed
again from a source that holds no lost rank's slices, fresh slot state,
buffers and steps) and replay the requeued requests, so every stream
equals the fault-free run's bit for bit (tests/test_torch_elastic.py).
The control plane follows the new mesh inside the call that degraded:
the clocks and `follow()` read the engine's current control mesh.  Off
a mesh a `DeviceLoss` is a plain fault.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import device as device_lib
from repro_torch.distributed import context as dctx
from repro_torch.distributed import elastic as delastic
from repro_torch.distributed import sharding as dshard
from repro_torch.kernels import registry
from repro_torch.launch import methods as smethods
from repro_torch.launch import prefix_cache as pfx
from repro_torch.launch import resilience as res
from repro_torch.launch import sampling
from repro_torch.launch import scheduler
from repro_torch.launch import serve
from repro_torch.launch.resilience import SimulatedFailure
from repro_torch.models import attention, lm, slot_state


@dataclasses.dataclass(frozen=True)
class _MeshPlan:
    """How a mesh-aware engine lays the serve state over the mesh (built
    at construction from the ambient `mesh_scope`): slot axes over the
    dp axes (dealt cyclically, module docstring), the probed head /
    state axes (`tp_axes`) over `model_axis` when the config's head
    counts divide it (`slot_state.tp_plan`)."""
    mesh: object
    dp_axes: tuple
    model_axis: str
    tp: slot_state.TPPlan
    slot_axes: tuple           # per-leaf, tree_flatten order
    tp_axes: tuple
    state_treedef: object

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def dp_index(self) -> int:
        """This rank's shard along the dp axes."""
        return self.mesh.axis_index(self.dp_axes) if self.dp_axes else 0

    @property
    def dp(self):
        return dshard.dp_spec_entry(self.dp_axes)

    def state_specs(self):
        return dshard.slot_state_pspecs(
            self.state_treedef, self.slot_axes, self.tp_axes, self.dp_axes,
            self.model_axis if self.tp.active else None)

    @property
    def key(self) -> tuple:
        """Hashable mesh fingerprint for the decode-bundle LRU: two
        engines share a bundle only when the mesh shape, its world
        ranks, axis roles, this rank, its backend and device and the tp
        plan all agree."""
        m = self.mesh
        return (tuple((n, m.shape[n]) for n in m.axis_names), m.ranks,
                m.rank, m.backend, str(m.device), self.dp_axes,
                self.model_axis,
                self.tp.size, self.tp.attn, self.tp.ssm, self.slot_axes,
                self.tp_axes)

    def tp_scope(self):
        """The tensor-parallel scope model calls run under (a null
        context when the plan shards no mixer)."""
        if not self.tp.active:
            return contextlib.nullcontext()
        return dctx.tp_scope(self.model_axis, self.tp.size,
                             attn=self.tp.attn, ssm=self.tp.ssm,
                             mesh=self.mesh)

    def gather(self, t, dim: int = 0):
        """Shard-major all-gather over the dp axes (shard d's block at
        [d * n, (d + 1) * n) along `dim`)."""
        if not self.dp_axes:
            return t
        return self.mesh.all_gather(t, self.dp_axes, dim)

    def gather_rows(self, t):
        """Every shard's local rows [n, ...] back in global slot order
        [dp * n, ...]: global row j * dp + d is shard d's row j."""
        g = self.gather(t)
        n = t.shape[0]
        return g.reshape(self.dp_size, n, *t.shape[1:]).transpose(0, 1) \
            .reshape(self.dp_size * n, *t.shape[1:])


def _mesh_plan(cfg, spec: slot_state.SlotStateSpec,
               init_kwargs: dict) -> Optional[_MeshPlan]:
    ctx = dctx.current()
    if ctx is None:
        return None
    mesh, dp_axes, model_axis = ctx
    if mesh.rank is None:
        raise ValueError("mesh-aware serving needs a mesh of process "
                         "groups (launch.mesh.init_mesh), not make_mesh's")
    m = mesh.shape[model_axis] if model_axis in mesh.axis_names else 1
    plan = slot_state.tp_plan(cfg, m)
    tp_axes = slot_state.tp_axes_for(cfg, m, **init_kwargs) if plan.active \
        else (None,) * len(spec.batch_axes)
    return _MeshPlan(mesh=mesh, dp_axes=tuple(dp_axes),
                     model_axis=model_axis, tp=plan,
                     slot_axes=spec.batch_axes, tp_axes=tp_axes,
                     state_treedef=spec.treedef)


_ATTN_COLS = ("wq", "bq", "wk", "wv", "bk", "bv")


def _map_attention(params, fn):
    """`params` with fn(name, leaf) applied to every attention mixer's
    wq / wk / wv and biases (a dict holding both wq and wo)."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        if "wq" in node and "wo" in node:
            return {k: fn(k, v) if k in _ATTN_COLS else v
                    for k, v in node.items()}
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def _to(w, device):
    if isinstance(w, attention.QTensor):
        return attention.QTensor(w.q.to(device), w.scale.to(device), w.fmt)
    return w.to(device)


def _place_params(params, cfg, plan: _MeshPlan, device):
    """This rank's copy of the weights on a mesh: the caller's whole
    weights as they are, but under attention tensor parallelism wq / wk
    / wv (and their biases), which are replaced by contiguous copies of
    this rank's column slices (`attention._tp_slice_cols`), made once
    here, never per step.  Attention leaves held elsewhere (the host
    copies a re-plan places from, `_host_attention`) are moved to
    `device`.  Returns (params, {resident: bytes})."""
    if plan.tp.attn:
        j, size, d = plan.mesh.axis_index(plan.model_axis), plan.tp.size, \
            cfg.head_dim
        width = {"wq": cfg.n_heads // size * d, "bq": cfg.n_heads // size
                 * d}
        width.update({k: cfg.n_kv // size * d
                      for k in ("wk", "wv", "bk", "bv")})

        def local_cols(k, w):
            w = attention._tp_slice_cols(w, j, width[k])
            if isinstance(w, attention.QTensor):
                w = attention.QTensor(w.q.contiguous(),
                                      w.scale.contiguous(), w.fmt)
            else:
                w = w.contiguous()
            return _to(w, device)

        params = _map_attention(params, local_cols)
    else:
        params = _map_attention(params, lambda k, w: _to(w, device))
    return params, {"resident": _nbytes(params)}


def _attention_bytes(params) -> int:
    """The bytes of `params`' attention projections (_ATTN_COLS)."""
    leaves = []
    _map_attention(params, lambda k, w: leaves.append(w) or w)
    return _nbytes(leaves)


def _host_attention(params):
    """`params` with host copies of the whole wq / wk / wv (and biases),
    the other leaves `params`' own tensors: what a rank that keeps only
    its attention column slices places its weights from after a loss
    (`ServeEngine._place`), since its slices hold no other shard's
    heads, and a lost rank's slices go with it."""
    return _map_attention(params, lambda k, w: _to(w, "cpu"))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class _EngineBundle:
    """The decode function shared by every engine with the same (cfg,
    pass set, lowering census, device, mesh plan), pinned to that census
    and, on a mesh, run under the plan's tensor-parallel scope; stored in
    serve.py's LRU decode cache under an "engine" variant key.  The
    captured segment steps belong to each engine: they read its slot
    state and buffers at their addresses."""
    decode_fn: object      # (params, tok [B,1], state, pos, active)


def _engine_bundle(cfg, silvia_passes: str, device,
                   plan: Optional[_MeshPlan] = None) -> _EngineBundle:
    if silvia_passes not in serve.SILVIA_PASS_SETS:
        raise ValueError(f"unknown SILVIA pass set {silvia_passes!r}")
    dev = torch.device(device)
    fp = registry.fingerprint(dev)

    def build():
        def decode_fn(p, tok, state, pos, active):
            return lm.decode_step(p, tok, state, pos, cfg, active=active)

        passes = serve.SILVIA_PASS_SETS[silvia_passes]
        if passes:
            decode_fn = serve.silvia.optimize(decode_fn, passes)
        if plan is not None and plan.tp.active:
            inner = decode_fn

            def decode_fn(*args):
                # the SILVIA trace, the eager calls and the capture all
                # run inside the scope: the graph keeps the collectives
                with plan.tp_scope():
                    return inner(*args)
        return _EngineBundle(serve._pin_lowerings(decode_fn, dict(fp)))

    return serve._DECODE_CACHE.get_or_build(
        (cfg, silvia_passes, fp, "engine",
         None if plan is None else plan.key, dev), build)


class _Gather:
    """A mesh step's output gather: `fn()` all-gathers the shard-local
    outputs into global buffers.  Captured in a CUDA graph where the mesh
    captures collectives (NCCL on CUDA), so one replay moves them; else
    `run` calls it eagerly."""

    def __init__(self, fn, device: torch.device, capture: bool):
        self._fn, self.graph, self.capture_ms = fn, None, 0.0
        if capture and device.type == "cuda":
            self.graph, _, self.capture_ms = serve.capture(fn, device)

    def run(self) -> None:
        if self.graph is None:
            self._fn()
        else:
            self.graph.replay()


class _LeaderClock:
    """Rank 0's clock inside a mirrored call: every reading is
    broadcast to the followers (module docstring) over the engine's
    CURRENT control mesh, which a degrade inside the call replaces."""

    def __init__(self, clock: scheduler.Clock, engine):
        self._clock, self._engine = clock, engine

    def now(self) -> float:
        t = self._clock.now()
        if self._engine._ctl is not None:
            self._engine._ctl.bcast_float(t)
        return t

    def wait_until(self, t: float) -> None:
        self._clock.wait_until(t)


class _FollowerClock:
    """A follower's clock: each reading is rank 0's, received over the
    engine's current control mesh."""

    def __init__(self, engine):
        self._engine = engine

    def now(self) -> float:
        return self._engine._ctl.bcast_float()

    def wait_until(self, t: float) -> None:
        pass


def _mirrored(fn):
    """A public engine call that changes host or device state: on a mesh
    of more than one rank the leader broadcasts it (its arguments, its
    clock replaced by a marker) before running it, and the followers
    run it from `follow()` with a `_FollowerClock`.  Calls it makes on
    the engine are not broadcast again."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if self._left_at is not None:
            raise RuntimeError(
                f"{fn.__name__}: this rank left the mesh at "
                f"{self._left_at} (a degrade's plan left it out)")
        mesh = self._ctl
        if mesh is None or self._mirroring:
            return fn(self, *args, **kwargs)
        if mesh.rank != 0:
            raise RuntimeError(
                f"{fn.__name__}: on a mesh only rank 0 drives the engine; "
                f"rank {mesh.rank} runs follow()")
        bound = sig.bind(self, *args, **kwargs)
        clock = bound.arguments.pop("clock", False)
        bound.arguments.pop("self")
        mesh.bcast_object((fn.__name__, dict(bound.arguments),
                           clock is not False))
        if clock is not False:
            bound.arguments["clock"] = _LeaderClock(
                clock or scheduler.Clock(), self)
        self._mirroring = True
        try:
            return fn(self, **bound.arguments)
        finally:
            self._mirroring = False

    return wrapper


class _ChunkStep:
    """`decode` of [bb, c] tokens at positions pos .. pos + c - 1 per row,
    the `active` rows writing, over `state` and the token, position and
    active buffers `tok` [bb, c], `pos` [bb], `act` [bb]: one chunk of
    chunked prefill (`prefill`: a static prefill state of (bb, t_pre) and
    buffers of its own), or the replay step (c = 1, over views of the
    engine's slot state and device buffers).  On CUDA the step is
    captured in a CUDA graph (`serve.capture`: its eager step runs with
    every row inactive, which leaves the state as it was); each `run`
    loads the buffers and replays it, and the [bb, c, V] logits it
    returns live in the graph's pool until the next replay.  On the CPU,
    and with `capture` False (a mesh over `gloo`), `run` calls the step
    eagerly.  A failed capture raises.  `gather`, if given, maps the
    logits to what `run` returns (the replay step: the last rows; on a
    mesh every dp shard's, all-gathered inside the graph)."""

    def __init__(self, decode, params, state, tok, pos, act,
                 device: torch.device, gather=None, capture: bool = True):
        self.state, self.tok, self.pos, self.act = state, tok, pos, act
        self.leaves = pytree.tree_leaves(params)    # the graph reads them

        def step():
            logits = decode(params, self.tok, self.state, self.pos,
                            self.act)[0]
            return logits if gather is None else gather(logits)

        self._step, self.graph, self.logits, self.capture_ms = \
            step, None, None, 0.0
        if device.type == "cuda" and capture:
            act.zero_()
            self.graph, self.logits, self.capture_ms = serve.capture(
                step, device)

    @classmethod
    def prefill(cls, decode, params, state, bb: int, c: int,
                device: torch.device, capture: bool = True) -> "_ChunkStep":
        """Over a fresh prefill `state` of bb rows and buffers of its
        own."""
        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(decode, params, state, zeros(bb, c), zeros(bb),
                   zeros(bb, dtype=torch.bool), device, capture=capture)

    def reset(self) -> None:
        """Fresh (zero) prefill state, as the reference's init_state per
        admission: no page of an earlier admission survives into this
        one's rows."""
        for t in pytree.tree_leaves(self.state):
            t.zero_()

    def run(self, toks: np.ndarray, start, act: np.ndarray):
        """Tokens [bb, c] at positions start.. (an int for every row, or
        [bb] per row), rows `act` [bb] writing: the [bb, c, V] float32
        logits."""
        self.tok.copy_(torch.from_numpy(np.ascontiguousarray(toks)))
        if isinstance(start, np.ndarray):
            self.pos.copy_(torch.from_numpy(np.ascontiguousarray(start)))
        else:
            self.pos.fill_(start)
        self.act.copy_(torch.from_numpy(np.ascontiguousarray(act)))
        if self.graph is None:
            return self._step()
        self.graph.replay()
        return self.logits


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Self-speculative decoding (ServeEngine `spec_decode=`): a draft
    model of the SAME family and vocab (`draft_params`, `draft_cfg`)
    free-runs `k` tokens per slot, then the target verifies all k in one
    round.  Emitted tokens are always the target's under a teacher-forced
    prefix, so streams equal the non-speculative engine's bit for bit
    however often the draft is right; acceptance only changes how many
    target dispatches that takes."""
    draft_params: object
    draft_cfg: object
    k: int = 3

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("spec_decode.k must be >= 1")


class _SpecRound:
    """One speculative round's steps for (bb, t_b, k + 1), over views of
    the target's and the draft's slot states (`tstate`, `dstate`) and of
    the engine's round buffers `b` (each [:bb]):

      x [bb, k+2] int64     column 0 the pending token, column j + 1 the
                            draft's token of step j
      g [bb, k+1] int64     the target's token at each verify step
      gbad [bb, k+1] bool   an active row's logits non-finite at that step
      pos, dpos [bb] int64  the target's and the draft's positions
      act [bb] bool, samp   the active rows and the sampling operand
      dstep, vstep [1]      the device-side step indices
      tsnaps, dsnaps        per constant-size leaf [k+1, ...leaf]: the
                            leaf after each step (the reference's scan
                            stack)
      out [bb, k+4] int64   what the host reads: g, m, pos, bad

    `draft(n)`: the draft's sampled decode step, n times: it reads x at
    its step, writes its token one column on and snapshots its
    constant-size leaves.  `verify(n)`: the target's decode step n times,
    teacher-forced over x, then the settle: the accepted count m =
    sum(cumprod(drafts == g[:k])), the target's constant-size leaves
    rolled back to snapshot m (`rollback_select`, in place), pos + m + 1,
    and bad over the steps the round used.  `rollback()`: the draft's
    leaves rolled back to snapshot m (None where the draft has no
    constant-size leaf: its stale KV rows are masked).  The sampler runs
    at the segment's generation index pos - plen + 1 under the same
    per-slot keys in both models.

    On CUDA each of the draft step, the verify step, the settle and the
    rollback is captured in a CUDA graph (`serve.capture`) with every row
    inactive, so the capture's eager call leaves both states as they
    were; the caller loads the buffers AFTER constructing the round.  On
    the CPU, and with `capture` False (a mesh over `gloo`), each runs
    eagerly.  `gather(out)`, if given, ends the settle: a mesh
    all-gathers every dp shard's `out` rows for the host."""

    def __init__(self, k: int, tdecode, params, tspec, tstate, ddecode,
                 dparams, dspec, dstate, b: dict, device: torch.device,
                 gather=None, capture: bool = True):
        self.leaves = (pytree.tree_leaves(params),
                       pytree.tree_leaves(dparams))   # the graphs read them
        x, g, gbad, out = b["x"], b["g"], b["gbad"], b["out"]
        pos, dpos, act = b["pos"], b["dpos"], b["act"]
        dstep, vstep = b["dstep"], b["vstep"]
        key, temp, top_k, top_p, plen = b["samp"]

        def sample(logits, p):
            last = logits[:, -1, :]
            nxt = sampling.sample(last, key, temp, top_k, top_p,
                                  p - plen + 1)
            return torch.where(act, nxt, 0)[:, None], last

        def draft_step():
            logits, _ = ddecode(dparams, x.index_select(1, dstep), dstate,
                                dpos, act)
            nxt, _ = sample(logits, dpos)
            x.index_copy_(1, dstep + 1, nxt)
            for snap, leaf in zip(b["dsnaps"], dspec.const_leaves(dstate)):
                snap.index_copy_(0, dstep, leaf.unsqueeze(0))
            dpos.copy_(torch.where(act, dpos + 1, dpos))
            dstep.add_(1)

        def verify_step():
            logits, _ = tdecode(params, x.index_select(1, vstep), tstate,
                                pos, act)
            nxt, last = sample(logits, pos)
            g.index_copy_(1, vstep, nxt)
            gbad.index_copy_(1, vstep, (act & ~torch.isfinite(last)
                                        .all(dim=-1))[:, None])
            for snap, leaf in zip(b["tsnaps"], tspec.const_leaves(tstate)):
                snap.index_copy_(0, vstep, leaf.unsqueeze(0))
            pos.copy_(torch.where(act, pos + 1, pos))
            vstep.add_(1)

        def settle():
            eq = (x[:, 1:k + 1] == g[:, :k]).to(torch.int64)
            m = eq.cumprod(dim=1).sum(dim=1)
            tspec.rollback_select(tstate, b["tsnaps"], m, act)
            # pos advanced k + 1 on the active rows: pos0 + m + 1
            pos.copy_(torch.where(act, pos - k + m, pos))
            used = torch.arange(k + 1, device=m.device)[None, :] \
                <= m[:, None]
            out[:, :k + 1].copy_(g)
            out[:, k + 1].copy_(m)
            out[:, k + 2].copy_(pos)
            out[:, k + 3].copy_((gbad & used).any(dim=1))
            if gather is not None:
                gather(out)

        def rollback():
            dspec.rollback_select(dstate, b["dsnaps"], out[:, k + 1], act)

        fns = [draft_step, verify_step, settle]
        if b["dsnaps"]:
            fns.append(rollback)
        self.graphs, self.capture_ms = [None] * len(fns), 0.0
        if device.type == "cuda" and capture:
            act.zero_()
            for i, fn in enumerate(fns):
                # each capture's eager call advances the step indices the
                # rounds share: start it at step 0, inside the buffers
                dstep.zero_()
                vstep.zero_()
                self.graphs[i], _, ms = serve.capture(fn, device)
                self.capture_ms += ms
        self._run = [fn if gr is None else gr.replay
                     for fn, gr in zip(fns, self.graphs)]
        self.rollback = self._run[3] if len(fns) == 4 else None

    def draft(self, n: int) -> None:
        for _ in range(n):
            self._run[0]()

    def verify(self, n: int) -> None:
        for _ in range(n):
            self._run[1]()
        self._run[2]()


@dataclasses.dataclass
class _PendingSegment:
    """A dispatched-but-not-harvested decode segment (step_begin /
    step_finish): its outputs are still being computed on the device."""
    bb: int
    n_steps: int


class ServeEngine:
    """Continuous-batching engine (see module docstring).

    Parameters
    ----------
    n_slots:        state pages / maximum in-flight requests.
    max_cache_len:  page length; every request needs
                    prompt_len + max_new_tokens <= max_cache_len.  For
                    families without a cache-length axis (ssm) it only
                    bounds request sizes and prompt buckets.
    segment_len:    decode steps per segment.
    silvia_passes:  serve.SILVIA_PASS_SETS key ("off" | "add" | "muladd"
                    | "all").
    prefill_chunk:  if set (a power of two dividing max_cache_len),
                    prompts are prefilled through the decode step this
                    many tokens per launch (`_ChunkStep`); None uses one
                    bucketed full prefill.  Only for families whose slot
                    state is prefill-chunkable.
    enc_len:        encdec families only: the longest encoder input; every
                    request carries `features` of [1..enc_len, d_model].
    min_len_bucket / min_batch_bucket: smallest cache-length / batch
                    buckets (both clamped to the physical maxima).
    resilience:     ResilienceConfig (queue bound, shed policy, default
                    TTL, recovery budget); None = defaults (unbounded
                    queue, no TTL, 8 recoveries per request).
    chaos:          a resilience.ChaosSchedule (fault injection at the
                    engine's dispatch sites), "env" (the default: the
                    schedule $REPRO_CHAOS gives, if any) or None.
    prefix_cache:   if set, the page capacity of the cross-request prefix
                    cache (launch/prefix_cache.py): admission reuses
                    pooled prefix pages instead of re-prefilling cached
                    prompt prefixes, bit-identically.  None disables it.
    admit_token_budget: each admission round prefills at most this many
                    UNCACHED prompt tokens (the head-of-queue request
                    always proceeds); the overflow is deferred back to
                    the queue in arrival order, counted in
                    cache_info()["admission"]["deferrals"].
    device:         where the slot state lives and the steps run; "cuda"
                    by default (raises without CUDA, as every entry
                    point of the port).  Under a mesh_scope it must
                    name the place the mesh gave this rank ("cuda" for
                    cuda:r, "cpu" for ranks on the CPU), and raises
                    otherwise.
    spec_decode:    a SpecDecodeConfig: self-speculative decoding rounds
                    instead of segments (module docstring).  Refuses the
                    encdec family, a draft of another family or vocab,
                    and composition with prefill_chunk / prefix_cache,
                    as the reference does.
    """

    def __init__(self, params, cfg, *, n_slots: int = 8,
                 max_cache_len: int = 256, segment_len: int = 16,
                 silvia_passes: str = "off",
                 prefill_chunk: Optional[int] = None,
                 enc_len: Optional[int] = None,
                 min_len_bucket: int = 32, min_batch_bucket: int = 1,
                 resilience: Optional[res.ResilienceConfig] = None,
                 chaos: object = "env",
                 prefix_cache: Optional[int] = None,
                 admit_token_budget: Optional[int] = None,
                 spec_decode=None, device="cuda"):
        if cfg.family == "encdec" and enc_len is None:
            raise ValueError("encdec serving needs enc_len (the fixed "
                             "encoder length of every request's features)")
        if cfg.family != "encdec" and enc_len is not None:
            raise ValueError(f"enc_len is encdec-only, got family "
                             f"{cfg.family!r}")
        init_kwargs = {"s_enc": enc_len} if enc_len is not None else {}
        # raises with registry guidance for unregistered families
        self._spec = slot_state.spec_for(cfg, **init_kwargs)
        if segment_len < 1:
            raise ValueError("segment_len must be >= 1")
        if prefill_chunk is not None and not self._spec.prefill_chunkable:
            raise ValueError(
                f"family {cfg.family!r} slot state is not prefill-chunkable "
                "(models/slot_state.py): use full prefill (prefill_chunk="
                "None)")
        if prefill_chunk is not None and prefill_chunk & (prefill_chunk - 1):
            raise ValueError("prefill_chunk must be a power of two")
        if prefill_chunk is not None and max_cache_len % prefill_chunk:
            # a prompt bucket clamped to the cap must still split into
            # whole chunks, or the prompt tail would be silently dropped
            raise ValueError("max_cache_len must be a multiple of "
                             "prefill_chunk")
        if spec_decode is not None:
            if cfg.family == "encdec":
                raise ValueError("spec_decode does not support encdec "
                                 "serving (draft prefill has no ragged "
                                 "feature path)")
            if spec_decode.draft_cfg.family != cfg.family:
                raise ValueError(
                    f"spec_decode draft must be the SAME family as the "
                    f"target (self-speculation): draft is "
                    f"{spec_decode.draft_cfg.family!r}, target is "
                    f"{cfg.family!r}")
            if spec_decode.draft_cfg.vocab != cfg.vocab:
                raise ValueError("spec_decode draft/target vocab mismatch")
            if prefix_cache is not None or prefill_chunk is not None:
                raise ValueError("spec_decode composes with full-prefill "
                                 "engines only (prefill_chunk=None, "
                                 "prefix_cache=None)")
        # mesh-aware serving: an ambient mesh_scope at construction makes
        # the engine one rank of a sharded engine (module docstring).  The
        # slot axis splits evenly over the dp shards, so the dp size is
        # the batch-bucket floor (admission included; _set_plan)
        plan = _mesh_plan(cfg, self._spec, init_kwargs)
        if plan is not None:
            # the mesh placed this rank (launch/mesh.py init_mesh): the
            # engine's device must name the same place, never replace it
            want, got = torch.device(device), plan.mesh.device
            if want.type != got.type or want.index not in (None, got.index):
                raise ValueError(
                    f"device={str(device)!r}, but the mesh placed rank "
                    f"{plan.mesh.rank} on {got}: pass the mesh's device "
                    f"(init_mesh's device=)")
            self.device = got
        else:
            self.device = device_lib.resolve(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_cache_len = max_cache_len
        self.segment_len = segment_len
        self.silvia_passes = silvia_passes
        self.prefill_chunk = prefill_chunk
        self.enc_len = enc_len
        self.min_len_bucket = min(min_len_bucket, max_cache_len)
        # the caller's floor, before the dp floor: re-applied when a
        # degraded mesh shrinks the dp floor (_degrade)
        self._user_min_batch = min(min_batch_bucket, n_slots)
        self._init_kwargs = init_kwargs
        # the leader / follower control plane (mirrored calls); the site
        # at which a degrade left this rank out of the mesh
        self._mirroring = False
        self._left_at: Optional[str] = None
        # elastic serving (distributed/elastic.py): the mesh's health
        # registry, the time spent re-planning, the serving-clock times
        # of the degrades
        self._health = None if plan is None \
            else delastic.DeviceHealthRegistry(plan.mesh.ranks)
        self._reshard_s = 0.0
        self._degrade_at: List[float] = []
        self._lowerings = dict(registry.fingerprint(self.device))
        self._set_plan(plan)
        # smallest prompt bucket: chunked prefill needs chunk-aligned
        # buckets; full prefill just avoids degenerate tiny shapes
        self.min_prompt_bucket = min(prefill_chunk or 8, max_cache_len)
        self.len_buckets = scheduler.bucket_set(self.min_len_bucket,
                                                max_cache_len) \
            if self._spec.has_length_axis else ()
        # encdec: encoder-length buckets for RAGGED features.  The encoder
        # runs at the request's bucket width; the cross-KV page is padded
        # to the full enc_len (slot pages have ONE constant shape) and the
        # padding is masked to exact softmax zeros, so a short request is
        # bit-identical to itself unpadded
        self.enc_buckets = scheduler.bucket_set(min(8, enc_len), enc_len) \
            if enc_len is not None else ()
        self._queue = scheduler.RequestQueue()
        self._weight_bytes: Dict[str, int] = {}
        self.params = self._whole = params
        if plan is not None:
            # weights: whole, but this rank's attention column slices;
            # slot state: this shard's slots and, under tensor
            # parallelism, its heads
            self._place(plan)
        # per-slot sampling page, host-resident like _tok / _pos, shipped
        # [:bb] into the device buffers before each segment
        self._samp = sampling.host_page(n_slots)
        self._init_device_state()
        self._tok = np.zeros((n_slots, 1), np.int64)
        self._pos = np.zeros((n_slots,), np.int64)
        self._active = np.zeros((n_slots,), bool)
        self._slot_req: List[Optional[scheduler.Request]] = [None] * n_slots
        self._remaining = np.zeros((n_slots,), np.int64)
        self.finished: List[scheduler.Request] = []
        self.total_generated = 0
        self.compactions = 0
        self.segments = 0
        self.occupancy: List[float] = []
        self._graphs: set = set()
        self._res = resilience if resilience is not None \
            else res.ResilienceConfig()
        self._chaos = res.chaos_from_env() if chaos == "env" else chaos
        self._site_counts = {"segment": 0, "prefill": 0, "chunk": 0,
                             "embed": 0, "draft": 0, "verify": 0}
        self.replay_steps = 0
        # per slot: the recorded tokens a recovered request still replays,
        # and the completion tokens a score request still teacher-forces
        # (both drain through the replay step, `_drain_replay`)
        self._replay: List[List[int]] = [[] for _ in range(n_slots)]
        self._score: List[List[int]] = [[] for _ in range(n_slots)]
        self._admitting: List[scheduler.Request] = []
        self._rids: set = set()
        self._results: Dict[int, res.RequestResult] = {}
        self._method_admits: Dict[str, int] = {m: 0
                                               for m in smethods.METHODS}
        self._robust: Dict[str, int] = {k: 0 for k in (
            "shed", "expired_queued", "expired_inflight", "failed",
            "quarantined", "faults_injected", "errors", "recoveries",
            "replayed_tokens", "replay_divergence", "duplicate_rejects",
            "snapshots", "restores", "drains", "degraded",
            "cancelled_queued", "cancelled_inflight")}
        # -- cross-request prefix cache (launch/prefix_cache.py) --
        self._prefix: Optional[pfx.PrefixCache] = None
        if prefix_cache is not None:
            # chain (per-chunk) sharing needs EVERY leaf length-paged:
            # resuming mid-prompt would otherwise skip the sequential
            # updates a constant-size leaf accumulated over the skipped
            # chunks.  Families with any constant-size state still share
            # at exact-full-prompt (terminal) granularity
            chain_ok = prefill_chunk is not None and all(
                la is not None for la in self._spec.length_axes)
            self._prefix = pfx.PrefixCache(
                prefix_cache, chunk=prefill_chunk, chain_ok=chain_ok,
                salt=f"{cfg.family}:{prefill_chunk}")
            if plan is not None:
                # the mesh this pool serves (info()'s fingerprint)
                self._prefix.note_remesh(plan.key)
        # keys pinned in the pool per slot, released at eviction; and the
        # pins an admission holds before its slots own them
        self._slot_pins: List[tuple] = [()] * n_slots
        self._admit_pins: List[tuple] = []
        # -- admission fairness (token budget) --
        self._admit_budget = admit_token_budget
        self._deferrals = 0
        # -- self-speculative decoding (SpecDecodeConfig) --
        self._sd = spec_decode
        self._spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0,
                            "emitted": 0, "target_dispatches": 0}
        if spec_decode is not None:
            self._init_draft(spec_decode)

    def _set_plan(self, plan: Optional[_MeshPlan]) -> None:
        """Lay the engine over `plan` (None: one device): this rank's dp
        shard, the batch-bucket floors, the control plane, whether steps
        are captured, and the decode bundle.  At construction and after
        a degrade."""
        self._plan = plan
        n_slots = self.n_slots
        self.min_batch_bucket = self._user_min_batch
        self._adm_floor = 1
        # this rank's dp shard: global slot s lives on shard s % dp at
        # local row s // dp (one shard, every slot, with no mesh)
        self._dp, self._d = 1, 0
        self._ctl = None
        if plan is not None:
            dp = plan.dp_size
            scheduler.validate_slot_sharding(n_slots, dp)
            self.min_batch_bucket = min(max(self.min_batch_bucket, dp),
                                        n_slots)
            self._adm_floor = min(dp, n_slots)
            self._dp, self._d = dp, plan.dp_index
            if plan.mesh.size > 1:
                self._ctl = plan.mesh
        # steps with collectives are captured only where the backend can
        # hold them in a graph (NCCL); over gloo every step runs eagerly
        self._capture = plan is None or plan.mesh.captures_collectives
        self._n_loc = n_slots // self._dp
        self.batch_buckets = scheduler.bucket_set(self.min_batch_bucket,
                                                  n_slots)
        self._bundle = _engine_bundle(self.cfg, self.silvia_passes,
                                      self.device, plan)

    def _place(self, plan: _MeshPlan) -> None:
        """This rank's weights under `plan` (`_place_params`) from
        `_whole`, which then becomes what the next re-plan places from:
        the weights themselves where they are whole on the device, else
        them with host copies of the whole attention projections (whose
        bytes `cache_info()` reports).  At construction and after a
        degrade."""
        self.params, self._weight_bytes = _place_params(
            self._whole, self.cfg, plan, self.device)
        self._whole = _host_attention(self._whole) if plan.tp.attn \
            else self.params
        self._weight_bytes["host_whole_attention"] = 0 \
            if self._whole is self.params else _attention_bytes(self._whole)

    def _init_device_state(self) -> None:
        """The slot state, the per-slot device buffers, the gathered
        copies the host reads on a mesh, and no captured step yet: all
        shaped by this shard's slot count and, under tensor parallelism,
        its heads.  At construction and after a degrade (the in-place
        reset of `_recover` keeps them otherwise)."""
        dev, n_loc, n_slots = self.device, self._n_loc, self.n_slots
        seg = self.segment_len
        self._cache = self._init_state(self._spec, n_loc,
                                       self.max_cache_len)
        self._bufs = {
            "tok": torch.zeros((n_loc, 1), dtype=torch.int64, device=dev),
            "pos": torch.zeros((n_loc,), dtype=torch.int64, device=dev),
            "act": torch.zeros((n_loc,), dtype=torch.bool, device=dev),
            "samp": sampling.null_operand(n_loc, dev),
            "toks": torch.zeros((n_loc, seg), dtype=torch.int32,
                                device=dev),
            "bad": torch.zeros((n_loc,), dtype=torch.bool, device=dev),
            "step": torch.zeros((1,), dtype=torch.int64, device=dev),
        }
        # what the host reads a segment's results from: the buffers
        # themselves, or on a mesh their all-gathered global copies
        self._out = self._bufs if self._plan is None else {
            "tok": torch.zeros((n_slots, 1), dtype=torch.int64, device=dev),
            "pos": torch.zeros((n_slots,), dtype=torch.int64, device=dev),
            "toks": torch.zeros((n_slots, seg), dtype=torch.int32,
                                device=dev),
            "bad": torch.zeros((n_slots,), dtype=torch.bool, device=dev),
        }
        self._gathers: Dict[tuple, _Gather] = {}
        self._segments: Dict[tuple, serve._CapturedStep] = {}
        self._chunks: Dict[tuple, _ChunkStep] = {}
        # the replay step per (bb, t_b) (`_replay_step_for`)
        self._replays: Dict[tuple, _ChunkStep] = {}
        self._rounds: Dict[tuple, _SpecRound] = {}
        self._dreplays: Dict[tuple, _ChunkStep] = {}

    def _drop_device_state(self) -> None:
        """Release every tensor shaped by the old plan before a degrade
        builds the new one (or, on a rank the plan leaves out, for
        good)."""
        self._cache = self._bufs = self._out = None
        self._gathers, self._segments, self._chunks = {}, {}, {}
        self._replays, self._rounds, self._dreplays = {}, {}, {}
        if self._sd is not None:
            self._draft_cache = self._sbufs = self._draft_params = None

    def _init_draft(self, sd: SpecDecodeConfig) -> None:
        """The draft's decode function, its slot state (its own, in place
        for the engine's lifetime, as the target's) and the round
        buffers (_SpecRound), each [n_slots, ...] (this shard's slots on
        a mesh); the snapshot stacks only for constant-size leaves: k + 1
        copies of each.  On a mesh the draft has a plan of its own (its
        head counts decide its tensor parallelism) and its weights are
        placed as the target's."""
        n, k1, dev = self._n_loc, sd.k + 1, self.device
        self._draft_spec = slot_state.spec_for(sd.draft_cfg)
        self._draft_plan = None if self._plan is None else _mesh_plan(
            sd.draft_cfg, self._draft_spec, {})
        self._draft_bundle = _engine_bundle(sd.draft_cfg,
                                            self.silvia_passes, dev,
                                            self._draft_plan)
        self._draft_params = sd.draft_params
        if self._draft_plan is not None:
            self._draft_params, _ = _place_params(
                sd.draft_params, sd.draft_cfg, self._draft_plan, dev)
        self._draft_cache = self._init_state(
            self._draft_spec, n, self.max_cache_len, self._draft_plan)

        def snaps(spec, state):
            return tuple(torch.zeros((k1,) + tuple(leaf.shape),
                                     dtype=leaf.dtype, device=dev)
                         for leaf in spec.const_leaves(state))

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._sbufs = {
            "x": zeros(n, k1 + 1), "g": zeros(n, k1),
            "gbad": zeros(n, k1, dtype=torch.bool), "dpos": zeros(n),
            "out": zeros(n, k1 + 3), "dstep": zeros(1), "vstep": zeros(1),
            "tsnaps": snaps(self._spec, self._cache),
            "dsnaps": snaps(self._draft_spec, self._draft_cache),
        }
        if self._plan is not None:
            self._sbufs["gout"] = zeros(self.n_slots, k1 + 3)

    def _init_state(self, spec, n: int, t: int, plan="target"):
        """Fresh slot pages of n rows and length t on the engine's device,
        made under the plan's tensor-parallel scope (local heads)."""
        plan = self._plan if plan == "target" else plan
        with contextlib.nullcontext() if plan is None else plan.tp_scope():
            return spec.init_state(n, t, self.device)

    def _tp(self):
        """The target's tensor-parallel scope (a null context off a
        mesh): every eager model call runs inside it."""
        return contextlib.nullcontext() if self._plan is None \
            else self._plan.tp_scope()

    def _rows(self, host: np.ndarray, bb: int) -> np.ndarray:
        """This shard's rows of the global host rows [:bb] (every
        dp-th, from its index)."""
        return host[:bb][self._d::self._dp]

    def _route(self, owners: np.ndarray):
        """Admission routing: request i goes to shard owners[i].  Returns
        (this shard's request indices, the local batch bucket -- the
        largest shard's count, bucketed -- and, per request, its row in
        the shard-major all-gather of the shards' outputs)."""
        counts = np.bincount(owners, minlength=self._dp)
        bbl = scheduler.bucket_pow2(int(counts.max()), minimum=1,
                                    maximum=self._n_loc)
        within = np.zeros_like(owners)
        seen = np.zeros(self._dp, np.int64)
        for i, o in enumerate(owners):
            within[i] = seen[o]
            seen[o] += 1
        mine = np.nonzero(owners == self._d)[0]
        return mine, bbl, owners * bbl + within

    def _gather_out(self, t):
        """Shard-major all-gather over the dp axes (identity off a
        mesh)."""
        return t if self._plan is None else self._plan.gather(t)

    # -- request lifecycle --------------------------------------------------

    @_mirrored
    def submit(self, req: scheduler.Request) -> str:
        """Validate and enqueue; returns resilience.QUEUED, or
        resilience.SHED when the bounded queue rejects the newcomer under
        the reject-new policy (under drop-oldest the VICTIM is shed and
        the newcomer queued).  Malformed requests and duplicate rids
        raise: those are caller bugs, not load conditions."""
        if req.rid in self._rids:
            self._robust["duplicate_rejects"] += 1
            raise ValueError(
                f"duplicate request id {req.rid}: this engine already "
                f"tracks that rid (rids key structured results and "
                f"recovery requeues)")
        if req.served_len > self.max_cache_len:
            raise ValueError(
                f"request {req.rid}: prompt+gen {req.served_len} exceeds "
                f"max_cache_len {self.max_cache_len}")
        if self.cfg.family == "encdec":
            shape = None if req.features is None \
                else np.asarray(req.features).shape
            if shape is None or len(shape) != 2 \
                    or shape[1] != self.cfg.d_model \
                    or not 1 <= shape[0] <= self.enc_len:
                raise ValueError(
                    f"request {req.rid}: encdec serving needs features of "
                    f"shape [1..enc_len={self.enc_len}, "
                    f"{self.cfg.d_model}], got {shape}")
        elif req.features is not None:
            raise ValueError(f"request {req.rid}: features are encdec-only "
                             f"(family {self.cfg.family!r})")
        if req.deadline is None and self._res.default_ttl_s is not None:
            req.deadline = req.arrival_time + self._res.default_ttl_s
        cap = self._res.max_queue
        if cap is not None and len(self._queue) >= cap:
            if self._res.shed_policy == "reject-new":
                self._robust["shed"] += 1
                self._rids.add(req.rid)
                self._finish(req, req.arrival_time, res.SHED,
                             f"queue full ({cap} queued), policy "
                             f"reject-new")
                return res.SHED
            victim = self._queue.pop_oldest()       # drop-oldest
            if victim is not None:
                self._robust["shed"] += 1
                self._finish(victim, req.arrival_time, res.SHED,
                             f"queue full ({cap} queued), policy "
                             f"drop-oldest")
        self._rids.add(req.rid)
        self._queue.submit(req)
        return res.QUEUED

    def _finish(self, req: scheduler.Request, now: float,
                outcome: str = res.OK,
                error: Optional[str] = None) -> None:
        req.finish_time = now
        req.outcome = outcome
        req.error = error
        if outcome == res.FAILED:
            self._robust["failed"] += 1
        self.finished.append(req)
        self._results[req.rid] = res.RequestResult(
            rid=req.rid, outcome=outcome, tokens=list(req.tokens),
            error=error, retries=req.retries,
            logprobs=list(req.logprobs) if req.logprobs else None,
            embedding=None if req.embedding is None
            else np.asarray(req.embedding, np.float32))

    def _evict(self, slot: int) -> None:
        """Free a page: no scrubbing needed (see module docstring)."""
        self._active[slot] = False
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._replay[slot] = []
        self._score[slot] = []
        sampling.clear_row(self._samp, slot)
        if self._prefix is not None and self._slot_pins[slot]:
            self._prefix.release(self._slot_pins[slot])
        self._slot_pins[slot] = ()

    @staticmethod
    def _stopped(req: scheduler.Request, tok: int) -> bool:
        return bool(req.stop_tokens) and tok in req.stop_tokens

    # -- admission / prefill ------------------------------------------------

    def _compact(self) -> bool:
        """Remap surviving slots downward when eviction holes inflate the
        live batch bucket (the permutation is exact: slot identity is
        pure bookkeeping, every per-slot array moves together)."""
        live = np.nonzero(self._active)[0]
        if live.size == 0 or int(live[-1]) == live.size - 1:
            return False          # already a dense prefix
        # per dp shard: its live slots first, then its holes; a slot never
        # leaves its shard (one shard, a dense prefix, off a mesh)
        dp = self._dp
        act = self._active.reshape(self._n_loc, dp)
        local = [np.concatenate([np.nonzero(act[:, d])[0],
                                 np.nonzero(~act[:, d])[0]])
                 for d in range(dp)]
        perm = np.stack(local, axis=1).reshape(-1) * dp \
            + np.tile(np.arange(dp), self._n_loc)
        cur = scheduler.bucket_pow2(int(live[-1]) + 1,
                                    minimum=self.min_batch_bucket,
                                    maximum=self.n_slots)
        hi = max((int(act[:, d].sum()) - 1) * dp + d + 1
                 for d in range(dp) if act[:, d].any())
        tgt = scheduler.bucket_pow2(hi, minimum=self.min_batch_bucket,
                                    maximum=self.n_slots)
        if cur <= tgt:
            return False          # hole doesn't change the bucket
        self._spec.permute_slots(self._cache, local[self._d])
        self._samp = sampling.permute(self._samp, perm)
        self._tok = self._tok[perm]
        self._pos = self._pos[perm]
        self._active = self._active[perm]
        self._remaining = self._remaining[perm]
        self._slot_req = [self._slot_req[i] for i in perm]
        self._replay = [self._replay[i] for i in perm]
        self._score = [self._score[i] for i in perm]
        self._slot_pins = [self._slot_pins[i] for i in perm]
        if self._sd is not None:
            self._draft_spec.permute_slots(self._draft_cache,
                                           local[self._d])
        self.compactions += 1
        return True

    def _admit(self, now: float, clock: scheduler.Clock,
               resume_only: bool = False) -> int:
        self._compact()
        # resume_only (drain): only requests a recovery requeued -- with
        # emitted tokens (generate) or a retry count (score and embed
        # leave no token trail) -- are taken; fresh ones keep their place
        pred = (lambda r: bool(r.tokens) or r.retries > 0) \
            if resume_only else None
        # embeds admit first and apart: one prefill-shaped launch each
        # group, no decode slot, so they admit while every slot is busy
        # and never count against the free slots or the token budget
        embeds = self._queue.pop_ready(
            now, limit=self.n_slots,
            predicate=lambda r: r.method == "embed"
            and (pred is None or pred(r)))
        n_embed = self._admit_embed(embeds, clock) if embeds else 0
        free = [i for i in range(self.n_slots) if not self._active[i]]
        ready = self._queue.pop_ready(
            now, limit=len(free),
            predicate=lambda r: r.method != "embed"
            and (pred is None or pred(r)))
        if ready and self._admit_budget is not None:
            ready = self._defer_over_budget(ready)
        if not ready:
            return n_embed
        # popped but not yet registered in a slot: a fault mid-admission
        # leaves the rest here for _recover to requeue
        self._admitting = list(ready)
        # group by (prompt bucket, enc bucket): one prefill shape per
        # (batch bucket, prompt bucket[, enc bucket]) covers the mix
        groups: Dict[tuple, List[scheduler.Request]] = {}
        for r in ready:
            groups.setdefault((self._prompt_bucket(r.prompt_len),
                               self._enc_bucket(r)), []).append(r)
        for (sb, eb), group in sorted(
                groups.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0)):
            self._admit_group(group, sb, eb, free, clock)
        self._admitting = []
        return len(ready) + n_embed

    def _admit_embed(self, group: List[scheduler.Request],
                     clock: scheduler.Clock) -> int:
        """Serve embed requests: per (prompt bucket, enc bucket) group, one
        pooled-embedding launch (`lm.embed_pool`) whose vectors finish
        each request at once.  No slot state is touched, so embeds run
        beside a full decode batch; a non-finite vector is quarantined."""
        self._admitting = list(group)
        groups: Dict[tuple, List[scheduler.Request]] = {}
        for r in group:
            groups.setdefault((self._prompt_bucket(r.prompt_len),
                               self._enc_bucket(r)), []).append(r)
        for (sb, eb), g in sorted(
                groups.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0)):
            # an embed takes no slot: the batch is dealt over the dp
            # shards cyclically
            mine, bbl, at = self._route(np.arange(len(g)) % self._dp)
            inputs, lens = self._prefill_inputs([g[i] for i in mine], bbl,
                                                sb, eb)
            self._graphs.add(self._embed_key(bbl * self._dp, sb, eb))
            emb, bad = self._guarded("embed", self._embed, inputs, lens)
            at = torch.as_tensor(at, device=self.device)
            emb = self._gather_out(emb)[at].cpu().numpy()
            bad = self._gather_out(bad)[at].cpu().numpy()
            now = clock.now()
            for i, r in enumerate(g):
                self._admitting = [x for x in self._admitting if x is not r]
                self._method_admits["embed"] += 1
                if bad[i]:
                    self._robust["quarantined"] += 1
                    self._finish(r, now, res.FAILED,
                                 "non-finite pooled embedding")
                    continue
                r.embedding = emb[i]
                r.first_token_time = now
                self._finish(r, now)
        self._admitting = []
        return len(group)

    @staticmethod
    def _embed_key(bb: int, sb: int, eb: Optional[int]) -> tuple:
        return ("embed", bb, sb) + (() if eb is None else (eb,))

    def _embed(self, inputs, lens: np.ndarray):
        """One pooled-embedding launch: (vectors [bb, d_model] f32, bad
        [bb]).  encdec inputs are (features, tokens, enc_lengths)."""
        last_pos = torch.as_tensor(lens - 1, device=self.device)
        with self._tp():
            if self.cfg.family == "encdec":
                audio, tokens, enc_lens = inputs
                emb = lm.embed_pool(self.params, (audio, tokens), self.cfg,
                                    last_positions=last_pos,
                                    enc_lengths=enc_lens)
            else:
                emb = lm.embed_pool(self.params, inputs, self.cfg,
                                    last_positions=last_pos)
        return emb, ~torch.isfinite(emb).all(dim=-1)

    def _enc_bucket(self, r: scheduler.Request) -> Optional[int]:
        if self.cfg.family != "encdec":
            return None
        return scheduler.bucket_pow2(int(np.asarray(r.features).shape[0]),
                                     minimum=self.enc_buckets[0],
                                     maximum=self.enc_len)

    def _defer_over_budget(
            self, ready: List[scheduler.Request]) -> List[scheduler.Request]:
        """Admission fairness: take ready requests in queue order until
        their summed UNCACHED prompt tokens exceed admit_token_budget,
        then defer the rest back to the queue (ordered re-insertion keeps
        arrival order).  The head request always proceeds: an
        over-budget prompt would stall behind the budget forever
        otherwise.  With the prefix cache on, a request costs its
        uncached tail only (a peek: the probe moves no counter and no LRU
        order)."""
        take, spent = [], 0
        for r in ready:
            cost = r.prompt_len
            if self._prefix is not None:
                cost -= min(self._prefix.peek_cached_tokens(r), cost)
            if take and spent + cost > self._admit_budget:
                break
            take.append(r)
            spent += cost
        for r in ready[len(take):]:
            self._deferrals += 1
            self._queue.submit(r)
        return take

    def _prompt_bucket(self, n: int) -> int:
        return scheduler.bucket_pow2(n, minimum=self.min_prompt_bucket,
                                     maximum=self.max_cache_len)

    def _prefill_bucket(self, sb: int) -> int:
        """The prefill's cache_len.  Families without a length axis get
        cache_len == sb (unused by their blocks)."""
        if not self._spec.has_length_axis:
            return sb
        return scheduler.bucket_pow2(sb, minimum=self.min_len_bucket,
                                     maximum=self.max_cache_len)

    @staticmethod
    def _prompt_page(group: List[scheduler.Request], bb: int, sb: int):
        """(prompts [bb, sb] right-padded with 0, lens [bb]) on the host;
        padding rows have length 1."""
        prompts = np.zeros((bb, sb), np.int64)
        lens = np.ones((bb,), np.int64)
        for i, r in enumerate(group):
            prompts[i, :r.prompt_len] = r.prompt
            lens[i] = r.prompt_len
        return prompts, lens

    def _prefill_inputs(self, group: List[scheduler.Request], bb: int,
                        sb: int, eb: Optional[int] = None):
        prompts, lens = self._prompt_page(group, bb, sb)
        tokens = torch.as_tensor(prompts, device=self.device)
        if self.cfg.family != "encdec":
            return tokens, lens
        # ragged features, right-padded to the group's enc bucket; the
        # real frame counts ride along and mask the padding to exact
        # zeros inside the encoder and the cross-attention
        eb = eb or self.enc_len
        feats = np.zeros((bb, eb, self.cfg.d_model), np.float32)
        enc_lens = np.ones((bb,), np.int64)
        for i, r in enumerate(group):
            f = np.asarray(r.features, np.float32)
            feats[i, :f.shape[0]] = f
            enc_lens[i] = f.shape[0]
        return (torch.as_tensor(feats, device=self.device), tokens,
                torch.as_tensor(enc_lens, device=self.device)), lens

    def _warmup_prefill_inputs(self, bb: int, sb: int,
                               eb: Optional[int] = None):
        tokens = torch.zeros((bb, sb), dtype=torch.int64, device=self.device)
        if self.cfg.family != "encdec":
            return tokens
        eb = eb or self.enc_len
        return (torch.zeros((bb, eb, self.cfg.d_model), dtype=torch.float32,
                            device=self.device), tokens,
                torch.full((bb,), eb, dtype=torch.int64, device=self.device))

    def _prefill(self, inputs, lens: np.ndarray, t_pre: int):
        """One bucketed full prefill: (tok0 [bb] greedy, last [bb, V] f32,
        the prefilled rows' state, bad0 [bb]).  encdec inputs are
        (features, tokens, enc_lengths); its cross K/V come out padded to
        enc_len."""
        last_pos = torch.as_tensor(lens - 1, device=self.device)
        with self._tp():
            if self.cfg.family == "encdec":
                audio, tokens, enc_lens = inputs
                logits, rows = lm.prefill(
                    self.params, (audio, tokens), self.cfg,
                    cache_len=t_pre, last_positions=last_pos,
                    enc_lengths=enc_lens, enc_pad=self.enc_len)
            else:
                logits, rows = lm.prefill(self.params, inputs, self.cfg,
                                          cache_len=t_pre,
                                          last_positions=last_pos)
        last = logits[:, -1, :]
        return (last.argmax(dim=-1), last, rows,
                ~torch.isfinite(last).all(dim=-1))

    def _draft_prefill(self, inputs, lens: np.ndarray, t_pre: int):
        """The draft's full prefill of the target's prefill inputs: the
        prefilled rows' draft state (its logits are not needed)."""
        plan = self._draft_plan
        with contextlib.nullcontext() if plan is None else plan.tp_scope():
            _, rows = lm.prefill(self._draft_params, inputs,
                                 self._sd.draft_cfg, cache_len=t_pre,
                                 last_positions=torch.as_tensor(
                                     lens - 1, device=self.device))
        return rows

    def _graph_key(self, bb: int, sb: int, t_pre: int,
                   eb: Optional[int]) -> tuple:
        """The census key of a full prefill, or of the chunk step a
        chunked engine prefills (bb, sb) with."""
        if self.prefill_chunk is not None:
            return ("chunk", bb, min(self.prefill_chunk, sb), t_pre)
        return ("prefill", bb, sb, t_pre) + (() if eb is None else (eb,))

    def _admit_group(self, group: List[scheduler.Request], sb: int,
                     eb: Optional[int], free: List[int],
                     clock: scheduler.Clock) -> None:
        g = len(group)
        t_pre = self._prefill_bucket(sb)
        if self._prefix is None:
            slots = np.asarray([free.pop(0) for _ in range(g)], np.int64)
            # each request prefills on the dp shard that owns its slot
            # (every request here, off a mesh), in a batch bucketed by
            # the largest shard's count; the pages never cross ranks
            mine, bbl, at = self._route(slots % self._dp)
            sub = [group[i] for i in mine]
            bb = bbl * self._dp
            if self.prefill_chunk is None:
                inputs, lens = self._prefill_inputs(sub, bbl, sb, eb)
                self._graphs.add(self._graph_key(bb, sb, t_pre, eb))
                tok0, last, rows, bad0 = self._guarded(
                    "prefill", self._prefill, inputs, lens, t_pre)
            else:
                prompts, lens = self._prompt_page(sub, bbl, sb)
                tok0, last, rows, bad0 = self._chunked_prefill(
                    prompts, lens, t_pre)
            # every shard's first tokens, flags and last logits rows, in
            # group order
            at = torch.as_tensor(at, device=self.device)
            tok0 = self._gather_out(tok0)[at].cpu().numpy()
            bad0 = self._gather_out(bad0)[at].cpu().numpy()
            last = self._gather_out(last)[at]
            # scatter the admitted pages into their slots; leaves without
            # a length axis (SSM / conv state, cross K/V) are reset whole
            local = slots[mine] // self._dp
            self._spec.admit(self._cache, rows, local, len(mine),
                             t_pre=t_pre)
            del rows
            if self._sd is not None:
                # the draft prefills the same prompts in the same bucket
                # into the same slots: draft and target share self._pos
                # from admission through every round and replay
                self._graphs.add(("dprefill", bb, sb, t_pre))
                d_rows = self._guarded("draft", self._draft_prefill,
                                       inputs, lens, t_pre)
                self._draft_spec.admit(self._draft_cache, d_rows, local,
                                       len(mine), t_pre=t_pre)
                del d_rows
            pins: List[tuple] = [()] * g
        elif self.prefill_chunk is not None:
            tok0, bad0, slots, pins, last = self._prefix_admit_chunked(
                group, sb, t_pre, free)
        else:
            tok0, bad0, slots, pins, last = self._prefix_admit_full(
                group, sb, eb, t_pre, free)
        # registration time is read AFTER the admitting launches (the
        # device syncs above), so a request's TTFT includes its prefill:
        # the time a prefix hit saves
        self._register_admitted(group, tok0, bad0, slots, pins, free,
                                clock.now(), last)

    def _register_admitted(self, group: List[scheduler.Request],
                           tok0: np.ndarray, bad0: np.ndarray,
                           slots: np.ndarray, pins: List[tuple],
                           free: List[int], now: float, last) -> None:
        """Per-request bookkeeping once a group's pages are in their
        slots, shared by the cold and the prefix-cache admissions:
        quarantine, a score request's first logprob, the replay of a
        recovered request, the fresh stream's start.  `last` gives each
        row's final prefill logits (a [bb, V] tensor or an {index: row}
        dict); a sampled request's first token is sampled from its row,
        and a score request's first logprob read from it (neither takes
        the terminal-hit shortcut, so their row is always there)."""
        tok0 = np.array(tok0).reshape(-1)
        self._admit_pins = []
        for i, r in enumerate(group):
            slot = int(slots[i])
            self._admitting = [x for x in self._admitting if x is not r]
            self._method_admits[r.method] += 1
            if bad0[i]:
                # the slot never owned its pins: release them directly
                if self._prefix is not None and pins[i]:
                    self._prefix.release(pins[i])
                self._robust["quarantined"] += 1
                self._finish(r, now, res.FAILED,
                             "non-finite logits at prefill")
                self._scrub(slot)
                free.append(slot)
                free.sort()
                continue
            # pins transfer to the slot BEFORE any eviction below, so
            # _evict is the single release point for owned pins
            self._slot_pins[slot] = tuple(pins[i])
            if r.method == "generate" and not sampling.is_greedy(r):
                # the first token at generated-token index 0, sampled from
                # this row alone (the sampler is per-row: bitwise the
                # batch row's); the pool keeps the GREEDY token
                tok0[i] = sampling.expected_token(r, last[i], 0)
            sampling.write_row(self._samp, slot, r)
            if r.method == "score":
                # teacher-forced scoring: the prefill's last logits row is
                # the distribution completion[0] is scored under; the rest
                # of the completion drains through the replay step.  A
                # recovery's re-admission recomputes the same rows, so the
                # logprobs start afresh
                comp = list(r.score_tokens)
                row = last[i].to(torch.float32).cpu().numpy()
                r.logprobs = [smethods.logprob_from_logits(row, comp[0])]
                if r.first_token_time is None:
                    r.first_token_time = now
                if len(comp) == 1:
                    self._finish(r, now)
                    self._evict(slot)
                    free.append(slot)
                    free.sort()
                    continue
                self._slot_req[slot] = r
                self._active[slot] = True
                self._pos[slot] = r.prompt_len
                self._tok[slot] = comp[0]
                self._remaining[slot] = 0
                self._score[slot] = comp[1:]
                continue
            if r.tokens:
                # recovery as replay: a request _recover requeued with its
                # emitted tokens.  The prefill above repeated its first
                # admission's (the same prompt, bucket and steps); check
                # the first token and replay the rest of the recorded
                # stream through the decode step (_drain_replay)
                if int(tok0[i]) != r.tokens[0]:
                    self._robust["replay_divergence"] += 1
                self._slot_req[slot] = r
                self._active[slot] = True
                self._pos[slot] = r.prompt_len
                self._tok[slot] = r.tokens[0]
                self._remaining[slot] = r.max_new_tokens - len(r.tokens)
                self._replay[slot] = r.tokens[1:]
                continue
            r.tokens = [int(tok0[i])]
            r.first_token_time = now
            self.total_generated += 1
            if r.max_new_tokens == 1 or self._stopped(r, r.tokens[0]):
                self._finish(r, now)
                self._evict(slot)
                free.append(slot)
                free.sort()
                continue
            self._slot_req[slot] = r
            self._active[slot] = True
            self._pos[slot] = r.prompt_len
            self._tok[slot] = tok0[i]
            self._remaining[slot] = r.max_new_tokens - 1

    # -- the prefix cache ---------------------------------------------------

    def _concat_pages(self, entries: List[pfx.Entry]) -> list:
        """Consecutive chain entries' pages concatenated along each leaf's
        length axis, on the host (chain entries exist only for
        all-length-paged families, so no leaf is None)."""
        out = []
        for j, la in enumerate(self._spec.length_axes):
            ps = [e.pages[j] for e in entries]
            out.append(ps[0] if len(ps) == 1 else torch.cat(ps, dim=la))
        return out

    def _chunk_pages(self, span: list, j: int, c: int) -> list:
        """Chunk j of an extracted multi-chunk span, on the host."""
        return [None if p is None else
                p.narrow(la, j * c, c).clone()
                for la, p in zip(self._spec.length_axes, span)]

    def _every_row(self, state):
        """Every dp shard's rows of a prefill state, shard-major along
        each leaf's slot axis (row `at` of `_route`): on a mesh the pool
        takes a miss's pages from whichever shard computed them, so that
        every rank pools every entry -- its own heads of it (the state
        itself off a mesh, or with one dp shard)."""
        if self._dp == 1:
            return state
        leaves, treedef = pytree.tree_flatten(state)
        return pytree.tree_unflatten(
            [self._plan.gather(leaf, ba)
             for leaf, ba in zip(leaves, self._spec.batch_axes)], treedef)

    def _prefix_admit_full(self, group: List[scheduler.Request], sb: int,
                           eb: Optional[int], t_pre: int,
                           free: List[int]):
        """Prefix-cache admission for full-prefill engines (every family,
        sequential-state ones included): an exact repeat (terminal hit)
        copies its pooled pages -- KV rows plus constant-size state
        snapshots -- into the slot, in place, and makes NO prefill
        launch; the misses prefill as one smaller bucketed sub-group
        (batch composition cannot perturb a row) and donate their pages
        to the pool.  On a mesh every rank keeps the same pool (the same
        lookups, pins and evictions, run by the same scheduler), each
        entry holding its own heads: a hit is written by the shard that
        owns the slot, and a miss prefills on it (`_route`)."""
        g = len(group)
        slots = np.asarray([free.pop(0) for _ in range(g)], np.int64)
        tok0 = np.zeros((g,), np.int64)
        bad0 = np.zeros((g,), bool)
        pins: List[tuple] = [()] * g
        last: Dict[int, torch.Tensor] = {}
        miss_idx: List[int] = []
        for i, r in enumerate(group):
            # a score or sampled request needs its final logits row, which
            # pooled pages don't carry: it always takes the prefill path
            # (and still donates its pages for later greedy hits); a score
            # request skips the lookup, which keeps its traffic out of the
            # pool's stats and LRU order
            hit = self._prefix.lookup(r) \
                if r.method != "score" and sampling.is_greedy(r) else None
            if hit is None or hit.terminal is None:
                miss_idx.append(i)
                continue
            ent = hit.terminal
            if slots[i] % self._dp == self._d:
                self._spec.write_row_pages(
                    self._cache, int(slots[i]) // self._dp, 0, ent.pages)
            tok0[i] = ent.tok0
            pins[i] = self._prefix.pin([ent.key])
            self._admit_pins.append(pins[i])
            self._prefix.note_skip(r.prompt_len)
        if miss_idx:
            sub = [group[i] for i in miss_idx]
            sub_slots = slots[np.asarray(miss_idx, np.int64)]
            mine, bbl, at = self._route(sub_slots % self._dp)
            inputs, lens = self._prefill_inputs([sub[k] for k in mine], bbl,
                                                sb, eb)
            self._graphs.add(self._graph_key(bbl * self._dp, sb, t_pre, eb))
            stok0, slast, rows, sbad0 = self._guarded(
                "prefill", self._prefill, inputs, lens, t_pre)
            at_d = torch.as_tensor(at, device=self.device)
            stok0 = self._gather_out(stok0)[at_d].cpu().numpy()
            sbad0 = self._gather_out(sbad0)[at_d].cpu().numpy()
            slast = self._gather_out(slast)[at_d]
            self._spec.admit(self._cache, rows, sub_slots[mine] // self._dp,
                             len(mine), t_pre=t_pre)
            every = self._every_row(rows)
            for j, i in enumerate(miss_idx):
                tok0[i] = stok0[j]
                bad0[i] = sbad0[j]
                last[i] = slast[j]
                if not sbad0[j]:
                    r = group[i]
                    self._prefix.insert_terminal(
                        r, self._spec.extract_row_pages(
                            every, int(at[j]), 0, r.prompt_len),
                        int(stok0[j]))
        return tok0, bad0, slots, pins, last

    def _prefix_admit_chunked(self, group: List[scheduler.Request],
                              sb: int, t_pre: int, free: List[int]):
        """Prefix-cache admission for chunked-prefill engines: each row
        resumes at its first uncached chunk -- pooled chunk pages are
        copied in below the resume point (copy-on-write: everything at or
        past it is computed into the row's private pages) -- and a chunk
        launch is skipped outright once every row is past it.  The rows
        that do run go through the SAME captured ("chunk", bb, c, t_pre)
        step as a cold admission; copied pages are bitwise what this
        row's own chunks would have written (KV purity), and masking
        hides batch composition, so the harvested logits -- and every
        later token -- are bit-identical to the cold path.  On a mesh
        each request's rows run on the shard that owns its slot
        (`_route`), every shard launching every chunk that any row needs,
        and the pool is every rank's, as in `_prefix_admit_full`."""
        g = len(group)
        slots = np.asarray(free[:g], np.int64)
        mine, bbl, at = self._route(slots % self._dp)
        local = {int(i): b for b, i in enumerate(mine)}
        c = min(self.prefill_chunk, sb)
        n_chunks = sb // c
        prompts, lens = self._prompt_page([group[i] for i in mine], bbl, sb)
        last_chunk = np.asarray([(r.prompt_len - 1) // c for r in group],
                                np.int64)
        step = self._chunk_step(bbl, c, t_pre)
        step.reset()
        cache = step.state
        resume = np.full((g,), n_chunks, np.int64)
        term: List[Optional[pfx.Entry]] = [None] * g
        n_chain = [0] * g
        pin_keys: List[List[bytes]] = [[] for _ in range(g)]
        for i, r in enumerate(group):
            if r.method == "score":
                # score needs the final logits row: every chunk runs cold
                # (resume 0; its pages still donate to the pool), with no
                # lookup to move the pool's stats or LRU order
                resume[i] = 0
                continue
            hit = self._prefix.lookup(r)
            if hit.terminal is not None and sampling.is_greedy(r):
                # the terminal shortcut is greedy-only: the pooled tok0 is
                # the argmax token.  A sampled request still rides any
                # chain hits below and re-runs its final chunk, which
                # recovers the logits row its tok0 is sampled from
                if i in local:
                    self._spec.write_row_pages(cache, local[i], 0,
                                               hit.terminal.pages)
                term[i] = hit.terminal
                pin_keys[i].append(hit.terminal.key)
                self._prefix.note_skip(r.prompt_len)
                continue
            if hit.chain and i in local:
                # one write per leaf for the whole cached span
                self._spec.write_row_pages(cache, local[i], 0,
                                           self._concat_pages(hit.chain))
            pin_keys[i].extend(ent.key for ent in hit.chain)
            n_chain[i] = len(hit.chain)
            # resume at the first uncached chunk; a chain covering the
            # final chunk still re-runs it (rewriting identical bits) to
            # recover the first-token logits
            resume[i] = min(len(hit.chain), int(last_chunk[i]))
            self._prefix.note_skip(int(resume[i]) * c)
        rows: List[Optional[torch.Tensor]] = [None] * bbl
        for k in range(n_chunks):
            act_g = (resume <= k) & (k <= last_chunk)
            if not act_g.any():
                continue    # every row is past this chunk: no launch
            act = np.zeros((bbl,), bool)
            act[:len(mine)] = act_g[mine]
            self._graphs.add(("chunk", bbl * self._dp, c, t_pre))
            logits = self._guarded("chunk", step.run,
                                   prompts[:, k * c:(k + 1) * c], k * c, act)
            hit_rows = np.nonzero((last_chunk[mine] == k)
                                  & act[:len(mine)])[0]
            if hit_rows.size:
                # gathered into a fresh tensor: the next replay rewrites
                # the step's logits
                sel = logits[torch.as_tensor(hit_rows, device=self.device),
                             torch.as_tensor((lens[hit_rows] - 1) % c,
                                             device=self.device)]
                for j, b in enumerate(hit_rows):
                    rows[int(b)] = sel[j]
            like = logits[:, 0]
        last: Dict[int, torch.Tensor] = {}
        if any(t is None for t in term):
            # every shard's last logits rows, in shard-major order
            every = self._gather_out(torch.stack(
                [torch.zeros_like(like[0]) if x is None else x
                 for x in rows]))
            for i in range(g):
                if term[i] is None:
                    last[i] = every[int(at[i])]
        tok0 = np.zeros((g,), np.int64)
        bad0 = np.zeros((g,), bool)
        for i in range(g):
            if term[i] is not None:
                tok0[i] = term[i].tok0
                continue
            tok0[i] = int(last[i].argmax())
            bad0[i] = not bool(torch.isfinite(last[i]).all())
        # donate computed pages back to the pool (never from a failed
        # launch: an exception above unwinds before this point)
        donors = [i for i in range(g) if term[i] is None and not bad0[i]]
        every = self._every_row(cache) if donors else None
        for i in donors:
            r = group[i]
            # ONE extraction (one device-to-host wait) per miss row: the
            # terminal pages cover [0, prompt_len), and chain chunk pages
            # are host-side slices of them
            full = self._spec.extract_row_pages(every, int(at[i]), 0,
                                                r.prompt_len)
            n_full = r.prompt_len // c
            if self._prefix.chain_ok and n_full > n_chain[i]:
                keys = self._prefix.chain_keys(r.prompt, req=r)
                for k in range(n_chain[i], n_full):
                    self._prefix.insert_chain(
                        keys[k], self._chunk_pages(full, k, c))
            self._prefix.insert_terminal(r, full, int(tok0[i]))
        pins = [self._prefix.pin(pk) for pk in pin_keys]
        self._admit_pins.extend(pins)
        del free[:g]
        self._spec.admit(self._cache, cache, slots[mine] // self._dp,
                         len(mine), t_pre=t_pre)
        return tok0, bad0, slots, pins, last

    # -- chunked prefill ----------------------------------------------------

    def _chunk_step(self, bb: int, c: int, t_pre: int) -> _ChunkStep:
        """The chunk step of (bb, c, t_pre) -- bb this shard's rows --
        captured at first use."""
        key = ("chunk", bb, c, t_pre)
        s = self._chunks.get(key)
        if s is None:
            s = _ChunkStep.prefill(
                self._bundle.decode_fn, self.params,
                self._init_state(self._spec, bb, t_pre), bb, c,
                self.device, self._capture)
            self._chunks[key] = s
        return s

    def _chunked_prefill(self, prompts: np.ndarray, lens: np.ndarray,
                         t_pre: int):
        """Prefill through the decode step, `prefill_chunk` tokens per
        launch of the captured chunk step.  Only each row's
        last-real-position logits are needed: they are gathered per chunk,
        so one [bb, c, V] block is ever live.  Returns (tok0 [bb], last
        [bb, V], the prefill state, bad0 [bb])."""
        bb, sb = prompts.shape
        c = min(self.prefill_chunk, sb)
        assert sb % c == 0, (sb, c)
        step = self._chunk_step(bb, c, t_pre)
        step.reset()
        active = np.ones((bb,), bool)
        last: List[Optional[torch.Tensor]] = [None] * bb
        self._graphs.add(("chunk", bb * self._dp, c, t_pre))
        for k in range(sb // c):
            logits = self._guarded("chunk", step.run,
                                   prompts[:, k * c:(k + 1) * c], k * c,
                                   active)
            hit = np.nonzero((lens - 1) // c == k)[0]
            if hit.size:
                sel = logits[torch.as_tensor(hit, device=self.device),
                             torch.as_tensor((lens[hit] - 1) % c,
                                             device=self.device)]
                for j, b in enumerate(hit):
                    last[b] = sel[j]
        stack = torch.stack(last)
        return (stack.argmax(dim=-1), stack, step.state,
                ~torch.isfinite(stack).all(dim=-1))

    # -- decode segments ----------------------------------------------------

    def _segment_shape(self):
        """(bb, t_b) for the next segment; t_b is None for constant-size
        state (no length bucketing -- batch-bucket-only graph growth)."""
        hi = int(np.max(np.nonzero(self._active)[0])) + 1
        bb = scheduler.bucket_pow2(hi, minimum=self.min_batch_bucket,
                                   maximum=self.n_slots)
        if not self._spec.has_length_axis:
            return bb, None
        need = int(np.max(self._pos[:bb][self._active[:bb]])) \
            + self.segment_len
        t_b = scheduler.bucket_pow2(min(need, self.max_cache_len),
                                    minimum=self.min_len_bucket,
                                    maximum=self.max_cache_len)
        return bb, t_b

    def _segment_step(self, bb: int,
                      t_b: Optional[int]) -> serve._CapturedStep:
        """The captured step of (bb, t_b), captured at first use, over
        the first bb rows of the slot state and the device buffers (on a
        mesh this shard's bb / dp rows, and the gather of its outputs)."""
        key = ("segment", bb, t_b, self.segment_len)
        s = self._segments.get(key)
        if s is None:
            n = bb // self._dp
            bufs = {k: t if k == "step" else tuple(x[:n] for x in t)
                    if k == "samp" else t[:n]
                    for k, t in self._bufs.items()}
            s = serve._CapturedStep(
                self._bundle.decode_fn, self.params,
                self._spec.slice_live(self._cache, n, t_b), bufs,
                self.device, graphed=self._capture)
            self._segments[key] = s
            self._graphs.add(key)
        return s

    def _segment_gather(self, bb: int) -> Optional[_Gather]:
        """On a mesh, the gather of a bb-row segment's outputs (every
        shard's tokens, positions and flags) into the global buffers the
        host reads; None off a mesh."""
        if self._plan is None:
            return None
        g = self._gathers.get(("segment", bb))
        if g is None:
            n, b, o = bb // self._dp, self._bufs, self._out
            rows = self._plan.gather_rows

            def fn():
                for k in ("tok", "pos", "toks", "bad"):
                    o[k][:bb].copy_(rows(b[k][:n]))

            g = self._gathers[("segment", bb)] = _Gather(
                fn, self.device, self._capture)
        return g

    def _load_rows(self, bb: int, names=("tok", "pos", "act")) -> None:
        """This shard's rows of the host's per-slot arrays [:bb] (and the
        sampling page) into the device buffers."""
        b, n = self._bufs, bb // self._dp
        host = {"tok": self._tok, "pos": self._pos, "act": self._active}
        for name in names:
            b[name][:n].copy_(torch.from_numpy(self._rows(host[name], bb)))
        for buf, leaf in zip(b["samp"], self._samp):
            buf[:n].copy_(torch.from_numpy(self._rows(leaf, bb)))

    def _begin_segment(self) -> _PendingSegment:
        """Load the per-slot buffers and replay the bucket's captured step
        segment_len times; returns without syncing on the device."""
        bb, t_b = self._segment_shape()
        n_steps = self.segment_len
        b = self._bufs
        self._load_rows(bb)
        b["bad"].zero_()
        b["step"].zero_()
        # captured at first use AFTER the buffers are loaded: the capture's
        # eager step writes its token at the step index
        step = self._segment_step(bb, t_b)
        gather = self._segment_gather(bb)
        self._guarded("segment", step.replay, n_steps)
        if gather is not None:
            gather.run()
        self.segments += 1
        self.occupancy.append(float(np.sum(self._active)) / self.n_slots)
        return _PendingSegment(bb=bb, n_steps=n_steps)

    def _finish_segment(self, p: _PendingSegment,
                        clock: scheduler.Clock) -> None:
        """Block on a dispatched segment's outputs and harvest."""
        o = self._out
        self._tok[:p.bb] = o["tok"][:p.bb].cpu().numpy()
        self._pos[:p.bb] = o["pos"][:p.bb].cpu().numpy()
        seq = o["toks"][:p.bb, :p.n_steps].cpu().numpy().T   # [n_steps, bb]
        self._harvest(seq, o["bad"][:p.bb].cpu().numpy(), clock.now())

    def _harvest(self, seq: np.ndarray, bad: np.ndarray,
                 now: float) -> None:
        n_steps, bb = seq.shape
        for slot in range(bb):
            req = self._slot_req[slot]
            if req is None:
                continue
            if bad[slot]:
                # quarantine: this slot's logits went non-finite during
                # the segment; no other slot saw it (per-slot state), but
                # this segment's tokens for the slot are not trustworthy
                self._robust["quarantined"] += 1
                self._finish(req, now, res.FAILED,
                             "non-finite logits during decode")
                self._evict(slot)
                self._scrub(slot)
                continue
            take = int(min(self._remaining[slot], n_steps))
            toks = seq[:take, slot]
            done = False
            if req.stop_tokens:
                hits = np.nonzero(np.isin(toks, req.stop_tokens))[0]
                if hits.size:
                    toks = toks[:int(hits[0]) + 1]   # stop token included
                    done = True
            req.tokens.extend(int(t) for t in toks)
            self.total_generated += len(toks)
            self._remaining[slot] -= len(toks)
            if done or self._remaining[slot] == 0:
                self._finish(req, now)
                self._evict(slot)

    # -- self-speculative decoding (SpecDecodeConfig) ------------------------

    def _spec_round_for(self, bb: int, t_b: Optional[int]) -> _SpecRound:
        """The round of (bb, t_b), captured at first use over the first bb
        rows of both slot states (their first t_b positions) and of the
        round buffers."""
        r = self._rounds.get((bb, t_b))
        if r is None:
            n = bb // self._dp      # this shard's rows

            def snaps(spec, stacks):    # the slot axis is one on, past k+1
                axes = [ba for ba, la in zip(spec.batch_axes,
                                             spec.length_axes) if la is None]
                return tuple(x.narrow(ba + 1, 0, n)
                             for x, ba in zip(stacks, axes))

            sb, eb = self._sbufs, self._bufs
            b = {k: sb[k][:n] for k in ("x", "g", "gbad", "dpos", "out")}
            b.update(pos=eb["pos"][:n], act=eb["act"][:n],
                     samp=tuple(x[:n] for x in eb["samp"]),
                     dstep=sb["dstep"], vstep=sb["vstep"],
                     tsnaps=snaps(self._spec, sb["tsnaps"]),
                     dsnaps=snaps(self._draft_spec, sb["dsnaps"]))
            gather = None
            if self._plan is not None:
                gout, rows = sb["gout"][:bb], self._plan.gather_rows

                def gather(out):
                    gout.copy_(rows(out))
            r = _SpecRound(
                self._sd.k, self._bundle.decode_fn, self.params, self._spec,
                self._spec.slice_live(self._cache, n, t_b),
                self._draft_bundle.decode_fn, self._draft_params,
                self._draft_spec,
                self._draft_spec.slice_live(self._draft_cache, n, t_b), b,
                self.device, gather=gather, capture=self._capture)
            self._rounds[(bb, t_b)] = r
        return r

    def _spec_round(self, clock: scheduler.Clock) -> None:
        """One speculative round: the draft free-runs k + 1 sampled steps
        (k drafts, plus the step a full acceptance needs the draft to have
        consumed), the target verifies the pending token and the k drafts
        teacher-forced, and both states roll back to the accepted prefix
        on the device (_SpecRound).  No host round trip between draft and
        verify: the drafts feed the verify step from the x buffer; the
        one host read is the packed outputs at harvest.  Both models
        sample under the same per-slot keys, so acceptance is a pure
        function of (seed, rid, token prefix): recovery replay is
        acceptance-history-exact."""
        k = self._sd.k
        hi = int(np.max(np.nonzero(self._active)[0])) + 1
        bb = scheduler.bucket_pow2(hi, minimum=self.min_batch_bucket,
                                   maximum=self.n_slots)
        t_b = None
        if self._spec.has_length_axis:
            # the verify writes rows pos..pos+k (an overrun at the
            # cache's end clamps into the slot's own discarded row)
            need = int(np.max(self._pos[:bb][self._active[:bb]])) + k + 1
            t_b = scheduler.bucket_pow2(min(need, self.max_cache_len),
                                        minimum=self.min_len_bucket,
                                        maximum=self.max_cache_len)
        self._graphs.add(("draft", bb, t_b, k + 1))
        self._graphs.add(("verify", bb, t_b, k + 1))
        # captured at first use BEFORE the buffers are loaded: a capture's
        # eager calls scribble on them
        rnd = self._spec_round_for(bb, t_b)
        b, sb, n = self._bufs, self._sbufs, bb // self._dp
        sb["x"][:n, 0].copy_(torch.from_numpy(self._rows(self._tok[:, 0],
                                                         bb)))
        self._load_rows(bb, ("pos", "act"))
        sb["dpos"][:n].copy_(b["pos"][:n])
        sb["dstep"].zero_()
        sb["vstep"].zero_()
        self._guarded("draft", rnd.draft, k + 1)
        self._guarded("verify", rnd.verify, k + 1)
        if rnd.rollback is not None:
            # constant-size draft leaves restore from their snapshots;
            # a pure length-paged draft rolls back for free
            self._graphs.add(("rollback", bb, t_b, k + 1))
            rnd.rollback()
        self.occupancy.append(float(np.sum(self._active)) / self.n_slots)
        out = sb["out" if self._plan is None else "gout"][:bb].cpu().numpy()
        self._pos[:bb] = out[:, k + 2]
        self._spec_harvest(out[:, :k + 1].T, out[:, k + 1],
                           out[:, k + 3].astype(bool), clock.now())

    def _spec_harvest(self, g_seq: np.ndarray, m: np.ndarray,
                      bad: np.ndarray, now: float) -> None:
        """Host bookkeeping after a round: per live slot, emit the m + 1
        target tokens the round settled (the accepted drafts' positions
        plus the first disagreeing or extending target token), with
        _harvest's stop-token and budget logic, so streams truncate
        identically."""
        k1, bb = g_seq.shape
        self._spec_stats["rounds"] += 1
        self._spec_stats["target_dispatches"] += 1
        for slot in range(bb):
            req = self._slot_req[slot]
            if req is None or not self._active[slot]:
                continue
            if bad[slot]:
                self._robust["quarantined"] += 1
                self._finish(req, now, res.FAILED,
                             "non-finite logits during decode")
                self._evict(slot)
                self._scrub(slot)
                continue
            self._spec_stats["drafted"] += k1 - 1
            self._spec_stats["accepted"] += int(m[slot])
            e = int(m[slot]) + 1
            take = int(min(self._remaining[slot], e))
            toks = g_seq[:take, slot]
            done = False
            if req.stop_tokens:
                hits = np.nonzero(np.isin(toks, req.stop_tokens))[0]
                if hits.size:
                    toks = toks[:int(hits[0]) + 1]
                    done = True
            req.tokens.extend(int(t) for t in toks)
            self.total_generated += len(toks)
            self._spec_stats["emitted"] += len(toks)
            self._remaining[slot] -= len(toks)
            if done or self._remaining[slot] == 0:
                self._finish(req, now)
                self._evict(slot)
                continue
            # the new pending token: the target's right after the last
            # accepted draft (pos advanced to pos + m + 1 on the device)
            self._tok[slot] = g_seq[e - 1, slot]

    # -- resilience: chaos sites, expiry, replay, recovery ------------------

    def _guarded(self, kind: str, fn, *args):
        """Every device launch funnels through here: count the per-kind
        site, give the chaos schedule its shot at it, then launch.  The
        check fires BEFORE the call, so an injected fault never leaves a
        launch half done; failures unwind to step() / drain(), which
        recover."""
        idx = self._site_counts[kind]
        self._site_counts[kind] = idx + 1
        if self._chaos is not None:
            self._chaos.check_site(f"{kind}:{idx}")
        return fn(*args)

    def _expire(self, now: float) -> int:
        """EXPIRED outcomes for requests past their deadline: queued ones
        never dispatch; in-flight ones are cancelled by slot eviction,
        keeping the tokens already emitted."""
        n = 0
        for req in self._queue.pop_expired(now):
            self._robust["expired_queued"] += 1
            self._finish(req, now, res.EXPIRED,
                         "deadline exceeded in queue")
            n += 1
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is not None and req.expired(now):
                self._robust["expired_inflight"] += 1
                self._finish(req, now, res.EXPIRED,
                             "deadline exceeded in flight")
                self._evict(slot)
                n += 1
        return n

    def _scrub(self, slot: int) -> None:
        """Overwrite a quarantined slot's pages with fresh state.  Normal
        eviction never scrubs (stale FINITE values are masked to exact
        zeros), but a masked softmax weight is an exact 0 and 0 * NaN is
        NaN."""
        if slot % self._dp != self._d:
            return          # another dp shard's page
        local = [slot // self._dp]
        zeros = self._init_state(self._spec, 1, self.max_cache_len)
        self._spec.admit(self._cache, zeros, local, 1)
        if self._sd is not None:
            # the draft saw the same poisoned row: scrub its page too
            dz = self._init_state(self._draft_spec, 1, self.max_cache_len,
                                  self._draft_plan)
            self._draft_spec.admit(self._draft_cache, dz, local, 1)

    def _replay_step_for(self, bb: int, t_b: Optional[int]) -> _ChunkStep:
        """The replay step of (bb, t_b), captured at first use over the
        first bb rows of the slot state (its first t_b positions) and of
        the token, position and active buffers."""
        s = self._replays.get((bb, t_b))
        if s is None:
            b, n = self._bufs, bb // self._dp
            # the step's output: every row's last logits, in slot order
            # (on a mesh every dp shard's, all-gathered inside the step)
            gather = (lambda lg: lg[:, -1, :]) if self._plan is None \
                else (lambda lg: self._plan.gather_rows(lg[:, -1, :]))
            s = _ChunkStep(self._bundle.decode_fn, self.params,
                           self._spec.slice_live(self._cache, n, t_b),
                           b["tok"][:n], b["pos"][:n], b["act"][:n],
                           self.device, gather, self._capture)
            self._replays[(bb, t_b)] = s
        return s

    def _draft_replay_step_for(self, bb: int,
                               t_b: Optional[int]) -> _ChunkStep:
        """The draft's replay step of (bb, t_b): the draft teacher-forces
        what the target replays, over the same token, position and active
        buffers."""
        s = self._dreplays.get((bb, t_b))
        if s is None:
            b, n = self._bufs, bb // self._dp
            s = _ChunkStep(self._draft_bundle.decode_fn, self._draft_params,
                           self._draft_spec.slice_live(self._draft_cache,
                                                       n, t_b),
                           b["tok"][:n], b["pos"][:n], b["act"][:n],
                           self.device, capture=self._capture)
            self._dreplays[(bb, t_b)] = s
        return s

    def _drain_replay(self, clock: scheduler.Clock) -> None:
        """Teacher-forced replay of recovered requests' recorded tokens,
        one replay step at a time, through the decode step live traffic
        uses.  Replaying, not re-prefilling prompt + emitted in one go,
        keeps recovery bit-exact for every family: prefill and stepwise
        decode sum sequential state in different orders, a replayed step
        repeats the fault-free step's ops.  Each replayed token is checked
        against the recorded stream (`replay_divergence`).

        Score requests drain through the same launches: teacher-forcing a
        fixed completion is replay with the expected token supplied by
        the caller, plus a host logprob from each step's logits row
        (methods.logprob_from_logits)."""
        while any(self._replay) or any(self._score):
            self._replay_step(clock.now())

    def _replay_step(self, now: float) -> None:
        hi = int(np.max(np.nonzero(self._active)[0])) + 1
        bb = scheduler.bucket_pow2(hi, minimum=self.min_batch_bucket,
                                   maximum=self.n_slots)
        t_b = None
        if self._spec.has_length_axis:
            need = int(np.max(self._pos[:bb][self._active[:bb]])) + 1
            t_b = scheduler.bucket_pow2(min(need, self.max_cache_len),
                                        minimum=self.min_len_bucket,
                                        maximum=self.max_cache_len)
        # only the slots mid-replay or mid-score are active: caught-up
        # requests in the batch neither advance nor change (masking and
        # batch invariance, module docstring)
        replaying = np.asarray([bool(self._replay[s]) or bool(self._score[s])
                                for s in range(bb)])
        step = self._replay_step_for(bb, t_b)
        self._graphs.add(("chunk", bb, 1, t_b))
        inputs = (self._rows(self._tok, bb), self._rows(self._pos, bb),
                  self._rows(replaying, bb))
        last = self._guarded("chunk", step.run, *inputs)
        self.replay_steps += 1
        if self._sd is not None:
            # the draft teacher-forces the same token at the same position,
            # so the rounds after a recovery draft from the state a
            # fault-free run would have (the target's logits live in
            # another graph's pool)
            dstep = self._draft_replay_step_for(bb, t_b)
            self._graphs.add(("dchunk", bb, 1, t_b))
            self._guarded("draft", dstep.run, *inputs)
        nxt = last.argmax(dim=-1).cpu().numpy()
        bad = (~torch.isfinite(last).all(dim=-1)).cpu().numpy()
        # whole rows come to the host only for a score slot's logprob
        rows = last.cpu().numpy() if any(self._score[:bb]) else None
        for slot in range(bb):
            if not replaying[slot]:
                continue
            req = self._slot_req[slot]
            if bad[slot]:
                self._robust["quarantined"] += 1
                self._finish(req, now, res.FAILED,
                             "non-finite logits during replay")
                self._evict(slot)
                self._scrub(slot)
                continue
            if self._score[slot]:
                tok = self._score[slot].pop(0)
                req.logprobs.append(
                    smethods.logprob_from_logits(rows[slot], tok))
                self._tok[slot] = tok      # teacher forcing
                self._pos[slot] += 1
                if not self._score[slot]:
                    self._finish(req, now)
                    self._evict(slot)
                continue
            expect = self._replay[slot].pop(0)
            self._robust["replayed_tokens"] += 1
            # greedy: the argmax over the logits bits the segment saw (a
            # comparison, no float sum); sampled: the same sampler on the
            # row, on its device (the key needs only seed, rid and t)
            actual = int(nxt[slot]) if sampling.is_greedy(req) else \
                sampling.expected_token(
                    req, last[slot],
                    int(self._pos[slot]) - req.prompt_len + 1)
            if actual != expect:
                self._robust["replay_divergence"] += 1
            self._tok[slot] = expect       # teacher forcing
            self._pos[slot] += 1

    def _recover(self, exc: Exception, now: float) -> None:
        """Requeue every in-flight (and mid-admission) request with its
        emitted tokens, then reset the engine's state.  The reset is in
        place: every slot-state leaf refilled with its init value, the
        device buffers zeroed, the host pages cleared and the prefix pins
        released -- the captured segment, replay and chunk steps read the
        state and the buffers at their addresses, and each is kept, so
        recovery captures nothing.  Requeued requests re-enter through
        admission and replay their recorded tokens before generating new
        ones, so surviving streams stay bit-identical to a fault-free
        run.  A request past its recovery budget is FAILED.  A rank's
        loss (`DeviceLoss`) on a mesh re-plans first (`_degrade`); off a
        mesh it is a plain fault."""
        if isinstance(exc, SimulatedFailure):
            self._robust["faults_injected"] += 1
        else:
            self._robust["errors"] += 1
        self._robust["recoveries"] += 1
        if isinstance(exc, delastic.DeviceLoss) and self._plan is not None:
            # a rank's loss re-plans the mesh FIRST, so that the state
            # reset below and the replay both land on the new one
            self._degrade_at.append(now)
            self._degrade(exc)
            if self._left_at is not None:
                return
        victims = [r for r in self._slot_req if r is not None]
        seen = {id(r) for r in victims}
        victims += [r for r in self._admitting
                    if id(r) not in seen and r.outcome is None]
        self._admitting = []
        for r in victims:
            r.retries += 1
            if r.retries > self._res.max_recoveries:
                self._finish(r, now, res.FAILED,
                             f"recovery budget "
                             f"({self._res.max_recoveries}) exhausted; "
                             f"last error: {exc}")
            else:
                self._queue.submit(r)
        fresh = self._init_state(self._spec, 1, self.max_cache_len)
        for leaf, init in zip(pytree.tree_leaves(self._cache),
                              pytree.tree_leaves(fresh)):
            leaf.copy_(init)        # broadcast over the slot axis
        for buf in pytree.tree_leaves(self._bufs):
            buf.zero_()
        if self._sd is not None:
            dfresh = self._init_state(self._draft_spec, 1,
                                      self.max_cache_len, self._draft_plan)
            for leaf, init in zip(pytree.tree_leaves(self._draft_cache),
                                  pytree.tree_leaves(dfresh)):
                leaf.copy_(init)
            for buf in pytree.tree_leaves(self._sbufs):
                buf.zero_()
        self._samp = sampling.host_page(self.n_slots)
        self._tok[:] = 0
        self._pos[:] = 0
        self._active[:] = False
        self._remaining[:] = 0
        self._slot_req = [None] * self.n_slots
        self._replay = [[] for _ in range(self.n_slots)]
        self._score = [[] for _ in range(self.n_slots)]
        if self._prefix is not None:
            for pk in self._slot_pins + self._admit_pins:
                if pk:
                    self._prefix.release(pk)
        self._slot_pins = [()] * self.n_slots
        self._admit_pins = []

    # -- run loop -----------------------------------------------------------

    @_mirrored
    def step(self, clock: Optional[scheduler.Clock] = None) -> bool:
        """Admit what has arrived, drain replays and scores, then run one
        decode segment.  Returns False when there was nothing to do (the
        caller should wait for the next arrival).  A failure -- injected
        or real -- does not escape: `_recover` requeues the in-flight
        work, counts the failure (`faults_injected` or `errors`), and
        later steps replay it bit-exactly.  The same launches as
        step_begin + an immediate step_finish."""
        clock = clock or scheduler.Clock()
        try:
            return self._step_inner(clock)
        except Exception as e:  # noqa: BLE001 -- the serve loop survives
            self._recover(e, clock.now())
            return True

    @_mirrored
    def step_begin(self, clock: Optional[scheduler.Clock] = None):
        """First half of step(): expire, admit and replay, then dispatch
        one decode segment WITHOUT syncing on it.  Returns (pending,
        progressed); pending is None when no segment ran; otherwise the
        caller MUST call step_finish(pending).  A failure here recovers
        and returns (None, True)."""
        clock = clock or scheduler.Clock()
        try:
            return self._step_begin_inner(clock)
        except Exception as e:  # noqa: BLE001
            self._recover(e, clock.now())
            return None, True

    @_mirrored
    def step_finish(self, pending,
                    clock: Optional[scheduler.Clock] = None) -> bool:
        """Second half of step(): block on the dispatched segment and
        harvest its tokens; a failure surfacing at the sync recovers."""
        clock = clock or scheduler.Clock()
        try:
            self._finish_segment(pending, clock)
        except Exception as e:  # noqa: BLE001
            self._recover(e, clock.now())
        return True

    def _step_begin_inner(self, clock: scheduler.Clock,
                          resume_only: bool = False):
        now = clock.now()
        expired = self._expire(now)
        admitted = self._admit(now, clock, resume_only=resume_only)
        self._drain_replay(clock)
        if not self._active.any():
            return None, bool(admitted or expired)
        if self._sd is not None:
            # a speculative round is synchronous (draft, verify, rollback,
            # harvest): no pending segment to double-buffer
            self._spec_round(clock)
            return None, True
        return self._begin_segment(), True

    def _step_inner(self, clock: scheduler.Clock,
                    resume_only: bool = False) -> bool:
        pending, progressed = self._step_begin_inner(clock, resume_only)
        if pending is None:
            return progressed
        self._finish_segment(pending, clock)
        return True

    @_mirrored
    def cancel(self, rid: int, now: float = 0.0,
               reason: Optional[str] = None) -> bool:
        """Cancel a request by rid.  Queued: removed before it ever
        dispatches.  In flight: the slot is evicted and the request
        finishes CANCELLED with the tokens harvested so far; its batch
        mates are not perturbed by one ULP.  False when the rid is not
        live."""
        req = self._queue.remove(rid)
        if req is not None:
            self._robust["cancelled_queued"] += 1
            self._finish(req, now, res.CANCELLED,
                         reason or "cancelled while queued")
            return True
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is not None and req.rid == rid:
                self._robust["cancelled_inflight"] += 1
                self._finish(req, now, res.CANCELLED,
                             reason or "cancelled in flight")
                self._evict(slot)
                return True
        return False

    @_mirrored
    def drain(self, clock: Optional[scheduler.Clock] = None) -> None:
        """Finish all in-flight work WITHOUT admitting fresh requests
        (requests a fault mid-drain requeued, with emitted tokens or a
        retry count, are re-admitted so their streams complete).  Fresh
        queued requests stay queued; pair with snapshot() / restore() for
        rolling restarts."""
        clock = clock or scheduler.Clock()
        self._robust["drains"] += 1
        while True:
            try:
                self._step_inner(clock, resume_only=True)
            except Exception as e:  # noqa: BLE001
                self._recover(e, clock.now())
                if self._left_at is not None:
                    return      # a degrade left this rank out
                continue
            if not self._active.any() and not any(
                    r.tokens or r.retries > 0
                    for r in self._queue.pending()):
                return

    def snapshot(self, ckpt_dir: str, step: int = 0) -> str:
        """Persist the queue and the per-slot request state atomically
        through checkpoint/ckpt.py (launch/resilience.py's encoding).
        In-flight requests are stored with their emitted tokens and
        resume on restore() through the recovery / replay path, so device
        state is never serialized.  The snapshot is stamped with the
        current mesh (observability only): request state carries no mesh,
        so a snapshot taken on one mesh restores onto another, or onto
        one device, with the same tokens; the stamp names the world
        ranks a degrade lost (`dead_devices`).  On a mesh the leader
        writes it (the host state it reads is every rank's)."""
        reqs = [r for r in self._slot_req if r is not None] \
            + list(self._queue.pending())
        self._robust["snapshots"] += 1
        extra = None
        if self._plan is not None:
            p = self._plan
            extra = {"mesh": {
                "shape": dict(p.mesh.shape), "dp_axes": list(p.dp_axes),
                "model_axis": p.model_axis,
                "dead_devices": list(self._health.dead_ids),
            }}
        return res.snapshot_requests(ckpt_dir, step, reqs, extra=extra)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Load a snapshot into this (fresh or drained) engine's queue;
        returns the number of requests restored.  On a mesh the leader
        reads it and every rank queues the requests it read."""
        return self._restore_requests(res.restore_requests(ckpt_dir,
                                                           step=step))

    @_mirrored
    def _restore_requests(self, reqs: list) -> int:
        for r in reqs:
            if r.rid in self._rids:
                raise ValueError(
                    f"restore: rid {r.rid} is already tracked by this "
                    f"engine (restore targets a fresh or drained engine)")
            self._rids.add(r.rid)
            self._queue.submit(r)
        self._robust["restores"] += 1
        return len(reqs)

    def results(self) -> Dict[int, res.RequestResult]:
        """Structured terminal outcome per finished request, by rid."""
        return dict(self._results)

    def result(self, rid: int) -> Optional[res.RequestResult]:
        """The structured result of one request, or None while it is
        still queued or in flight."""
        return self._results.get(rid)

    def next_arrival(self, now: float) -> Optional[float]:
        """Earliest future arrival_time in the queue (None when nothing
        is in transit)."""
        return self._queue.next_arrival(now)

    def admission_plan(self) -> int:
        """Host-side admission planning that is safe to run while a
        dispatched segment is in flight (between step_begin and
        step_finish): precompute and memoize the prefix-cache digests of
        queued requests, so the NEXT admission starts with its sha256
        work done.  No launch, no admission decision, no LRU change.
        Returns the number of requests whose digests were warmed."""
        if self._prefix is None:
            return 0
        return sum(1 for r in self._queue.pending()
                   if self._prefix.warm_digest(r))

    def run(self, requests: Sequence[scheduler.Request] = (),
            clock: Optional[scheduler.Clock] = None) -> Dict[int, np.ndarray]:
        """Serve until the queue drains; returns {rid: generated tokens}."""
        for r in requests:
            self.submit(r)
        clock = clock or scheduler.Clock()
        while True:
            if not self.step(clock):
                nxt = self._queue.next_arrival(clock.now())
                if nxt is not None:
                    clock.wait_until(nxt)
                    continue
                if not len(self._queue) and not self._active.any():
                    break
        return {r.rid: np.asarray(r.tokens, np.int32) for r in self.finished}

    def _degrade(self, exc: "delastic.DeviceLoss") -> None:
        """Elastic re-plan after a rank's loss (distributed/elastic.py).

        SILVIA rebinds ops to fewer DSPs with identical results; this
        rebinds slots to fewer ranks with identical tokens.  Every rank
        raised the same `DeviceLoss` at the same site (the same scheduler
        over the same site counters), so every rank kills the same ranks
        in its health registry and plans the same sub-mesh: the largest
        valid healthy one (dp floor and tp divisibility respected), whose
        process groups the survivors create among themselves
        (`plan_degraded_mesh`; a failed re-formation raises, and nothing
        carries on with the old mesh).  A rank the plan leaves out --
        lost, or healthy but unused -- releases its state and leaves:
        `follow()` returns, and it takes part in no collective after.
        The survivors rebuild the engine on the new mesh: a new plan (a
        new bundle key), the re-bucketed admission floors, the weights
        placed again from `_whole` (no lost rank's slices needed), fresh
        slot state, buffers and gathers, no captured step, and the
        draft's plan, weights, state and rounds.  The prefix pool keeps
        its entries when each rank's heads are unchanged (a dp-only
        loss: every dp peer pools every entry) and drops them when the
        tensor-parallel layout changes (pages of a lost rank's heads
        cannot be rebuilt; a miss recomputes).  `_recover` then requeues
        the in-flight requests, which replay bit-exactly on the new
        mesh."""
        t0 = time.perf_counter()
        self._health.kill(exc.n_lost)
        old = self._plan
        new_mesh = delastic.plan_degraded_mesh(
            old.mesh, self._health.healthy(), dp_axes=old.dp_axes,
            model_axis=old.model_axis, n_slots=self.n_slots, cfg=self.cfg)
        self._robust["degraded"] += 1
        self._graphs = set()
        self._drop_device_state()
        if new_mesh is None:
            self._left_at = exc.site
            self._ctl = None
            self.params = self._whole = None
            self._reshard_s += time.perf_counter() - t0
            return
        with dctx.mesh_scope(new_mesh, old.dp_axes, old.model_axis):
            plan = _mesh_plan(self.cfg, self._spec, self._init_kwargs)
            self._set_plan(plan)
            self._place(plan)
            self._init_device_state()
            if self._sd is not None:
                self._init_draft(self._sd)
        if self._prefix is not None:
            # rank-uniform: the plans are every rank's.  The survivors
            # are a prefix of the old rank order (kill takes the last),
            # so an unchanged model extent keeps each rank's heads
            def heads(p):
                return (p.tp.size, p.tp.attn, p.tp.ssm) if p.tp.active \
                    else None
            if heads(old) != heads(plan):
                self._prefix.drop_all()
            self._prefix.note_remesh(plan.key)
        self._reshard_s += time.perf_counter() - t0

    # -- the mesh's control plane ------------------------------------------

    def follow(self) -> None:
        """A follower rank's serve loop (mesh serving, module docstring):
        receive each call rank 0's engine broadcasts and run it here,
        with rank 0's clock readings, until rank 0's `release()`.  A
        ValueError -- what `submit` raises for a malformed request,
        before any launch -- is the leader's to report (it raised it too:
        the host state is the same); any other exception ends the loop
        and the process.  A degrade that leaves this rank out of the new
        mesh (lost, or healthy but unused) ends the loop at once: the
        rank takes part in no collective after it
        (`cache_info()["mesh"]["left_at"]`)."""
        if self._ctl is None or self._ctl.rank == 0:
            raise RuntimeError("follow() runs on the ranks after rank 0 "
                               "of a mesh of more than one rank")
        while self._left_at is None:
            # the current control mesh: a degrade replaces it, and one
            # that leaves this rank out ends the loop
            name, kwargs, clocked = self._ctl.bcast_object()
            if name is None:
                return
            if clocked:
                kwargs["clock"] = _FollowerClock(self)
            fn = getattr(type(self), name).__wrapped__
            self._mirroring = True
            try:
                fn(self, **kwargs)
            except ValueError:
                pass            # a caller's error, raised on rank 0 too
            finally:
                self._mirroring = False

    def release(self) -> None:
        """Rank 0: end the followers' `follow()` loops."""
        if self._ctl is not None and self._ctl.rank == 0:
            self._ctl.bcast_object((None, None, False))

    # -- observability ------------------------------------------------------

    @property
    def prompt_buckets(self) -> tuple:
        return scheduler.bucket_set(self.min_prompt_bucket,
                                    self.max_cache_len)

    @property
    def admission_batch_buckets(self) -> tuple:
        return scheduler.bucket_set(self._adm_floor, self.n_slots)

    def graph_bound(self) -> int:
        """Upper bound on distinct graphs: the captured segment grid
        (batch buckets only for constant-size state) plus one prefill
        shape -- or captured chunk step -- per (admission batch bucket,
        prompt bucket[, enc bucket]), what `warmup()` walks, plus the
        embed grid of the same size and the replay step's grid, which
        recovery and the score method both walk (score traffic can come
        to any engine, so that grid is always in the bound)."""
        enc = max(1, len(self.enc_buckets))
        seg = len(self.batch_buckets) * max(1, len(self.len_buckets))
        pre = len(self.admission_batch_buckets) \
            * len(self.prompt_buckets) * enc
        bound = seg + pre + seg + pre
        if self._sd is not None:
            # the draft / verify / rollback round grids (a spec engine
            # never runs a segment, but their term stays in the base
            # bound), the draft prefill and the draft replay grids
            bound += 3 * seg + pre + seg
        return bound

    @_mirrored
    def warmup(self, prompt_lens: Optional[Sequence[int]] = None,
               methods: Sequence[str] = ("generate",)) -> int:
        """Capture the (batch bucket x length bucket) segment grid (a spec
        engine's round grid instead: draft, verify and, where the draft
        has constant-size leaves, rollback) and, when the expected prompt
        lengths are given, the admissions they map to: each full-prefill
        shape run once (kernels built and loaded, the allocator warm; a
        spec engine's draft prefill too), every encoder bucket of an
        encdec engine, or each chunk step captured.  `methods` names the
        methods the traffic uses: "score" also captures the replay step's grid
        its teacher forcing drains through, as a chaos-armed engine does
        (it will recover, and recovery replays: no capture after warmup
        under faults; a spec engine's draft replay grid too), and "embed"
        runs each pooled-embedding shape once.
        Returns the number of graphs added.  Call it with no request in
        flight."""
        if self._active.any():
            raise RuntimeError("warmup() with requests in flight")
        n = 0
        k1 = self._sd.k + 1 if self._sd is not None else None
        for bb in self.batch_buckets:
            for t_b in (self.len_buckets or (None,)):
                if self._sd is None:
                    if ("segment", bb, t_b, self.segment_len) not in \
                            self._graphs:
                        self._segment_step(bb, t_b)
                        self._segment_gather(bb)
                        n += 1
                    continue
                # a spec engine never runs a segment: its round grid
                if ("verify", bb, t_b, k1) in self._graphs:
                    continue
                keys = ["draft", "verify"]
                if self._spec_round_for(bb, t_b).rollback is not None:
                    keys.append("rollback")
                self._graphs.update((key, bb, t_b, k1) for key in keys)
                n += len(keys)
        if self._chaos is not None or "score" in methods:
            for bb in self.batch_buckets:
                for t_b in (self.len_buckets or (None,)):
                    if ("chunk", bb, 1, t_b) not in self._graphs:
                        self._replay_step_for(bb, t_b)
                        self._graphs.add(("chunk", bb, 1, t_b))
                        n += 1
                    if self._sd is not None and \
                            ("dchunk", bb, 1, t_b) not in self._graphs:
                        # replay advances the draft through its own grid
                        self._draft_replay_step_for(bb, t_b)
                        self._graphs.add(("dchunk", bb, 1, t_b))
                        n += 1
        if prompt_lens is None:
            return n
        sbs = sorted({self._prompt_bucket(pl) for pl in prompt_lens})
        # encdec admission groups ragged features by enc bucket: warm
        # every bucket, or ragged traffic meets the smaller ones mid-run
        for bb in self.admission_batch_buckets:
            bbl = bb // self._dp        # each shard's rows
            for sb in sbs:
                for eb in (self.enc_buckets or (None,)):
                    t_pre = self._prefill_bucket(sb)
                    key = self._graph_key(bb, sb, t_pre, eb)
                    if key in self._graphs:
                        continue
                    lens = np.ones((bbl,), np.int64)
                    if self.prefill_chunk is None:
                        out = self._prefill(
                            self._warmup_prefill_inputs(bbl, sb, eb), lens,
                            t_pre)
                    else:
                        out = self._chunked_prefill(
                            np.zeros((bbl, sb), np.int64), lens, t_pre)
                    out[0].cpu()
                    self._graphs.add(key)
                    n += 1
                    dkey = ("dprefill", bb, sb, t_pre)
                    if self._sd is not None and dkey not in self._graphs:
                        pytree.tree_leaves(self._draft_prefill(
                            self._warmup_prefill_inputs(bbl, sb), lens,
                            t_pre))[0].cpu()
                        self._graphs.add(dkey)
                        n += 1
        if "embed" in methods:
            for bb in self.admission_batch_buckets:
                bbl = bb // self._dp
                for sb in sbs:
                    for eb in (self.enc_buckets or (None,)):
                        key = self._embed_key(bb, sb, eb)
                        if key in self._graphs:
                            continue
                        self._embed(self._warmup_prefill_inputs(bbl, sb, eb),
                                    np.ones((bbl,), np.int64))[0].cpu()
                        self._graphs.add(key)
                        n += 1
        return n

    def cache_info(self) -> dict:
        """The graph census (engine shape keys, bounded by the bucket
        sets), the captured segment and chunk steps and their capture
        time, the lowering census every graph was captured under, the
        decode-bundle LRU, the robustness counters, the admission budget
        and, with the prefix cache on, its counters."""
        steps = list(self._segments.values()) \
            + list(self._chunks.values()) + list(self._replays.values()) \
            + list(self._dreplays.values())
        rounds = list(self._rounds.values())
        info = {
            "family": self.cfg.family,
            "has_length_axis": self._spec.has_length_axis,
            "graphs": len(self._graphs),
            "graph_bound": self.graph_bound(),
            "graph_keys": sorted(self._graphs,
                                 key=lambda k: tuple(str(x) for x in k)),
            "captured": sum(s.graph is not None for s in steps) + sum(
                gr is not None for r in rounds for gr in r.graphs),
            "capture_ms": sum(s.capture_ms for s in steps + rounds),
            "batch_buckets": list(self.batch_buckets),
            "len_buckets": list(self.len_buckets),
            "enc_buckets": list(self.enc_buckets),
            "compactions": self.compactions,
            "segments": self.segments,
            "replay_steps": self.replay_steps,
            "methods": {"admits": dict(self._method_admits)},
            "lowerings": dict(self._lowerings),
            "decode_bundle_lru": serve.decode_cache_info(),
            "robustness": dict(self._robust),
            "dispatch_sites": dict(self._site_counts),
            "admission": {
                "token_budget": self._admit_budget,
                "deferrals": self._deferrals,
            },
            "resilience": {
                "max_queue": self._res.max_queue,
                "shed_policy": self._res.shed_policy,
                "default_ttl_s": self._res.default_ttl_s,
                "max_recoveries": self._res.max_recoveries,
                "chaos": None if self._chaos is None else {
                    "sites": list(self._chaos.fail_at_sites),
                    "rate": self._chaos.rate,
                    "seed": self._chaos.seed,
                    "max_failures": self._chaos.max_failures,
                    "fired": sorted(self._chaos.failed),
                },
            },
        }
        chaos = info["resilience"]["chaos"]
        if isinstance(self._chaos, delastic.DeviceLossInjector):
            chaos["lose_at_sites"] = [list(x)
                                      for x in self._chaos.lose_at_sites]
            chaos["lose_rate"] = self._chaos.lose_rate
            chaos["lost_sites"] = dict(self._chaos.lost_sites)
        if self._prefix is not None:
            info["prefix_cache"] = self._prefix.info()
        if self._plan is not None:
            p = self._plan
            info["mesh"] = {
                "shape": dict(p.mesh.shape),
                "dp_axes": list(p.dp_axes),
                "model_axis": p.model_axis,
                "dp_size": p.dp_size,
                "tp_size": p.tp.size,
                "tp_attn": p.tp.attn,
                "tp_ssm": p.tp.ssm,
                "n_devices": p.mesh.size,
                "ranks": list(p.mesh.ranks),
                "dead_devices": list(self._health.dead_ids),
                "degraded": self._robust["degraded"],
                "reshard_s": self._reshard_s,
                "degrade_at": list(self._degrade_at),
                # the site of the degrade that left this rank out of the
                # mesh (None while it serves): its shape is the last one
                # it served on
                "left_at": self._left_at,
                "rank": p.mesh.rank,
                "backend": p.mesh.backend,
                # steps with collectives in CUDA graphs (NCCL on CUDA), or
                # every step eager (gloo, or the CPU)
                "captured": self._capture and self.device.type == "cuda",
                "gathered_bytes": p.mesh.gathered_bytes,
                "weights": dict(self._weight_bytes),
                "state_bytes": 0 if self._cache is None
                else _nbytes(self._cache),
            }
        if self._sd is not None:
            sd = dict(self._spec_stats)
            sd["k"] = self._sd.k
            sd["draft"] = getattr(self._sd.draft_cfg, "name",
                                  str(self._sd.draft_cfg))
            sd["acceptance_rate"] = (sd["accepted"] / sd["drafted"]) \
                if sd["drafted"] else 0.0
            sd["tokens_per_dispatch"] = (
                sd["emitted"] / sd["target_dispatches"]) \
                if sd["target_dispatches"] else 0.0
            info["spec_decode"] = sd
        if hasattr(self._bundle.decode_fn, "cache_info"):
            info["silvia"] = self._bundle.decode_fn.cache_info()
        return info

    @property
    def n_active(self) -> int:
        return int(np.sum(self._active))

    @property
    def n_queued(self) -> int:
        return len(self._queue)
