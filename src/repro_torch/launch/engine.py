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
* **full prefill per (batch bucket, prompt bucket)**, eager, as the
  static path's (capturing it is ROADMAP B2), then one scatter into the
  free slots.
* **per-request sampling** (launch/sampling.py) inside the captured step;
  greedy rows take the argmax.
* **stop tokens**, **slot compaction** (surviving slots remapped downward
  when holes inflate the batch bucket), **admission control** (bounded
  queue, shedding, deadlines; launch/resilience.py), cancellation and
  the non-finite quarantine (a slot whose logits went non-finite fails
  with the tokens it had, and its pages are scrubbed).

Exactness: an active row's tokens are a pure function of its request.
An attention row attends only cache positions <= its own position, all
written by its own request, and masked scores are exact zeros after the
softmax; SSM state is masked wholesale; the MoE routes per token; the
GEMM kernels accumulate in int32; and no reduction on the path changes
its order with the number of rows (CUDA's reduce, scan and batched-GEMM
kernels do: RMSNorm's mean, the SSD decode contraction, top-p's prefix
sum and decode attention's sums go through `common.row_sum` / `row_mean`
/ `row_cumsum`, which pin the row count the kernel sees and sum a masked
key axis in a tree that zeros appended to it do not change;
scripts/batch_invariance.py gates them).  So every request's stream
equals `serve.generate` of that request alone, bit for bit
(tests/test_torch_engine.py; chip_smoke.py phase 13 on the card).

Not ported yet (each keyword keeps its place in the signature and raises
with its ROADMAP A6 item): the mesh, `spec_decode`, `prefix_cache`,
`prefill_chunk`, `admit_token_budget`, chaos injection and recovery,
the score / embed methods, and the encdec family (`enc_len`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import registry
from repro_torch.launch import methods as smethods
from repro_torch.launch import resilience as res
from repro_torch.launch import sampling
from repro_torch.launch import scheduler
from repro_torch.launch import serve
from repro_torch.models import lm, slot_state

# ROADMAP.md A6, the engine's remaining slices, in order
_LATER = {
    "encdec": "engine slice 2 (the encdec family and image prompts)",
    "prefill_chunk": "engine slice 3 (chunked prefill and the prefix "
                     "cache)",
    "prefix_cache": "engine slice 3 (chunked prefill and the prefix "
                    "cache)",
    "admit_token_budget": "engine slice 3 (chunked prefill and the "
                          "prefix cache)",
    "methods": "engine slice 4 (the score and embed methods)",
    "chaos": "engine slice 5 (chaos, recovery, replay, drain, snapshot)",
    "spec_decode": "engine slice 6 (speculative decoding)",
    "mesh": "engine slice 7 (the mesh and elastic paths, with A8)",
}


def _not_yet(what: str, item: str):
    return NotImplementedError(
        f"ServeEngine: {what} is not ported yet (ROADMAP.md A6, "
        f"{_LATER[item]})")


@dataclasses.dataclass(frozen=True)
class _EngineBundle:
    """The decode function shared by every engine with the same (cfg,
    pass set, lowering census, device), pinned to that census; stored in
    serve.py's LRU decode cache under an "engine" variant key.  The
    captured segment steps belong to each engine: they read its slot
    state and buffers at their addresses."""
    decode_fn: object      # (params, tok [B,1], state, pos, active)


def _engine_bundle(cfg, silvia_passes: str, device) -> _EngineBundle:
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
        return _EngineBundle(serve._pin_lowerings(decode_fn, dict(fp)))

    return serve._DECODE_CACHE.get_or_build(
        (cfg, silvia_passes, fp, "engine", None, dev), build)


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
    min_len_bucket / min_batch_bucket: smallest cache-length / batch
                    buckets (both clamped to the physical maxima).
    resilience:     ResilienceConfig (queue bound, shed policy, default
                    TTL); None = defaults (unbounded queue, no TTL).
    chaos:          None, or "env" while $REPRO_CHAOS is unset (fault
                    injection is not ported yet).
    device:         where the slot state lives and the steps run; "cuda"
                    by default (raises without CUDA, as every entry
                    point of the port).
    prefill_chunk, enc_len, prefix_cache, admit_token_budget,
    spec_decode:    the reference's; not ported yet (each raises with
                    its ROADMAP item when set).
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
        if cfg.family == "encdec" or enc_len is not None:
            raise _not_yet("the encdec family (enc_len, features)",
                           "encdec")
        for name, value in (("prefill_chunk", prefill_chunk),
                            ("prefix_cache", prefix_cache),
                            ("admit_token_budget", admit_token_budget),
                            ("spec_decode", spec_decode)):
            if value is not None:
                raise _not_yet(name, name)
        if chaos not in (None, "env") or (
                chaos == "env" and os.environ.get("REPRO_CHAOS")):
            raise _not_yet("fault injection (chaos)", "chaos")
        # raises with registry guidance for unregistered families
        self._spec = slot_state.spec_for(cfg)
        if segment_len < 1:
            raise ValueError("segment_len must be >= 1")
        self.device = device_lib.resolve(device)
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_cache_len = max_cache_len
        self.segment_len = segment_len
        self.silvia_passes = silvia_passes
        self.min_len_bucket = min(min_len_bucket, max_cache_len)
        self.min_batch_bucket = min(min_batch_bucket, n_slots)
        self._adm_floor = 1
        # smallest prompt bucket: avoids degenerate tiny prefill shapes
        self.min_prompt_bucket = min(8, max_cache_len)
        self.batch_buckets = scheduler.bucket_set(self.min_batch_bucket,
                                                  n_slots)
        self.len_buckets = scheduler.bucket_set(self.min_len_bucket,
                                                max_cache_len) \
            if self._spec.has_length_axis else ()
        self._lowerings = dict(registry.fingerprint(self.device))
        self._bundle = _engine_bundle(cfg, silvia_passes, self.device)
        self._queue = scheduler.RequestQueue()
        self._cache = self._spec.init_state(n_slots, max_cache_len,
                                            self.device)
        # per-slot sampling page, host-resident like _tok / _pos, shipped
        # [:bb] into the device buffers before each segment
        self._samp = sampling.host_page(n_slots)
        dev = self.device
        self._bufs = {
            "tok": torch.zeros((n_slots, 1), dtype=torch.int64, device=dev),
            "pos": torch.zeros((n_slots,), dtype=torch.int64, device=dev),
            "act": torch.zeros((n_slots,), dtype=torch.bool, device=dev),
            "samp": sampling.null_operand(n_slots, dev),
            "toks": torch.zeros((n_slots, segment_len), dtype=torch.int32,
                                device=dev),
            "bad": torch.zeros((n_slots,), dtype=torch.bool, device=dev),
            "step": torch.zeros((1,), dtype=torch.int64, device=dev),
        }
        self._segments: Dict[tuple, serve._CapturedStep] = {}
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
        self._site_counts = {"segment": 0, "prefill": 0}
        self._admitting: List[scheduler.Request] = []
        self._rids: set = set()
        self._results: Dict[int, res.RequestResult] = {}
        self._method_admits: Dict[str, int] = {m: 0
                                               for m in smethods.METHODS}
        self._robust: Dict[str, int] = {k: 0 for k in (
            "shed", "expired_queued", "expired_inflight", "failed",
            "quarantined", "duplicate_rejects", "cancelled_queued",
            "cancelled_inflight")}

    # -- request lifecycle --------------------------------------------------

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
                f"tracks that rid (rids key structured results)")
        if req.method != "generate":
            raise _not_yet(f"the {req.method!r} method", "methods")
        if req.served_len > self.max_cache_len:
            raise ValueError(
                f"request {req.rid}: prompt+gen {req.served_len} exceeds "
                f"max_cache_len {self.max_cache_len}")
        if req.features is not None:
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
            error=error, retries=req.retries)

    def _evict(self, slot: int) -> None:
        """Free a page: no scrubbing needed (see module docstring)."""
        self._active[slot] = False
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        self._pos[slot] = 0
        self._tok[slot] = 0
        sampling.clear_row(self._samp, slot)

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
        cur = scheduler.bucket_pow2(int(live[-1]) + 1,
                                    minimum=self.min_batch_bucket,
                                    maximum=self.n_slots)
        tgt = scheduler.bucket_pow2(int(live.size),
                                    minimum=self.min_batch_bucket,
                                    maximum=self.n_slots)
        if cur <= tgt:
            return False          # hole doesn't change the bucket
        holes = np.asarray([i for i in range(self.n_slots)
                            if not self._active[i]], np.int64)
        perm = np.concatenate([live, holes])
        self._spec.permute_slots(self._cache, perm)
        self._samp = sampling.permute(self._samp, perm)
        self._tok = self._tok[perm]
        self._pos = self._pos[perm]
        self._active = self._active[perm]
        self._remaining = self._remaining[perm]
        self._slot_req = [self._slot_req[i] for i in perm]
        self.compactions += 1
        return True

    def _admit(self, now: float, clock: scheduler.Clock) -> int:
        self._compact()
        free = [i for i in range(self.n_slots) if not self._active[i]]
        ready = self._queue.pop_ready(now, limit=len(free))
        if not ready:
            return 0
        # popped but not yet registered in a slot
        self._admitting = list(ready)
        # group by prompt bucket: one prefill shape per (batch bucket,
        # prompt bucket) covers the mix
        groups: Dict[int, List[scheduler.Request]] = {}
        for r in ready:
            groups.setdefault(self._prompt_bucket(r.prompt_len),
                              []).append(r)
        for sb, group in sorted(groups.items()):
            self._admit_group(group, sb, free, clock)
        self._admitting = []
        return len(ready)

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

    def _prefill_inputs(self, group: List[scheduler.Request], bb: int,
                        sb: int):
        prompts = np.zeros((bb, sb), np.int64)
        lens = np.ones((bb,), np.int64)
        for i, r in enumerate(group):
            prompts[i, :r.prompt_len] = r.prompt
            lens[i] = r.prompt_len
        return torch.as_tensor(prompts, device=self.device), lens

    def _prefill(self, inputs, lens: np.ndarray, t_pre: int):
        """One bucketed prefill: (tok0 [bb] greedy, last [bb, V] f32,
        the prefilled rows' state, bad0 [bb])."""
        logits, rows = lm.prefill(
            self.params, inputs, self.cfg, cache_len=t_pre,
            last_positions=torch.as_tensor(lens - 1, device=self.device))
        last = logits[:, -1, :]
        return (last.argmax(dim=-1), last, rows,
                ~torch.isfinite(last).all(dim=-1))

    def _admit_group(self, group: List[scheduler.Request], sb: int,
                     free: List[int], clock: scheduler.Clock) -> None:
        g = len(group)
        t_pre = self._prefill_bucket(sb)
        bb = scheduler.bucket_pow2(g, minimum=self._adm_floor,
                                   maximum=self.n_slots)
        inputs, lens = self._prefill_inputs(group, bb, sb)
        self._graphs.add(("prefill", bb, sb, t_pre))
        tok0, last, rows, bad0 = self._guarded("prefill", self._prefill,
                                               inputs, lens, t_pre)
        if any(not sampling.is_greedy(r) for r in group):
            # sampled first tokens from the final prefill rows at
            # generated-token index 0, on the device in one batched call
            # (per-row: bitwise what each row would sample alone)
            page = sampling.host_page(bb)
            for i, r in enumerate(group):
                sampling.write_row(page, i, r)
            key, temp, top_k, top_p, _ = sampling.operand(page, bb,
                                                          self.device)
            tok0 = sampling.sample(last, key, temp, top_k, top_p,
                                   torch.zeros_like(top_k))
        tok0 = tok0.cpu().numpy()
        bad0 = bad0.cpu().numpy()
        slots = np.asarray([free.pop(0) for _ in range(g)], np.int64)
        # scatter the admitted pages into their slots; leaves without a
        # length axis (SSM / conv state) are reset wholesale
        self._spec.admit(self._cache, rows, slots, g, t_pre=t_pre)
        del rows
        # registration time is read AFTER the admitting prefill (the
        # device sync above), so a request's TTFT includes its prefill
        self._register_admitted(group, tok0, bad0, slots, free,
                                clock.now())

    def _register_admitted(self, group: List[scheduler.Request],
                           tok0: np.ndarray, bad0: np.ndarray,
                           slots: np.ndarray, free: List[int],
                           now: float) -> None:
        """Per-request bookkeeping once a group's pages are in their
        slots: quarantine, the first token, the fresh stream's start."""
        for i, r in enumerate(group):
            slot = int(slots[i])
            self._admitting = [x for x in self._admitting if x is not r]
            self._method_admits[r.method] += 1
            if bad0[i]:
                self._robust["quarantined"] += 1
                self._finish(r, now, res.FAILED,
                             "non-finite logits at prefill")
                self._scrub(slot)
                free.append(slot)
                free.sort()
                continue
            sampling.write_row(self._samp, slot, r)
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
        the first bb rows of the slot state and the device buffers."""
        key = ("segment", bb, t_b, self.segment_len)
        s = self._segments.get(key)
        if s is None:
            bufs = {k: t if k == "step" else tuple(x[:bb] for x in t)
                    if k == "samp" else t[:bb]
                    for k, t in self._bufs.items()}
            s = serve._CapturedStep(
                self._bundle.decode_fn, self.params,
                self._spec.slice_live(self._cache, bb, t_b), bufs,
                self.device)
            self._segments[key] = s
            self._graphs.add(key)
        return s

    def _begin_segment(self) -> _PendingSegment:
        """Load the per-slot buffers and replay the bucket's captured step
        segment_len times; returns without syncing on the device."""
        bb, t_b = self._segment_shape()
        n_steps = self.segment_len
        step = self._segment_step(bb, t_b)
        b = self._bufs
        for name, host in (("tok", self._tok), ("pos", self._pos),
                           ("act", self._active)):
            b[name][:bb].copy_(torch.from_numpy(host[:bb]))
        for buf, leaf in zip(b["samp"], self._samp):
            buf[:bb].copy_(torch.from_numpy(leaf[:bb]))
        b["bad"].zero_()
        b["step"].zero_()
        self._guarded("segment", step.replay, n_steps)
        self.segments += 1
        self.occupancy.append(float(np.sum(self._active)) / self.n_slots)
        return _PendingSegment(bb=bb, n_steps=n_steps)

    def _finish_segment(self, p: _PendingSegment,
                        clock: scheduler.Clock) -> None:
        """Block on a dispatched segment's outputs and harvest."""
        b = self._bufs
        self._tok[:p.bb] = b["tok"][:p.bb].cpu().numpy()
        self._pos[:p.bb] = b["pos"][:p.bb].cpu().numpy()
        seq = b["toks"][:p.bb, :p.n_steps].cpu().numpy().T   # [n_steps, bb]
        self._harvest(seq, b["bad"][:p.bb].cpu().numpy(), clock.now())

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

    # -- dispatch sites, expiry, quarantine ---------------------------------

    def _guarded(self, kind: str, fn, *args):
        """Every device dispatch funnels through here: count the per-kind
        site, then call straight through (fault injection, which the
        reference runs here, is not ported yet)."""
        self._site_counts[kind] += 1
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
        zeros = self._spec.init_state(1, self.max_cache_len, self.device)
        self._spec.admit(self._cache, zeros, [slot], 1)

    # -- run loop -----------------------------------------------------------

    def step(self, clock: Optional[scheduler.Clock] = None) -> bool:
        """Admit what has arrived, then run one decode segment.  Returns
        False when there was nothing to do (the caller should wait for
        the next arrival).  A dispatch failure raises (recovery is not
        ported yet)."""
        clock = clock or scheduler.Clock()
        pending, progressed = self.step_begin(clock)
        if pending is None:
            return progressed
        self.step_finish(pending, clock)
        return True

    def step_begin(self, clock: Optional[scheduler.Clock] = None):
        """First half of step(): expire and admit, then dispatch one
        decode segment WITHOUT syncing on it.  Returns (pending,
        progressed); pending is None when no segment ran; otherwise the
        caller MUST call step_finish(pending)."""
        clock = clock or scheduler.Clock()
        now = clock.now()
        expired = self._expire(now)
        admitted = self._admit(now, clock)
        if not self._active.any():
            return None, bool(admitted or expired)
        return self._begin_segment(), True

    def step_finish(self, pending,
                    clock: Optional[scheduler.Clock] = None) -> bool:
        """Second half of step(): block on the dispatched segment and
        harvest its tokens."""
        self._finish_segment(pending, clock or scheduler.Clock())
        return True

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
        """Host-side admission planning safe to run while a segment is in
        flight.  The reference warms the prefix cache's digests here;
        there is no prefix cache yet, so there is nothing to plan."""
        return 0

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
        shape per (admission batch bucket, prompt bucket) -- what
        `warmup()` walks.  (The reference's bound also counts the chunk
        and embed grids of paths not ported yet.)"""
        seg = len(self.batch_buckets) * max(1, len(self.len_buckets))
        return seg + len(self.admission_batch_buckets) \
            * len(self.prompt_buckets)

    def warmup(self, prompt_lens: Optional[Sequence[int]] = None) -> int:
        """Capture the (batch bucket x length bucket) segment grid and,
        when the expected prompt lengths are given, run the prefill
        shapes they map to once (kernels built and loaded, the allocator
        warm); returns the number of graphs added.  Call it with no
        request in flight."""
        if self._active.any():
            raise RuntimeError("warmup() with requests in flight")
        n = 0
        for bb in self.batch_buckets:
            for t_b in (self.len_buckets or (None,)):
                if ("segment", bb, t_b, self.segment_len) not in \
                        self._graphs:
                    self._segment_step(bb, t_b)
                    n += 1
        if prompt_lens is None:
            return n
        for bb in self.admission_batch_buckets:
            for sb in sorted({self._prompt_bucket(pl)
                              for pl in prompt_lens}):
                t_pre = self._prefill_bucket(sb)
                key = ("prefill", bb, sb, t_pre)
                if key in self._graphs:
                    continue
                inputs = torch.zeros((bb, sb), dtype=torch.int64,
                                     device=self.device)
                out = self._prefill(inputs, np.ones((bb,), np.int64), t_pre)
                out[0].cpu()
                self._graphs.add(key)
                n += 1
        return n

    def cache_info(self) -> dict:
        """The graph census (engine shape keys, bounded by the bucket
        sets), capture time, the lowering census every graph was captured
        under, the decode-bundle LRU, and the robustness counters."""
        info = {
            "family": self.cfg.family,
            "has_length_axis": self._spec.has_length_axis,
            "graphs": len(self._graphs),
            "graph_bound": self.graph_bound(),
            "graph_keys": sorted(self._graphs,
                                 key=lambda k: tuple(str(x) for x in k)),
            "captured": sum(s.graph is not None
                            for s in self._segments.values()),
            "capture_ms": sum(s.capture_ms for s in self._segments.values()),
            "batch_buckets": list(self.batch_buckets),
            "len_buckets": list(self.len_buckets),
            "compactions": self.compactions,
            "segments": self.segments,
            "methods": {"admits": dict(self._method_admits)},
            "lowerings": dict(self._lowerings),
            "decode_bundle_lru": serve.decode_cache_info(),
            "robustness": dict(self._robust),
            "dispatch_sites": dict(self._site_counts),
            "resilience": {
                "max_queue": self._res.max_queue,
                "shed_policy": self._res.shed_policy,
                "default_ttl_s": self._res.default_ttl_s,
            },
        }
        if hasattr(self._bundle.decode_fn, "cache_info"):
            info["silvia"] = self._bundle.decode_fn.cache_info()
        return info

    @property
    def n_active(self) -> int:
        return int(np.sum(self._active))

    @property
    def n_queued(self) -> int:
        return len(self._queue)
