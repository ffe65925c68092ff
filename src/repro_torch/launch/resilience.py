"""Serving resilience: admission control, fault injection, recovery.

Port of `repro/launch/resilience.py`.  The engine's bar is
bit-exactness (engine == static `generate` of each request alone); this
module supplies the failure half of that story for `launch/engine.py`,
with the same proof obligation: a fault-injected run must reproduce the
fault-free streams exactly.

* **admission control** -- `ResilienceConfig`: a bounded request queue
  with a load-shedding policy (reject the newcomer, or drop the oldest
  queued request to make room) and per-request deadlines / TTL.  Expired
  queued requests never dispatch; expired in-flight requests are
  cancelled by slot eviction between segments, keeping their partial
  tokens.
* **structured outcomes** -- every submitted request ends in exactly one
  of `OK` / `SHED` / `EXPIRED` / `FAILED` / `CANCELLED`
  (`RequestResult`); dispatch exceptions recover instead of ending the
  engine's loop.
* **fault injection** -- `ChaosSchedule` extends
  `distributed.fault.FailureInjector` into the engine's dispatch path:
  sites are ``kind:index`` strings over the engine's per-kind dispatch
  counters (``segment:3``, ``prefill:0``, ``chunk:7``, ``embed:0``),
  listed explicitly or drawn by a seeded sha256 hash at a given rate --
  the reference's hash, so a spec fires at the same sites in both
  packages.  `$REPRO_CHAOS` arms every engine in the process.
* **recovery as replay** -- on a dispatch failure the engine requeues its
  in-flight requests WITH their emitted tokens; at re-admission it
  re-prefills the original prompt (same prompt bucket, same steps) and
  replays the emitted tokens through the single-token decode step with
  teacher forcing.  Replay repeats the ops of the fault-free run --
  prefill(prompt), then one decode step per token -- so recovered
  streams are bit-identical for every family; re-prefilling prompt +
  emitted in one go would not be for the sequential-state families (the
  SSD's chunked sums are not its stepwise decode's).  The engine checks
  each replayed token against the recorded stream and counts any
  difference (`replay_divergence`).

Snapshot / restore (`snapshot_requests` / `restore_requests`) persists
the queue and the per-slot request state through `checkpoint/ckpt.py`
for rolling restarts; device state is not serialized: restore re-enters
the recovery path above, which regenerates it.  The layout is the
reference's, so a snapshot written by either package restores in the
other.

Device loss (``lose@site`` arms, the reference's
`distributed.elastic.DeviceLossInjector`) is elastic degraded-mesh
serving, ROADMAP A11: it raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import ckpt
from repro_torch.distributed.fault import FailureInjector, SimulatedFailure

__all__ = ["OK", "SHED", "EXPIRED", "FAILED", "CANCELLED", "QUEUED",
           "RequestResult", "ResilienceConfig", "ChaosSchedule",
           "chaos_from_env", "snapshot_requests", "restore_requests",
           "SimulatedFailure"]

# terminal request outcomes (structured results instead of exceptions)
OK = "ok"              # full stream delivered
SHED = "shed"          # rejected by admission control (bounded queue)
EXPIRED = "expired"    # deadline/TTL passed (queued or in-flight)
FAILED = "failed"      # quarantined (non-finite logits) / retries exhausted
CANCELLED = "cancelled"  # client cancelled (cancel(rid))
# submit() return value for an accepted request (not a terminal outcome)
QUEUED = "queued"


@dataclasses.dataclass
class RequestResult:
    """Structured terminal outcome of one request (engine.results())."""
    rid: int
    outcome: str                # OK | SHED | EXPIRED | FAILED | CANCELLED
    tokens: List[int]           # possibly partial (EXPIRED/FAILED/CANCELLED)
    error: Optional[str] = None
    retries: int = 0                  # fault recoveries this request rode
    logprobs: Optional[List[float]] = None   # score method: per-token lp
    embedding: Optional[np.ndarray] = None   # embed method: [d_model] f32


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Admission-control policy for a `ServeEngine`.

    max_queue:       queued-request bound; None = unbounded.
    shed_policy:     what to do when the queue is full: "reject-new"
                     sheds the incoming request, "drop-oldest" sheds the
                     oldest queued request to admit the newcomer.
    default_ttl_s:   default per-request TTL (deadline = arrival + ttl)
                     applied at submit() when the request carries no
                     explicit deadline; None = no deadline.
    max_recoveries:  per-request cap on fault recoveries; a request that
                     exceeds it is FAILED instead of requeued (bounds the
                     work a persistently failing dispatch can absorb).
    """
    max_queue: Optional[int] = None
    shed_policy: str = "reject-new"
    default_ttl_s: Optional[float] = None
    max_recoveries: int = 8

    def __post_init__(self):
        if self.shed_policy not in ("reject-new", "drop-oldest"):
            raise ValueError(
                f"shed_policy must be 'reject-new' or 'drop-oldest', got "
                f"{self.shed_policy!r}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")


# ---------------------------------------------------------------------------
# fault schedules
# ---------------------------------------------------------------------------

def _hash_frac(seed: int, site: str) -> float:
    """Deterministic uniform [0, 1) from (seed, site), stable across
    processes, hosts and the two packages (unlike `hash()`)."""
    h = hashlib.sha256(f"{seed}|{site}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


@dataclasses.dataclass
class ChaosSchedule(FailureInjector):
    """FailureInjector over serving dispatch sites.

    Sites are ``kind:index`` strings over the engine's per-kind dispatch
    counters.  A site fails when listed in `fail_at_sites` or when the
    deterministic hash of (seed, site) falls under `rate`; each site
    fires at most once and `max_failures` (if set) caps the injections,
    so chaos always makes forward progress.
    """
    rate: float = 0.0
    seed: int = 0
    max_failures: Optional[int] = None

    # the engine's guarded dispatch kinds (launch/engine.py _guarded);
    # draft / verify are the speculative-decode round's (engine slice 6)
    SITE_KINDS = frozenset({"segment", "prefill", "chunk", "embed",
                            "draft", "verify"})

    def should_fail(self, site: str) -> bool:
        if site in self.fail_at_sites:
            return True
        return self.rate > 0 and _hash_frac(self.seed, site) < self.rate

    def check_site(self, site: str) -> None:
        if site in self.failed:
            return
        if self.max_failures is not None \
                and len(self.failed) >= self.max_failures:
            return
        if self.should_fail(site):
            self.failed.add(site)
            raise SimulatedFailure(f"injected serving fault at {site}")

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        """Parse a $REPRO_CHAOS schedule.

        Tokens separated by ',' or ';': explicit sites ``kind:index``
        (e.g. ``segment:3``), and / or ``rate=F`` / ``seed=N`` / ``max=N``
        for the deterministic random schedule::

            REPRO_CHAOS='segment:1;prefill:0'
            REPRO_CHAOS='rate=0.05,seed=11'
            REPRO_CHAOS='rate=0.2,seed=3,max=4;chunk:2'
        """
        sites: List[str] = []
        rate, seed, max_failures = 0.0, 0, None
        for tok in (t.strip() for part in spec.split(";")
                    for t in part.split(",")):
            if not tok:
                continue
            if "=" in tok:
                k, v = tok.split("=", 1)
                k = k.strip()
                if k == "rate":
                    rate = float(v)
                elif k == "seed":
                    seed = int(v)
                elif k == "max":
                    max_failures = int(v)
                else:
                    raise ValueError(
                        f"REPRO_CHAOS: unknown key {k!r} in {spec!r} "
                        f"(want rate=/seed=/max= or kind:index sites)")
            elif ":" in tok:
                kind, idx = tok.split(":", 1)
                if kind not in cls.SITE_KINDS or not idx.isdigit():
                    raise ValueError(
                        f"REPRO_CHAOS: bad site {tok!r} (want "
                        f"segment:N, prefill:N, chunk:N, embed:N, "
                        f"draft:N or verify:N)")
                sites.append(tok)
            else:
                raise ValueError(f"REPRO_CHAOS: cannot parse token {tok!r}")
        return cls(fail_at_sites=tuple(sites), rate=rate, seed=seed,
                   max_failures=max_failures)


def chaos_from_env() -> Optional[ChaosSchedule]:
    """The process-wide chaos schedule from $REPRO_CHAOS (None if unset),
    read at engine construction.  Device-loss arms (``lose@site``,
    ``lose_rate=``) need the mesh and raise."""
    spec = os.environ.get("REPRO_CHAOS", "").strip()
    if not spec:
        return None
    if "lose" in spec:
        raise NotImplementedError(
            f"REPRO_CHAOS={spec!r}: device-loss arms are elastic "
            f"degraded-mesh serving, not ported yet (ROADMAP.md A11)")
    return ChaosSchedule.parse(spec)


# ---------------------------------------------------------------------------
# queue + per-slot request snapshots (rolling restarts)
# ---------------------------------------------------------------------------

def _encode_requests(requests: Sequence[Any]) -> Tuple[list, dict]:
    """(tree of arrays, JSON-able meta) for checkpoint/ckpt.py: the prompt,
    the emitted tokens and the optional encdec features and score
    completion go in the tree; scalars ride in the checkpoint's meta.
    Device state is absent: restore replays (module docstring)."""
    tree, meta = [], []
    for r in requests:
        leaf = {"prompt": np.asarray(r.prompt, np.int32),
                "tokens": np.asarray(r.tokens, np.int32)}
        if r.features is not None:
            leaf["features"] = np.asarray(r.features, np.float32)
        if r.score_tokens is not None:
            leaf["score_tokens"] = np.asarray(r.score_tokens, np.int32)
        tree.append(leaf)
        meta.append({
            "rid": int(r.rid),
            "max_new_tokens": int(r.max_new_tokens),
            "arrival_time": float(r.arrival_time),
            "deadline": None if r.deadline is None else float(r.deadline),
            "stop_tokens": None if r.stop_tokens is None
            else [int(t) for t in r.stop_tokens],
            "retries": int(r.retries),
            "has_features": r.features is not None,
            "method": r.method,
            "has_score_tokens": r.score_tokens is not None,
            # the counter-based sampling keys need only these scalars, so
            # a restored sampled request replays -- and then continues --
            # its exact stream with no sampler state in the snapshot
            "sampling": None if r.sampling is None else {
                "temperature": float(r.sampling.temperature),
                "top_k": int(r.sampling.top_k),
                "top_p": float(r.sampling.top_p),
                "seed": int(r.sampling.seed),
            },
        })
    return tree, {"requests": meta}


def snapshot_requests(ckpt_dir: str, step: int, requests: Sequence[Any],
                      extra: Optional[dict] = None) -> str:
    """Atomically persist request-level serve state (ckpt.py layout).
    `extra` rides along in the checkpoint meta; restore ignores it."""
    tree, meta = _encode_requests(requests)
    if extra:
        meta = {**extra, **meta}    # "requests" always wins
    return ckpt.save_checkpoint(ckpt_dir, step, tree, extra_meta=meta)


def restore_requests(ckpt_dir: str, step: Optional[int] = None) -> list:
    """Rebuild `scheduler.Request`s from a snapshot ([] when no committed
    snapshot exists).  Requests with emitted tokens re-enter the engine
    on the recovery / replay path."""
    from repro_torch.launch import scheduler  # here: an import cycle

    meta, step = ckpt.load_meta(ckpt_dir, step=step)
    if meta is None:
        return []
    entries = meta["requests"]
    like = []
    for e in entries:
        leaf = {"prompt": np.zeros(0, np.int32),
                "tokens": np.zeros(0, np.int32)}
        if e["has_features"]:
            leaf["features"] = np.zeros(0, np.float32)
        if e.get("has_score_tokens"):
            leaf["score_tokens"] = np.zeros(0, np.int32)
        like.append(leaf)
    tree, _ = ckpt.restore_checkpoint(ckpt_dir, like, step=step)
    out = []
    for e, leaf in zip(entries, tree):
        req = scheduler.Request(
            rid=e["rid"], prompt=np.asarray(leaf["prompt"], np.int32),
            max_new_tokens=e["max_new_tokens"],
            arrival_time=e["arrival_time"],
            stop_tokens=e["stop_tokens"],
            features=np.asarray(leaf["features"], np.float32)
            if e["has_features"] else None,
            deadline=e["deadline"],
            method=e.get("method", "generate"),
            score_tokens=[int(t) for t in np.asarray(leaf["score_tokens"])]
            if e.get("has_score_tokens") else None,
            sampling=None if e.get("sampling") is None
            else scheduler.SamplingParams(**e["sampling"]))
        req.tokens = [int(t) for t in np.asarray(leaf["tokens"])]
        req.retries = e["retries"]
        out.append(req)
    return out
