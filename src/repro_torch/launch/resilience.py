"""Serving resilience: admission control and structured outcomes.

Port of the admission-control part of `repro/launch/resilience.py`
(:67-121): the terminal outcome constants, `RequestResult` and
`ResilienceConfig` -- a bounded request queue with a load-shedding
policy (reject the newcomer, or drop the oldest queued request to make
room) and per-request deadlines / TTL.  Expired queued requests never
dispatch; expired in-flight requests are cancelled by slot eviction
between segments, keeping their partial tokens.  Fault injection
(`ChaosSchedule`, `chaos_from_env`), recovery as replay and
snapshot / restore come with the engine's resilience slice (ROADMAP A6,
engine slice 5).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["OK", "SHED", "EXPIRED", "FAILED", "CANCELLED", "QUEUED",
           "RequestResult", "ResilienceConfig"]

# terminal request outcomes (structured results instead of exceptions)
OK = "ok"              # full stream delivered
SHED = "shed"          # rejected by admission control (bounded queue)
EXPIRED = "expired"    # deadline/TTL passed (queued or in-flight)
FAILED = "failed"      # quarantined (non-finite logits)
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
    max_recoveries:  per-request cap on fault recoveries (kept for the
                     reference's signature; recovery is not ported yet).
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
