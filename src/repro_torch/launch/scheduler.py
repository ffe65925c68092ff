"""Request-level scheduling for the continuous-batching serve engine.

Port of `repro/launch/scheduler.py`, all of it (it is numpy only):

* `Request` / `RequestQueue`: FIFO admission with arrival-time gating, so
  synthetic Poisson traffic (or a real frontend) can feed the engine.
* shape **buckets**: batch sizes and cache/prompt lengths are rounded up to
  a small power-of-two set, so the engine captures a handful of decode
  graphs (one per (batch bucket, cache-length bucket)), bounded by the
  bucket-set product.
* `synthetic_traffic` / `shared_prefix_traffic` / `method_traffic`:
  Poisson arrivals with mixed lengths, drawn from numpy's
  `default_rng(seed)` in the reference's order, so one seed gives the
  reference's requests, field for field.
* `Clock` (wall) and `FastForwardClock` (idle waits skipped).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------

def bucket_pow2(n: int, minimum: int = 1, maximum: Optional[int] = None) -> int:
    """Smallest power of two >= n, clamped to [minimum, maximum].

    `minimum` must itself be a power of two; `maximum` need not be -- it is
    an inclusive cap (the physical slot count / cache capacity)."""
    if n < 0:
        raise ValueError(f"bucket_pow2: negative size {n}")
    b = max(minimum, 1)
    while b < n:
        b *= 2
    if maximum is not None:
        if n > maximum:
            raise ValueError(f"size {n} exceeds bucket cap {maximum}")
        b = min(b, maximum)
    return b


def validate_slot_sharding(n_slots: int, dp_size: int) -> None:
    """Mesh-aware engines shard the slot axis over `dp_size` data shards:
    every batch bucket must split evenly, so the bucket FLOOR becomes
    dp_size and n_slots (the bucket cap, included verbatim in the bucket
    set) must be a multiple of it.  dp_size must be a power of two so the
    floored power-of-two bucket set stays shard-divisible throughout."""
    if dp_size < 1 or dp_size & (dp_size - 1):
        raise ValueError(
            f"sharded serve needs a power-of-two data-shard count, got "
            f"{dp_size} (mesh dp axes)")
    if n_slots % dp_size:
        raise ValueError(
            f"n_slots {n_slots} is not a multiple of the data-shard count "
            f"{dp_size}: the slot axis cannot split evenly over the mesh")


def largest_valid_dp(n_slots: int, max_dp: int) -> int:
    """Largest data-shard count that `validate_slot_sharding` accepts
    with at most `max_dp` shards: a power of two dividing n_slots (>= 1).
    The degraded-mesh planner (distributed/elastic.py) uses this to pick
    the widest data extent a shrunken device budget still supports."""
    d = 1
    while d * 2 <= max_dp and n_slots % (d * 2) == 0:
        d *= 2
    return d


def bucket_set(minimum: int, maximum: int) -> tuple:
    """All buckets bucket_pow2 can produce in [minimum, maximum]: the
    powers of two in range plus the cap itself.  The compiled-graph count
    is bounded by products of these sets."""
    out = []
    b = max(minimum, 1)
    while b < maximum:
        out.append(b)
        b *= 2
    out.append(maximum)
    return tuple(out)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy (launch/sampling.py executes it).

    temperature <= 0 selects greedy argmax -- bit-identical to the
    pre-sampling engine.  With temperature > 0, logits are divided by the
    temperature, truncated to the `top_k` highest entries (0 = disabled)
    and to the smallest `top_p` nucleus (1.0 = disabled), and sampled via
    Gumbel-max with a counter-based key folded from (seed, rid, token
    index) -- so a request's stream is a pure function of (seed, rid,
    token prefix), which is what lets chaos recovery replay and
    prefix-cache warm runs reproduce byte-identical sampled tokens."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


@dataclasses.dataclass(eq=False)      # identity eq: prompt arrays don't
class Request:                        # support elementwise == in `in`/remove
    """One generation request.  `prompt` is a 1-D int token array; the
    engine generates up to `max_new_tokens` greedy tokens, stopping the
    segment a token in `stop_tokens` is emitted (the stop token is the
    last token of the output).  `features` carries per-request modality
    inputs for encoder-decoder families (whisper: [enc_len, d_model]
    precomputed frame embeddings).  `deadline` is an absolute time in the
    serving clock's domain (same domain as `arrival_time`); past it the
    request is EXPIRED instead of (further) served -- the engine fills it
    from its default TTL when left None (launch/resilience.py).

    `method` selects the servable method (launch/methods.py):
      generate  greedy decode of up to max_new_tokens (the default);
      score     teacher-force `score_tokens` and report their per-token
                logprobs (no sampling; max_new_tokens is unused);
      embed     pooled final-hidden-state embedding of the prompt (one
                prefill-shaped dispatch, no decode slot consumed)."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_time: float = 0.0
    stop_tokens: Optional[Sequence[int]] = None
    features: Optional[np.ndarray] = None
    deadline: Optional[float] = None
    method: str = "generate"
    score_tokens: Optional[Sequence[int]] = None
    # per-request sampling policy; None means greedy (generate only --
    # score teacher-forces and embed never samples)
    sampling: Optional[SamplingParams] = None
    # filled in by the engine:
    tokens: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    outcome: Optional[str] = None      # resilience.OK/SHED/EXPIRED/...
    error: Optional[str] = None
    retries: int = 0                   # fault recoveries survived
    logprobs: List[float] = dataclasses.field(default_factory=list)
    embedding: Optional[np.ndarray] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")
        if self.stop_tokens is not None:
            self.stop_tokens = tuple(int(t) for t in self.stop_tokens)
        if self.method not in ("generate", "score", "embed"):
            raise ValueError(
                f"request {self.rid}: unknown method {self.method!r} "
                f"(want generate/score/embed)")
        if self.method == "score":
            if self.score_tokens is None or len(self.score_tokens) == 0:
                raise ValueError(
                    f"request {self.rid}: score needs score_tokens")
            self.score_tokens = tuple(int(t) for t in self.score_tokens)
        elif self.score_tokens is not None:
            raise ValueError(
                f"request {self.rid}: score_tokens only valid with "
                f"method='score'")
        if self.sampling is not None:
            if not isinstance(self.sampling, SamplingParams):
                raise ValueError(
                    f"request {self.rid}: sampling must be a "
                    f"SamplingParams, got {type(self.sampling).__name__}")
            if self.method != "generate" and not self.sampling.greedy:
                raise ValueError(
                    f"request {self.rid}: sampling is generate-only "
                    f"(method {self.method!r} never samples)")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def served_len(self) -> int:
        """Cache positions the request actually needs under its method
        (what the engine validates against max_cache_len)."""
        if self.method == "score":
            return self.prompt_len + len(self.score_tokens)
        if self.method == "embed":
            return self.prompt_len
        return self.total_len

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time


class RequestQueue:
    """FIFO queue with arrival-time gating."""

    _ORDER = staticmethod(lambda r: (r.arrival_time, r.rid))

    def __init__(self, requests: Sequence[Request] = ()):
        self._pending: List[Request] = sorted(requests, key=self._ORDER)

    def submit(self, req: Request) -> None:
        bisect.insort(self._pending, req, key=self._ORDER)

    def __len__(self) -> int:
        return len(self._pending)

    def next_arrival(self, now: float) -> Optional[float]:
        """Earliest arrival time still in the future (None if the queue is
        empty or something is already ready)."""
        if not self._pending:
            return None
        t = self._pending[0].arrival_time
        return None if t <= now else t

    def pop_ready(self, now: float, limit: int,
                  predicate=None) -> List[Request]:
        """Up to `limit` requests whose arrival_time <= now, FIFO order.
        With `predicate`, only matching requests are taken (non-matching
        arrived requests keep their queue position)."""
        out: List[Request] = []
        i = 0
        while i < len(self._pending) and len(out) < limit \
                and self._pending[i].arrival_time <= now:
            if predicate is None or predicate(self._pending[i]):
                out.append(self._pending.pop(i))
            else:
                i += 1
        return out

    def pop_expired(self, now: float) -> List[Request]:
        """Remove and return every queued request whose deadline passed
        (arrived or not: a deadline can lapse while still in transit)."""
        out = [r for r in self._pending if r.expired(now)]
        if out:
            dead = {id(r) for r in out}
            self._pending = [r for r in self._pending
                             if id(r) not in dead]
        return out

    def pop_oldest(self) -> Optional[Request]:
        """Remove and return the head of the queue (drop-oldest load
        shedding); None when empty."""
        return self._pending.pop(0) if self._pending else None

    def remove(self, rid: int) -> Optional[Request]:
        """Remove and return the queued request with this rid (client
        cancellation before admission); None if not queued."""
        for i, r in enumerate(self._pending):
            if r.rid == rid:
                return self._pending.pop(i)
        return None

    def pending(self) -> tuple:
        """Snapshot view of the queued requests (FIFO order)."""
        return tuple(self._pending)


# ---------------------------------------------------------------------------
# synthetic traffic
# ---------------------------------------------------------------------------

def synthetic_traffic(seed: int, n_requests: int, rate: float,
                      prompt_lens: Sequence[int], gen_lens: Sequence[int],
                      vocab: int,
                      ttls: Optional[Sequence[Optional[float]]] = None,
                      sampling_mix: Optional[Sequence[
                          Optional[SamplingParams]]] = None,
                      ) -> List[Request]:
    """Poisson arrivals (exponential inter-arrival gaps at `rate` req/s)
    with prompt/gen lengths drawn uniformly from the given mixes.  With
    `ttls`, each request draws a TTL from the mix (None entries mean no
    deadline) -- the deadline mix for resilience benchmarks/tests.  With
    `sampling_mix`, each request draws a SamplingParams from the mix
    (None entries mean greedy) -- the policy mix for sampling tests."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        pl = int(rng.choice(np.asarray(prompt_lens)))
        gl = int(rng.choice(np.asarray(gen_lens)))
        prompt = rng.integers(0, vocab, size=pl, dtype=np.int32)
        deadline = None
        if ttls is not None:
            ttl = ttls[int(rng.integers(0, len(ttls)))]
            deadline = None if ttl is None else t + float(ttl)
        sampling = None
        if sampling_mix is not None:
            sampling = sampling_mix[int(rng.integers(0, len(sampling_mix)))]
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gl,
                            arrival_time=t, deadline=deadline,
                            sampling=sampling))
    return reqs


def shared_prefix_traffic(seed: int, n_requests: int, rate: float,
                          n_prefixes: int, prefix_len: int,
                          tail_lens: Sequence[int],
                          gen_lens: Sequence[int], vocab: int,
                          zipf_a: float = 1.2,
                          ttls: Optional[Sequence[Optional[float]]] = None,
                          ) -> List[Request]:
    """Poisson arrivals whose prompts share prefixes zipfian-style: each
    request draws one of `n_prefixes` fixed prefix token blocks with
    P(k) proportional to 1/(k+1)^zipf_a (a few system prompts dominate,
    a long tail of rare ones -- the real-traffic shape that makes a
    cross-request prefix cache pay), then appends a fresh random tail of
    a length drawn from `tail_lens`.  Same rate/gen/TTL machinery as
    synthetic_traffic."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, size=prefix_len, dtype=np.int32)
                for _ in range(n_prefixes)]
    w = 1.0 / np.arange(1, n_prefixes + 1, dtype=np.float64) ** zipf_a
    w /= w.sum()
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        pre = prefixes[int(rng.choice(n_prefixes, p=w))]
        tl = int(rng.choice(np.asarray(tail_lens)))
        tail = rng.integers(0, vocab, size=tl, dtype=np.int32)
        gl = int(rng.choice(np.asarray(gen_lens)))
        deadline = None
        if ttls is not None:
            ttl = ttls[int(rng.integers(0, len(ttls)))]
            deadline = None if ttl is None else t + float(ttl)
        reqs.append(Request(rid=i, prompt=np.concatenate([pre, tail]),
                            max_new_tokens=gl, arrival_time=t,
                            deadline=deadline))
    return reqs


def method_traffic(seed: int, n_requests: int, rate: float,
                   prompt_lens: Sequence[int], gen_lens: Sequence[int],
                   vocab: int,
                   method_mix: Optional[Sequence] = None,
                   score_lens: Sequence[int] = (4, 8),
                   ) -> List[Request]:
    """Poisson open-loop traffic mixing servable methods: each request
    draws a method from `method_mix` -- a sequence of (method, weight)
    pairs (default: 70% generate / 20% score / 10% embed).  Score
    requests carry a random completion of a length drawn from
    `score_lens`.  This is the trace shape `benchmarks/serve_latency.py`
    replays against the async front-end."""
    if method_mix is None:
        method_mix = (("generate", 0.7), ("score", 0.2), ("embed", 0.1))
    names = [m for m, _ in method_mix]
    w = np.asarray([float(p) for _, p in method_mix], np.float64)
    w /= w.sum()
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        pl = int(rng.choice(np.asarray(prompt_lens)))
        gl = int(rng.choice(np.asarray(gen_lens)))
        prompt = rng.integers(0, vocab, size=pl, dtype=np.int32)
        method = names[int(rng.choice(len(names), p=w))]
        score_tokens = None
        if method == "score":
            sl = int(rng.choice(np.asarray(score_lens)))
            score_tokens = rng.integers(0, vocab, size=sl,
                                        dtype=np.int32).tolist()
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gl,
                            arrival_time=t, method=method,
                            score_tokens=score_tokens))
    return reqs


# ---------------------------------------------------------------------------
# clocks (real serving vs fast-forward benchmarking)
# ---------------------------------------------------------------------------

class Clock:
    """Wall clock: now() advances with real time, wait_until() sleeps."""

    def __init__(self):
        import time
        self._time = time
        self._t0 = time.monotonic()

    def now(self) -> float:
        return self._time.monotonic() - self._t0

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            self._time.sleep(dt)


class FastForwardClock(Clock):
    """Clock for benchmarks: compute time is measured for real, but idle
    waits (no request in flight, none arrived yet) are skipped by jumping
    the clock forward, so a simulated Poisson trace replays instantly."""

    def __init__(self):
        super().__init__()
        self._skew = 0.0

    def now(self) -> float:
        return super().now() + self._skew

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            self._skew += dt
