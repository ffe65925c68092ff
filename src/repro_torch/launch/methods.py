"""Servable methods: request builders and result decoding.

Port of `repro/launch/methods.py`.  The engine serves three request
methods (scheduler.Request.method), all through the same decode steps:

* ``generate`` -- decode of up to max_new_tokens (greedy, or sampled per
  request).
* ``score``    -- per-token logprobs of a FIXED completion under the
  prompt.  The engine teacher-forces the completion through the same
  single-token replay step recovery uses (engine._drain_replay), so the
  logits row each scored token is conditioned on is bitwise the row
  greedy decode would have produced at that position: scoring is exact
  by construction, not by tolerance.
* ``embed``    -- one pooled vector per request: the final hidden states'
  masked mean over the prompt (lm.embed_pool), one prefill-shaped
  launch that takes NO decode slot.

``logprob_from_logits`` is the one logits-row to logprob map: the engine
scores with it and tests recompute references with it, so score-vs-
decode parity is a statement about logits bits, never about a tolerance
on the host arithmetic.  It is the reference's float32 numpy arithmetic,
so the same row gives the same float in both packages.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.launch import resilience as res
from repro_torch.launch import scheduler

METHODS = ("generate", "score", "embed")


def logprob_from_logits(row, token: int) -> float:
    """log softmax(row)[token] in float32 on the host (max-shifted, one
    np.sum).  Bitwise-identical rows give bitwise-identical logprobs."""
    row = np.asarray(row, np.float32)
    m = row.max()
    z = np.log(np.sum(np.exp(row - m), dtype=np.float32))
    return float(row[int(token)] - m - z)


# -- request builders -------------------------------------------------------

def generate_request(rid: int, prompt, max_new_tokens: int, *,
                     arrival_time: float = 0.0,
                     stop_tokens: Optional[Sequence[int]] = None,
                     features=None,
                     deadline: Optional[float] = None,
                     sampling: Optional[scheduler.SamplingParams] = None,
                     ) -> scheduler.Request:
    """`sampling` carries the per-request policy (temperature / top-k /
    top-p / seed, launch/sampling.py); None (the default) is greedy."""
    return scheduler.Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                             max_new_tokens=int(max_new_tokens),
                             arrival_time=arrival_time,
                             stop_tokens=stop_tokens, features=features,
                             deadline=deadline, sampling=sampling)


def score_request(rid: int, prompt, completion: Sequence[int], *,
                  arrival_time: float = 0.0, features=None,
                  deadline: Optional[float] = None) -> scheduler.Request:
    """Score `completion` under `prompt`: the result's ``logprobs[i]`` is
    the logprob of completion[i] given prompt + completion[:i].
    max_new_tokens is unused by scoring (the completion bounds the work)
    but the Request invariant wants >= 1."""
    return scheduler.Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                             max_new_tokens=1, arrival_time=arrival_time,
                             features=features, deadline=deadline,
                             method="score",
                             score_tokens=tuple(int(t) for t in completion))


def embed_request(rid: int, prompt, *, arrival_time: float = 0.0,
                  features=None,
                  deadline: Optional[float] = None) -> scheduler.Request:
    return scheduler.Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                             max_new_tokens=1, arrival_time=arrival_time,
                             features=features, deadline=deadline,
                             method="embed")


# -- result decoding --------------------------------------------------------

def _check_ok(result: res.RequestResult, want: str) -> None:
    if result.outcome != res.OK:
        raise RuntimeError(
            f"request {result.rid}: {want} unavailable, outcome "
            f"{result.outcome!r} ({result.error})")


def completion_logprobs(result: res.RequestResult) -> list:
    """The per-token logprobs of a finished score request."""
    _check_ok(result, "logprobs")
    if result.logprobs is None:
        raise RuntimeError(f"request {result.rid}: no logprobs recorded "
                           f"(not a score request?)")
    return list(result.logprobs)


def embedding(result: res.RequestResult) -> np.ndarray:
    """The pooled embedding of a finished embed request."""
    _check_ok(result, "embedding")
    if result.embedding is None:
        raise RuntimeError(f"request {result.rid}: no embedding recorded "
                           f"(not an embed request?)")
    return np.asarray(result.embedding, np.float32)
