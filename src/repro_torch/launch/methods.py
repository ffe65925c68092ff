"""Servable methods: request constructors for the engine.

Port of `repro/launch/methods.py`, its generate part: `METHODS` and
`generate_request`.  The engine serves ``generate`` (decode of up to
max_new_tokens, greedy or sampled per request); ``score`` and ``embed``
(`score_request`, `embed_request`, their result decoding and their
engine paths, with `lm.embed_pool`) come with the engine's methods
slice (ROADMAP A6, engine slice 4).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.launch import scheduler

METHODS = ("generate", "score", "embed")


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
