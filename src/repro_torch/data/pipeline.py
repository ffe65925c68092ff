"""Deterministic sharded token pipeline (port of `repro/data/pipeline.py`,
numpy, a copy of the reference's own: the port imports nothing of it).

Design constraints for large-scale runs:

* **Exact resume**: batch contents are a pure function of (seed, step,
  shard), so a restarted job skips to `start_step` and reproduces the
  stream without replaying data (checkpoint stores only the step).
* **Sharding**: each data-parallel shard draws its own slice of the global
  batch; host h of H hosts materializes rows [h*B/H, (h+1)*B/H).
* **Sources**: `synthetic` (seeded LCG tokens, always available -- used by
  smoke tests and the dry-run) and `mmap` (memory-mapped token file,
  production-style, zero-copy reads).
* **Prefetch**: a small lookahead buffer computed on the host thread;
  the caller copies each batch to the device (`launch/train.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | mmap
    path: Optional[str] = None         # token file for mmap
    n_hosts: int = 1
    host_id: int = 0


class TokenStream:
    """Iterator of {tokens: [b, S+1] int32} host-local batches by step."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._mm = None
        if cfg.source == "mmap":
            assert cfg.path, "mmap source needs a token file path"
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> np.ndarray:
        """[local_batch, seq_len + 1] int32 tokens for `step` (pure fn)."""
        cfg = self.cfg
        if cfg.source == "synthetic":
            # counter-based RNG: one Philox-seeded generator per (step, host)
            rng = np.random.Generator(np.random.Philox(
                key=cfg.seed, counter=[step, cfg.host_id, 0, 0]))
            return rng.integers(0, cfg.vocab,
                                (self.local_batch, cfg.seq_len + 1),
                                dtype=np.int32)
        # mmap: strided contiguous windows, deterministic per (step, host)
        n_tok = self._mm.shape[0]
        span = cfg.seq_len + 1
        windows = max(1, (n_tok - span) // span)
        rows = []
        for r in range(self.local_batch):
            gidx = (step * cfg.global_batch
                    + cfg.host_id * self.local_batch + r)
            off = (gidx * 2654435761 % windows) * span
            rows.append(np.asarray(self._mm[off:off + span], np.int32))
        return np.stack(rows)

    def iterate(self, start_step: int = 0,
                prefetch: int = 2) -> Iterator[np.ndarray]:
        """Prefetching iterator starting at `start_step` (exact resume)."""
        import collections
        buf: collections.deque = collections.deque()
        step = start_step
        while True:
            while len(buf) < prefetch:
                buf.append(self.batch_at(step))
                step += 1
            yield buf.popleft()


def synthetic_stream(seq_len, global_batch, vocab, seed=0, **kw):
    return TokenStream(DataConfig(seq_len, global_batch, vocab, seed,
                                  "synthetic", **kw))


def mmap_stream(path, seq_len, global_batch, vocab, **kw):
    return TokenStream(DataConfig(seq_len, global_batch, vocab,
                                  source="mmap", path=path, **kw))


def make_stream(cfg: DataConfig) -> TokenStream:
    return TokenStream(cfg)
