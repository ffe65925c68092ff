"""Cross-request prefix cache over the paged slot state.

Port of `repro/launch/prefix_cache.py`, key for key: the same sha256
construction, so the port's chain and terminal keys are the reference's
bytes for the same prompt, salt and features.  Requests that share a
system prompt, a few-shot template or RAG boilerplate would each
re-prefill it on a cold engine; this cache hashes prompt token chunks
into a content-addressed pool of immutable prefix pages, and admission
looks up the longest cached prefix and prefills only the uncached tail.

Why sharing is EXACT: a slot's KV rows [0, L) are a pure function of
the token prefix -- each row is written once at its own position and
attention masks everything beyond a row's own position
(models/attention.py), so pages captured from one request's prefill are
bitwise the pages any other request with the same prefix would have
computed.  Constant-size state (SSM, conv windows, cross-KV) is a
snapshot of the state AFTER the whole prefix, so it is only shared at
exact-full-prompt granularity (a terminal entry); per-chunk checkpoints
exist only for families whose prefill is chunkable without changing the
floating-point reduction order (slot_state.FamilyState.prefill_chunkable).

Two entry kinds:

* **chain** entries -- one per prefill chunk, keyed by a rolling hash
  h_k = H(h_{k-1} || tokens[kC:(k+1)C)), so a chunk is only reachable
  through the exact token prefix in front of it.  Chain entries hold the
  length-axis page slices of their chunk and exist only for chunked
  engines whose state is entirely length-paged.
* **terminal** entries -- keyed by the full prompt (plus the encoder
  features digest for encdec), holding ALL pages [0:prompt_len) plus
  constant-size state snapshots AND the first greedy token, so an exact
  repeat skips prefill entirely (zero launches).

Copy-on-write: pool pages are immutable host tensors
(`slot_state.extract_row_pages`, pinned when they came off the card);
admission COPIES them into the admitted slot's private state, and
decode mutates only that working copy.  The reference keeps host numpy
so that its pool is mesh-free and survives an elastic re-plan; the
port's is host-resident for the same reason.  `note_remesh` records
the mesh a pool serves (info()'s `remeshes` and `mesh_fingerprint`):
the mesh-aware engine calls it at construction.  There every rank
keeps a pool of the same entries -- the same scheduler looks up,
inserts, pins and evicts them -- each page holding that rank's own
heads (launch/engine.py `_prefix_admit_full`).

Capacity is bounded in page units (1 per entry) with LRU eviction that
skips pinned entries: an entry is pinned while any live slot was admitted
from it and unpinned at eviction, so a page a later recovery might need
cannot be evicted mid-flight.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Entry:
    """One pooled page set (a chain chunk or a terminal prefix)."""
    key: bytes
    pages: list                 # slot_state.extract_row_pages output
    kind: str                   # "chain" | "terminal"
    tok0: Optional[int] = None  # terminal only: the first sampled token
    refs: int = 0               # live slots admitted from this entry


@dataclasses.dataclass
class Lookup:
    """Longest cached prefix for one request."""
    terminal: Optional[Entry]
    chain: List[Entry]
    cached_tokens: int

    @property
    def hit(self) -> bool:
        return self.cached_tokens > 0


def _features_digest(features) -> bytes:
    if features is None:
        return b""
    a = np.asarray(features, np.float32)
    return hashlib.sha256(a.tobytes() + str(a.shape).encode()).digest()


class PrefixCache:
    """Content-addressed pool of immutable prefix pages (module docstring).

    chunk: the engine's prefill chunk C (None for full-prefill engines --
    chain entries are then never created).
    chain_ok: chain sharing requires EVERY state leaf to be length-paged
    (a mid-prompt resume re-initializes constant-size leaves, which is
    only correct when there are none); the engine passes the probed
    verdict from its SlotStateSpec.
    """

    def __init__(self, max_pages: int, *, chunk: Optional[int] = None,
                 chain_ok: bool = True, salt: str = ""):
        if max_pages < 1:
            raise ValueError(f"prefix cache needs max_pages >= 1, got "
                             f"{max_pages}")
        self.max_pages = max_pages
        self.chunk = chunk
        self.chain_ok = chain_ok and chunk is not None
        self._salt = salt.encode()
        self._entries: "OrderedDict[bytes, Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.tokens_skipped = 0
        self.evicted = 0
        self.insertions = 0
        self.remeshes = 0
        self.mesh_key = None

    # -- keys ---------------------------------------------------------------

    @property
    def _memo_tag(self) -> tuple:
        # digests depend on these; a memo from a differently-configured
        # pool must never be trusted
        return (self._salt, self.chunk, self.chain_ok)

    def warm_digest(self, req) -> bool:
        """Precompute and memoize this request's content digests -- the
        terminal sha256 and the rolling chain keys -- ON the request
        object, so later lookups do no hashing at admission time.  This
        is the host-side admission planning a caller overlaps with an
        in-flight decode segment (engine.admission_plan): pure
        hashing, no pool mutation, no counters.  Idempotent; returns
        True when work was done, False when already warm."""
        memo = getattr(req, "_prefix_memo", None)
        if memo is not None and memo[0] == self._memo_tag:
            return False
        req._prefix_memo = (self._memo_tag, self._hash_terminal(req),
                            tuple(self._hash_chain(req.prompt)))
        return True

    def _terminal_key(self, req) -> bytes:
        memo = getattr(req, "_prefix_memo", None)
        if memo is not None and memo[0] == self._memo_tag:
            return memo[1]
        return self._hash_terminal(req)

    def _hash_terminal(self, req) -> bytes:
        h = hashlib.sha256()
        h.update(b"terminal:")
        h.update(self._salt)
        h.update(_features_digest(req.features))
        h.update(np.asarray(req.prompt, np.int32).tobytes())
        return h.digest()

    def chain_keys(self, prompt, req=None) -> List[bytes]:
        """Rolling keys for every FULLY-real chunk of `prompt`: chunk k is
        reachable only through the exact tokens [0:(k+1)C).  Pass the
        owning request as `req` to reuse a warm_digest memo."""
        memo = getattr(req, "_prefix_memo", None) if req is not None \
            else None
        if memo is not None and memo[0] == self._memo_tag:
            return list(memo[2])
        return self._hash_chain(prompt)

    def _hash_chain(self, prompt) -> List[bytes]:
        if not self.chain_ok:
            return []
        c = self.chunk
        toks = np.asarray(prompt, np.int32)
        keys, prev = [], b"chain:" + self._salt
        for k in range(len(toks) // c):
            h = hashlib.sha256()
            h.update(prev)
            h.update(toks[k * c:(k + 1) * c].tobytes())
            prev = h.digest()
            keys.append(prev)
        return keys

    # -- lookup / insert ----------------------------------------------------

    def _touch(self, ent: Entry) -> Entry:
        self._entries.move_to_end(ent.key)
        return ent

    def lookup(self, req) -> Lookup:
        """Longest cached prefix for `req`, counting hit/miss and marking
        every returned entry recently-used.  A terminal hit covers the
        whole prompt (and carries tok0); otherwise the chain is walked
        until the first uncached chunk."""
        ent = self._entries.get(self._terminal_key(req))
        if ent is not None:
            self.hits += 1
            return Lookup(self._touch(ent), [], req.prompt_len)
        chain: List[Entry] = []
        for key in self.chain_keys(req.prompt, req=req):
            ce = self._entries.get(key)
            if ce is None:
                break
            chain.append(self._touch(ce))
        if chain:
            self.hits += 1
        else:
            self.misses += 1
        return Lookup(None, chain, len(chain) * (self.chunk or 0))

    def peek_cached_tokens(self, req) -> int:
        """Like lookup().cached_tokens but WITHOUT touching counters or
        LRU order -- for admission token budgeting."""
        if self._terminal_key(req) in self._entries:
            return req.prompt_len
        n = 0
        for key in self.chain_keys(req.prompt, req=req):
            if key not in self._entries:
                break
            n += 1
        return n * (self.chunk or 0)

    def _insert(self, ent: Entry) -> None:
        if ent.key in self._entries:
            self._touch(self._entries[ent.key])
            return
        self._entries[ent.key] = ent
        self.insertions += 1
        self._evict_over_capacity()

    def note_skip(self, n: int) -> None:
        """Engine callback: `n` prompt tokens' prefill work was actually
        skipped (a terminal hit skips the whole prompt; a chain hit skips
        resume-point * chunk tokens -- the engine knows the resume point,
        lookup doesn't)."""
        self.tokens_skipped += int(n)

    def insert_terminal(self, req, pages: list, tok0: int) -> None:
        self._insert(Entry(self._terminal_key(req), pages, "terminal",
                           tok0=int(tok0)))

    def insert_chain(self, key: bytes, pages: list) -> None:
        if self.chain_ok:
            self._insert(Entry(key, pages, "chain"))

    def _evict_over_capacity(self) -> None:
        """LRU-by-refcount: evict least-recently-used UNPINNED entries
        until within capacity; pinned entries (refs > 0 -- a live slot
        was admitted from them) are never evicted, so the pool may
        transiently exceed max_pages under heavy pinning."""
        while len(self._entries) > self.max_pages:
            victim = next((e for e in self._entries.values()
                           if e.refs == 0), None)
            if victim is None:
                return
            del self._entries[victim.key]
            self.evicted += 1

    # -- pinning ------------------------------------------------------------

    def pin(self, keys) -> tuple:
        """Refcount the entries a slot was admitted from; returns the keys
        actually pinned (for the engine's per-slot release list)."""
        pinned = []
        for key in keys:
            ent = self._entries.get(key)
            if ent is not None:
                ent.refs += 1
                pinned.append(key)
        return tuple(pinned)

    def release(self, keys) -> None:
        for key in keys:
            ent = self._entries.get(key)
            if ent is not None and ent.refs > 0:
                ent.refs -= 1
        self._evict_over_capacity()

    # -- mesh bookkeeping ---------------------------------------------------

    def note_remesh(self, mesh_key) -> None:
        """Record a mesh (re-)plan.  Pages are host-resident and so
        mesh-free: nothing to invalidate.  The fingerprint is kept for
        observability: info() shows which mesh the pool serves."""
        if self.mesh_key is not None and mesh_key != self.mesh_key:
            self.remeshes += 1
        self.mesh_key = mesh_key

    # -- observability ------------------------------------------------------

    def info(self) -> dict:
        looked = self.hits + self.misses
        return {
            "max_pages": self.max_pages,
            "chunk": self.chunk,
            "chain_ok": self.chain_ok,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / looked) if looked else 0.0,
            "tokens_skipped": self.tokens_skipped,
            "pages_resident": len(self._entries),
            "pages_evicted": self.evicted,
            "pages_pinned": sum(1 for e in self._entries.values()
                                if e.refs > 0),
            "insertions": self.insertions,
            "remeshes": self.remeshes,
            "mesh_fingerprint": None if self.mesh_key is None
            else hashlib.sha256(repr(self.mesh_key).encode()).hexdigest()[:12],
        }
