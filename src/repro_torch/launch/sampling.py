"""Per-request sampling policies for the serve engine and static path.

Port of `repro/launch/sampling.py`.  Every sampled token is a PURE
FUNCTION of (seed, rid, token index, logits row):

* the per-token key is counter-based -- ``fold_in(fold_in(PRNGKey(seed),
  rid), t)`` with ``t`` the generated-token index -- so no sampler state
  needs keeping;
* temperature / top-k / top-p truncation and the Gumbel-max draw are
  per-row ops, so a row samples the same token whatever its batch mates
  (the nucleus's prefix sum is `common.row_cumsum`: `torch.cumsum`'s
  order on CUDA depends on the number of rows);
* greedy rows (temperature <= 0, the default) take the literal argmax of
  the raw logits through a `torch.where` select.

The keys are JAX's threefry2x32 written in torch: `prng_key(seed)`
(`jax.random.PRNGKey`), `fold_in` and `random_bits` (the bits behind
`jax.random.gumbel(key, (V,), float32)` in the partitionable form, JAX's
default since 0.5: element i hashes the 64-bit counter i as (hi, lo)
words and XORs the two output words).  torch's uint32 supports few
operations, so the words are int64 tensors holding uint32 values, every
sum masked to 32 bits; all of it is elementwise on the device, with no
host sync, so it runs inside a captured decode step.  The words and bits
are the reference's bit for bit; `-log(-log(u))` runs through torch's
(or CUDA's) `log` where the reference runs XLA's, so a Gumbel float may
differ from the reference's in its last bit, and sampled tokens are held
to the reference under ROADMAP C2's rule.

The per-slot sampling state -- base key, temperature, top-k, top-p,
prompt length -- is registered with `models/slot_state.py` as its own
constant-size slot-page family (``"sampling"``): the engine keeps it on
the host and ships its [:bb] rows to the device before each segment.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.scheduler import GREEDY, SamplingParams
from repro_torch.models import common, slot_state

# operand order of the page leaves (one flat tuple everywhere)
PAGE_LEAVES = ("key", "temp", "top_k", "top_p", "plen")

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY32 = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# threefry2x32 (JAX's PRNG) on int64 tensors holding uint32 words
# ---------------------------------------------------------------------------

def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counts (x0, x1) under key (k0, k1), 20
    rounds, as JAX's `_threefry2x32_lowering`: int64 tensors holding
    uint32 values, broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device="cpu"):
    """`jax.random.PRNGKey(seed)` for a seed in int32's range: the words
    (0, seed mod 2^32), as an int64 [2] tensor."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """`jax.random.fold_in`, row-wise: key [..., 2] int64 words, data
    [...] int (each taken mod 2^32) -> [..., 2].  The data is hashed as
    the counts (0, data), as JAX's `threefry_seed` makes them."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, n: int):
    """The 32-bit words of `jax.random.bits(key, (n,), uint32)`, row-wise:
    key [B, 2] -> [B, n] int64.  Partitionable form: element i hashes
    the counts (i >> 32, i & 0xFFFFFFFF) and XORs the two words."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[:, 0:1], key[:, 1:2], i >> 32, i & _M32)
    return y0 ^ y1


def uniform(key, n: int):
    """`jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)`:
    the bits' top 23 as the mantissa of a float in [1, 2), minus 1, then
    `f * (1 - tiny) + tiny` (1 - tiny is 1.0 in float32) and at least
    tiny."""
    f = ((random_bits(key, n) >> 9) | 0x3F800000).to(torch.int32) \
        .view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY32, _TINY32)


def gumbel(key, n: int):
    """`jax.random.gumbel(key, (n,), float32)` (its "low" mode, the
    default) row-wise: -log(-log(u)), key [B, 2] -> [B, n] float32."""
    return -torch.log(-torch.log(uniform(key, n)))


# ---------------------------------------------------------------------------
# the page: a registered constant-size slot-state family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _SamplingPageCfg:
    """Minimal config handle so `slot_state.spec_for` can probe the
    sampling page like any model family's cache."""
    family: str = "sampling"


def _init_page(cfg, n_slots: int, max_cache_len: int, *, device):
    del cfg, max_cache_len            # constant-size: no length axis
    return (torch.zeros((n_slots, 2), dtype=torch.int64, device=device),
            torch.zeros((n_slots,), dtype=torch.float32, device=device),
            torch.zeros((n_slots,), dtype=torch.int64, device=device),
            torch.ones((n_slots,), dtype=torch.float32, device=device),
            torch.zeros((n_slots,), dtype=torch.int64, device=device))


slot_state.register("sampling", _init_page)


def page_spec() -> slot_state.SlotStateSpec:
    """The probed SlotStateSpec of the sampling page (all leaves slot-axis
    0, no length axis -- a constant-size page)."""
    return slot_state.spec_for(_SamplingPageCfg())


# ---------------------------------------------------------------------------
# host-side page bookkeeping
# ---------------------------------------------------------------------------

def params_of(req) -> SamplingParams:
    return req.sampling if req.sampling is not None else GREEDY


def is_greedy(req) -> bool:
    """Whether this request's stream is the argmax stream (score/embed
    never sample)."""
    return req.method != "generate" or params_of(req).greedy


@functools.lru_cache(maxsize=8192)
def base_key(seed: int, rid: int) -> tuple:
    """fold_in(PRNGKey(seed), rid) as a hashable pair of uint32 ints."""
    return tuple(int(w) for w in fold_in(prng_key(seed), rid))


def host_page(n_slots: int) -> list:
    """Fresh host-resident sampling page (numpy leaves, PAGE_LEAVES
    order), built by the registered slot-state init so its layout cannot
    drift from the probed spec."""
    return [leaf.numpy() for leaf in page_spec().init_state(n_slots, 1)]


def write_row(page: list, slot: int, req) -> None:
    """Admit one request's policy into its slot row."""
    p = params_of(req)
    page[0][slot] = base_key(p.seed, req.rid)
    page[1][slot] = np.float32(p.temperature)
    page[2][slot] = p.top_k
    page[3][slot] = np.float32(p.top_p)
    page[4][slot] = req.prompt_len


def clear_row(page: list, slot: int) -> None:
    """Evict: reset the row to the greedy defaults."""
    page[0][slot] = 0
    page[1][slot] = 0.0
    page[2][slot] = 0
    page[3][slot] = 1.0
    page[4][slot] = 0


def permute(page: list, perm) -> list:
    """Slot compaction (the host mirror of SlotStateSpec.permute_slots)."""
    return [leaf[np.asarray(perm)] for leaf in page]


def operand(page: list, bb: int, device="cpu") -> tuple:
    """The [:bb] device operand tuple a bucketed dispatch consumes."""
    return tuple(torch.as_tensor(leaf[:bb], device=device) for leaf in page)


def null_operand(bb: int, device="cpu") -> tuple:
    """All-greedy operand."""
    return operand(host_page(bb), bb, device)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def sample(last, key, temp, top_k, top_p, t):
    """Next tokens [B] int64 from logits rows `last` [B,V].

    Greedy rows (temp <= 0) are the literal argmax of the raw logits,
    selected by `torch.where`.  Sampled rows divide by temperature in
    float32, mask everything outside the top-k / top-p truncation to
    -inf, and take the Gumbel-max argmax under the row's key folded with
    the token index `t` [B].  Every op is per-row: a row's token is
    invariant to batch composition."""
    v = last.shape[-1]
    arg = last.argmax(dim=-1)
    x = last.to(torch.float32) / torch.clamp_min(temp, 1e-6)[:, None]
    srt = torch.sort(x, dim=-1, descending=True).values
    # top-k threshold: the kth largest value (0 or oversize k = disabled)
    kk = torch.where(top_k > 0, torch.clamp(top_k, 1, v),
                     torch.full_like(top_k, v))
    thr_k = srt.gather(-1, (kk - 1)[:, None])
    # top-p nucleus: keep the smallest sorted prefix with mass >= top_p;
    # the EXCLUSIVE prefix sum keeps at least the first entry
    probs = torch.softmax(srt, dim=-1)
    excl = common.row_cumsum(probs) - probs
    kept = excl < top_p[:, None]
    thr_p = torch.where(kept, srt, torch.inf).amin(dim=-1, keepdim=True)
    keep = (x >= thr_k) & (x >= thr_p)
    gum = gumbel(fold_in(key, t), v)
    smp = torch.where(keep, x + gum, -torch.inf).argmax(dim=-1)
    return torch.where(temp > 0.0, smp, arg)


def sample_host(row, params: SamplingParams, rid: int, t: int) -> int:
    """Recompute ONE row's sampled token from logits row `row` [V], on
    the row's own device (the card's log is not the CPU's): `sample` has
    no cross-row reduction, so the result is bitwise the batch row's."""
    row = torch.as_tensor(row, dtype=torch.float32)[None]
    dev = row.device
    out = sample(row, torch.tensor([base_key(params.seed, rid)],
                                   dtype=torch.int64, device=dev),
                 torch.full((1,), params.temperature, dtype=torch.float32,
                            device=dev),
                 torch.full((1,), params.top_k, dtype=torch.int64,
                            device=dev),
                 torch.full((1,), params.top_p, dtype=torch.float32,
                            device=dev),
                 torch.full((1,), t, dtype=torch.int64, device=dev))
    return int(out[0])


def expected_token(req, row, t: int) -> int:
    """The token request `req` emits at generated-token index `t` from
    logits row `row`: the argmax for greedy rows, `sample_host`
    otherwise."""
    row = torch.as_tensor(row, dtype=torch.float32)
    if is_greedy(req):
        return int(row.argmax())
    return sample_host(row, params_of(req), req.rid, t)


def static_operand(reqs_or_params, prompt_len: int, rids=None,
                   device="cpu") -> Optional[tuple]:
    """Batch sampling operand for the STATIC `serve.generate` path: one
    SamplingParams (or None) per row, rid defaulting to the row index.
    Returns None when every row is greedy -- the caller then keeps the
    untouched greedy loop."""
    ps = [p if isinstance(p, SamplingParams) else GREEDY
          for p in (reqs_or_params or [])]
    if all(p.greedy for p in ps):
        return None
    rids = list(rids) if rids is not None else list(range(len(ps)))
    key = [base_key(p.seed, r) for p, r in zip(ps, rids)]

    def t(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=device)

    return (t(key, torch.int64),
            t([p.temperature for p in ps], torch.float32),
            t([p.top_k for p in ps], torch.int64),
            t([p.top_p for p in ps], torch.float32),
            t([prompt_len] * len(ps), torch.int64))
