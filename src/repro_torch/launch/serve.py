"""Serving entry point: quantized weights + batched prefill / greedy decode.

Port of `repro/launch/serve.py` (greedy `generate`, its decode-bundle
cache and the CLI):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --quant w4a8 --batch 8 --prompt-len 128 --gen 32 --device cuda \\
        [--silvia {off,add,muladd,all}] [--no-fused-decode]

`--arch` takes the dense family (smollm-135m, qwen1.5-0.5b, yi-6b,
command-r-35b), the vlm family (qwen2-vl-72b: the dense block with
M-RoPE; from tokens its three position rows are equal, as the
reference's `generate` serves it; an image prompt, the vision
frontend's patch embeddings with their [3, B, S] positions, goes
through `lm.prefill` and then the decode step), the MoE family
(granite-moe-1b-a400m, arctic-480b; each expert-stacked weight is one
GEMM launch, and the per-token routing
runs inside the captured decode step), the SSM family (mamba2-2.7b:
two GEMMs per layer, in_proj and out_proj; its recurrent state takes the
KV cache's place, a static buffer of the captured step updated in
place; the prompt runs on the fixed chunk grid, padded to a multiple of
the chunk) and the hybrid family (jamba-v0.1-52b: per scan unit of 8
layers one attention layer, seven SSD mixers and eight FFNs, every
other one the MoE; the flat cache of both kinds is the captured step's
static buffers; its 51.46 B parameters are built a [K, N] matrix at a
time, `build_params`).  The encoder-decoder family (whisper-small) is
served by `generate` with a (features [B, S_enc, d], dec_tokens [B, S])
tuple: its cross-attention K/V, projected once by the prefill, is a
static buffer of the captured step, read by every step and never
written; the CLI refuses it, as the reference's does (it has no
features to give).  As in the reference, the int8
KV cache (`serve_kv_dtype="int8"`) and the chunked prefill attention
(`attn_q_chunk`) are config fields, set with `dataclasses.replace`; the
CLI has no flag for them.

* Weights are quantized offline (w8a8, or w4a8 with two int4 per int8
  word); every weight matmul dispatches through kernels/registry.py to
  the Hopper kernels on a CUDA device (the census and per-op dispatch
  counts are printed per run).  ``REPRO_TORCH_LOWERING='*=ref'`` serves
  on the plain PyTorch versions instead, bit-identically.
* With ``--silvia {off,add,muladd,all}`` the decode step is rewritten by
  the SILVIA passes (`core.optimize`), which pack any narrow-integer ops
  the quantized graph exposes.  The passes' trace cache makes this
  compile-once / run-many: repeated `generate` calls with the same
  shapes never re-run them.
* Decode runs, by default (``fused=True``), as ONE decode step captured
  in a CUDA graph and replayed gen-1 times: the port's counterpart of
  the reference's fused `lax.scan` loop.  The host dispatches the step's
  ops once, at capture, instead of once per token.  The step reads its
  token and position from static device buffers, writes the next token
  (and with ``return_logits`` the logits row it was chosen from) at a
  device-side step index, and advances position and index in place.
  ``--no-fused-decode`` runs the per-step loop.  There is no graph on
  the CPU: there ``fused=True`` runs the per-step loop, the one
  difference between the devices.  On CUDA a failed capture or replay
  raises; nothing falls back to the per-step loop.  A replay launches
  the step's kernels without their wrappers, so the wrappers' launch
  counters see the warm-up step and the capture, never a replay: a
  replayed run's launches are counted from a profile
  (`registry.profiled_launches`).
* Decode bundles -- the decode function, pinned to the lowering census
  it was built under, and the one step captured from it (re-captured
  for another params tree or shape) -- live in a bounded LRU keyed on
  (cfg, pass set, lowering fingerprint, device), of
  ``$REPRO_DECODE_CACHE_SIZE`` bundles (default 16).

Sampling is greedy only.
"""
from __future__ import annotations

import argparse
import collections
import functools
import os
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch import core as silvia
from repro_torch import device as device_lib
from repro_torch.kernels import registry
from repro_torch.models import lm
from repro_torch.quant.qtensor import QTensor, quantize_weight, serving_format

SILVIA_PASS_SETS = {
    "off": [],
    "muladd": [silvia.PassConfig(op="muladd")],
    "add": [silvia.PassConfig(op="add", op_size=8),
            silvia.PassConfig(op="add", op_size=16)],
    "all": list(silvia.DEFAULT_PASSES),
}


class LRUCache:
    """Bounded LRU keyed cache with info() / clear() counters, as the
    reference's.

    A decode bundle holds a captured CUDA graph (with its params tree,
    static KV cache and output buffers) and, with SILVIA passes on, its
    own trace cache, so an unbounded dict would keep every one alive."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = max(1, int(maxsize))
        self._store: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key, make):
        ent = self._store.get(key)
        if ent is not None:
            self.hits += 1
            self._store.move_to_end(key)
            return ent
        self.misses += 1
        ent = make()
        self._store[key] = ent
        while len(self._store) > self.maxsize:
            self._store.popitem(last=False)
            self.evictions += 1
        return ent

    def info(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._store),
                "maxsize": self.maxsize}

    def clear(self) -> None:
        self._store.clear()
        self.hits = self.misses = self.evictions = 0


# (cfg, silvia_passes, lowering fingerprint, device) -> decode bundle.
# ModelConfig is a frozen dataclass; the fingerprint keys out forced
# lowerings: a bundle built (and a graph captured) under one lowering
# census is never served under another.
_DECODE_CACHE = LRUCache(
    maxsize=int(os.environ.get("REPRO_DECODE_CACHE_SIZE", "16")))

def decode_cache_info() -> dict:
    """Counters for the decode-bundle LRU (hits/misses/evictions/size)."""
    return _DECODE_CACHE.info()


def decode_cache_clear() -> None:
    _DECODE_CACHE.clear()


def _pin_lowerings(fn, census: dict):
    """Run every call of a bundle callable under the lowering census its
    cache key records, so key and trace (or capture) agree for the
    bundle's lifetime, whatever is forced around a later call."""
    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        with registry.force(**census):
            return fn(*args, **kwargs)
    return pinned


class _CapturedStep:
    """One greedy decode step over static buffers: the token and position
    it reads, the cache it updates in place (whatever `lm.init_cache`
    gives: the KV cache, the ssm family's {ssm, conv} state, or the
    hybrid family's flat dict of both, or the encdec family's self KV and
    cross K/V of `s_enc` positions), the tokens (and logits rows) it
    writes at a device-side step index, for up to `n_steps` steps.  On
    CUDA the step is captured in a CUDA graph and each replay is one
    decode step; nothing on the host changes between replays.  On
    the CPU there is no graph and `run` calls the step eagerly
    (`generate` never builds one there; the CPU tests check the buffers'
    bookkeeping this way).

    What it holds on the device: the params tree (the graph reads the
    weights at their addresses), a KV cache of `cache_len` positions
    (29.5 MB for smollm-135m at B=8, cache_len 160; an int8 cache's
    float32 scales are static buffers too, which the step updates in
    place with the values) or an ssm state (1.359 GB for mamba2-2.7b at
    B=8, whatever cache_len; jamba-v0.1-52b's 28 mixers' 0.129 GB and its
    4 attention layers' 21 MB of KV at cache_len 160; whisper-small's
    0.442 GB of cross K/V at B=8 and 1500 frames), the tokens [B,
    n_steps] int32, with return_logits the logits rows [B, n_steps, V]
    float32 (48.8 MB at B=8, n_steps 31), and the graph's private pool
    of one step's intermediates."""

    def __init__(self, decode, params, cfg, batch: int, cache_len: int,
                 n_steps: int, return_logits: bool, device: torch.device,
                 s_enc: int | None = None):
        self.key = _step_key(params, batch, cache_len, return_logits, s_enc)
        self.n_steps = n_steps
        self.leaves = pytree.tree_leaves(params)   # kept alive: see above
        self.cache = lm.init_cache(cfg, batch, cache_len, device=device,
                                   s_enc=s_enc)

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tok, self.pos, self.step = zeros(batch, 1), zeros(batch), \
            zeros(1)
        self.toks = zeros(batch, n_steps, dtype=torch.int32)
        self.logits = zeros(batch, n_steps, cfg.vocab,
                            dtype=torch.float32) if return_logits else None

        def step():
            logits, _ = decode(params, self.tok, self.cache, self.pos)
            last = logits[:, -1, :]
            nxt = last.argmax(dim=-1)[:, None]
            self.toks.index_copy_(1, self.step, nxt.to(torch.int32))
            if self.logits is not None:
                self.logits.index_copy_(1, self.step, last[:, None, :])
            self.tok.copy_(nxt)
            self.pos.add_(1)
            self.step.add_(1)

        self.graph, self.capture_ms, self._replay = None, 0.0, step
        if device.type != "cuda":
            return
        with torch.cuda.device(device):
            # one eager step on a side stream first: it builds and loads
            # every kernel, fills the per-device caches and runs the SILVIA
            # trace, none of which may happen under capture
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream().wait_stream(side)
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                step()
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        self._replay = self.graph.replay

    def run(self, tok, cache: dict, start: int, n_steps: int):
        """n_steps decode steps after a prefill that left `cache` and
        chose `tok` [B,1] for position `start`: ([B, n_steps] int32
        tokens, [B, n_steps, V] f32 logits or None)."""
        if n_steps > self.n_steps:
            raise ValueError(f"{n_steps} steps, buffers for {self.n_steps}")
        for k, t in self.cache.items():
            t.copy_(cache[k])
        self.tok.copy_(tok)
        self.pos.fill_(start)
        self.step.zero_()
        for _ in range(n_steps):
            self._replay()
        logits = None if self.logits is None \
            else self.logits[:, :n_steps].clone()
        return self.toks[:, :n_steps].clone(), logits


def _step_key(params, batch: int, cache_len: int, return_logits: bool,
              s_enc: int | None):
    # the params tree by the identity of its leaves, which a captured step
    # keeps alive, so a second tree never replays the first one's weights;
    # s_enc, the width of an encdec cache's cross K/V buffers
    return (tuple(id(t) for t in pytree.tree_leaves(params)), batch,
            cache_len, return_logits, s_enc)


class _DecodeBundle:
    """The decode function of one (cfg, pass set, lowering census,
    device), and the one decode step captured from it."""

    def __init__(self, cfg, silvia_passes: str, census: dict):
        def decode_fn(p, tok, kv, pos):
            return lm.decode_step(p, tok, kv, pos, cfg)

        passes = SILVIA_PASS_SETS[silvia_passes]
        if passes:
            decode_fn = silvia.optimize(decode_fn, passes)
        self.cfg = cfg
        self.decode = _pin_lowerings(decode_fn, census)
        self.step: _CapturedStep | None = None
        self.captures = 0

    def captured(self, params, batch: int, cache_len: int,
                 return_logits: bool, n_steps: int, device,
                 s_enc: int | None = None) -> _CapturedStep:
        """The captured step for this params tree and these shapes.  The
        bundle keeps one: another params tree, batch, cache_len,
        return_logits or cross K/V width s_enc, or more steps than its
        buffers hold, drops it and captures anew."""
        s = self.step
        if s is None or s.key != _step_key(params, batch, cache_len,
                                           return_logits, s_enc) \
                or s.n_steps < n_steps:
            self.step = None    # the old graph, weights and buffers first
            self.step = _CapturedStep(self.decode, params, self.cfg, batch,
                                      cache_len, n_steps, return_logits,
                                      device, s_enc)
            self.captures += 1
        return self.step


def _decode_bundle(cfg, silvia_passes: str, device) -> _DecodeBundle:
    if silvia_passes not in SILVIA_PASS_SETS:
        raise ValueError(f"unknown SILVIA pass set {silvia_passes!r} "
                         f"(known: {', '.join(SILVIA_PASS_SETS)})")
    dev = torch.device(device)
    fp = registry.fingerprint(dev)
    return _DECODE_CACHE.get_or_build(
        (cfg, silvia_passes, fp, dev),
        lambda: _DecodeBundle(cfg, silvia_passes, dict(fp)))


def get_decode_step(cfg, silvia_passes: str = "off", device="cuda"):
    """The (possibly SILVIA-rewritten) single-token decode step for cfg,
    (params, tok, cache, pos) -> (logits, cache), updating the cache in
    place.

    Cached per (cfg, pass set, lowering census, device); with passes on,
    the SILVIA wrapper's own trace cache runs them once per input-shape
    signature (`get_decode_step(...).cache_info()`)."""
    return _decode_bundle(cfg, silvia_passes, device).decode


def generate(params, prompts, cfg, *, gen: int, cache_len: int,
             silvia_passes: str = "off", fused: bool = True,
             return_logits: bool = False, device="cuda"):
    """Greedy generation: prefill, its argmax, then gen-1 decode steps.

    prompts: [B,S] int tokens (tensor or numpy); for the encdec family a
    tuple (features [B,S_enc,d], dec_tokens [B,S]), as the reference's
    takes, the encoder's frames then the decoder's prompt (S counts the
    decoder's tokens).  Returns the generated
    tokens [B, gen] int32 on `device`, the reference's dtype; with
    return_logits=True also the float32 logits each token was chosen
    from, [B, gen, V].  silvia_passes picks a SILVIA_PASS_SETS entry for
    the decode step.  fused=True on a CUDA device replays one captured
    decode step (module docstring); fused=False, and any CPU run, is the
    per-step loop.  Both give the same tokens and logits, bit for bit."""
    dev = device_lib.resolve(device)
    s_enc = None
    if cfg.family == "encdec":
        features, tokens = (torch.as_tensor(t, device=dev) for t in prompts)
        prompts, s_enc = (features, tokens), features.shape[1]
    else:
        tokens = prompts = torch.as_tensor(prompts, device=dev)
    b, s = tokens.shape
    if gen < 1 or cache_len < s + gen - 1:
        raise ValueError(f"need gen >= 1 and cache_len >= prompt + gen - 1 "
                         f"(got gen={gen}, cache_len={cache_len}, "
                         f"prompt={s})")
    logits, cache = lm.prefill(params, prompts, cfg, cache_len=cache_len)
    bundle = _decode_bundle(cfg, silvia_passes, dev)
    last = logits[:, -1, :]
    tok = last.argmax(dim=-1)[:, None]
    if fused and dev.type == "cuda" and gen > 1:
        step = bundle.captured(params, b, cache_len, return_logits, gen - 1,
                               dev, s_enc)
        toks, seen = step.run(tok, cache, s, gen - 1)
        toks = torch.cat([tok.to(torch.int32), toks], dim=1)
        if return_logits:
            return toks, torch.cat([last[:, None], seen], dim=1)
        return toks
    out, seen = [tok], [last]
    pos = torch.full((b,), s, dtype=torch.int64, device=dev)
    for i in range(gen - 1):
        logits, _ = bundle.decode(params, tok, cache, pos + i)
        tok = logits[:, -1, :].argmax(dim=-1)[:, None]
        out.append(tok)
        seen.append(logits[:, -1, :])
    toks = torch.cat(out, dim=1).to(torch.int32)
    if return_logits:
        return toks, torch.stack(seen, dim=1)
    return toks


# the most elements of a matrix that `build_params` quantizes at once
QUANT_SLICE_ELEMS = 1 << 27


def build_params(cfg, quant: str, *, seed: int = 0, quant_force=False,
                 device="cuda", max_seq: int = 4096):
    """Random params from `seed`, quantized for serving as `quant`: bit for
    bit `quantize_tree_for_serving(lm.init_params(cfg, seed,
    max_seq=max_seq), quant, force=quant_force)`, without ever holding a
    whole leaf of float
    weights.  lm.init_params draws each random leaf one [K, N] matrix at
    a time; each matrix of a leaf that quantizes is quantized as it is
    drawn (per-column scales: a matrix's are those of the whole leaf),
    QUANT_SLICE_ELEMS elements of columns at a time, into the leaf's
    preallocated QTensor.  Whether a leaf quantizes, and to which format,
    is decided from the WHOLE leaf's path and shape (`serving_format`:
    size floors, the 2-D rule, the odd-N w4a8 -> w8a8 fallback), never
    from a matrix's.  So beside the tree built so far there is one
    matrix in its dtype, its float32 draw until it is cast, and one
    column slice's quantization temporaries: command-r-35b (whose
    [8192, 256000] lm_head is drawn as 7.8 GiB of float32) peaks 2.24 /
    1.89 GiB above its resident 18.02 / 32.12 GiB (w4a8 / w8a8;
    scripts/build_memory.py on an H100 80GB HBM3), where quantizing that
    head whole peaked 27.88 / 8.90 GiB above, and drawing
    jamba-v0.1-52b's stacked expert weights whole would take 60 GB."""
    def build(path, spec, slices, dev):
        fmt = serving_format("/".join(path), spec.shape, quant,
                             force=quant_force)
        if fmt is None:
            return lm.materialize(path, spec, slices, dev)
        k, n = spec.shape[-2:]
        per = 2 if fmt == "w4a8" else 1        # columns per stored byte
        q = torch.empty(spec.shape[:-1] + (n // per,), dtype=torch.int8,
                        device=dev)
        scale = torch.empty(spec.shape[:-2] + (1, n), dtype=torch.float32,
                            device=dev)
        # columns quantize independently: slices of an even width
        cols = max(2, QUANT_SLICE_ELEMS // k // 2 * 2)
        for idx, w in slices:
            for c in range(0, n, cols):
                qt = quantize_weight(w[:, c:c + cols], fmt)
                q[idx][:, c // per:(c + cols) // per] = qt.q
                scale[idx][:, c:c + cols] = qt.scale
        return QTensor(q, scale, fmt)

    # the constant leaves (norms, biases, the mixers' A_log, D, dt_bias,
    # conv_b) stay float, as serving_format keeps them
    return lm.init_params(cfg, seed, device=device, build=build,
                          max_seq=max_seq)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="w8a8",
                    choices=["bf16", "w8a8", "w4a8"])
    ap.add_argument("--quant-force", action="store_true",
                    help="drop the quantization size floors (reduced "
                         "configs sit entirely under them)")
    ap.add_argument("--silvia", default="off",
                    choices=list(SILVIA_PASS_SETS))
    ap.add_argument("--no-fused-decode", action="store_true",
                    help="per-step decode loop instead of the captured "
                         "CUDA-graph step (for A/B comparison)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced_config(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    if cfg.family == "encdec":
        ap.error(f"--arch {args.arch}: the encoder-decoder family takes "
                 "(features, dec_tokens); serve it through generate(), "
                 "not the CLI (as the reference's CLI refuses it)")
    dev = device_lib.resolve(args.device)
    cache_len = args.prompt_len + args.gen
    params = build_params(cfg, args.quant, seed=args.seed,
                          quant_force=args.quant_force, device=dev)
    if args.quant != "bf16":
        print(f"quantized weights to {args.quant}"
              + (" (forced floors)" if args.quant_force else ""))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    print("active lowerings:", registry.census_str(dev))
    registry.reset_dispatch_counts()
    t0 = time.perf_counter()
    toks = generate(params, prompts, cfg, gen=args.gen, cache_len=cache_len,
                    silvia_passes=args.silvia,
                    fused=not args.no_fused_decode, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = args.batch * args.gen
    print("dispatch counts:", registry.dispatch_counts())
    print("decode cache:", decode_cache_info())
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s batch-aggregate, {dev})")
    print("sample tokens:", toks[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
