"""Rank-side cases of the port's sharded-serving tests (no JAX here: every
rank process imports this module alone).

`run_group(shape, cases, out, snap_dir)` runs in each of the
prod(shape) ranks that `launch.mesh.spawn` starts: it builds the mesh
over `gloo` on the CPU, runs every case in order on every rank (rank 0
drives the engine, the others follow it), and rank 0 pickles
{case: result} to `out`.  The tests compare the results with the port's
unsharded engine on the same requests (`baseline`), which the rest of
the suite holds against the JAX package.
"""
from __future__ import annotations

import asyncio
import pickle

import numpy as np

from repro_torch import configs
from repro_torch.distributed import context as dctx
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import scheduler
from repro_torch.launch.engine import ServeEngine, SpecDecodeConfig
from repro_torch.launch.frontend import AsyncFrontend, serve_requests
from repro_torch.models import lm
from repro_torch.quant.qtensor import quantize_tree_for_serving

ENC_LEN = 16
FAMILIES = {"dense": "smollm-135m", "qwen": "qwen1.5-0.5b",
            "ssm": "mamba2-2.7b", "hybrid": "jamba-v0.1-52b",
            "encdec": "whisper-small"}


def build(kind: str, quant: str = "w8a8", seed: int = 0):
    cfg = configs.get_reduced_config(FAMILIES[kind])
    params = lm.init_params(cfg, seed, device="cpu", max_seq=80)
    return cfg, quantize_tree_for_serving(params, quant, force=True)


def requests(cfg, n: int = 5, seed: int = 0, stagger: float = 0.02):
    """The reference test's ragged mix (tests/test_sharded_serve.py):
    more requests than slots, staggered arrivals, varied prompt and
    generation lengths."""
    plens = (5, 12, 9, 16, 7)[:n]
    gens = (3, 8, 1, 6, 9)[:n]
    rng = np.random.default_rng(seed)
    out = []
    for i, (pl, g) in enumerate(zip(plens, gens)):
        kw = {}
        if cfg.family == "encdec":
            kw["features"] = rng.standard_normal(
                (ENC_LEN - 3 * (i % 3), cfg.d_model)).astype(np.float32)
        out.append(scheduler.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, pl).astype(np.int32),
            max_new_tokens=g, arrival_time=stagger * i, **kw))
    return out


def compaction_requests(cfg):
    """Two short requests beside two long ones in four slots: the short
    ones finish in the first segment, leaving the long ones at the top
    of the batch, which compaction moves down (within each dp shard)."""
    rng = np.random.default_rng(3)
    return [scheduler.Request(
        rid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
        max_new_tokens=g, arrival_time=0.0)
        for i, g in enumerate((2, 2, 12, 12))]


def prefix_waves(cfg):
    """Two waves of traffic for the prefix cache, the second sent once
    the first is served, so that what hits does not depend on how fast
    a step runs: three prompts and one with an 8-token shared prefix,
    then the three prompts again (terminal hits, admitted on whichever
    shard frees a slot) and three more behind the shared prefix (chain
    hits on a chunked engine)."""
    rng = np.random.default_rng(5)
    heads = [rng.integers(0, cfg.vocab, n).astype(np.int32)
             for n in (6, 11, 9)]
    shared = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    tails = [np.concatenate(
        [shared, rng.integers(0, cfg.vocab, n).astype(np.int32)])
        for n in (2, 4, 6, 3)]
    prompts = heads + tails[:1] + tails[1:] + heads
    gens = (4, 6, 3, 5, 2, 6, 4, 5, 3, 6)
    reqs = [scheduler.Request(rid=i, prompt=p, max_new_tokens=g,
                              arrival_time=0.0)
            for i, (p, g) in enumerate(zip(prompts, gens))]
    return reqs[:4], reqs[4:]


def serve(eng, case: str, cfg) -> dict:
    """The case's traffic through `eng.run`: its streams."""
    clock = scheduler.FastForwardClock()
    if case.startswith("prefix"):
        first, second = prefix_waves(cfg)
        eng.run(first, clock)
        return streams(eng.run(second, clock))
    return streams(eng.run(traffic(case, cfg), clock))


def frontend_traffic(cfg):
    return scheduler.method_traffic(
        seed=19, n_requests=6, rate=200.0, prompt_lens=(4, 7, 12),
        gen_lens=(3, 6), vocab=cfg.vocab)


def engine_kwargs(case: str, cfg, dp: int = 1) -> dict:
    kw = dict(n_slots=max(2, dp), max_cache_len=64, segment_len=4,
              chaos=None, device="cpu")
    if cfg.family == "encdec":
        kw["enc_len"] = ENC_LEN
    if case == "silvia":
        kw["silvia_passes"] = "all"
    elif case == "chunked":
        kw["prefill_chunk"] = 8
    elif case in ("compact", "spec", "frontend", "snapshot"):
        kw["n_slots"] = 4
    elif case.startswith("prefix"):
        kw.update(n_slots=4, prefix_cache=64)
        if case == "prefix_chunked":
            kw["prefill_chunk"] = 4
    return kw


CASE_MODEL = {"w4a8": ("qwen", "w4a8"), "silvia": ("qwen", "w8a8"),
              "chunked": ("qwen", "w8a8"), "compact": ("qwen", "w8a8"),
              "spec": ("qwen", "w8a8"), "frontend": ("qwen", "w8a8"),
              "snapshot": ("qwen", "w8a8"), "prefix": ("qwen", "w8a8"),
              "prefix_chunked": ("qwen", "w8a8"),
              "prefix_ssm": ("ssm", "w8a8")}


def model_of(case: str):
    if case == "unmeshed":
        return "qwen", "w8a8"
    return CASE_MODEL.get(case, (case, "w8a8"))


def streams(out: dict) -> dict:
    return {int(r): [int(t) for t in v] for r, v in out.items()}


def results(res: dict) -> dict:
    """Comparable {rid: (outcome, tokens, logprobs, embedding)}."""
    return {rid: (r.outcome, [int(t) for t in r.tokens],
                  None if r.logprobs is None else list(r.logprobs),
                  None if r.embedding is None else r.embedding.tolist())
            for rid, r in res.items()}


def traffic(case: str, cfg):
    if case == "compact":
        return compaction_requests(cfg)
    if case == "frontend":
        return frontend_traffic(cfg)
    return requests(cfg)


def baseline(case: str):
    """The port's unsharded engine on the case's requests: the streams
    the sharded run must equal bit for bit.  Speculative rounds are held
    against the NON-speculative engine."""
    kind, quant = model_of(case)
    cfg, params = build(kind, quant)
    kw = engine_kwargs(case, cfg)
    eng = ServeEngine(params, cfg, **kw)
    if case == "frontend":
        out = results(_batch(eng, frontend_traffic(cfg)))
    else:
        out = streams(eng.run(traffic(case, cfg),
                              scheduler.FastForwardClock()))
    assert eng.cache_info()["robustness"]["errors"] == 0, case
    assert {r.outcome for r in eng.finished} == {"ok"}, case
    return out


def _batch(eng, reqs) -> dict:
    clock = scheduler.FastForwardClock()
    for r in reqs:
        eng.submit(r)
    while len(eng.results()) < len(reqs):
        if not eng.step(clock):
            nxt = eng.next_arrival(clock.now())
            if nxt is not None:
                clock.wait_until(nxt)
    return eng.results()


async def _serve_frontend(eng, reqs) -> dict:
    fe = AsyncFrontend(eng, clock=scheduler.FastForwardClock())
    out, streamed = {}, {}
    async with fe:
        async def stream_one(req):
            toks = []
            async for t in fe.generate_stream(req.prompt, req.max_new_tokens,
                                              rid=req.rid):
                toks.append(t)
            streamed[req.rid] = toks

        plain = [r for r in reqs if r.method != "generate"]
        coros = [stream_one(r) for r in reqs if r.method == "generate"]

        async def call_plain():
            out.update(await serve_requests(fe, plain))

        await asyncio.gather(call_plain(), *coros)
    for r in reqs:
        if r.method == "generate":
            out[r.rid] = eng.result(r.rid)
    return out, streamed


def _mesh_info(eng) -> dict:
    m = eng.cache_info()["mesh"]
    return {k: m[k] for k in ("dp_size", "tp_size", "tp_attn", "tp_ssm",
                              "n_devices", "backend", "captured")}


def _shard_gather(mesh) -> dict:
    """`shard_tree` then `gather_sharded` of reduced qwen1.5-0.5b's w4a8
    tree under its `param_pspecs`: each block's shape, and the gathered
    tree against the whole one, bit for bit.  Only rank 0 reports, but
    every rank gathers (the gathers are collective)."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.distributed import sharding as dshard
    cfg, params = build("qwen", "w4a8")
    specs = dshard.param_pspecs(params, mesh, cfg)
    local = dshard.shard_tree(params, specs, mesh)
    whole = pytree.tree_leaves(params)
    flat_s = pytree.tree_leaves(specs, is_leaf=dshard._is_spec)
    shapes_ok, n_sharded = True, 0
    for w, b, sp in zip(whole, pytree.tree_leaves(local), flat_s):
        want = list(w.shape)
        for dim, entry in enumerate(sp):
            if entry is not None:
                want[dim] //= mesh.axis_size(entry)
        shapes_ok &= list(b.shape) == want
        n_sharded += tuple(b.shape) != tuple(w.shape)
    back = pytree.tree_leaves(dshard.gather_sharded(local, specs, mesh))
    return {"shapes_ok": bool(shapes_ok), "n_sharded": n_sharded,
            "n_leaves": len(whole),
            "equal": len(back) == len(whole) and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(back, whole))}


def run_case(case: str, mesh, snap_dir: str):
    """One case on every rank; rank 0's result (None elsewhere)."""
    shape = tuple(mesh.shape.values())
    dp = shape[0]
    leader = mesh.rank == 0
    if case == "reject":
        cfg, params = build("qwen")
        with dctx.mesh_scope(mesh, ("data",), "model"):
            try:
                ServeEngine(params, cfg, n_slots=dp + 1, max_cache_len=64,
                            chaos=None, device="cpu")
            except ValueError as e:
                return str(e)
        return None
    if case == "shard_gather":
        got = _shard_gather(mesh)           # collective: every rank
        return got if leader else None
    if case == "device":
        cfg, params = build("qwen")
        with dctx.mesh_scope(mesh, ("data",), "model"):
            try:
                ServeEngine(params, cfg, n_slots=max(2, dp),
                            max_cache_len=64, chaos=None, device="cuda")
            except ValueError as e:
                return str(e)
        return None
    if case == "unmeshed":
        cfg, params = build("qwen")
        eng = ServeEngine(params, cfg, **engine_kwargs(case, cfg))
        out = streams(eng.run(requests(cfg), scheduler.FastForwardClock()))
        return {"streams": out, "has_mesh": "mesh" in eng.cache_info()}
    kind, quant = model_of("snapshot" if case == "restore" else case)
    cfg, params = build(kind, quant)
    kw = engine_kwargs("snapshot" if case == "restore" else case, cfg, dp)
    if case == "spec":
        _, draft = build(kind, quant, seed=1)
        kw["spec_decode"] = SpecDecodeConfig(draft, cfg, k=3)
    with dctx.mesh_scope(mesh, ("data",), "model"):
        eng = ServeEngine(params, cfg, **kw)
    if not leader:
        eng.follow()
        return None
    try:
        res = {"info": _mesh_info(eng)}
        if case == "frontend":
            got, streamed = asyncio.run(_serve_frontend(
                eng, frontend_traffic(cfg)))
            res["results"] = results(got)
            res["streamed"] = {int(k): v for k, v in streamed.items()}
        elif case == "snapshot":
            # every request there at once and one step: two are done
            # (generation lengths 3 and 1), two are mid-stream and one is
            # still queued when the snapshot is taken
            clock = scheduler.FastForwardClock()
            for r in requests(cfg, stagger=0.0):
                eng.submit(r)
            eng.step(clock)
            res["in_flight"] = sorted(
                [r.rid for r in eng._slot_req if r is not None]
                + [r.rid for r in eng._queue.pending()])
            eng.snapshot(snap_dir)
        elif case == "restore":
            n = eng.restore(snap_dir)
            eng.run((), scheduler.FastForwardClock())
            res["restored"] = n
            res["streams"] = streams({r.rid: r.tokens
                                      for r in eng.finished})
            res["outcomes"] = sorted({r.outcome for r in eng.finished})
            res["errors"] = eng.cache_info()["robustness"]["errors"]
        else:
            res["streams"] = serve(eng, case, cfg)
            info = eng.cache_info()
            res["outcomes"] = sorted({r.outcome for r in eng.finished})
            res["errors"] = info["robustness"]["errors"]
            res["compactions"] = info["compactions"]
            res["graphs"] = (info["graphs"], info["graph_bound"])
            if case == "spec":
                res["spec"] = info["spec_decode"]
            if case.startswith("prefix"):
                res["prefix"] = info["prefix_cache"]
        return res
    finally:
        eng.release()


def run_group(rank: int, shape: tuple, cases: tuple, out: str,
              snap_dir: str) -> None:
    mesh = mesh_lib.init_mesh(shape, ("data", "model"), backend="gloo",
                              device="cpu")
    got = {case: run_case(case, mesh, snap_dir) for case in cases}
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(got, f)


def spawn_group(shape: tuple, cases: tuple, out: str, snap_dir: str):
    mesh_lib.spawn(run_group, shape[0] * shape[1], tuple(shape),
                   tuple(cases), out, snap_dir)
    with open(out, "rb") as f:
        return pickle.load(f)


def run_card_group(rank: int, shape: tuple, backend: str, out: str) -> None:
    """A card rank (tests/test_torch_cuda.py): reduced qwen1.5-0.5b w4a8
    on cuda:0 (every gloo rank shares it; NCCL takes one rank per card),
    the ragged mix served by rank 0, the streams and the mesh block
    pickled to `out`."""
    import torch
    mesh = mesh_lib.init_mesh(shape, ("data", "model"), backend=backend,
                              device="cuda:0")
    cfg = configs.get_reduced_config(FAMILIES["qwen"])
    params = quantize_tree_for_serving(
        lm.init_params(cfg, 0, device="cpu", max_seq=80), "w4a8", force=True)
    params = torch.utils._pytree.tree_map(lambda t: t.to(mesh.device),
                                          params)
    kw = engine_kwargs("w4a8", cfg, shape[0])
    kw["device"] = "cuda"
    with dctx.mesh_scope(mesh, ("data",), "model"):
        eng = ServeEngine(params, cfg, **kw)
    if mesh.rank != 0:
        eng.follow()
        return
    try:
        got = streams(eng.run(requests(cfg), scheduler.FastForwardClock()))
        info = eng.cache_info()
    finally:
        eng.release()
    with open(out, "wb") as f:
        pickle.dump({"streams": got, "mesh": info["mesh"],
                     "captured": info["captured"],
                     "errors": info["robustness"]["errors"]}, f)
