"""Async streaming front-end over ServeEngine: concurrent clients,
per-request token streams, multi-method serving, double-buffered dispatch.

Port of `repro/launch/frontend.py`.  SILVIA's kernels hit II=1 by
overlapping stages -- while the datapath crunches beat N, the control
logic is already fetching beat N+1.  The serve loop here is the same
two-stage software pipeline over CUDA's asynchronous launches: a decode
segment is DISPATCHED (engine.step_begin replays the captured step and
returns without syncing on the device), and while the device crunches the host
runs the serve loop's control work -- publishing segment N-1's freshly
harvested tokens to per-request streams, warming the NEXT admission's
prefix-cache digests (engine.admission_plan), and absorbing client
submits/cancels -- before blocking on the segment (engine.step_finish).
With ``overlap=False`` the same work runs serially after the sync, which
is the baseline the pipeline is measured against.  A speculative engine's
round is synchronous (step_begin returns no pending segment), so the
front-end overlaps nothing there.

Why overlap cannot change a single bit: the host work between begin and
finish never dispatches to the device and never touches decode state --
it reads already-harvested tokens, hashes queued prompts, and mutates
only the queue (submit/cancel).  The dispatch order of device work is
identical with and without overlap, so streamed tokens are byte-identical
to the batch engine's output (tests/test_torch_frontend.py asserts this
for all four families, with and without overlap, and through a warm
prefix cache).

Threading model (the saxml enqueue/dequeue-stream pattern): ONE worker
thread owns the engine; asyncio clients talk to it through a command
queue (submit/cancel/stop) and receive tokens through BOUNDED per-stream
asyncio queues fed via ``loop.call_soon_threadsafe``.  A stream whose
consumer stops draining overflows its queue and is cancelled
("stream backlog exceeded") instead of wedging the serve loop; a
consumer that disconnects mid-stream (GeneratorExit) cancels its request,
freeing the slot while keeping the partial tokens in the result.

CUDA and threads: the worker thread makes the engine's device its
current device (the current device is per thread) and is the only
thread that launches; the asyncio side handles numpy only.  A step
captured lazily in the worker is captured in `torch.cuda.graph`'s global
error mode, which faults if another thread touches CUDA meanwhile, so
a caller that launches work of its own should `warmup()` the engine
first.  An exception that escapes the worker (the engine recovers from
its own) is delivered to every waiting client and stream, and re-raised
by `stop()`.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import queue as _thread_queue
import threading
import time
from typing import Optional, Sequence

import numpy as np

import torch

from repro_torch.launch import methods
from repro_torch.launch import resilience as res
from repro_torch.launch import scheduler


@dataclasses.dataclass
class _Done:
    """End-of-stream marker carrying the structured result."""
    result: Optional[res.RequestResult]
    error: Optional[BaseException] = None


class AsyncFrontend:
    """Asyncio host loop around a ServeEngine (module docstring).

    Parameters
    ----------
    engine:       the ServeEngine to serve (exclusively owned by the
                  front-end's worker thread between start() and stop()).
    clock:        serving clock; a scheduler.FastForwardClock runs
                  virtual time (tests), the default real Clock serves
                  wall-clock traffic (benchmarks).
    overlap:      True (default) runs the two-stage pipeline; False
                  syncs each segment before doing host work -- the
                  no-overlap baseline.
    stream_queue: per-stream token buffer bound; an undrained stream
                  that overflows it is cancelled, not buffered forever.
    poll_s:       idle wait granularity of the worker loop.
    """

    def __init__(self, engine, *, clock: Optional[scheduler.Clock] = None,
                 overlap: bool = True, stream_queue: int = 256,
                 poll_s: float = 0.02):
        self.engine = engine
        self.clock = clock if clock is not None else scheduler.Clock()
        self.overlap = overlap
        self._qsize = stream_queue
        self._poll_s = poll_s
        self._cmds: "_thread_queue.SimpleQueue" = _thread_queue.SimpleQueue()
        self._rids = itertools.count()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = False
        self._fatal: Optional[BaseException] = None
        self._device: Optional[torch.device] = None
        # worker-thread state
        self._live: dict = {}          # rid -> live Request
        self._fin_idx = 0              # engine.finished cursor
        self._sent: dict = {}          # rid -> tokens already published
        # event-loop state
        self._streams: dict = {}       # rid -> asyncio.Queue
        self._waiters: dict = {}       # rid -> asyncio.Future
        self.stats = {"submitted": 0, "streamed_tokens": 0,
                      "overlapped_segments": 0, "disconnect_cancels": 0,
                      "backlog_cancels": 0, "hidden_host_s": 0.0}

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "AsyncFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._loop = asyncio.get_running_loop()
        dev = getattr(self.engine, "device", None)
        if dev is not None and dev.type == "cuda" and dev.index is None:
            # "cuda" means the caller's current device; the worker's own
            # current device starts at 0
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="serve-frontend", daemon=True)
        self._thread.start()
        return self

    async def stop(self) -> None:
        """Stop the worker loop (in-flight device work completes; queued
        requests stay queued on the engine).  Re-raises what ended the
        worker, if anything did."""
        if self._thread is None:
            return
        self._cmds.put(("stop",))
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join)
        self._thread = None
        if self._fatal is not None:
            raise self._fatal

    async def __aenter__(self) -> "AsyncFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- client API ---------------------------------------------------------

    def _new_rid(self, rid: Optional[int]) -> int:
        return next(self._rids) if rid is None else int(rid)

    async def _call(self, req: scheduler.Request) -> res.RequestResult:
        fut = asyncio.get_running_loop().create_future()
        self._waiters[req.rid] = fut
        if self._fatal is not None:
            self._waiters.pop(req.rid)
            raise self._fatal
        self.stats["submitted"] += 1
        self._cmds.put(("submit", req))
        try:
            return await fut
        finally:
            self._waiters.pop(req.rid, None)

    async def generate(self, prompt, max_new_tokens: int, *,
                       rid: Optional[int] = None,
                       stop_tokens: Optional[Sequence[int]] = None,
                       features=None,
                       deadline: Optional[float] = None,
                       sampling=None) -> res.RequestResult:
        """Non-streaming generation; resolves to the structured result.
        `sampling` is an optional scheduler.SamplingParams (temperature /
        top-k / top-p / seed); None means greedy."""
        return await self._call(methods.generate_request(
            self._new_rid(rid), prompt, max_new_tokens,
            arrival_time=self.clock.now(), stop_tokens=stop_tokens,
            features=features, deadline=deadline, sampling=sampling))

    async def generate_stream(self, prompt, max_new_tokens: int, *,
                              rid: Optional[int] = None,
                              stop_tokens: Optional[Sequence[int]] = None,
                              features=None,
                              deadline: Optional[float] = None,
                              sampling=None):
        """Async iterator of generated tokens, published per segment as
        they are harvested.  Exiting the iteration early (client
        disconnect) cancels the request: its slot frees mid-stream and
        the tokens streamed so far stay in the CANCELLED result."""
        rid = self._new_rid(rid)
        q: asyncio.Queue = asyncio.Queue(self._qsize)
        self._streams[rid] = q
        if self._fatal is not None:
            self._streams.pop(rid)
            raise self._fatal
        self.stats["submitted"] += 1
        req = methods.generate_request(
            rid, prompt, max_new_tokens, arrival_time=self.clock.now(),
            stop_tokens=stop_tokens, features=features, deadline=deadline)
        self._cmds.put(("submit", req))
        done = False
        try:
            while True:
                item = await q.get()
                if isinstance(item, _Done):
                    done = True
                    if item.error is not None:
                        raise item.error
                    return
                yield item
        finally:
            self._streams.pop(rid, None)
            if not done:
                self.stats["disconnect_cancels"] += 1
                self._cmds.put(("cancel", rid, "client disconnected"))

    async def score(self, prompt, completion: Sequence[int], *,
                    rid: Optional[int] = None, features=None,
                    deadline: Optional[float] = None) -> list:
        """Per-token logprobs of `completion` under `prompt` (the score
        method; exact decode-path parity, launch/methods.py)."""
        result = await self._call(methods.score_request(
            self._new_rid(rid), prompt, completion,
            arrival_time=self.clock.now(), features=features,
            deadline=deadline))
        return methods.completion_logprobs(result)

    async def embed(self, prompt, *, rid: Optional[int] = None,
                    features=None,
                    deadline: Optional[float] = None) -> np.ndarray:
        """Pooled final-hidden-state embedding of `prompt`."""
        result = await self._call(methods.embed_request(
            self._new_rid(rid), prompt, arrival_time=self.clock.now(),
            features=features, deadline=deadline))
        return methods.embedding(result)

    async def cancel(self, rid: int, reason: Optional[str] = None) -> None:
        self._cmds.put(("cancel", int(rid), reason or "client cancel"))

    # -- worker loop (owns the engine) --------------------------------------

    def _serve_loop(self) -> None:
        dev = self._device
        try:
            if dev is not None and dev.type == "cuda":
                torch.cuda.set_device(dev)
            self._loop_body()
        except BaseException as e:  # noqa: BLE001 -- surfaced to clients
            self._fatal = e
            self._fail_all(e)

    def _loop_body(self) -> None:
        eng, clock = self.engine, self.clock
        while True:
            self._drain_cmds()
            if self._stop_flag:
                return
            pending, progressed = eng.step_begin(clock)
            if pending is not None:
                if self.overlap:
                    # two-stage pipeline: host work runs WHILE the
                    # dispatched segment is in flight.  hidden_host_s is
                    # the measured overlap -- host time that a sync loop
                    # would have added to the dispatch-to-dispatch path.
                    self.stats["overlapped_segments"] += 1
                    t0 = time.monotonic()
                    self._host_stage()
                    self.stats["hidden_host_s"] += time.monotonic() - t0
                    eng.step_finish(pending, clock)
                    self._publish()
                else:
                    eng.step_finish(pending, clock)
                    self._host_stage()
                continue
            self._publish()
            if progressed:
                continue
            self._idle_wait()

    def _host_stage(self) -> None:
        """The control half of the pipeline: publish segment N-1's
        harvested tokens, warm the next admission's prefix digests, and
        absorb client commands -- all host-only (no device dispatch, no
        decode-state mutation), so running it under an in-flight segment
        cannot perturb a bit."""
        self._publish()
        self.engine.admission_plan()
        self._drain_cmds()

    def _idle_wait(self) -> None:
        """Nothing active and nothing admitted: wait for the next queued
        arrival (virtual clocks jump straight to it) or the next client
        command, whichever is first."""
        clock = self.clock
        nxt = self.engine.next_arrival(clock.now())
        if isinstance(clock, scheduler.FastForwardClock):
            if nxt is not None:
                clock.wait_until(nxt)
                return
            timeout = self._poll_s
        else:
            timeout = self._poll_s if nxt is None else \
                max(0.0, min(nxt - clock.now(), self._poll_s))
        try:
            cmd = self._cmds.get(timeout=timeout)
        except _thread_queue.Empty:
            return
        self._handle_cmd(cmd)

    def _drain_cmds(self) -> None:
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except _thread_queue.Empty:
                return
            self._handle_cmd(cmd)

    def _handle_cmd(self, cmd: tuple) -> None:
        if cmd[0] == "stop":
            self._stop_flag = True
        elif cmd[0] == "submit":
            req = cmd[1]
            self._live[req.rid] = req
            try:
                self.engine.submit(req)
            except Exception as e:  # validation error -> the caller
                self._live.pop(req.rid, None)
                self._deliver_error(req.rid, e)
        elif cmd[0] == "cancel":
            _, rid, reason = cmd
            self.engine.cancel(rid, now=self.clock.now(), reason=reason)

    # -- publishing (worker thread -> event loop) ---------------------------

    def _publish(self) -> None:
        """Push per-stream token deltas and completed results.  Deltas
        come from each live Request's append-only token list (recovery
        replays never re-append, so a delta is never re-published), and
        completion is detected from the engine's finished list -- both
        plain host reads, safe to run under an in-flight segment."""
        for rid, req in list(self._live.items()):
            if rid in self._streams:
                sent = self._sent.get(rid, 0)
                toks = req.tokens
                if len(toks) > sent:
                    for t in toks[sent:]:
                        self._push(rid, int(t))
                    self.stats["streamed_tokens"] += len(toks) - sent
                    self._sent[rid] = len(toks)
        fin = self.engine.finished
        while self._fin_idx < len(fin):
            req = fin[self._fin_idx]
            self._fin_idx += 1
            rid = req.rid
            if rid not in self._live:
                continue        # not ours (engine shared with a driver)
            self._live.pop(rid, None)
            sent = self._sent.pop(rid, 0)
            result = self.engine.result(rid)
            if rid in self._streams:
                for t in req.tokens[sent:]:
                    self._push(rid, int(t))
                    self.stats["streamed_tokens"] += 1
                self._push(rid, _Done(result))
            else:
                self._deliver_result(rid, result)

    def _push(self, rid: int, item) -> None:
        loop = self._loop

        def put() -> None:
            q = self._streams.get(rid)
            if q is None:
                return
            try:
                q.put_nowait(item)
            except asyncio.QueueFull:
                # slow consumer: cancel rather than buffer unboundedly
                # or stall every other stream behind this one
                self.stats["backlog_cancels"] += 1
                self._cmds.put(("cancel", rid, "stream backlog exceeded"))

        loop.call_soon_threadsafe(put)

    def _deliver_result(self, rid: int, result) -> None:
        def done() -> None:
            fut = self._waiters.get(rid)
            if fut is not None and not fut.done():
                fut.set_result(result)

        self._loop.call_soon_threadsafe(done)

    def _fail_all(self, exc: BaseException) -> None:
        """The worker ended: fail every waiting call and open stream (a
        call made later raises at once, seeing `_fatal`)."""
        def fail() -> None:
            for fut in list(self._waiters.values()):
                if not fut.done():
                    fut.set_exception(exc)
            for q in list(self._streams.values()):
                if q.full():
                    q.get_nowait()
                q.put_nowait(_Done(None, error=exc))

        self._loop.call_soon_threadsafe(fail)

    def _deliver_error(self, rid: int, exc: BaseException) -> None:
        def fail() -> None:
            fut = self._waiters.get(rid)
            if fut is not None and not fut.done():
                fut.set_exception(exc)
            q = self._streams.get(rid)
            if q is not None:
                try:
                    q.put_nowait(_Done(None, error=exc))
                except asyncio.QueueFull:
                    pass

        self._loop.call_soon_threadsafe(fail)


async def serve_requests(frontend: AsyncFrontend,
                         requests: Sequence[scheduler.Request]) -> dict:
    """Convenience driver: submit pre-built Requests (any method mix)
    concurrently through a running front-end and gather their structured
    results keyed by rid -- what the stream-vs-batch equality tests and
    the latency benchmark build on."""
    async def one(req: scheduler.Request):
        return req.rid, await frontend._call(req)

    pairs = await asyncio.gather(*(one(r) for r in requests))
    return dict(pairs)
