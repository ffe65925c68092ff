"""Device meshes over `torch.distributed`: one process per rank.

Port of `repro/launch/mesh.py`.  The reference builds a `jax` mesh of
devices that one controller drives; the port runs one process per mesh
position, and a `Mesh` here is that position's view of the whole:

* `shape` (axis name -> size, row-major over `axis_names`), this rank's
  `coords`, its `device`, and the `backend` its collectives run over;
* one process group for every set of axes (`group(axes)`): the ranks
  that differ from this one only along those axes.  `torch.distributed`
  creates a group collectively, so `init_mesh` creates all of them on
  every rank, in one order;
* a `gloo` control group over all ranks (`ctrl`), whatever the data
  backend: the serve engine broadcasts its commands and clock readings
  there (launch/engine.py);
* `all_gather(t, axes, dim)`: the one data collective the serving path
  uses, an exact concatenation along `dim` in rank order over `axes`.

`make_mesh` and `make_production_mesh` give a mesh with no process
group (the reference's `AbstractMesh` role): enough for the sharding
rules (distributed/sharding.py) and the tensor-parallel plan, which
read only `shape` and `axis_names`.

The backend rule: NCCL with one card per rank (`cuda:{local_rank}`),
the default; `gloo` when the caller names it -- several ranks sharing
one card (its default), or ranks on the CPU (`device="cpu"`).  NCCL
refuses two ranks on one device, so `init_mesh` raises when NCCL is
asked for with more ranks than cards.  Over NCCL a collective can be captured in a CUDA graph; over
`gloo` it cannot, and a `gloo` collective on CUDA tensors is staged
through host copies (`_gather_gloo_cuda`): an explicit per-backend
branch, not a fallback.

`spawn(fn, nprocs, *args)` starts `nprocs` rank processes on a free
localhost port (one torch thread each) and raises if any rank fails:
the tests and chip_smoke.py's sharded phase share it.  A collective
waits at most `TIMEOUT` for its peers, then fails.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import socket
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import device as device_lib


class Mesh:
    """A mesh of `math.prod(shape)` ranks over named axes (module
    docstring).  Built bare by `make_mesh` (no groups, no rank) or
    whole by `init_mesh`."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None, backend: Optional[str] = None,
                 device: Optional[torch.device] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank, self.backend, self.device = rank, backend, device
        self.coords = None if rank is None else dict(zip(
            self.axis_names, _unravel(rank, tuple(self.shape.values()))))
        self._groups: Dict[tuple, object] = {}
        self.ctrl = None
        # bytes this rank received through all_gather (eager calls only:
        # a captured graph's replays run no Python)
        self.gathered_bytes = 0

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")

    # -- coordinates --------------------------------------------------------

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major coordinate over `axes` (in mesh order)."""
        idx = 0
        for a in self._ordered(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _ordered(self, axes) -> tuple:
        axes = set(_axes(axes))
        return tuple(a for a in self.axis_names if a in axes)

    # -- groups and collectives ---------------------------------------------

    def _make_groups(self) -> None:
        """Every subset of the axes, every group of it: created on every
        rank in the same order (dist.new_group is collective)."""
        sizes = tuple(self.shape.values())
        names = self.axis_names
        for r in range(1, len(names) + 1):
            for sub in itertools.combinations(names, r):
                rest = [a for a in names if a not in sub]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    members = []
                    for var in itertools.product(
                            *(range(self.shape[a]) for a in sub)):
                        c = dict(zip(rest, fixed))
                        c.update(zip(sub, var))
                        members.append(_ravel(
                            tuple(c[a] for a in names), sizes))
                    g = dist.new_group(sorted(members),
                                       backend=self.backend,
                                       timeout=TIMEOUT)
                    if all(self.coords[a] == c for a, c in zip(rest, fixed)):
                        self._groups[sub] = g
        self.ctrl = dist.new_group(list(range(self.size)), backend="gloo",
                                   timeout=TIMEOUT)

    def group(self, axes):
        return self._groups[self._ordered(axes)]

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0):
        """Concatenate `t` from every rank of `axes` along `dim`, in the
        axes' row-major rank order: exact, pure data movement."""
        axes = self._ordered(axes)
        n = self.axis_size(axes)
        if self.backend == "gloo" and t.is_cuda:
            out = _gather_gloo_cuda(t, n, self.group(axes))
        else:
            out = _gather(t, n, self.group(axes))
        if dim % t.dim() != 0:
            out = torch.cat(out.chunk(n, dim=0), dim=dim)
        self.gathered_bytes += (n - 1) * t.numel() * t.element_size()
        return out

    @property
    def captures_collectives(self) -> bool:
        """Whether steps with collectives may be captured in CUDA graphs
        (NCCL); `gloo` collectives run eagerly."""
        return self.backend == "nccl"

    # -- the control plane (gloo, all ranks) ---------------------------------

    def bcast_object(self, obj=None):
        """Rank 0's `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.ctrl)
        return box[0]

    def bcast_float(self, x: float = 0.0) -> float:
        t = torch.tensor([x], dtype=torch.float64)
        dist.broadcast(t, src=0, group=self.ctrl)
        return float(t.item())


def _gather(t, n: int, group):
    t = t.contiguous()
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        t, n, group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


def _gather_gloo_cuda(t, n: int, group):
    """`gloo` over CUDA tensors: through host copies, gathered on the
    CPU, copied back to t's device."""
    return _gather(t.cpu(), n, group).to(t.device)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _unravel(rank: int, sizes: tuple) -> tuple:
    out = []
    for n in reversed(sizes):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _ravel(coords: tuple, sizes: tuple) -> int:
    idx = 0
    for c, n in zip(coords, sizes):
        idx = idx * n + c
    return idx


# ---------------------------------------------------------------------------
# the reference's helpers
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of this shape with no process group (the sharding rules'
    input); `init_mesh` builds one to run on."""
    return Mesh(tuple(shape), tuple(axes))


def dp_axes(mesh) -> tuple:
    """Axis names carrying the batch dimension."""
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def fsdp_axes(mesh) -> tuple:
    """Axis names parameters are fully sharded over (ZeRO-3 style)."""
    return dp_axes(mesh)


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

# how long a rank waits in a collective before it fails (a peer that
# died or took another path): torch's default is 30 minutes
TIMEOUT = datetime.timedelta(seconds=300)


def init_mesh(shape, axes, *, backend: str = "nccl", device=None) -> Mesh:
    """This process's view of a mesh over the `torch.distributed` world
    (initialized here from $RANK, $WORLD_SIZE, $MASTER_ADDR and
    $MASTER_PORT when it is not yet; `spawn` sets them).  The world size
    must be the mesh's.  NCCL (the default) places rank r on
    `cuda:{local_rank}` and raises when there are more ranks than cards;
    `gloo` places it on `cuda:{local_rank % cards}` (ranks share the
    cards) and raises without CUDA, unless `device` names another place
    ("cpu" for ranks on the CPU).  Creates every axis
    group and the control group, and warms each group with one
    collective (NCCL builds its communicators lazily, and never inside a
    graph capture)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    n = math.prod(int(x) for x in shape)
    rank = int(os.environ.get("RANK", "0")) if not dist.is_initialized() \
        else dist.get_rank()
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n > cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: a {tuple(shape)} mesh has "
                f"{n} ranks and this host has {cards} card(s).  NCCL refuses "
                f"two ranks on one device; use backend='gloo' to share a "
                f"card (its collectives then run uncaptured)")
        dev = torch.device(device) if device is not None \
            else torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = device_lib.resolve("cuda" if device is None else device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=int(os.environ.get(
                                    "WORLD_SIZE", n)), timeout=TIMEOUT)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the world "
                         f"has {dist.get_world_size()}")
    mesh = Mesh(shape, axes, rank=rank, backend=backend, device=dev)
    mesh._make_groups()
    probe = torch.zeros((1,), device=dev)
    for sub in mesh._groups:
        mesh.all_gather(probe, sub)
    mesh.gathered_bytes = 0
    return mesh


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, nprocs: int, port: int, fn, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, *args) -> None:
    """Run `fn(rank, *args)` in `nprocs` fresh processes (the `spawn`
    start method; `fn` must be importable), each with the rendezvous
    variables `init_mesh` reads and one torch thread.  Returns when all
    have exited; raises if any rank raised or exited nonzero."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(nprocs, free_port(), fn,
                                               args),
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    try:
        while not ctx.join():
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
