"""Meshes and the process groups behind them (port of
``repro.launch.mesh``).

The JAX package shards over a ``jax.sharding.Mesh`` of devices inside
one program.  The port shards over processes: each gateway of the fleet
is one rank of a ``torch.distributed`` process group, and
:class:`Mesh` is a small descriptor of that group: its axis names, its
shape, this rank's coordinates, and, where it has more than one rank,
the group itself.  The sharding rules (:mod:`repro_torch.sharding.
rules`) read only the names and the shape, so a descriptor with no
group (``make_production_mesh``, or a test's) serves them as well.

A mesh of more than one rank carries a process group for every set of
its axes (:meth:`Mesh.group_of`): on a (data, model) mesh the ranks of
one row share a "model" group, those of one column a "data" group, and
both axes together are the whole world.  The groups are created in one
order on every rank, as ``dist.new_group`` requires.

The backend is chosen explicitly (:func:`choose_backend`): ``nccl``
where every rank has a card of its own, ``gloo`` otherwise, including
for CUDA tensors on a one-card machine, where the ranks share the card.
NCCL refuses two ranks on one device, and gloo reduces CUDA tensors for
``all_reduce`` and ``broadcast`` only, which is why the sharded step
uses no other collective.  Nothing switches backend on a failure.

:func:`spawn` is the port's counterpart of JAX's
``--xla_force_host_platform_device_count``: it starts ``world`` ranks
(the ``spawn`` start method: CUDA cannot be forked once the parent has
initialised it) that rendezvous through a file under a temporary
directory, so that concurrent test workers never contend for a TCP
port, runs ``fn(mesh, *args)`` on each and returns their results.  It
kills every rank and raises once one fails or ``timeout_s`` passes.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.cost import CollectiveLog, collective_call
from repro_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(eq=False)
class Mesh:
    """Axis names and sizes, this rank's coordinates on them, and the
    process group (None for a descriptor or a one-rank mesh).

    ``cpu_group`` is the group for CPU copies (the gathers of
    :func:`repro_torch.sharding.agent_shard.gather_agents`): the same
    group under gloo, a gloo group beside an ``nccl`` one.
    ``axis_groups`` maps a tuple of axis names (in the mesh's order) to
    this rank's group over those axes (:meth:`group_of`).
    ``collectives`` logs every collective issued through its methods,
    with the axes it ran over."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...] = ()
    group: Any = None
    cpu_group: Any = None
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    collectives: CollectiveLog = dataclasses.field(
        default_factory=CollectiveLog)
    axis_groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def rank(self) -> int:
        """This rank's flat index (row-major over the axes); 0 for a
        descriptor."""
        r = 0
        for c, s in zip(self.coords, self.axis_sizes):
            r = r * s + c
        return r

    def _axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (None: all of them) as a tuple in the mesh's order."""
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"mesh {self.axis_names!r} has no axis "
                             f"{unknown[0]!r}")
        return tuple(a for a in self.axis_names if a in axes)

    def axes_size(self, axes) -> int:
        """The number of ranks in a group over ``axes``."""
        n = 1
        for a in self._axes(axes):
            n *= self.shape[a]
        return n

    def axes_index(self, axes) -> int:
        """This rank's index within its group over ``axes`` (row-major
        over them, in the mesh's order)."""
        r = 0
        for a in self._axes(axes):
            i = self.axis_names.index(a)
            r = r * self.axis_sizes[i] + self.coords[i]
        return r

    def group_of(self, axes):
        """This rank's process group over ``axes`` (a name or a tuple;
        None: the whole mesh); None on a descriptor or a one-rank mesh."""
        axes = self._axes(axes)
        if self.group is None:
            return None
        if axes == self.axis_names:
            return self.group
        if axes not in self.axis_groups:
            raise ValueError(f"mesh {self.axis_names!r} was built without "
                             f"a group over {axes!r}")
        return self.axis_groups[axes]

    def all_reduce(self, x: torch.Tensor, tag: str, axes=None,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` (contiguous, in place) over the group of
        ``axes`` (default: the whole mesh) with ``op`` ("sum" or
        "max"); logged under ``tag`` and the axes.  A group of one rank
        issues nothing."""
        axes = self._axes(axes)
        n = self.axes_size(axes)
        if n == 1 or self.group is None:
            return x
        collective_call(self.collectives, "all-reduce",
                        x.numel() * x.element_size(), n, tag, axes)
        dist.all_reduce(x, op=_OPS[op], group=self.group_of(axes))
        return x

    def all_gather(self, x: torch.Tensor, tag: str, axes=None
                   ) -> List[torch.Tensor]:
        """Every rank's ``x`` over the group of ``axes``, in the group's
        rank order (an ``all_gather``: for nccl, or gloo on the CPU)."""
        axes = self._axes(axes)
        n = self.axes_size(axes)
        if n == 1 or self.group is None:
            return [x]
        x = x.contiguous()
        collective_call(self.collectives, "all-gather",
                        x.numel() * x.element_size(), n, tag, axes)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.group_of(axes))
        return parts

    def all_gather_cpu(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Every rank's ``x`` (a CPU tensor of one shape on every rank)
        concatenated along a new leading axis, over ``cpu_group``."""
        x = x.contiguous()
        collective_call(self.collectives, "all-gather",
                        x.numel() * x.element_size(), self.size, tag)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.cpu_group)
        return torch.stack(parts)

    def gather_cpu(self, x: torch.Tensor, dst: int, tag: str
                   ) -> Optional[List[torch.Tensor]]:
        """Every rank's ``x`` (a CPU tensor of one shape on every rank)
        on rank ``dst`` alone, in rank order, over ``cpu_group`` (each
        copy crosses once); None on the other ranks."""
        x = x.contiguous()
        if self.group is None:
            return [x]
        collective_call(self.collectives, "gather",
                        x.numel() * x.element_size(), self.size, tag)
        parts = ([torch.empty_like(x) for _ in range(self.size)]
                 if self.rank == dst else None)
        dist.gather(x, parts, dst=dst, group=self.cpu_group)
        return parts

    def all_gather_object(self, obj: Any, tag: str) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order, over
        ``cpu_group`` (logged with the pickled size)."""
        collective_call(self.collectives, "all-gather",
                        len(pickle.dumps(obj)), self.size, tag)
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _axis_subsets(names: Tuple[str, ...]):
    """Every proper non-empty subset of ``names``, in a fixed order."""
    for k in range(1, len(names)):
        yield from itertools.combinations(names, k)


def _axis_groups(names: Tuple[str, ...], sizes: Tuple[int, ...],
                 coords: Tuple[int, ...], backend: Optional[str]) -> dict:
    """This rank's group over every proper subset of the axes.  Every
    rank creates every group of every subset, in the same order."""
    out = {}
    for axes in _axis_subsets(names):
        idx = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in idx]
        mine = tuple(coords[i] for i in rest)
        for fixed in itertools.product(*(range(sizes[i]) for i in rest)):
            ranks = []
            for free in itertools.product(*(range(sizes[i]) for i in idx)):
                c = [0] * len(names)
                for i, v in zip(rest, fixed):
                    c[i] = v
                for i, v in zip(idx, free):
                    c[i] = v
                r = 0
                for ci, si in zip(c, sizes):
                    r = r * si + ci
                ranks.append(r)
            group = dist.new_group(ranks, backend=backend)
            if fixed == mine:
                out[axes] = group
    return out


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's TPU v5e pod meshes as descriptors: (16, 16)
    over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model").  They have no group (no such world exists here); the
    sharding rules and the dry-run read their names and shape."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_host_mesh(model: int = 1, *,
                   device: Optional[DeviceLike] = None) -> Mesh:
    """A ("data", "model") mesh over the running ranks (one rank when no
    process group is running): ``world // model`` by ``model``, rank
    ``r`` at (r // model, r % model).  With more than one rank it
    carries the group of every set of axes (:meth:`Mesh.group_of`), so
    every rank must call it, in the same order as its other
    collectives.  ``device`` is this rank's device (recorded on the
    mesh; nothing moves)."""
    n, rank = _world()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    dev = None if device is None else torch.device(device)
    names, sizes = ("data", "model"), (n // model, model)
    coords = (rank // model, rank % model)
    if n == 1:
        return Mesh(names, sizes, coords, device=dev)
    backend = dist.get_backend()
    group = dist.group.WORLD
    cpu_group = dist.new_group(backend="gloo") if backend == "nccl" else group
    return Mesh(names, sizes, coords, group, cpu_group, backend, dev,
                axis_groups=_axis_groups(names, sizes, coords, backend))


def choose_backend(world: int, device: DeviceLike) -> str:
    """``nccl`` where each of ``world`` ranks has a card of its own,
    ``gloo`` otherwise (the CPU, or ranks sharing a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def make_fleet_mesh(shards: Optional[int] = None, *,
                    backend: Optional[str] = None,
                    device: DeviceLike = "cuda") -> Mesh:
    """The 1-D ("data",) mesh of the running process group: one gateway
    per rank, on ``device``.

    With no group running it is the one-rank mesh (the sharded step
    then is the plain hybrid step), and asking for more shards raises.
    ``shards`` must equal the world size, as JAX raises for more shards
    than devices; ``backend``, where given, must be the group's."""
    n, rank = _world()
    shards = n if shards is None else int(shards)
    if shards != n:
        raise ValueError(f"asked for {shards} fleet shards but the process "
                         f"group has {n} rank(s)")
    dev = resolve_device(device)
    if n == 1:
        return Mesh(("data",), (1,), (0,), device=dev)
    running = dist.get_backend()
    if backend is not None and backend != running:
        raise ValueError(f"asked for backend {backend!r} but the process "
                         f"group runs {running!r}")
    group = dist.group.WORLD
    cpu_group = dist.new_group(backend="gloo") if running == "nccl" else group
    return Mesh(("data",), (n,), (rank,), group, cpu_group, running, dev)


def _rank_device(device: DeviceLike, rank: int, backend: str):
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    # nccl: one card per rank; gloo: the ranks share the current card
    index = rank if backend == "nccl" else (dev.index or 0)
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _rank_main(fn, rank: int, world: int, backend: str, init_file: str,
               device: str, timeout_s: float, args: tuple, results,
               model: Optional[int] = None) -> None:
    # an exception ends the process with a nonzero code, its traceback on
    # the inherited stderr: the parent then kills the other ranks
    dev = _rank_device(device, rank, backend)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    mesh = (make_fleet_mesh(world, backend=backend, device=dev)
            if model is None else make_host_mesh(model, device=dev))
    # by value: torch's queue pickler would pass tensors as shared memory
    # handles, which die with the rank
    results.put((rank, pickle.dumps(fn(mesh, *args))))
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, timeout_s: float,
          backend: Optional[str] = None, device: DeviceLike = "cuda",
          args: Sequence = (), model: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` fresh ranks; returns their
    results in rank order.  ``mesh`` is the 1-D fleet mesh
    (:func:`make_fleet_mesh`), or with ``model`` the ("data", "model")
    host mesh of :func:`make_host_mesh`.

    ``fn`` and ``args`` are pickled (``fn`` by import path), and so is
    each result (by value: tensors come back as copies).
    ``backend`` defaults to :func:`choose_backend`'s; the choice is
    printed.  A rank that raises (its traceback on stderr) makes this
    raise ``RuntimeError``; a run past ``timeout_s`` raises
    ``TimeoutError``.  Either way every rank is killed first."""
    if torch.device(device).type == "cuda":
        resolve_device(device)  # no card: raise here, not in every rank
    backend = backend or choose_backend(world, device)
    ndev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"[mesh] backend={backend} world={world} device={device} "
          f"cuda_device_count={ndev}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: Dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world, backend, os.path.join(tmp, "rendezvous"),
                  str(device), timeout_s, tuple(args), results, model))
            for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: {world - len(out)} of {world} ranks still "
                        f"running after {timeout_s} s")
                try:
                    rank, value = results.get(timeout=min(left, 0.2))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"spawn: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} (its traceback is "
                            f"on stderr)")
                    continue
                out[rank] = pickle.loads(value)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            started = [p for p in procs if p.pid is not None]
            for p in started:
                if p.is_alive():
                    p.kill()
            for p in started:
                p.join(5.0)
            results.close()
    return [out[r] for r in range(world)]
