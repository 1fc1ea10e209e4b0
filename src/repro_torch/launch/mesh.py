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
    ``collectives`` logs every collective issued through its methods."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...] = ()
    group: Any = None
    cpu_group: Any = None
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    collectives: CollectiveLog = dataclasses.field(
        default_factory=CollectiveLog)

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

    def all_reduce(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Sum ``x`` (contiguous, reduced in place) over the group; the
        call is logged under ``tag``."""
        collective_call(self.collectives, "all-reduce",
                        x.numel() * x.element_size(), self.size, tag)
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather_cpu(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """Every rank's ``x`` (a CPU tensor of one shape on every rank)
        concatenated along a new leading axis, over ``cpu_group``."""
        x = x.contiguous()
        collective_call(self.collectives, "all-gather",
                        x.numel() * x.element_size(), self.size, tag)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.cpu_group)
        return torch.stack(parts)

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


def make_host_mesh(model: int = 1) -> Mesh:
    """A ("data", "model") mesh over the running ranks (one rank when no
    process group is running): ``world // model`` by ``model``."""
    n, rank = _world()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    group = dist.group.WORLD if n > 1 else None
    return Mesh(("data", "model"), (n // model, model),
                (rank // model, rank % model), group, group,
                dist.get_backend() if n > 1 else None)


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
               device: str, timeout_s: float, args: tuple, results) -> None:
    # an exception ends the process with a nonzero code, its traceback on
    # the inherited stderr: the parent then kills the other ranks
    dev = _rank_device(device, rank, backend)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    mesh = make_fleet_mesh(world, backend=backend, device=dev)
    # by value: torch's queue pickler would pass tensors as shared memory
    # handles, which die with the rank
    results.put((rank, pickle.dumps(fn(mesh, *args))))
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, timeout_s: float,
          backend: Optional[str] = None, device: DeviceLike = "cuda",
          args: Sequence = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` fresh ranks; returns their
    results in rank order.

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
                  str(device), timeout_s, tuple(args), results))
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
