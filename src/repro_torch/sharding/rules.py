"""Logical-axis → mesh-axis rules (port of ``repro.sharding.rules``).

The logical axis vocabulary of the model zoo (``layer``, ``vocab``,
``embed``, ``heads``, ``kv_heads``, ``ff``, ``expert``, ``state``,
``conv``, ``batch``, ``agent``, ``seq``, ``cache_seq``, ``patch``,
``frame``) maps onto the mesh's axes through :func:`resolve_rules`, and
:func:`resolve_pspec` turns one tensor's logical axes into a
:class:`PartitionSpec` with the JAX package's safeguards: a mesh axis
appears at most once per spec, and a dimension its axes do not divide
is replicated.  The rules read only a mesh's ``axis_names`` and
``shape`` (:class:`repro_torch.launch.mesh.Mesh`, or any object with
those two).

The fleet-sharded step reads the ``agent`` rule: :func:`agent_pspec`
says whether the fleet's agent axis shards, and warns LOUDLY where it
replicates.

:func:`tree_shardings` lays a tree out over a mesh: each leaf's
:class:`NamedSharding` gives its block's shape
(:meth:`NamedSharding.shard_shape`, as JAX's), this rank's block of a
global tensor (:meth:`NamedSharding.local`, by the rank's mesh
coordinates, as JAX places ``addressable_shards``) and the global tensor
from every rank's block (:meth:`NamedSharding.gather`, a collective over
the spec's axes).  :func:`shard_tree` and :func:`gather_tree` do the
same for whole trees: a global state (``repro_torch.convert`` turns a
JAX state into one) is placed on the mesh with ``shard_tree``.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.utils.tree import tree_map

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of
    names, or None (replicated); prints like JAX's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def resolve_rules(
    mesh,
    *,
    fsdp: bool = False,
    agent_axes: Tuple[str, ...] = ("data",),
    seq_shard: bool = False,
    inner_batch_shard: bool = False,
    cache_seq_shard: bool = False,
) -> Dict[str, MeshAxes]:
    """The default rule table of the JAX package.

    Tensor-parallel dims go to "model"; ``batch`` to the data axes (with
    "pod" where the mesh has it); ``agent`` to ``agent_axes``; with
    ``fsdp`` the ``embed`` dim also shards over the data axes;
    ``seq_shard``, ``inner_batch_shard`` and ``cache_seq_shard`` move
    ``seq``, ``inner_batch`` and ``cache_seq`` onto "model" (the last
    one takes "model" from ``decode_heads``)."""
    has_pod = "pod" in mesh.axis_names
    data_axes: Tuple[str, ...] = ("pod", "data") if has_pod else ("data",)
    return {
        "layer": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "expert": "model",
        "state": None,
        "conv": None,
        "embed": tuple(data_axes) if fsdp else None,
        "batch": data_axes,
        "agent": agent_axes,
        "inner_batch": "model" if inner_batch_shard else None,
        "seq": "model" if seq_shard else None,
        "cache_seq": "model" if cache_seq_shard else None,
        "decode_heads": None if cache_seq_shard else "model",
        "patch": None,
        "frame": None,
    }


def _axis_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def resolve_pspec(
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    rules: Dict[str, MeshAxes],
    mesh,
) -> PartitionSpec:
    """Map one tensor's logical axes to a PartitionSpec.

    Per dimension, in order: an unknown or None name is replicated; a
    mesh axis an earlier dimension already took is replicated; a size
    the axes' product does not divide is replicated.  Trailing Nones are
    dropped."""
    used: set = set()
    spec = []
    for dim, name in zip(shape, logical_axes):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            spec.append(None)
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        axes_t = tuple(a for a in axes_t if a in mesh.axis_names)
        if not axes_t or any(a in used for a in axes_t):
            spec.append(None)
            continue
        size = _axis_size(mesh, axes_t)
        if size <= 1 or dim % size != 0:
            spec.append(None)
            continue
        used.update(axes_t)
        spec.append(axes_t[0] if len(axes_t) == 1 else axes_t)
    while spec and spec[-1] is None:
        spec.pop()
    return PartitionSpec(*spec)


def agent_axis_names(mesh, rules: Optional[Dict[str, MeshAxes]] = None
                     ) -> Tuple[str, ...]:
    """The mesh axes behind the ``agent`` logical axis (the rule's axes
    that the mesh has): what the gateway reduce sums over; empty where
    the fleet cannot shard."""
    rules = rules if rules is not None else resolve_rules(mesh)
    axes = rules.get("agent")
    if axes is None:
        return ()
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes_t if a in mesh.axis_names)


def agent_shard_count(mesh,
                      rules: Optional[Dict[str, MeshAxes]] = None) -> int:
    """The number of agent shards (gateways) the mesh provides."""
    return _axis_size(mesh, agent_axis_names(mesh, rules) or None)


def agent_pspec(mesh, num_agents: int,
                rules: Optional[Dict[str, MeshAxes]] = None,
                ) -> PartitionSpec:
    """The PartitionSpec of an ``(m, ...)`` per-agent tensor's leading
    axis.  Where the agent axes do not divide ``num_agents`` the fleet
    replicates, every gateway computing every agent: a whole-fleet cliff,
    so it warns (``UserWarning``) instead of shrugging."""
    rules = rules if rules is not None else resolve_rules(mesh)
    spec = resolve_pspec((num_agents,), ("agent",), rules, mesh)
    shards = agent_shard_count(mesh, rules)
    if shards > 1 and spec == PartitionSpec():
        warnings.warn(
            f"agent axis of size {num_agents} is not divisible by the "
            f"{shards}-way agent mesh axes "
            f"{agent_axis_names(mesh, rules)}: falling back to "
            f"REPLICATION — the fleet will not shard",
            UserWarning,
            stacklevel=2,
        )
    return spec


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf: a tuple of names and Nones (JAX's
    ``repro.models.param.is_axes_leaf``)."""
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def map_axes(fn, axes_tree, *rest):
    """``fn(axes_leaf, *leaves)`` over an axes tree and trees of its
    structure (dicts in sorted-key order, tuples and NamedTuples)."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(r[k] for r in rest))
                for k in sorted(axes_tree)}
    parts = [map_axes(fn, *xs) for xs in zip(axes_tree, *rest)]
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*parts)
    return type(axes_tree)(parts)


def _shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape if hasattr(x, "shape") else x)


def tree_pspecs(axes_tree, shapes_tree, rules, mesh):
    """Map matching (logical axes, shapes) trees to a PartitionSpec tree.
    An axes leaf is a tuple of names and Nones; a shape leaf a tensor,
    anything with ``.shape``, or a shape tuple."""
    return map_axes(lambda a, s: resolve_pspec(_shape_of(s), a, rules, mesh),
                    axes_tree, shapes_tree)


DATA_AXES = ("pod", "data")


def split_spec(spec: PartitionSpec) -> Tuple[PartitionSpec, PartitionSpec]:
    """``(data part, the rest)`` of a spec: its entries over the data
    axes ("pod", "data": ZeRO-3's ``embed``), and its others (the
    tensor-parallel dims over "model"), each with None elsewhere."""
    def over_data(e):
        names = (e,) if isinstance(e, str) else tuple(e or ())
        return bool(set(names) & set(DATA_AXES))

    return (PartitionSpec(*(e if over_data(e) else None for e in spec)),
            PartitionSpec(*(None if over_data(e) else e for e in spec)))


def spec_axes(spec: PartitionSpec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in the spec's order."""
    out = []
    for entry in spec:
        if entry is not None:
            out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


class NamedSharding:
    """A PartitionSpec on a mesh (the port's ``jax.sharding.
    NamedSharding``): which block of a global tensor each rank holds.

    Dimension ``i`` of the spec's entry ``axes`` is cut into
    ``prod(mesh.shape[a] for a in axes)`` equal blocks; a rank holds the
    block whose index is its coordinate over ``axes``, row-major in the
    entry's order.  Every axis the spec leaves out replicates."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"

    def _entries(self, ndim: int):
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [() if e is None else ((e,) if isinstance(e, str)
                                      else tuple(e)) for e in spec]

    def _count(self, axes) -> int:
        n = 1
        for a in axes:
            n *= int(self.mesh.shape[a])
        return n

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one rank's block (``NamedSharding.shard_shape``)."""
        out = []
        for dim, axes in zip(global_shape, self._entries(len(global_shape))):
            n = self._count(axes)
            if dim % n:
                raise ValueError(f"dimension {dim} does not split over "
                                 f"{axes!r} ({n} ways)")
            out.append(dim // n)
        return tuple(out)

    def _block_index(self, axes) -> int:
        i = 0
        for a in axes:
            k = self.mesh.axis_names.index(a)
            i = i * self.mesh.axis_sizes[k] + self.mesh.coords[k]
        return i

    def slices(self, global_shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of a tensor of ``global_shape``."""
        out = []
        block = self.shard_shape(global_shape)
        for per, axes in zip(block, self._entries(len(global_shape))):
            i = self._block_index(axes)
            out.append(slice(i * per, (i + 1) * per))
        return tuple(out)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``x`` (a contiguous copy; no
        communication).  Always a copy, also where the block is a
        contiguous slice: a view would keep the whole tensor's storage
        alive beside the block."""
        if not spec_axes(self.spec):
            return x
        return x[self.slices(x.shape)].clone(
            memory_format=torch.contiguous_format)

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the block varies over, in the mesh's order."""
        used = spec_axes(self.spec)
        return tuple(a for a in self.mesh.axis_names if a in used)

    def gather(self, x_local: torch.Tensor, tag: str = "gather",
               dst: Optional[int] = None) -> Optional[torch.Tensor]:
        """The global tensor from every rank's block: a collective over
        the group of the spec's axes, which every rank of the mesh calls.

        An ``all_gather`` where the backend runs one on ``x_local``'s
        device (nccl, or gloo on the CPU); else (gloo on CUDA tensors,
        which it reduces only in ``all_reduce`` and ``broadcast``) the
        sum of a zero-filled global buffer that holds this rank's block,
        exact because every other term is zero.

        With ``dst`` (a rank of the mesh) the global tensor is made on
        that rank alone, on the CPU: every rank sends a host copy of its
        block there over the mesh's ``cpu_group`` (each block crosses
        once, where the zero-filled sum moves the whole tensor through
        every rank's host); the other ranks get None."""
        axes = self.axes
        if dst is not None:
            return self._gather_to(x_local.detach().cpu(), tag, dst)
        if not axes or self.mesh.axes_size(axes) == 1:
            return x_local
        shape = tuple(d * self._count(a) for d, a in zip(
            x_local.shape, self._entries(x_local.ndim)))
        if self.mesh.backend != "nccl" and x_local.device.type != "cpu":
            out = x_local.new_zeros(shape)
            out[self.slices(shape)] = x_local
            return self.mesh.all_reduce(out, tag, axes)
        parts = self.mesh.all_gather(x_local, tag, axes)
        out = x_local.new_empty(shape)
        sizes = [self.mesh.shape[a] for a in axes]
        for j, part in enumerate(parts):
            # the j-th rank of the group, row-major over ``axes``
            coords, r = {}, j
            for a, n in zip(reversed(axes), reversed(sizes)):
                coords[a] = r % n
                r //= n
            peer = NamedSharding(_AtCoords(self.mesh, coords), self.spec)
            out[peer.slices(shape)] = part
        return out

    def _gather_to(self, block: torch.Tensor, tag: str, dst: int
                   ) -> Optional[torch.Tensor]:
        """:meth:`gather` to rank ``dst`` of a CPU ``block``."""
        if not self.axes:
            return block if self.mesh.rank == dst else None
        parts = self.mesh.gather_cpu(block, dst, tag)
        if parts is None:
            return None
        shape = tuple(d * self._count(a) for d, a in zip(
            block.shape, self._entries(block.ndim)))
        out = block.new_empty(shape)
        names, sizes = self.mesh.axis_names, self.mesh.axis_sizes
        for r, part in enumerate(parts):
            # rank r's coordinates, row-major over the mesh's axes
            coords = {a: (r // math.prod(sizes[i + 1:])) % sizes[i]
                      for i, a in enumerate(names)}
            peer = NamedSharding(_AtCoords(self.mesh, coords), self.spec)
            out[peer.slices(shape)] = part
        return out


class _AtCoords:
    """A mesh seen from other coordinates on some of its axes."""

    def __init__(self, mesh, coords: Dict[str, int]):
        self.axis_names, self.axis_sizes = mesh.axis_names, mesh.axis_sizes
        self.shape = mesh.shape
        self.coords = tuple(coords.get(a, c) for a, c in
                            zip(mesh.axis_names, mesh.coords))


def tree_shardings(axes_tree, shapes_tree, rules, mesh):
    """The :class:`NamedSharding` tree of matching (axes, shapes) trees
    (JAX's ``tree_shardings``)."""
    specs = tree_pspecs(axes_tree, shapes_tree, rules, mesh)
    return map_axes(lambda a, p: NamedSharding(mesh, p), axes_tree, specs)


def shard_tree(tree, shardings):
    """This rank's block of every leaf of a global tree (``shardings`` a
    tree of its structure whose leaves are :class:`NamedSharding` or
    None, which keeps the leaf)."""
    return tree_map(lambda sh, x: x if sh is None or x is None
                    else sh.local(x), shardings, tree)


def gather_tree(tree, shardings, tag: str = "gather",
                dst: Optional[int] = None):
    """The global tree from every rank's blocks (a collective per
    sharded leaf, which every rank calls in the same order); with
    ``dst``, on that rank's CPU alone (:meth:`NamedSharding.gather`),
    None on the other ranks (a leaf without a sharding is copied to the
    CPU on every rank)."""
    def one(sh, x):
        if x is None:
            return None
        if sh is None:
            return x if dst is None else x.detach().cpu()
        return sh.gather(x, tag, dst)

    return tree_map(one, shardings, tree)
