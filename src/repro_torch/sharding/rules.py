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
replicates.  Laying parameters out over a mesh (``tree_shardings``)
belongs to the LM half of the multi-device port.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.utils.todo import not_ported

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


def tree_pspecs(axes_tree, shapes_tree, rules, mesh):
    """Map matching (logical axes, shapes) trees to a PartitionSpec tree.
    An axes leaf is a tuple of names and Nones; a shape leaf a tensor,
    anything with ``.shape``, or a shape tuple."""
    def walk(axes, shapes):
        if isinstance(axes, tuple) and all(
                isinstance(a, (str, type(None))) for a in axes):
            shape = shapes.shape if hasattr(shapes, "shape") else shapes
            return resolve_pspec(tuple(shape), axes, rules, mesh)
        if isinstance(axes, dict):
            return {k: walk(axes[k], shapes[k]) for k in sorted(axes)}
        return type(axes)(walk(a, s) for a, s in zip(axes, shapes))

    return walk(axes_tree, shapes_tree)


__getattr__ = not_ported(__name__, {
    "tree_shardings": "queue 1 item 11",
})
