"""Crash-safe dependency-free checkpointing: npz payload + json manifest
(port of ``repro.checkpoint.checkpointer``, in the same on-disk format).

Layout:  <dir>/step_<k>/arrays.npz     (flat leaves, keyed by index)
         <dir>/step_<k>/manifest.json  (shapes/dtypes/leaf paths, payload
                                        checksum, caller metadata)

Durability model (the FleetSession resume path rides on all three):

* **Atomic saves.**  Both files are written into a ``step_<k>.tmp``
  sibling directory which is ``os.replace``d into place only once
  complete.  :func:`latest_step` matches ``step_<digits>`` exactly, so
  a crash mid-save leaves only an ignored ``.tmp`` orphan — never a
  half-written checkpoint that restore would pick up.  (Re-saving an
  existing step replaces it.)
* **Corruption detection.**  The manifest records a CRC-32 of the
  ``arrays.npz`` bytes; :func:`restore` re-hashes the payload and
  raises :class:`CheckpointCorruptionError` on mismatch instead of
  handing back silently wrong tensors.
* **Template validation.**  ``restore`` takes a template tree
  (``like=``) to rebuild structure and validates the checkpoint
  leaf-by-leaf against it: leaf count, then each leaf's shape AND
  dtype, with the first mismatching leaf's path in the exception
  message (never a silent dtype cast).

**One format for both packages.**  A checkpoint either package writes
restores in the other.  The tree is walked as ``jax.tree_util``
flattens a pytree: dict entries in sorted-key order, NamedTuple fields
and tuple entries in order, and no leaf for ``None``.  A leaf is a
tensor (written from the host), a numpy array, or a host ``int`` (the
port's ``TrainState.step``), written as a 0-d int32 leaf, as the JAX
package's step is, and read back as an ``int``.  Each leaf's path is
rendered as ``jax.tree_util.keystr`` renders it: ``['key']`` for a dict
key, ``.field`` for a NamedTuple field, ``[i]`` for a tuple index.  The
manifest's ``treedef`` describes the structure for a reader; neither
package's ``restore`` reads it.

``save(..., extra=...)`` stores one JSON-serializable object in the
manifest (the session layer keeps its round index and rollup counters
there); :func:`read_manifest` reads it back without touching the
payload.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


class CheckpointError(ValueError):
    """A checkpoint that cannot be restored (structure/shape/dtype)."""


class CheckpointCorruptionError(CheckpointError):
    """A checkpoint whose payload bytes fail their manifest checksum."""


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr path, leaf)]`` in ``jax.tree_util`` leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for name, x in zip(tree._fields, tree)
                for item in _flatten(x, f"{path}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [item for i, x in enumerate(tree)
                for item in _flatten(x, f"{path}[{i}]")]
    return [(path or "<root>", tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _describe(tree) -> str:
    """The structure with ``*`` for each leaf (the manifest's
    ``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{n}={_describe(x)}" for n, x in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(x) for x in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _template(leaf) -> Tuple[tuple, str]:
    """(shape, numpy dtype name) that a template leaf expects."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, int):
        return (), "int32"
    arr = np.asarray(leaf)
    return tuple(arr.shape), str(arr.dtype)


def _like(arr: np.ndarray, tmpl):
    """The stored leaf in the template leaf's kind and place."""
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(tmpl.device)
    if isinstance(tmpl, int):
        return int(arr)
    return np.array(arr)


def _crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def save(ckpt_dir: str, step: int, tree: Any, extra: Any = None) -> str:
    """Write ``tree`` atomically as checkpoint ``step``; returns its dir.

    ``extra`` is any JSON-serializable object stored in the manifest
    (read back via :func:`read_manifest`) — round counters, rollup
    snapshots, anything that must travel with the arrays but is not a
    tensor.
    """
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)  # orphan from a crashed earlier save
    os.makedirs(tmp)
    flat = _flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, (_, x) in enumerate(flat)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "num_leaves": len(flat),
        "treedef": _describe(tree),
        "paths": [p for p, _ in flat],
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "crc32": _crc32(os.path.join(tmp, "arrays.npz")),
        "extra": extra,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.isdir(final):
        shutil.rmtree(final)  # re-save of an existing step replaces it
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Highest COMPLETE checkpoint step (``.tmp`` orphans never match)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", d))
    ]
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The manifest dict of checkpoint ``step`` (default: latest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None) -> Any:
    """Load checkpoint ``step`` (default: latest) into ``like``'s
    structure, after checksum and leaf-by-leaf shape/dtype validation.
    Tensor leaves come back on the template leaf's device, with its
    dtype; a host ``int`` leaf comes back as an ``int``.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz = os.path.join(path, "arrays.npz")
    want_crc = manifest.get("crc32")
    if want_crc is not None and _crc32(npz) != want_crc:
        raise CheckpointCorruptionError(
            f"checkpoint {path} failed its payload checksum: arrays.npz "
            f"does not match manifest crc32={want_crc} — the checkpoint "
            f"is corrupt, restore from an earlier step"
        )
    flat = _flatten(like)
    if manifest["num_leaves"] != len(flat):
        raise CheckpointError(
            f"checkpoint {path} has {manifest['num_leaves']} leaves, "
            f"template has {len(flat)} — the template's slot "
            f"layout (EF/ctrl/net_state) must match the saved session"
        )
    leaves = []
    with np.load(npz) as data:
        for i, (leaf_path, tmpl) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            shape, dtype = _template(tmpl)
            if tuple(arr.shape) != shape:
                raise CheckpointError(
                    f"checkpoint {path} leaf {leaf_path!r} (index {i}): "
                    f"shape {tuple(arr.shape)} does not match template "
                    f"shape {shape}"
                )
            if str(arr.dtype) != dtype:
                raise CheckpointError(
                    f"checkpoint {path} leaf {leaf_path!r} (index {i}): "
                    f"dtype {arr.dtype} does not match template dtype "
                    f"{dtype}"
                )
            leaves.append(_like(arr, tmpl))
    return _unflatten(like, iter(leaves))
