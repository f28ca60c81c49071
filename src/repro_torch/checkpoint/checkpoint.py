"""Checkpointing: atomic, manifest-driven, self-verifying.

Port of ``repro.checkpoint.checkpoint`` with the same layout on disk, so a
checkpoint written by either package restores in the other:

* **Atomicity** — the payload is written to ``<dir>/.tmp.<step>`` and
  ``os.replace``d to ``<dir>/step_<step:010d>``; ``latest_step`` trusts
  only directories with a ``MANIFEST.json``.
* **Self-describing** — ``MANIFEST.json`` holds ``step``, ``keys`` (each
  stored array's ``shape``, ``dtype`` and ``crc32``) and ``metadata``;
  the arrays are ``arrays.npz``.
* **Self-verifying** — restore recomputes every array's crc32 and raises
  ``CheckpointCorrupt`` on a mismatch or an unreadable payload (manifests
  from before checksums restore unverified).

A tree's leaves are stored under the reference's keys: the path of each
leaf, one part per level joined by ``/`` — a dict key (dicts in sorted key
order, an ``OrderedDict`` in its own order), a sequence index, or a
namedtuple's or dataclass's field name.  Leaves are tensors (stored
through ``.detach().cpu().numpy()``), numpy arrays and scalars; ``None``
holds no leaf.  ``device=`` takes the place of the reference's
``shardings=``: the restored tensors are put there.

bfloat16 leaves are stored as the reference stores them (it writes
``ml_dtypes`` arrays through ``np.savez``): 2-byte void values (npz descr
``V2``) holding the bf16 bits, ``"dtype": "bfloat16"`` in the manifest and
the crc32 over those bytes.  numpy has no bf16 type, so the port views a
tensor's bits as int16 to write them and reads a ``V2`` array back
through int16 into ``torch.bfloat16``; it needs no ``ml_dtypes``.  A
manifest-driven restore (``template=None``) returns such an array as
stored (``V2``) or, with ``device=``, as a bf16 tensor.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps", "CheckpointCorrupt"]

_MANIFEST = "MANIFEST.json"
_PAYLOAD = "arrays.npz"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint payload is torn or corrupt: the npz is unreadable, a
    manifest-listed array is missing, or a stored array fails its manifest
    crc32.  Restore raises this instead of returning garbage; callers with
    older checkpoints to fall back to (the durable surplus snapshots) catch
    it and try the previous step."""


def _crc32(a: np.ndarray) -> int:
    """The reference's ``zlib.crc32`` of the array's C-order bytes, read
    through a byte view instead of a ``tobytes()`` copy (a 1.07 GB surplus
    would be copied once more on the host)."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


_BF16_BITS = np.dtype("V2")          # a stored bf16 leaf's numpy type


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array stored for ``leaf``, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(_BF16_BITS), \
                "bfloat16"
        a = leaf.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """A stored array as a tensor (a ``V2`` array as the bf16 it holds)."""
    if a.dtype == _BF16_BITS:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(key part, child)`` of a container in the reference's flattening
    order, each part spelled as its key path's string with ``[]'".``
    stripped; ``None`` for a leaf."""
    if isinstance(node, dict):
        keys = node if isinstance(node, collections.OrderedDict) \
            else sorted(node)
        return [(f"[{k!r}]".strip("[]'\"."), node[k]) for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}".strip("[]'\"."), getattr(node, f))
                for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]".strip("[]'\"."), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}".strip("[]'\"."), getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten_with_keys(tree) -> Dict[str, Any]:
    """``{key: leaf}`` in the reference's leaf order and key spelling."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out["/".join(path)] = node
            return
        for part, child in kids:
            walk(child, path + (part,))

    walk(tree, ())
    return out


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in flattening order."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return next(leaves)
    if isinstance(template, dict):
        keys = template if isinstance(template, collections.OrderedDict) \
            else sorted(template)
        new = {k: _unflatten(template[k], leaves) for k in keys}
        return type(template)((k, new[k]) for k in template)
    values = [_unflatten(child, leaves) for _, child in kids]
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*values)
    if isinstance(template, (list, tuple)):
        return type(template)(values)
    return dataclasses.replace(template, **{
        f.name: v for f, v in zip(dataclasses.fields(template), values)})


def save_checkpoint(directory: str, step: int, tree, *,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``directory`` (atomic);
    returns the checkpoint's directory."""
    stored = {k: _to_numpy(v) for k, v in _flatten_with_keys(tree).items()}
    arrays = {k: a for k, (a, _) in stored.items()}
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp.{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _PAYLOAD), **arrays)
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(a.shape), "dtype": dtype,
                     "crc32": _crc32(a)}
                 for k, (a, dtype) in stored.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(directory, name, _MANIFEST)):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _load_verified(path: str) -> Tuple[Dict[str, np.ndarray],
                                       Dict[str, Any]]:
    """Load and checksum-verify a checkpoint directory's payload."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    try:
        with np.load(os.path.join(path, _PAYLOAD)) as payload:
            arrays = {k: np.array(payload[k]) for k in payload.files}
    except (OSError, ValueError, KeyError, zlib.error,
            zipfile.BadZipFile) as e:
        raise CheckpointCorrupt(
            f"{path}: payload unreadable ({e})") from e
    for key, info in manifest["keys"].items():
        if key not in arrays:
            raise CheckpointCorrupt(
                f"{path}: manifest lists array {key!r} but the payload "
                f"does not contain it")
        want = info.get("crc32")
        if want is not None and _crc32(arrays[key]) != int(want):
            raise CheckpointCorrupt(
                f"{path}: array {key!r} failed its manifest crc32 — "
                f"payload is torn or corrupt")
    return arrays, manifest


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(leaf).dtype)).dtype


def restore_checkpoint(directory: str, step: int, template=None,
                       device=None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``template`` (shapes must match), as
    tensors of the template's dtypes, on ``device`` (default the CPU).

    ``template=None`` restores manifest-driven instead: the first return
    value is the flat ``{key: np.ndarray}`` dict of every stored array (how
    the durable surplus snapshots restore), or ``{key: tensor}`` on
    ``device`` when one is given.

    Every stored array is verified against its manifest crc32; a torn or
    corrupt payload raises ``CheckpointCorrupt``."""
    path = os.path.join(directory, f"step_{step:010d}")
    arrays, manifest = _load_verified(path)
    if template is None:
        if device is not None:
            arrays = {k: _to_tensor(a).to(device) for k, a in arrays.items()}
        return arrays, manifest["metadata"]
    leaves = []
    for key, tmpl_leaf in _flatten_with_keys(template).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        dtype = _torch_dtype(tmpl_leaf)
        arr = arrays[key]
        want = tuple(np.shape(tmpl_leaf))
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs template {want}")
        leaves.append(_to_tensor(arr).to(device=device or "cpu",
                                         dtype=dtype))
    return _unflatten(template, iter(leaves)), manifest["metadata"]
