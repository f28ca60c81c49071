"""Device meshes and slab-sharded results of the single-controller port.

The counterpart of ``repro.compat.make_mesh`` and ``jax.sharding.Mesh`` as
the reference's CT code uses them.  The reference is single-controller:
one process drives every device through ``shard_map``.  So is the port:
a ``Mesh`` is a grid of ``torch.device``s with named axes, and each
collective of ``repro_torch.core.distributed`` is an explicit, ordered
copy or fold between per-device tensors.  A mesh may name one device more
than once (``make_mesh((4,), ("slab",), devices=["cpu"] * 4)``); the
shards then live on that device and the collectives are copies within it,
which is how the sharded paths run on the CPU and on a machine with one
card.  On a machine with several cards the same code copies between them.

``SlabSharded`` is the port's counterpart of the reference's
``NamedSharding``-placed array that a ``gather=False`` slab-sharded gather
returns: one tensor per slab, each on its mesh device, with ``concat`` to
put them together.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "mesh_axes", "SlabSharded"]


class Mesh:
    """A grid of devices with named axes.

    ``devices`` is an ndarray of ``torch.device`` (dtype object) whose
    shape is the mesh's; ``shape`` maps each axis name to its extent, in
    order; ``axis_names`` is the tuple of names.  Two meshes are equal,
    and hash alike, when their devices (in order) and axis names are: an
    ``ExecSpec`` holding a mesh sits in the executable cache's keys.  All
    devices are of one type (all CUDA, or all the CPU)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(str(a) for a in axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} dim(s) needs as many "
                             f"axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ, got {axis_names}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [torch.device(d) for d in devices.reshape(-1)]
        if len({d.type for d in flat}) > 1:
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{sorted({str(d) for d in flat})}")
        out = np.empty(len(flat), dtype=object)
        out[:] = flat
        self.devices = out.reshape(devices.shape)
        self.axis_names = axis_names
        self._key = (axis_names, devices.shape, tuple(str(d) for d in flat))

    @property
    def shape(self) -> dict:
        """Axis name -> extent, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def axis_devices(self, axis_name: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis_name``, every other axis at index 0."""
        ax = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            index[ax] = i
            out.append(self.devices[tuple(index)])
        return tuple(out)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}; {list(self._key[2])})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              devices=None) -> Mesh:
    """A mesh of ``shape`` with ``axis_names`` over ``devices`` (anything
    ``torch.device`` takes, in row-major order; repeats allowed).  Without
    ``devices``: the first ``prod(shape)`` CUDA devices, raising when the
    machine has fewer (there is no CPU fallback; pass CPU devices for
    that)."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(
                f"make_mesh{shape} needs {n} CUDA devices, the machine has "
                f"{count}; pass devices= (a device may be repeated, e.g. "
                f"devices=['cuda:0'] * {n}, or ['cpu'] * {n})")
        devices = [torch.device("cuda", i) for i in range(n)]
    flat = list(np.asarray(devices, dtype=object).reshape(-1))
    if len(flat) != n:
        raise ValueError(f"make_mesh{shape} needs {n} devices, got "
                         f"{len(flat)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in flat]
    return Mesh(grid.reshape(shape), axis_names)


def mesh_axes(mesh) -> dict:
    """A mesh's axis name -> extent map; an object without a ``shape``
    mapping (not a mesh) has no axes."""
    shape = getattr(mesh, "shape", None)
    return dict(shape) if isinstance(shape, Mapping) else {}


@dataclass(frozen=True)
class SlabSharded:
    """The slab-sharded result of a ``gather=False`` gather: slab ``s`` of
    the fine grid (``slab_rows`` leading rows, ``fine_shape[1:]`` after)
    as ``slabs[s]``, on that slab's mesh device.  Rows past
    ``fine_shape[0]`` (the ragged last slab's tail) are zero.  ``shape`` is
    the slab-padded shape ``(n_slabs * slab_rows, *fine_shape[1:])`` of the
    reference's sharded array; ``concat`` puts the slabs together."""

    slabs: Tuple[torch.Tensor, ...]
    fine_shape: Tuple[int, ...]

    @property
    def n_slabs(self) -> int:
        return len(self.slabs)

    @property
    def slab_rows(self) -> int:
        return int(self.slabs[0].shape[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.n_slabs * self.slab_rows,) + tuple(self.fine_shape[1:])

    def concat(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The slabs in order, one slab-padded tensor on ``device``
        (default: the first slab's)."""
        device = self.slabs[0].device if device is None else device
        return torch.cat([s.to(device) for s in self.slabs])

    def full(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The fine grid: ``concat`` without the padding rows."""
        return self.concat(device)[:self.fine_shape[0]]
