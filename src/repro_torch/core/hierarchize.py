"""Core-level hierarchization façade: layout strategies of the paper.

Port of ``repro.core.hierarchize``.  Re-exports the per-grid entry points
of ``kernels.ops`` and adds the BFS (level-major) data layout of the paper
(Fig. 3 middle), in plain torch, so layouts can be compared.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ops import dehierarchize, hierarchize  # re-export  # noqa: F401

__all__ = [
    "hierarchize", "dehierarchize",
    "to_bfs", "from_bfs", "hierarchize_1d_bfs",
]


@functools.lru_cache(maxsize=64)
def _bfs_perms(level: int):
    perm = ref.bfs_permutation(level)          # bfs position -> nodal index
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)           # nodal index -> bfs position
    return perm, inv


def _take(x: torch.Tensor, idx: np.ndarray, axis: int) -> torch.Tensor:
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))


def to_bfs(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Reorder ``axis`` from nodal (row-major grid) to BFS (level-major)."""
    perm, _ = _bfs_perms(int(np.log2(x.shape[axis] + 1)))
    return _take(x, perm, axis)


def from_bfs(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    _, inv = _bfs_perms(int(np.log2(x.shape[axis] + 1)))
    return _take(x, inv, axis)


@functools.lru_cache(maxsize=64)
def _bfs_predecessors(level: int):
    """Predecessor indices/masks expressed in BFS coordinates."""
    li, ri, ml, mr = ref.predecessor_indices(level)
    perm, inv = _bfs_perms(level)
    # node at bfs position k is nodal index perm[k]; its predecessor nodal
    # indices are li/ri[perm[k]], living at bfs positions inv[...]
    return inv[li[perm]], inv[ri[perm]], ml[perm], mr[perm]


def hierarchize_1d_bfs(x_bfs: torch.Tensor, axis: int = -1,
                       reverse: bool = False) -> torch.Tensor:
    """Hierarchize data already stored in (reverse-)BFS layout.

    Level-by-level access is contiguous in this layout: level ``lam``
    occupies the range [2**(lam-1)-1, 2**lam-1).  ``reverse=True`` emulates
    the paper's Reverse-BFS (finest level first); here it only flips the
    ranges."""
    n = x_bfs.shape[axis]
    li, ri, ml, mr = _bfs_predecessors(int(np.log2(n + 1)))
    flip = np.arange(n)[::-1].copy()
    if reverse:
        x_bfs = _take(x_bfs, flip, axis)
        inv_flip = np.empty(n, dtype=np.int64)
        inv_flip[flip] = np.arange(n)
        li, ri = inv_flip[li][flip], inv_flip[ri][flip]
        ml, mr = ml[flip], mr[flip]
    x = torch.movedim(x_bfs, axis, -1)
    shape = (1,) * (x.ndim - 1) + (n,)
    mlt = torch.as_tensor(ml, dtype=x.dtype, device=x.device).reshape(shape)
    mrt = torch.as_tensor(mr, dtype=x.dtype, device=x.device).reshape(shape)
    out = x - 0.5 * (mlt * _take(x, li, -1) + mrt * _take(x, ri, -1))
    out = torch.movedim(out, -1, axis)
    if reverse:
        out = _take(out, flip, axis)
    return out
