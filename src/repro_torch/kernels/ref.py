"""Reference oracles for 1-D hierarchization (numpy / torch).

Port of ``repro.kernels.ref``.  Independent formulations that
cross-validate each other and the batched kernels:

  1. ``hierarchize_1d_bruteforce`` / ``dehierarchize_1d_bruteforce`` —
     numpy, node by node, straight from the definition of the
     hierarchical surplus (and its inverse as the hat-basis evaluation
     matrix).
  2. ``hierarchize_1d_ref`` / ``dehierarchize_1d_ref`` — torch, the
     paper's Alg. 1 as an unrolled fine-to-coarse level loop of strided
     slices.
  3. ``predecessor_indices`` / ``operator_matrix`` — the linear-operator
     formulation: hier(x) = x - 0.5*(x[L] + x[R]) with static index/mask
     vectors, or equivalently a constant (N, N) matrix.

All operate on arrays whose ``axis`` has length ``2**level - 1`` (nodal
layout, no boundary points).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "level_of_position",
    "predecessor_positions",
    "predecessor_indices",
    "operator_matrix",
    "dehier_operator_matrix",
    "hierarchize_1d_bruteforce",
    "dehierarchize_1d_bruteforce",
    "hierarchize_1d_ref",
    "dehierarchize_1d_ref",
    "hierarchize_nd_ref",
    "dehierarchize_nd_ref",
    "hierarchize_1d_gather",
    "bfs_permutation",
]


# ---------------------------------------------------------------------------
# Position / level arithmetic (positions are 1-based: p = 1 .. 2**l - 1)
# ---------------------------------------------------------------------------

def level_of_position(p: int, level: int) -> int:
    """Hierarchical level of 1-based position ``p`` in a level-``level`` pole."""
    t = (p & -p).bit_length() - 1  # trailing zeros
    return level - t


def predecessor_positions(p: int, level: int) -> Tuple[int, int]:
    """1-based positions of the (left, right) hierarchical predecessors;
    0 / 2**level denote the (absent) boundary."""
    t = (p & -p).bit_length() - 1
    s = 1 << t
    return p - s, p + s


def predecessor_indices(level: int) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """Static gather indices and masks for the one-shot formulation.

    Returns (left_idx, right_idx, mask_left, mask_right), each of length
    N = 2**level - 1.  Indices are 0-based array indices (clipped to valid
    range where the mask is 0)."""
    n = (1 << level) - 1
    p = np.arange(1, n + 1)
    s = p & -p  # 2**(trailing zeros)
    left_p = p - s
    right_p = p + s
    mask_l = (left_p > 0).astype(np.float64)
    mask_r = (right_p < (1 << level)).astype(np.float64)
    left_idx = np.clip(left_p - 1, 0, n - 1)
    right_idx = np.clip(right_p - 1, 0, n - 1)
    return left_idx, right_idx, mask_l, mask_r


@functools.lru_cache(maxsize=64)
def operator_matrix(level: int) -> np.ndarray:
    """Dense (N, N) matrix H with hier(x) = H @ x (<= 3 nonzeros per row)."""
    n = (1 << level) - 1
    li, ri, ml, mr = predecessor_indices(level)
    h = np.eye(n)
    rows = np.arange(n)
    h[rows, li] -= 0.5 * ml
    h[rows, ri] -= 0.5 * mr
    return h


@functools.lru_cache(maxsize=64)
def dehier_operator_matrix(level: int) -> np.ndarray:
    """Dense (N, N) matrix E = H^{-1} with dehier(a) = E @ a.

    E[i, j] = phi_j(x_i), the hat function of node j evaluated at node i,
    built exactly from the basis functions (no floating-point inverse)."""
    n = (1 << level) - 1
    e = np.zeros((n, n))
    h_fine = 1.0 / (1 << level)
    xs = np.arange(1, n + 1) * h_fine
    for j in range(n):
        p = j + 1
        lam = level_of_position(p, level)
        hj = 2.0 ** (-lam)
        cj = p * h_fine
        e[:, j] = np.maximum(0.0, 1.0 - np.abs(xs - cj) / hj)
    return e


def bfs_permutation(level: int) -> np.ndarray:
    """Permutation mapping nodal order -> BFS (level-major) order.

    ``perm[k]`` is the nodal 0-based index of the k-th point in BFS order
    (root first, then level 2 left to right, ...).  Paper Fig. 3 middle."""
    out = []
    for lam in range(1, level + 1):
        s = 1 << (level - lam)
        out.extend(range(s - 1, (1 << level) - 1, 2 * s))
    return np.asarray(out, dtype=np.int64)


def _level_of_length(n: int) -> int:
    level = int(np.log2(n + 1))
    if (1 << level) - 1 != n:
        raise ValueError(f"axis length {n} is not of the form 2**l - 1")
    return level


# ---------------------------------------------------------------------------
# 1. Brute force (numpy)
# ---------------------------------------------------------------------------

def hierarchize_1d_bruteforce(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Node-by-node surplus computation from the definition (numpy)."""
    x = np.moveaxis(np.asarray(x, dtype=np.float64), axis, -1)
    level = _level_of_length(x.shape[-1])
    out = x.copy()
    for j in range(x.shape[-1]):
        lp, rp = predecessor_positions(j + 1, level)
        acc = x[..., j].copy()
        if lp > 0:
            acc = acc - 0.5 * x[..., lp - 1]
        if rp < (1 << level):
            acc = acc - 0.5 * x[..., rp - 1]
        out[..., j] = acc
    return np.moveaxis(out, -1, axis)


def dehierarchize_1d_bruteforce(a: np.ndarray, axis: int = -1) -> np.ndarray:
    """Evaluate the hierarchical interpolant at every node (numpy)."""
    a = np.moveaxis(np.asarray(a, dtype=np.float64), axis, -1)
    level = _level_of_length(a.shape[-1])
    out = a @ dehier_operator_matrix(level).T
    return np.moveaxis(out, -1, axis)


# ---------------------------------------------------------------------------
# 2. Alg. 1 level loop (torch)
# ---------------------------------------------------------------------------

def _odd_even_lr(x: torch.Tensor, s: int):
    """(odd nodes x[s-1::2s], their zero-padded left/right even neighbours)."""
    odd = x[..., s - 1::2 * s]
    even = x[..., 2 * s - 1::2 * s]
    zero = torch.zeros(even.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return odd, torch.cat([zero, even], -1), torch.cat([even, zero], -1)


def hierarchize_1d_ref(x: torch.Tensor, axis: int = -1, *,
                       reduced_op: bool = True) -> torch.Tensor:
    """Paper Alg. 1 along ``axis``: fine-to-coarse unrolled level loop.

    ``reduced_op=False`` issues the two-multiply update of the unreduced
    algorithm (kept for the paper's ablation)."""
    x = torch.movedim(torch.as_tensor(x), axis, -1).clone()
    level = _level_of_length(x.shape[-1])
    for lam in range(level, 1, -1):
        s = 1 << (level - lam)
        odd, left, right = _odd_even_lr(x, s)
        if reduced_op:
            upd = odd - 0.5 * (left + right)
        else:
            upd = odd - 0.5 * left - 0.5 * right
        x[..., s - 1::2 * s] = upd
    return torch.movedim(x, -1, axis)


def dehierarchize_1d_ref(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse transform: coarse-to-fine level loop (sequential in level)."""
    a = torch.movedim(torch.as_tensor(a), axis, -1).clone()
    level = _level_of_length(a.shape[-1])
    for lam in range(2, level + 1):
        s = 1 << (level - lam)
        odd, left, right = _odd_even_lr(a, s)
        a[..., s - 1::2 * s] = odd + 0.5 * (left + right)
    return torch.movedim(a, -1, axis)


def hierarchize_nd_ref(x: torch.Tensor, *,
                       reduced_op: bool = True) -> torch.Tensor:
    """Full d-dimensional hierarchization: one 1-D pass per axis."""
    for axis in range(x.ndim):
        x = hierarchize_1d_ref(x, axis, reduced_op=reduced_op)
    return x


def dehierarchize_nd_ref(a: torch.Tensor) -> torch.Tensor:
    """Full d-dimensional dehierarchization: one 1-D pass per axis."""
    for axis in range(a.ndim):
        a = dehierarchize_1d_ref(a, axis)
    return a


# ---------------------------------------------------------------------------
# 3. One-shot gather formulation (torch)
# ---------------------------------------------------------------------------

def hierarchize_1d_gather(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """hier(x) = x - 0.5*(maskL*x[L] + maskR*x[R]) — single fused pass."""
    n = x.shape[axis]
    li, ri, ml, mr = predecessor_indices(_level_of_length(n))
    shape = [1] * x.ndim
    shape[axis] = n
    ml = torch.as_tensor(ml, dtype=x.dtype, device=x.device).reshape(shape)
    mr = torch.as_tensor(mr, dtype=x.dtype, device=x.device).reshape(shape)
    xl = torch.index_select(x, axis, torch.as_tensor(li, device=x.device))
    xr = torch.index_select(x, axis, torch.as_tensor(ri, device=x.device))
    return x - 0.5 * (ml * xl + mr * xr)
