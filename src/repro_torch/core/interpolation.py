"""Interpolation on combination grids (CT query).

Port of ``repro.core.interpolation``:

* ``interpolate_nodal``        — d-multilinear interpolation of nodal values,
  zero Dirichlet boundary;
* ``interpolate_hierarchical`` — hat-basis tensor contraction of
  hierarchical surpluses (the query path);
* ``interpolate_hierarchical_batched`` — the same over an explicit leading
  batch axis of T surpluses with T point batches (the reference vmaps the
  unbatched eval).  The unbatched eval IS its T=1 case, so a T=1 row is
  bitwise the unbatched eval.

``interpolate_hierarchical(hierarchize(u), y) == interpolate_nodal(u, y)``
for every grid function u and point y in [0,1]^d.

The contractions are plain matrix products (the reference leaves them to
XLA, outside any Pallas kernel).  TF32 is switched off while they run
(and the caller's setting restored after), so a float32 query on the card
is computed in full float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.ref import _level_of_length, level_of_position

__all__ = ["interpolate_nodal", "interpolate_hierarchical",
           "interpolate_hierarchical_batched", "sample_function"]


def sample_function(fn, levels: Sequence[int], *, device=None,
                    dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Sample ``fn`` (vectorized over a meshgrid tuple of tensors) on the
    nodal grid of level vector ``levels``, on ``device``."""
    device = resolve_device(device)
    axes = [torch.arange(1, 1 << l, dtype=dtype, device=device) * (2.0 ** -l)
            for l in levels]
    return fn(*torch.meshgrid(*axes, indexing="ij"))


def interpolate_nodal(u: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of nodal grid values at ``points`` (B, d);
    the grid has no boundary points and the function is 0 on the boundary."""
    points = torch.atleast_2d(torch.as_tensor(points, device=u.device))
    b, d = points.shape
    if d != u.ndim:
        raise ValueError(f"points are {d}-dim, the grid is {u.ndim}-dim")
    up = torch.nn.functional.pad(u, [1, 1] * d)
    idxs, weights = [], []
    for ax in range(d):
        level = _level_of_length(u.shape[ax])
        h = 2.0 ** -level
        t = torch.clamp(points[:, ax] / h, 0.0, (1 << level) - 1e-9)
        i0 = torch.floor(t).to(torch.int64)
        idxs.append(i0)
        weights.append(t - i0)
    out = torch.zeros((b,), dtype=u.dtype, device=u.device)
    for corner in range(1 << d):
        w = torch.ones((b,), dtype=u.dtype, device=u.device)
        gather_idx = []
        for ax in range(d):
            bit = (corner >> ax) & 1
            gather_idx.append(idxs[ax] + bit)
            w = w * (weights[ax] if bit else 1.0 - weights[ax]).to(u.dtype)
        out = out + w * up[tuple(gather_idx)]
    return out


def _hat_basis_matrix(level: int, ys: torch.Tensor) -> torch.Tensor:
    """(..., N) matrix of phi_{lam,p}(y) for all N nodes of a level-l pole,
    for points ``ys`` of shape (...)."""
    n = (1 << level) - 1
    p = np.arange(1, n + 1)
    lam = np.array([level_of_position(int(pi), level) for pi in p])
    centers = torch.as_tensor(p * (2.0 ** -level), device=ys.device)
    inv_supp = torch.as_tensor(2.0 ** lam.astype(np.float64), device=ys.device)
    return torch.clamp_min(
        1.0 - torch.abs(ys[..., None] - centers) * inv_supp, 0.0)


def interpolate_hierarchical_batched(alpha: torch.Tensor,
                                     points: torch.Tensor) -> torch.Tensor:
    """Evaluate T hierarchical interpolants, each at its own batch of
    points: ``alpha`` (T, N1..Nd), ``points`` (T, B, d) -> (T, B).

    One axis is contracted at a time, as a batched matrix product; every
    point's value depends on that point alone."""
    t, b, d = points.shape
    if d != alpha.ndim - 1 or alpha.shape[0] != t:
        raise ValueError(f"alpha {tuple(alpha.shape)} does not match "
                         f"points {tuple(points.shape)}")
    acc = alpha.to(torch.promote_types(alpha.dtype, torch.float32))
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _contract_axes(
            acc, points, [_level_of_length(n) for n in alpha.shape[1:]])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32


def _contract_axes(acc: torch.Tensor, points: torch.Tensor,
                   levels: Sequence[int]) -> torch.Tensor:
    t, b, d = points.shape
    for ax, level in enumerate(levels):
        basis = _hat_basis_matrix(level, points[..., ax]).to(acc.dtype)
        if ax == 0:
            # (T, B, N1) @ (T, N1, rest) -> (T, B, N2..Nd)
            rest = acc.shape[2:]
            acc = torch.bmm(basis, acc.reshape(t, acc.shape[1], -1))
            acc = acc.reshape((t, b) + tuple(rest))
        else:
            # per point: (1, N_ax) @ (N_ax, rest) for every (t, b)
            rest = acc.shape[3:]
            n = acc.shape[2]
            acc = torch.bmm(basis.reshape(t * b, 1, n),
                            acc.reshape(t * b, n, -1))
            acc = acc.reshape((t, b) + tuple(rest))
    return acc


def interpolate_hierarchical(alpha: torch.Tensor,
                             points: torch.Tensor) -> torch.Tensor:
    """Evaluate the hierarchical interpolant sum_v alpha_v prod_i phi(y_i)
    of surpluses ``alpha`` (N1..Nd) at ``points`` (B, d) -> (B,)."""
    points = torch.atleast_2d(torch.as_tensor(points, device=alpha.device))
    return interpolate_hierarchical_batched(alpha[None], points[None])[0]

