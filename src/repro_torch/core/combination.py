"""The combination technique's embedded gather as a dict loop — the
readable oracle the tests hold ``core.executor.ct_transform`` to.

Port of the embedded half of ``repro.core.combination``: every grid's
surpluses are scattered into the common fine grid with one strided write
and summed with their combination coefficients.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch

from repro_torch.core.levels import LevelVector, SchemeLike, fine_levels, \
    grid_shape

__all__ = ["embed_to_full", "combine_full", "combined_interpolant_points"]


def _embed_slices(ell: Sequence[int], full_levels: Sequence[int]):
    return tuple(slice((1 << (L - l)) - 1, None, 1 << (L - l))
                 for l, L in zip(ell, full_levels))


def embed_to_full(alpha: torch.Tensor, ell: Sequence[int],
                  full_levels: Sequence[int]) -> torch.Tensor:
    """Scatter grid-``ell`` surpluses into the level-``full_levels`` buffer:
    1-based node p of a level-l axis lands at fine node p * 2**(L-l)."""
    full = torch.zeros(grid_shape(full_levels), dtype=alpha.dtype,
                       device=alpha.device)
    full[_embed_slices(ell, full_levels)] = alpha
    return full


def combine_full(hier_grids: Mapping[LevelVector, torch.Tensor],
                 scheme: SchemeLike,
                 full_levels: Sequence[int] | None = None
                 ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """One-buffer gather: sum of coefficient-weighted embedded surpluses."""
    if full_levels is None:
        full_levels = fine_levels(scheme)
    acc = None
    for ell, c in scheme.grids:
        emb = c * embed_to_full(hier_grids[ell], ell, full_levels)
        acc = emb if acc is None else acc + emb
    return acc, tuple(full_levels)


def combined_interpolant_points(nodal_grids: Mapping[LevelVector,
                                                     torch.Tensor],
                                scheme: SchemeLike,
                                points: torch.Tensor) -> torch.Tensor:
    """Direct (no hierarchization) evaluation of the combination solution:
    the weighted sum of the grids' multilinear interpolants."""
    from repro_torch.core.interpolation import interpolate_nodal
    acc = 0.0
    for ell, c in scheme.grids:
        acc = acc + c * interpolate_nodal(nodal_grids[ell], points)
    return acc
