"""The combination technique communication phase, as dict loops.

Port of ``repro.core.combination``.  In the hierarchical basis a
combination grid ``ell`` carries exactly the subspaces ``m <= ell``, so

  * ``gather_subspaces``  — the sparse-grid surplus on subspace ``m`` is
    the coefficient-weighted sum over all combination grids containing it;
  * ``scatter_subspaces`` — projecting it back onto a combination grid
    truncates to the subspaces ``m <= ell`` (plain copies);
  * ``combine_full``      — the embedded spelling: every grid's surpluses
    scattered into the common fine grid with one strided write and summed
    with their coefficients, the readable oracle the tests hold
    ``core.executor.ct_transform`` to.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch

from repro_torch.core.levels import (LevelVector, SchemeLike, fine_levels,
                                     grid_shape, subspace_slices,
                                     subspaces_of_grid)

__all__ = ["gather_subspaces", "scatter_subspaces", "embed_to_full",
           "extract_from_full", "combine_full", "combined_interpolant_points"]


def gather_subspaces(hier_grids: Mapping[LevelVector, torch.Tensor],
                     scheme: SchemeLike) -> Dict[LevelVector, torch.Tensor]:
    """Gather step: combined surplus per sparse-grid subspace."""
    combined: Dict[LevelVector, torch.Tensor] = {}
    coeffs = dict(scheme.grids)
    for ell, alpha in hier_grids.items():
        c = coeffs[ell]
        for m in subspaces_of_grid(ell):
            block = c * alpha[subspace_slices(m, ell)]
            combined[m] = combined[m] + block if m in combined else block
    return combined


def scatter_subspaces(combined: Mapping[LevelVector, torch.Tensor],
                      scheme: SchemeLike) -> Dict[LevelVector, torch.Tensor]:
    """Scatter step: project the sparse-grid surplus onto every grid.  The
    grids take the type and device of the combined blocks."""
    block = next(iter(combined.values()))
    out: Dict[LevelVector, torch.Tensor] = {}
    for ell, _ in scheme.grids:
        alpha = torch.zeros(grid_shape(ell), dtype=block.dtype,
                            device=block.device)
        for m in subspaces_of_grid(ell):
            alpha[subspace_slices(m, ell)] = combined[m]
        out[ell] = alpha
    return out


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


def extract_from_full(full: torch.Tensor, ell: Sequence[int],
                      full_levels: Sequence[int]) -> torch.Tensor:
    """Truncating projection: read back the nodes grid ``ell`` owns."""
    return full[_embed_slices(ell, full_levels)]


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
