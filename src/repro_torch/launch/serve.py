"""Sparse-grid surrogate serving on the batched executor.

Port of ``repro.launch.serve.CTSurrogate``, single tenant: the reference
delegates to its multi-tenant ``CTEngine``; here the surrogate owns its
scheme, its plan and the served surplus.  ``refit`` (a refined scheme)
and ``drop_grid`` (fault recovery) swap all three through the executor's
incremental plan rebuilds.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.executor import (build_plan, ct_transform_with_plan,
                                       extend_plan)
from repro_torch.core.interpolation import interpolate_hierarchical
from repro_torch.runtime.fault_tolerance import recombine_after_fault

__all__ = ["CTSurrogate"]


class CTSurrogate:
    """Sparse-grid surrogate server: ingest once, answer point queries.

    A solver produces nodal values on every component grid; ``update``
    runs the CT transform (one batched pass over the plan) into the
    served surplus on the common fine grid, and ``query`` evaluates the
    hierarchical interpolant of that surplus at a batch of points in
    [0,1]^d.  ``merge`` opts the plan into bucket merging; ``fused``
    selects the gather's epilogue (default fused; same bits either way);
    ``device`` defaults to CUDA.
    """

    def __init__(self, scheme, nodal_grids, *, merge=None, fused=None,
                 device=None):
        self._device = resolve_device(device)
        self._scheme = scheme
        self._fused = fused
        self._plan = build_plan(scheme, merge=merge)
        self._surplus = None
        self.update(nodal_grids)

    @property
    def scheme(self):
        return self._scheme

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def surplus(self) -> torch.Tensor:
        """Sparse-grid surplus on the common fine grid (the served state)."""
        return self._surplus

    def update(self, nodal_grids) -> None:
        """Re-ingest new solver output for the same scheme.  The previous
        surplus is released before the new one is built, so the fine grid
        is held once."""
        self._surplus = None
        self._surplus = ct_transform_with_plan(
            nodal_grids, self._plan, fused=self._fused, device=self._device)

    def _commit(self, scheme, plan, nodal_grids) -> None:
        """Ingest ``nodal_grids`` under ``plan``, then swap in scheme, plan
        and surplus together.  A failing ingest (a grid missing from
        ``nodal_grids`` raises ``ValueError`` naming it) raises before any
        state changes; the old surplus is held until the new one exists."""
        surplus = ct_transform_with_plan(nodal_grids, plan, fused=self._fused,
                                         device=self._device)
        self._scheme, self._plan, self._surplus = scheme, plan, surplus

    def refit(self, scheme, nodal_grids) -> None:
        """Serve a (refined) scheme: the plan is rebuilt incrementally
        (``extend_plan``) and ``nodal_grids`` ingested under it."""
        self._commit(scheme, extend_plan(self._plan, scheme), nodal_grids)

    def drop_grid(self, failed, nodal_grids) -> None:
        """Fault recovery: recombine without grid(s) ``failed``
        (``recombine_after_fault``: coefficient-only when possible, else an
        ``extend_plan`` rebuild).  ``nodal_grids`` must hold FINITE data for
        the dropped grids (their coefficient is 0) and, when the reduction
        activates a previously coefficient-0 grid, that grid's data too.
        Later ``update`` calls recombine with the reduced coefficients."""
        scheme, plan, _ = recombine_after_fault(self._scheme, failed,
                                                plan=self._plan)
        self._commit(scheme, plan, nodal_grids)

    def query(self, points) -> np.ndarray:
        """points: (Q, d) in [0,1]^d -> combined-interpolant values (Q,)."""
        pts = np.asarray(points)
        if pts.ndim == 1:
            pts = pts[None, :]
        dim = self._plan.dim
        if pts.ndim != 2 or pts.shape[1] != dim:
            raise ValueError(f"query points must have shape (Q, {dim}) — "
                             f"the scheme is {dim}-dimensional — got "
                             f"{pts.shape}")
        if not np.issubdtype(pts.dtype, np.floating):
            raise TypeError(f"query points must be a floating dtype "
                            f"(coordinates in [0,1]^{dim}), got {pts.dtype}")
        out = interpolate_hierarchical(
            self._surplus, torch.from_numpy(pts).to(self._device))
        return out.cpu().numpy()
