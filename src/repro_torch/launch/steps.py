"""Combination-technique step functions: the CT half of
``repro.launch.steps`` as plain functions (PyTorch runs eagerly, so
nothing is jitted)."""

from __future__ import annotations

from typing import Callable

from repro_torch import resolve_device

__all__ = ["make_ct_step", "make_ct_eval_step"]


def make_ct_step(scheme, *, merge=None, fused=None, device=None) -> Callable:
    """``{ell: nodal}`` -> sparse-grid surplus on the common fine grid,
    with the scheme's plan built once and bound."""
    from repro_torch.core.executor import build_plan, ct_transform_with_plan
    device = resolve_device(device)
    plan = build_plan(scheme, merge=merge)
    return lambda nodal_grids: ct_transform_with_plan(
        nodal_grids, plan, fused=fused, device=device)


def make_ct_eval_step(scheme, *, merge=None, fused=None,
                      device=None) -> Callable:
    """``({ell: nodal}, points (Q, d))`` -> combined-interpolant values
    (Q,): the transform followed by the hierarchical-basis evaluation."""
    from repro_torch.core.interpolation import interpolate_hierarchical
    transform = make_ct_step(scheme, merge=merge, fused=fused, device=device)
    return lambda nodal_grids, points: interpolate_hierarchical(
        transform(nodal_grids), points)
