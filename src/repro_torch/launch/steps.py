"""Combination-technique step functions: the CT half of
``repro.launch.steps`` as plain functions (PyTorch runs eagerly, so
nothing is jitted).  ``spec=`` carries the execution policy; ``merge=`` and
``fused=`` are its deprecated spellings (they warn once)."""

from __future__ import annotations

from typing import Callable

from repro_torch import resolve_device

__all__ = ["make_ct_step", "make_ct_eval_step"]


def _bind(fn_name: str, scheme, spec, merge, fused, device) -> Callable:
    from repro_torch.core.executor import (build_plan, ct_transform_with_plan,
                                           resolve_spec)
    spec = resolve_spec(fn_name, spec, merge=merge, fused=fused)
    device = resolve_device(device)
    spec.resolve_interpret(device)
    plan = build_plan(scheme, spec=spec)
    return lambda nodal_grids: ct_transform_with_plan(
        nodal_grids, plan, spec=spec, device=device)


def make_ct_step(scheme, *, merge=None, fused=None, spec=None,
                 device=None) -> Callable:
    """``{ell: nodal}`` -> sparse-grid surplus on the common fine grid,
    with the scheme's plan built once and bound."""
    return _bind("make_ct_step", scheme, spec, merge, fused, device)


def make_ct_eval_step(scheme, *, merge=None, fused=None, spec=None,
                      device=None) -> Callable:
    """``({ell: nodal}, points (Q, d))`` -> combined-interpolant values
    (Q,): the transform followed by the hierarchical-basis evaluation."""
    from repro_torch.core.interpolation import interpolate_hierarchical
    transform = _bind("make_ct_eval_step", scheme, spec, merge, fused,
                      device)
    return lambda nodal_grids, points: interpolate_hierarchical(
        transform(nodal_grids), points)
