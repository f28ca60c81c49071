"""Standard solvers run on the combination grids (the "compute phase").

Port of ``repro.core.pde``.  The combination technique uses plain
regular-grid solvers as black boxes; this is an explicit heat-equation
stepper (zero Dirichlet boundary, matching the grids without boundary
nodes, whose functions vanish on the boundary) with a known exact
solution for validation:

    u_t = nu * Laplace(u),  u0 = prod_i sin(pi x_i)
    =>  u(x, t) = exp(-nu * d * pi^2 * t) * u0(x)

The reference computes it in jnp outside any kernel; here it is plain
torch on the grid's device, in the reference's order of operations.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.interpolation import sample_function

__all__ = ["heat_init", "heat_exact_factor", "heat_step", "heat_run",
           "stable_dt"]


def heat_init(levels: Sequence[int], *, device=None) -> torch.Tensor:
    """``prod_i sin(pi x_i)`` sampled on the grid of level vector
    ``levels`` (float64, on ``device``: CUDA unless the CPU is asked for)."""
    def f(*xs):
        out = 1.0
        for x in xs:
            out = out * torch.sin(math.pi * x)
        return out
    return sample_function(f, levels, device=device)


def heat_exact_factor(dim: int, nu: float, t: float) -> float:
    return math.exp(-nu * dim * math.pi ** 2 * t)


def stable_dt(levels: Sequence[int], nu: float, safety: float = 0.5) -> float:
    s = sum((2.0 ** (2 * l)) for l in levels)   # 1/h_i^2
    return safety / (2.0 * nu * s)


def heat_step(u: torch.Tensor, *, nu: float, dt: float) -> torch.Tensor:
    """One explicit Euler step of the d-dim heat equation:
    ``(up_hi - 2u + up_lo) * inv_h2`` summed over the axes, then
    ``u + (dt*nu) * lap``."""
    lap = torch.zeros_like(u)
    for ax in range(u.ndim):
        n = u.shape[ax]
        level = int(round(math.log2(n + 1)))
        inv_h2 = float(2.0 ** (2 * level))
        pad = [0, 0] * u.ndim
        pad[2 * (u.ndim - 1 - ax)] = pad[2 * (u.ndim - 1 - ax) + 1] = 1
        up = F.pad(u, pad)
        lap = lap + (up.narrow(ax, 2, n) - 2.0 * u + up.narrow(ax, 0, n)) \
            * inv_h2
    return u + dt * nu * lap


def heat_run(u: torch.Tensor, steps: int, *, nu: float,
             dt: float) -> torch.Tensor:
    for _ in range(steps):
        u = heat_step(u, nu=nu, dt=dt)
    return u
