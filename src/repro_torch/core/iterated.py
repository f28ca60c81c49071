"""The iterated combination technique (paper Fig. 2).

Port of ``repro.core.iterated``.  Per round: (1) t solver steps on every
combination grid (compute phase, embarrassingly parallel); (2) hierarchize
every grid; (3) gather the sparse grid solution; (4) scatter it back;
(5) dehierarchize.  Steps (2) and (5) are the paper's hierarchization
kernel, run through ``kernels.ops`` with the round's ``hier_method``;
steps (3) and (4) are the communication it preprocesses for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.core import combination as comb
from repro_torch.core.hierarchize import dehierarchize, hierarchize
from repro_torch.core.levels import CombinationScheme, LevelVector
from repro_torch.core.pde import heat_init, heat_run, stable_dt

__all__ = ["IteratedCombination", "run_iterated_heat"]


@dataclass
class IteratedCombination:
    scheme: CombinationScheme
    solver: Callable[[LevelVector, torch.Tensor, int], torch.Tensor]
    hier_method: str = "auto"
    grids: Dict[LevelVector, torch.Tensor] = field(default_factory=dict)

    def init(self, init_fn: Callable[[LevelVector], torch.Tensor]) -> None:
        self.grids = {ell: init_fn(ell) for ell, _ in self.scheme.grids}

    def compute_phase(self, t_steps: int) -> None:
        self.grids = {ell: self.solver(ell, u, t_steps)
                      for ell, u in self.grids.items()}

    def communication_phase(self) -> None:
        """hierarchize -> gather -> scatter -> dehierarchize."""
        hier = {ell: hierarchize(u, self.hier_method)
                for ell, u in self.grids.items()}
        combined = comb.gather_subspaces(hier, self.scheme)
        scattered = comb.scatter_subspaces(combined, self.scheme)
        self.grids = {ell: dehierarchize(a, self.hier_method)
                      for ell, a in scattered.items()}

    def round(self, t_steps: int) -> None:
        self.compute_phase(t_steps)
        self.communication_phase()

    def evaluate(self, points) -> torch.Tensor:
        """Evaluate the current combined solution at ``points`` (B, d)."""
        return comb.combined_interpolant_points(self.grids, self.scheme,
                                                points)


def run_iterated_heat(dim: int, level: int, *, nu: float = 0.05,
                      rounds: int = 3, t_steps: int = 8,
                      hier_method: str = "auto", device=None):
    """End-to-end run of the heat equation on ``CombinationScheme(dim,
    level)``, ``rounds`` rounds of ``t_steps`` solver steps each, on
    ``device`` (CUDA unless the CPU is asked for; raises without a card).

    Returns (the IteratedCombination, total_time): all grids share the
    global dt of the finest grid so the rounds advance synchronized
    physical time."""
    device = resolve_device(device)
    scheme = CombinationScheme(dim, level)
    dt = min(stable_dt(ell, nu) for ell, _ in scheme.grids)

    def solver(ell, u, steps):
        return heat_run(u, steps, nu=nu, dt=dt)

    it = IteratedCombination(scheme, solver, hier_method)
    it.init(lambda ell: heat_init(ell, device=device))
    for _ in range(rounds):
        it.round(t_steps)
    return it, rounds * t_steps * dt
