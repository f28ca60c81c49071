"""The paper's own workload configs (sparse-grid combination technique).

Port of ``repro.configs.sparse_grid`` (the port's own copy: it imports
nothing of the reference).  Mirrors the experimental setups of the
paper's figures; sizes follow the paper's "levelsum 27 = 1 GB doubles"
rule (double precision, no boundary).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.core.levels import CombinationScheme

__all__ = ["CTConfig", "CT_CONFIGS", "get_ct_config",
           "CTAdaptiveConfig", "CT_ADAPTIVE_CONFIGS",
           "get_ct_adaptive_config"]


@dataclass(frozen=True)
class CTConfig:
    name: str
    dim: int
    level: int                     # sparse-grid level (CombinationScheme)
    figure: str                    # which paper figure it reproduces

    @property
    def scheme(self) -> CombinationScheme:
        return CombinationScheme(self.dim, self.level)

    def sizes(self) -> Tuple[int, int]:
        s = self.scheme
        return s.total_points(), s.sparse_points()


CT_CONFIGS = {
    # paper Fig. 4: single 1-D grids (layout study); level 27 ~ 1 GB
    "fig4_1d": CTConfig("fig4_1d", dim=1, level=20, figure="Fig. 4"),
    # paper Fig. 5/6: 2-D grids
    "fig6_2d": CTConfig("fig6_2d", dim=2, level=11, figure="Fig. 5/6"),
    # paper Fig. 7: 4-D
    "fig7_4d": CTConfig("fig7_4d", dim=4, level=6, figure="Fig. 7"),
    # paper Fig. 8: 10-D anisotropic (first dim refined)
    "fig8_10d": CTConfig("fig8_10d", dim=10, level=3, figure="Fig. 8"),
    # production-scale CT problem for the distributed dry-run: 3-D level 9,
    # fine grid 511^3 (~534 MB f32), 109 combination grids.  (A 6-D problem
    # must use the subspace-keyed exchange — embedding into the common fine
    # grid is exactly the curse of dimensionality the CT avoids; see
    # DESIGN.md Sect. 4.)
    "prod_3d": CTConfig("prod_3d", dim=3, level=9, figure="(dry-run)"),
}


def get_ct_config(name: str) -> CTConfig:
    return CT_CONFIGS[name]


@dataclass(frozen=True)
class CTAdaptiveConfig:
    """Dimension-adaptive refinement workload (``repro.core.adaptive``).

    ``baseline_level`` names the regular scheme the adaptive run must beat:
    the acceptance bar is the SAME max-norm interpolation error with >= 3x
    fewer combination-grid points on the anisotropic reference target
    (``make_anisotropic_target(dim, decay)``).
    """

    name: str
    dim: int
    decay: float = 4.0             # per-axis importance falls off decay**-i
    baseline_level: int = 4        # regular scheme to match on error
    max_points: int = 20_000       # adaptive solver budget (grid points)
    max_level: int = 8             # per-axis refinement cap
    eval_points: int = 2000        # error-probe batch
    eval_seed: int = 42


CT_ADAPTIVE_CONFIGS = {
    # the d=6 anisotropic acceptance case (4**-i importance decay)
    "aniso_6d": CTAdaptiveConfig("aniso_6d", dim=6),
    # quick smoke variant for CI: same target, lower baseline
    "aniso_6d_smoke": CTAdaptiveConfig("aniso_6d_smoke", dim=6,
                                       baseline_level=3, max_points=3000,
                                       max_level=6, eval_points=500),
    # strong anisotropy in low dim: frontier stays 2-D-ish
    "aniso_3d": CTAdaptiveConfig("aniso_3d", dim=3, decay=8.0,
                                 baseline_level=6, max_points=10_000),
}


def get_ct_adaptive_config(name: str) -> CTAdaptiveConfig:
    return CT_ADAPTIVE_CONFIGS[name]
