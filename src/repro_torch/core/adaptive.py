"""Dimension-adaptive combination technique: surplus-driven refinement.

Port of ``repro.core.adaptive``.  ``AdaptiveDriver`` grows a
downward-closed index set (``repro_torch.core.levels.GeneralScheme``) one
admissible index at a time, Gerstner-Griebel style:

  1. **Gather** — the batched executor's gather phase
     (``ct_transform_with_plan``) over the current scheme, on the configured
     device: the sparse-grid surplus on the common fine grid.
  2. **Score**  — the surplus block of subspace ``W_m`` is read off the
     fine grid by a strided slice (``subspace_slices``); since hat
     functions of one subspace have disjoint supports, ``max |alpha|``
     over the block bounds the subspace's contribution to the interpolant.
  3. **Expand** — the frontier index with the largest indicator gets its
     admissible forward neighbours added, under a point/byte budget; only
     the newly activated grids are solved.

Every expansion updates the plan through ``extend_plan``: on an unchanged
fine grid, buckets whose members did not change are reused by object
identity; when the fine grid grew, the plan is rebuilt
(``full_rebuild=True``).  The surplus is copied to the host once per
expansion, and the frontier is scored there in numpy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.executor import (ExecutorPlan, MergeConfig, build_plan,
                                       ct_transform_with_plan, extend_plan)
from repro_torch.core.interpolation import interpolate_hierarchical
from repro_torch.core.levels import (GeneralScheme, LevelVector,
                                     forward_neighbors, is_admissible,
                                     num_points, subspace_slices)

__all__ = ["AdaptiveConfig", "RefineRecord", "AdaptiveResult",
           "AdaptiveDriver", "refine", "make_anisotropic_target",
           "nodal_sampler", "interpolation_error"]

#: A solver: level vector -> nodal values on that combination grid (a
#: numpy array or a tensor on any device).
Solver = Callable[[LevelVector], object]


@dataclass(frozen=True)
class AdaptiveConfig:
    """Budget and policy knobs of the refinement loop.  ``device`` is where
    the gather runs (default CUDA; ``"cpu"`` to run on the CPU)."""

    max_points: int = 100_000       # solver budget: total solved grid points
    max_bytes: Optional[int] = None  # same budget in bytes (dtype_bytes each)
    max_iterations: int = 200
    tol: float = 0.0                # stop when the best indicator <= tol
    max_level: Optional[int] = None  # per-axis refinement cap
    indicator: str = "max"          # 'max' | 'l1' | 'mean' over |surplus|
    dtype_bytes: int = 8
    device: Optional[object] = None
    #: bucket-merging cost model for the executor plan; extend_plan
    #: re-applies it on every expansion
    merge: Optional[MergeConfig] = None


@dataclass(frozen=True)
class RefineRecord:
    """One expansion step, for trajectories and rebuild accounting."""

    iteration: int
    refined: LevelVector             # frontier index that was expanded
    added: Tuple[LevelVector, ...]   # indices added to the set
    indicator: float                 # its error indicator at expansion time
    scheme_points: int               # total points of nonzero-coeff grids
    solved_points: int               # cumulative solver work (all grids)
    n_grids: int
    buckets: int
    buckets_reused: int              # reused by object identity
    full_rebuild: bool               # fine grid grew -> plan rebuilt


@dataclass
class AdaptiveResult:
    scheme: GeneralScheme
    plan: ExecutorPlan
    surplus: torch.Tensor            # on plan.fine_shape
    history: List[RefineRecord]
    stop_reason: str


class AdaptiveDriver:
    """Stateful dimension-adaptive refinement around the batched executor.

    ``solver(ell)`` produces the nodal values of combination grid ``ell``;
    results are kept on the configured device, so growing the index set only
    ever solves the newly activated grids.  ``step()`` performs one
    score-and-expand iteration; ``run()`` loops until budget, tolerance,
    iteration cap, or frontier exhaustion.
    """

    def __init__(self, solver: Solver, dim: Optional[int] = None,
                 initial: Optional[GeneralScheme] = None,
                 config: Optional[AdaptiveConfig] = None, *, spec=None):
        if initial is None:
            if dim is None:
                raise ValueError("pass dim or an initial GeneralScheme")
            initial = GeneralScheme.regular(dim, 1)   # {(1, ..., 1)}
        self.config = config or AdaptiveConfig()
        if spec is not None:
            # the spec is authoritative for the execution policy (merge,
            # fused); budgets and indicators stay AdaptiveConfig's, and a
            # conflicting config raises instead of being overwritten
            from repro_torch.core.executor import ensure_spec
            ensure_spec("AdaptiveDriver", spec)
            if spec.dtype is not None:
                raise ValueError(
                    "AdaptiveDriver: spec.dtype is not supported — the "
                    "driver scores surpluses in the solver's own dtype; "
                    "cast the solver output instead")
            have = self.config.merge
            if have is not None and have != spec.merge:
                raise ValueError(
                    f"AdaptiveDriver: config.merge={have!r} conflicts with "
                    f"spec.merge={spec.merge!r}; set the execution policy "
                    f"in ONE place (the spec)")
            self.config = dataclasses.replace(self.config, merge=spec.merge)
        self.spec = spec
        self.device = resolve_device(self.config.device)
        if spec is not None:
            spec.resolve_interpret(self.device)
        self.solver = solver
        self.scheme = initial
        self._nodal: Dict[LevelVector, torch.Tensor] = {}
        self.plan = build_plan(self.scheme, merge=self.config.merge)
        self.history: List[RefineRecord] = []
        self.stop_reason: Optional[str] = None
        self._solve_missing()
        self._retransform()

    # --- state ---

    @property
    def surplus(self) -> torch.Tensor:
        """Sparse-grid surplus on the plan's common fine grid."""
        return self._surplus

    @property
    def nodal_grids(self) -> Dict[LevelVector, torch.Tensor]:
        return dict(self._nodal)

    def solved_points(self) -> int:
        return sum(num_points(ell) for ell in self._nodal)

    def _solve_missing(self) -> None:
        for ell, _ in self.scheme.grids:
            if ell not in self._nodal:
                self._nodal[ell] = torch.as_tensor(self.solver(ell),
                                                   device=self.device)

    def _retransform(self) -> None:
        self._surplus = ct_transform_with_plan(self._nodal, self.plan,
                                               spec=self.spec,
                                               device=self.device)
        self._surplus_host = None        # host copy invalidated

    # --- scoring ---

    def _host_surplus(self) -> np.ndarray:
        # one device -> host copy per expansion; the frontier is then
        # scored in numpy, one strided slice and reduction per subspace
        if self._surplus_host is None:
            self._surplus_host = self._surplus.cpu().numpy()
        return self._surplus_host

    def indicator_of(self, m: LevelVector) -> float:
        """Surplus-based error indicator of subspace ``W_m``, read off the
        hierarchical coefficients the gather phase already produced."""
        block = np.abs(self._host_surplus()[
            subspace_slices(m, self.plan.full_levels)])
        kind = self.config.indicator
        if kind == "max":
            return float(block.max())
        if kind == "l1":
            return float(block.sum())
        if kind == "mean":
            return float(block.mean())
        raise ValueError(f"unknown indicator {kind!r}")

    def _addable(self, n: LevelVector, iset) -> bool:
        if n in iset:
            return False
        if self.config.max_level is not None and \
                max(n) > self.config.max_level:
            return False
        return is_admissible(n, iset)

    def frontier(self) -> Tuple[LevelVector, ...]:
        """Indices with at least one addable (admissible, uncapped) forward
        neighbour — the candidates for expansion."""
        iset = set(self.scheme.index_set)
        return tuple(m for m in self.scheme.index_set
                     if any(self._addable(n, iset)
                            for n in forward_neighbors(m)))

    # --- expansion ---

    def step(self) -> Optional[RefineRecord]:
        """One score-and-expand iteration; ``None`` once stopped (then
        ``stop_reason`` says why)."""
        if self.stop_reason is not None:
            return None
        cfg = self.config
        if len(self.history) >= cfg.max_iterations:
            self.stop_reason = "max_iterations"
            return None
        iset = set(self.scheme.index_set)
        scored = sorted(((self.indicator_of(m), m) for m in self.frontier()),
                        reverse=True)
        if not scored:
            self.stop_reason = "exhausted"
            return None
        eta, m = scored[0]
        if eta <= cfg.tol:
            self.stop_reason = "tol"
            return None
        added = tuple(n for n in forward_neighbors(m)
                      if self._addable(n, iset))
        new_scheme = self.scheme.with_levels(added)
        cost = sum(num_points(ell) for ell, _ in new_scheme.grids
                   if ell not in self._nodal)
        total = self.solved_points() + cost
        if total > cfg.max_points or (cfg.max_bytes is not None and
                                      total * cfg.dtype_bytes > cfg.max_bytes):
            self.stop_reason = "budget"
            return None

        old_plan = self.plan
        new_plan = extend_plan(old_plan, new_scheme)
        full_rebuild = new_plan.full_levels != old_plan.full_levels
        old_ids = {id(b) for b in old_plan.buckets}
        reused = sum(1 for b in new_plan.buckets if id(b) in old_ids)
        self.scheme, self.plan = new_scheme, new_plan
        self._solve_missing()
        self._retransform()
        rec = RefineRecord(
            iteration=len(self.history), refined=m, added=added,
            indicator=eta, scheme_points=self.scheme.total_points(),
            solved_points=self.solved_points(),
            n_grids=len(self.scheme.grids), buckets=len(new_plan.buckets),
            buckets_reused=reused, full_rebuild=full_rebuild)
        self.history.append(rec)
        return rec

    def run(self, stop_when: Optional[Callable[["AdaptiveDriver"], bool]]
            = None) -> AdaptiveResult:
        """Refine until a stop condition fires.  ``stop_when`` (checked
        after each step) lets callers stop on an external criterion, e.g.
        a validation error target."""
        while True:
            if stop_when is not None and stop_when(self):
                self.stop_reason = "stop_when"
                break
            if self.step() is None:
                break
        return AdaptiveResult(scheme=self.scheme, plan=self.plan,
                              surplus=self._surplus, history=self.history,
                              stop_reason=self.stop_reason or "stopped")


def refine(solver: Solver, dim: int,
           config: Optional[AdaptiveConfig] = None,
           initial: Optional[GeneralScheme] = None, *,
           spec=None) -> AdaptiveResult:
    """One-call dimension-adaptive refinement (see ``AdaptiveDriver``)."""
    return AdaptiveDriver(solver, dim=dim, initial=initial,
                          config=config, spec=spec).run()


# ---------------------------------------------------------------------------
# Reference workload + evaluation helpers
# ---------------------------------------------------------------------------

def make_anisotropic_target(dim: int, decay: float = 4.0):
    """Anisotropic target on [0,1]^d with per-axis importance
    ``decay**-i``: every factor vanishes on the boundary, blending a
    curved factor ``sin(pi x)`` (needs depth) into the level-1-exact tent
    ``1 - |2x - 1|`` (needs none), so axis i requires refinement depth
    falling off like ``decay**-i``.  Evaluates host-side (numpy ufuncs)."""
    ts = [decay ** -i for i in range(dim)]

    def f(*xs):
        out = 1.0
        for t, x in zip(ts, xs):
            x = np.asarray(x)
            out = out * ((1.0 - t) * (1.0 - np.abs(2.0 * x - 1.0))
                         + t * np.sin(np.pi * x))
        return out

    return f


def nodal_sampler(fn) -> Solver:
    """A ``Solver`` sampling the numpy function ``fn`` on each grid's
    meshgrid, on the host."""
    def solve(levels: LevelVector) -> np.ndarray:
        axes = [np.arange(1, 1 << l) * (2.0 ** -l) for l in levels]
        return np.asarray(fn(*np.meshgrid(*axes, indexing="ij")))
    return solve


def interpolation_error(surplus: torch.Tensor, fn, points,
                        chunk: int = 128) -> float:
    """Max-norm error of the hierarchical interpolant of ``surplus``
    against the numpy function ``fn`` at ``points`` (Q, d), evaluated on
    the surplus's device in chunks of ``chunk`` points (the hat-basis
    contraction holds a (chunk, prod(fine_shape[1:])) intermediate)."""
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    worst = 0.0
    for i in range(0, pts.shape[0], chunk):
        p = pts[i:i + chunk]
        approx = interpolate_hierarchical(
            surplus, torch.from_numpy(p).to(surplus.device)).cpu().numpy()
        exact = fn(*[p[:, j] for j in range(p.shape[1])])
        worst = max(worst, float(np.max(np.abs(approx - exact))))
    return worst
