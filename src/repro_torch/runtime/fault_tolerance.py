"""Fault tolerance: health policy and recombination after a lost grid.

Port of ``repro.runtime.fault_tolerance`` (the policy classes are plain
Python, copied; nothing here imports the reference):

* **NaN / loss-spike and straggler detection** — ``HealthMonitor`` judges
  each step from its scalar loss and wall time (EWMAs, armed after
  ``min_history`` steps).
* **Serving-host loss** — ``HostHealthTracker`` counts strikes per host
  over (heartbeat age, probe outcome) observations.
* **CT grid loss** — ``recombine_after_fault``: when a combination grid
  is lost, the fault-tolerant combination technique recombines WITHOUT
  it — the downward-closed index set shrinks, the inclusion-exclusion
  coefficients are recomputed, and the executor plan is updated
  coefficient-only when possible, by an incremental ``extend_plan``
  otherwise, instead of being rebuilt from scratch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["HealthConfig", "HealthMonitor", "StepVerdict",
           "HostHealthConfig", "HostHealthTracker",
           "recombine_after_fault"]


@dataclass(frozen=True)
class HealthConfig:
    loss_spike_factor: float = 3.0      # loss > factor * ewma -> bad step
    loss_ewma_decay: float = 0.9
    stall_factor: float = 5.0           # step_time > factor * ewma -> straggler
    time_ewma_decay: float = 0.8
    min_history: int = 5                # steps before policies arm


@dataclass
class StepVerdict:
    ok: bool
    reason: str = ""
    rollback: bool = False


@dataclass
class HealthMonitor:
    cfg: HealthConfig = field(default_factory=HealthConfig)
    loss_ewma: Optional[float] = None
    time_ewma: Optional[float] = None
    steps_seen: int = 0
    events: List[str] = field(default_factory=list)

    def observe(self, loss: float, step_time: float) -> StepVerdict:
        self.steps_seen += 1
        # --- NaN / inf: always fatal for the step ---
        if not math.isfinite(loss):
            self.events.append(f"step {self.steps_seen}: non-finite loss")
            return StepVerdict(ok=False, reason="non-finite loss", rollback=True)
        armed = self.steps_seen > self.cfg.min_history
        verdict = StepVerdict(ok=True)
        if armed and self.loss_ewma is not None and \
                loss > self.cfg.loss_spike_factor * self.loss_ewma:
            self.events.append(
                f"step {self.steps_seen}: loss spike {loss:.4f} "
                f"(ewma {self.loss_ewma:.4f})")
            verdict = StepVerdict(ok=False, reason="loss spike", rollback=True)
        if armed and self.time_ewma is not None and \
                step_time > self.cfg.stall_factor * self.time_ewma:
            self.events.append(
                f"step {self.steps_seen}: straggler step "
                f"{step_time:.3f}s (ewma {self.time_ewma:.3f}s)")
            if verdict.ok:
                verdict = StepVerdict(ok=True, reason="straggler observed")
        # update EWMAs with good observations only
        if verdict.ok or not verdict.rollback:
            d = self.cfg.loss_ewma_decay
            self.loss_ewma = loss if self.loss_ewma is None else \
                d * self.loss_ewma + (1 - d) * loss
            dt_ = self.cfg.time_ewma_decay
            self.time_ewma = step_time if self.time_ewma is None else \
                dt_ * self.time_ewma + (1 - dt_) * step_time
        return verdict


# ---------------------------------------------------------------------------
# Serving-host health (cluster failover policy)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HostHealthConfig:
    """Thresholds of the cluster health monitor (pure policy)."""

    #: heartbeat older than this marks the observation bad (the host's
    #: scheduler has not pumped — stalled dispatch or a dead thread)
    heartbeat_timeout_s: float = 2.0
    #: how long a probe query may take before the observation is bad
    probe_deadline_s: float = 0.5
    #: consecutive bad observations before the host is declared failed
    #: (>1 absorbs a single slow pump under CPU contention)
    max_strikes: int = 2


@dataclass
class HostHealthTracker:
    """Per-host strike accounting over (heartbeat age, probe outcome)
    observations.  ``observe`` returns ``True`` when the host crossed
    the failure threshold; a good observation resets its strikes.  An
    explicit ``killed=True`` observation fails immediately (the fault
    injector's kill seam — no reason to wait out strikes on a host that
    reported its own death)."""

    cfg: HostHealthConfig = field(default_factory=HostHealthConfig)
    strikes: Dict[str, int] = field(default_factory=dict)
    events: List[str] = field(default_factory=list)

    def observe(self, host_id: str, *,
                heartbeat_age_s: Optional[float] = None,
                probe_ok: Optional[bool] = None,
                killed: bool = False) -> bool:
        if killed:
            self.events.append(f"{host_id}: killed")
            self.strikes[host_id] = self.cfg.max_strikes
            return True
        bad = []
        if heartbeat_age_s is not None \
                and heartbeat_age_s > self.cfg.heartbeat_timeout_s:
            bad.append(f"heartbeat stale {heartbeat_age_s:.2f}s "
                       f"(> {self.cfg.heartbeat_timeout_s:.2f}s)")
        if probe_ok is False:
            bad.append(f"probe missed its "
                       f"{self.cfg.probe_deadline_s:.2f}s deadline")
        if not bad:
            self.strikes[host_id] = 0
            return False
        n = self.strikes.get(host_id, 0) + 1
        self.strikes[host_id] = n
        self.events.append(f"{host_id}: strike {n}/"
                           f"{self.cfg.max_strikes}: {'; '.join(bad)}")
        return n >= self.cfg.max_strikes

    def forget(self, host_id: str) -> None:
        """Drop a failed/removed host's accounting."""
        self.strikes.pop(host_id, None)


# ---------------------------------------------------------------------------
# Fault-tolerant combination technique (grid loss)
# ---------------------------------------------------------------------------

def recombine_after_fault(scheme, failed: Iterable[Tuple[int, ...]],
                          plan=None, *, spec=None):
    """Recombine the CT scheme without the failed grid(s).

    Returns ``(new_scheme, new_plan, coefficient_only)``:

    * ``new_scheme`` — a ``GeneralScheme`` over the reduced downward-closed
      index set (the failed vectors and everything dominating them
      removed; a ``CombinationScheme`` is generalized first).
    * ``new_plan``   — preferably ``update_plan_coefficients(plan, ...)``:
      every bucket and embed index map of the plan kept (by identity),
      the failed members weighted 0, so their stale data merely has to be
      finite.  When the reduced scheme activates a grid the plan never
      held (a coefficient-0 member of the index set), an incremental
      ``extend_plan`` on the SAME fine grid instead; the caller must then
      supply nodal data for the newly activated grids.
    * ``coefficient_only`` — which of the two paths was taken.

    ``plan`` defaults to ``build_plan(scheme, spec=spec)`` (a live plan
    wins over ``spec``); a merged plan stays merged on both paths.
    """
    from repro_torch.core.executor import (build_plan, extend_plan,
                                           update_plan_coefficients)
    from repro_torch.core.levels import CombinationScheme, GeneralScheme
    if isinstance(scheme, CombinationScheme):
        scheme = scheme.as_general()
    if not isinstance(scheme, GeneralScheme):
        raise TypeError(f"expected a scheme, got {type(scheme).__name__}")
    if plan is None:
        plan = build_plan(scheme, spec=spec)
    new_scheme = scheme.without_levels(failed)
    try:
        return new_scheme, update_plan_coefficients(plan, new_scheme), True
    except ValueError:
        new_plan = extend_plan(plan, new_scheme,
                               full_levels=plan.full_levels)
        return new_scheme, new_plan, False
