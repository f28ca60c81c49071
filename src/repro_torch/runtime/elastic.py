"""Elastic scaling: mesh policy and re-spreading tenants after a change.

Port of ``repro.runtime.elastic``:

* ``plan_mesh`` is pure policy (no devices): the largest (pods, data,
  model) factorisation of a chip count with tensor parallelism kept
  inside a pod, copied from the reference.
* ``rebalance_cluster`` re-spreads a ``CTCluster``'s tenants onto its
  current consistent-hash ring after a membership change
  (``CTCluster.add_host``).
* ``rebalance_engine`` moves an engine's tenants onto another slab mesh
  through ``CTEngine.rebind``; it needs multi-GPU sharding and raises
  naming ROADMAP A9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["MeshPlan", "plan_mesh", "rebalance_cluster", "rebalance_engine"]


@dataclass(frozen=True)
class MeshPlan:
    pods: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model

    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")

    def shape(self) -> Tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.pods > 1 \
            else (self.data, self.model)


def plan_mesh(num_chips: int, *, chips_per_pod: int = 256,
              preferred_model: int = 16,
              min_model: int = 1) -> Optional[MeshPlan]:
    """Largest usable mesh for ``num_chips`` with TP <= intra-pod size.

    Policy: keep model parallelism at ``preferred_model`` when divisible
    (TP wants the all-reduce-heavy axis inside a pod), shrink it
    otherwise; whole pods first, remainder chips are dropped (a 511-chip
    slice runs as 1 pod + the biggest power-of-two fraction of the next).
    """
    if num_chips <= 0:
        return None
    pods = max(1, num_chips // chips_per_pod)
    if num_chips >= chips_per_pod:
        per_pod = chips_per_pod
    else:
        # single partial pod: biggest power of two that fits
        per_pod = 1
        while per_pod * 2 <= num_chips:
            per_pod *= 2
        pods = 1
    model = preferred_model
    while model > min_model and per_pod % model:
        model //= 2
    data = per_pod // model
    return MeshPlan(pods=pods, data=data, model=model)


def rebalance_engine(engine, mesh=None, *, axis_name: str = "slab",
                     member_axis: Optional[str] = None,
                     names=None) -> Dict[str, str]:
    """Move engine tenants onto ``mesh`` through ``CTEngine.rebind``.  Not
    ported: meshes and ``rebind`` need multi-GPU sharding (ROADMAP A9)."""
    from repro_torch.core.engine import _not_ported
    raise _not_ported("rebalance_engine", "A9",
                      "moving tenants onto a slab mesh needs CTEngine.rebind")


def rebalance_cluster(cluster, *, names=None) -> Dict[str, str]:
    """Re-spread a ``CTCluster``'s tenants onto the CURRENT consistent-
    hash ring, after a membership change (``add_host``, or a manual ring
    rebuild).

    Tenants whose ring owners are unchanged are untouched (``"kept"``:
    joining one of N hosts relocates about 1/N of the tenants); moved
    tenants' new owners ADOPT the live primary's plan and surplus
    (``CTEngine.register(plan=, surplus=)``: no re-ingest, the same
    signature-shared executable), then stale ex-owners are unregistered.
    Returns ``{name: "kept" | "moved"}``.  Safe with live submitters: each
    tenant moves atomically under the cluster lock, and routing always
    reads the record's current owner list.
    """
    outcomes: Dict[str, str] = {}
    for name in (cluster.names() if names is None else tuple(names)):
        outcomes[name] = cluster.reconcile(name)
    return outcomes
