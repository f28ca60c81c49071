"""Elastic scaling: mesh policy and re-spreading tenants after a change.

Port of ``repro.runtime.elastic``:

* ``plan_mesh`` is pure policy (no devices): the largest (pods, data,
  model) factorisation of a chip count with tensor parallelism kept
  inside a pod, copied from the reference.
* ``rebalance_cluster`` re-spreads a ``CTCluster``'s tenants onto its
  current consistent-hash ring after a membership change
  (``CTCluster.add_host``).
* ``rebalance_engine`` moves an engine's tenants onto another slab mesh
  (or off any mesh) through ``CTEngine.rebind``: plans re-shard
  incrementally and each served surplus carries over without a
  recompute, so a lost device costs one rebind per tenant.
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
    """Move engine tenants onto ``mesh`` (or OFF any mesh when ``None``)
    through ``CTEngine.rebind``: no surplus recompute, an incremental plan
    re-shard, the executable re-bound from the shared signature cache.

    ``member_axis`` names the second (member) axis of a 2-D (member x
    slab) mesh; it is cleared on the ``mesh=None`` path, so de-meshed
    tenants fall back to the single-device ingest.  ``names`` restricts
    the sweep (default: every tenant).  Returns ``{name: outcome}``, the
    per-tenant ``rebind`` outcome.  Safe with live submitters: each swap
    is atomic."""
    outcomes: Dict[str, str] = {}
    for name in (engine.names() if names is None else tuple(names)):
        if mesh is None:
            outcomes[name] = engine.rebind(name, mesh=None, n_slabs=None,
                                           member_axis=None)
        else:
            outcomes[name] = engine.rebind(name, mesh=mesh,
                                           axis_name=axis_name,
                                           member_axis=member_axis,
                                           n_slabs=None)
    return outcomes


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
