"""CTCluster: a multi-host serving front end over N ``CTEngine`` hosts.

Port of ``repro.runtime.cluster``.  The hosts are in-process
``repro_torch.core.engine.CTEngine``s on one device: ``device=`` (default
CUDA; ``"cpu"`` where the caller asks) is passed to every host engine, so
on one card every host's tenants, surpluses and ingests share the card,
its CUDA context and the process-global ingest executables.  Harding et al.
(PAPERS.md) run the combination technique manager/worker style and recover
LOST component grids by recombination instead of recompute; this module is
that architecture as a serving tier: one engine per host, a consistent-
hash ring placing tenants on hosts, and a health monitor whose failover
path is recombination, never a recompute of lost solves.

Placement -> health -> failover
-------------------------------

**Placement.**  Tenants are placed by consistent hashing (``HashRing``):
every host projects ``vnodes`` virtual nodes onto a 64-bit ring under a
deterministic seed (``blake2b``, never Python's per-process ``hash``), and
a tenant's owner list is the first ``replication`` DISTINCT hosts
clockwise from its own ring point: the reference's owner tuples exactly,
for the same hosts, ``vnodes`` and ``seed``.  A restarted cluster computes
the SAME tenant map, and removing one of N hosts relocates only the
tenants whose owner walk crossed it.  Index 0 of the owner list is the
PRIMARY (serves queries); all owners ingest (replicas are warm standbys).

**Health.**  ``check_health`` (the ``start()``-ed monitor thread, or a
manual call) combines, per host, the engine's pump-liveness heartbeat
(``CTEngine.heartbeat``: age of the last scheduler pass) and a
deadline-bounded probe query against the host's private ``__probe__``
tenant, waited on with ``CTFuture.wait`` (which never drives the engine
from the prober's thread, so a dead scheduler cannot pass by accident).
Strike accounting is ``repro_torch.runtime.fault_tolerance.
HostHealthTracker``; a host that reports itself killed (the fault
injector's seam) fails at once.

**Failover.**  ``fail_host`` removes the host from the ring and migrates
every tenant it owned to the tenant's new owners:

* **replica exists**: the new owners ADOPT the replica's plan and live
  surplus through ``CTEngine.register(plan=, surplus=, tag=)``: no
  re-ingest, and the same signature-shared executable.
* **no replica**: the tenant is re-registered from the cluster's RETAINED
  state, the last-acked nodal grids (host numpy copies, so a resubmission
  never reads a donated or released device tensor) and the retained
  plan.  Ingests IN FLIGHT on the dead host are dropped from the scheme
  by the coefficient-only ``recombine_after_fault`` (plan and signature
  unchanged); only when the loss covers the whole index set does the
  tenant serve its last-acked state unreduced.
* **durable victim**: the victim's journaled in-flight ingests are read
  back from its WAL (``DurableStore.pending_after``), replayed onto the
  new owners, and their futures retarget at the replayed submissions.

In-flight requests routed at the dead host are never silently dropped:
queries are RESUBMITTED to the new primary, replicated ingests re-point at
a surviving replica's acknowledgement, and unreplicated in-flight ingests
with nothing to replay resolve with the named ``HostFailed``.

Lock order (for the port's lock checker, ROADMAP A10)
-----------------------------------------------------

* One cluster ``RLock`` (``CTCluster._lock``) guards the host table, the
  ring, the tenant records and the in-flight set.  Each ``ClusterFuture``
  has a leaf ``Lock`` (``_flock``) under it.  The classes, their ranks
  and the rules are machine-checked: the registry is
  ``repro_torch.analysis.invariants``, enforced by the static pass
  (``python -m repro_torch.analysis``) and the runtime sanitizer
  (``REPRO_TORCH_LOCKDEP=1``).
* The order is strictly ``cluster -> future`` and ``cluster -> engine``:
  the cluster calls into engines while holding its lock (registration,
  routing, failover), and an engine NEVER calls into the cluster, so the
  two cannot deadlock.  Nothing is called while ``_flock`` is held.
* Every engine submit made under the cluster lock is NON-BLOCKING
  (``block=False``).  ``EngineSaturated`` from a host whose scheduler is
  dead triggers failover and a re-route; from a live host it propagates to
  the caller as backpressure.
* ``ClusterFuture`` waits hold no lock; they poll the inner engine future
  and take the cluster lock only to finalize.
* The control-plane barriers that run engine work under the cluster lock
  on purpose are ``lockdep.allowed_dispatch`` sections and carry the
  reference's ``# ctlint: ok(...)`` reasons.  Engine teardown
  (``unregister``), the probe warm-up of ``add_host``, the restore and the
  WAL replay of ``restart_host`` run outside the lock.
* The WAL's device-to-host copies run on the engines' submitters' threads
  under the engine lock, never under the cluster lock: the cluster hands
  engines host numpy payloads.

Durability and recovery: restartable hosts
------------------------------------------

With ``durability_dir=`` every host carries a ``repro_torch.runtime.
durability.DurableStore``.  ``restart_host`` builds a fresh engine over
the SAME store in three phases: (1) **restore** each tenant's newest
intact snapshot with ``replay=False``, outside the lock; (2) **rejoin**
the ring under the same seeded vnodes, so placement returns EXACTLY to
the pre-failure map; a tenant whose store state is at least the
cluster's committed seq serves from the store (``"restored"``), one that
advanced on survivors during the outage adopts back from a live donor
(``"adopted"``); (3) **replay** the WAL entries newer than the snapshot
through the normal ingest executable, outside the lock, so the surplus is
bitwise that of a host that never crashed.  While a primary is
mid-replay its queries serve the snapshot state with
``ClusterFuture.stale_seq`` set.  All cluster-side retry loops share one
``repro_torch.runtime.durability.RetryPolicy``.

Meshes are host properties: ``over_device_slices`` builds hosts whose
engines mesh disjoint slices of a device list (1-D slab meshes, or 2-D
member x slab meshes with ``members > 1``), and placement gives each
tenant its owner host's mesh (``_host_exec_spec``); tenant specs stay
mesh-free.  A device list may repeat a device, so a fleet of meshed
hosts runs on one card or on the CPU.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.analysis import lockdep as _lockdep
from repro_torch.core.engine import (CTEngine, CTFuture, EngineSaturated,
                                     ExecSpec)
from repro_torch.core.levels import CombinationScheme, SchemeLike, grid_shape
from repro_torch.runtime.durability import (DurableStore, RetryPolicy,
                                            WALCorrupt, WALEntry)
from repro_torch.runtime.fault_tolerance import (HostHealthConfig,
                                                 HostHealthTracker,
                                                 recombine_after_fault)

__all__ = ["CTCluster", "ClusterFuture", "FaultInjector", "FaultEvent",
           "FaultSchedule", "HashRing", "HostFailed", "PROBE_TENANT"]

#: per-host liveness tenant (registered directly on each engine, never
#: placed on the ring); its probe query is the health monitor's signal
PROBE_TENANT = "__probe__"

#: how long the synchronous conveniences (``query``/``update``) and the
#: failover drain wait before declaring a future hung
_SYNC_TIMEOUT_S = 120.0


class HostFailed(RuntimeError):
    """Named failover error: the request was in flight on a host that
    failed, and no replica could transparently absorb it.  Carries the
    failed ``host_id`` — the actionable line in cluster logs."""

    def __init__(self, message: str, host_id: Optional[str] = None):
        super().__init__(message)
        self.host_id = host_id


def _json_safe(obj: Any) -> Any:
    """Recursively coerce a stats tree to plain JSON types: numpy
    scalars -> Python scalars, ndarrays -> lists, tuples/sets -> lists,
    non-string keys -> strings, anything else -> ``repr``.  The
    contract ``json.dumps(cluster.stats())`` never raises is what lets
    the benchmarks and the chaos CI job upload stats verbatim."""
    if isinstance(obj, dict):
        return {(k if isinstance(k, str) else str(k)): _json_safe(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


def _host_copy(v) -> np.ndarray:
    """A grid as the host array the cluster retains and routes: numpy input
    as is (``np.asarray``, as the reference), a tensor copied to the host,
    so the caller's tensor is never handed to an engine (nor donated)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy()
    return np.asarray(v)


def _stable_hash(s: str) -> int:
    """64-bit ring position, stable across processes and restarts
    (Python's ``hash`` is salted per process and would reshuffle the
    whole tenant map on every restart)."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes and a deterministic seed.

    ``owners(key, r)`` returns the first ``r`` DISTINCT hosts clockwise
    from the key's ring position — the replica placement rule.  Two
    rings built from the same (hosts, vnodes, seed) agree exactly;
    removing a host only reassigns keys whose owner walk crossed its
    virtual nodes."""

    def __init__(self, hosts: Sequence[str], *, vnodes: int = 64,
                 seed: int = 0):
        if not hosts:
            raise ValueError("HashRing needs at least one host")
        self.hosts = tuple(hosts)
        self.vnodes = vnodes
        self.seed = seed
        ring = sorted((_stable_hash(f"{seed}/{h}/{v}"), h)
                      for h in hosts for v in range(vnodes))
        self._keys = [k for k, _ in ring]
        self._vals = [h for _, h in ring]

    def owners(self, key: str, r: int = 1) -> Tuple[str, ...]:
        r = min(max(1, r), len(self.hosts))
        pos = bisect.bisect_right(self._keys, _stable_hash(
            f"{self.seed}/{key}"))
        out: List[str] = []
        n = len(self._vals)
        for i in range(n):
            h = self._vals[(pos + i) % n]
            if h not in out:
                out.append(h)
                if len(out) == r:
                    break
        return tuple(out)


@dataclass
class _Host:
    host_id: str
    engine: CTEngine
    spec: ExecSpec                     # host-level execution policy
    alive: bool = True                 # False once fail_host processed it
    killed: bool = False               # fault injector: reported dead
    stalled: bool = False              # fault injector: dispatch wedged
    fail_reason: str = ""
    #: the host's durable tenant store — SURVIVES the engine: a restart
    #: builds a fresh engine over the same store and restores from it
    store: Optional[DurableStore] = None


@dataclass
class _TenantRecord:
    """The cluster's retained source of truth for one tenant: what a
    migration rebuilds from when every serving copy is gone."""

    name: str
    scheme: SchemeLike
    spec: ExecSpec                     # tenant execution prefs
    replication: int
    owners: Tuple[str, ...]
    #: last-ACKED nodal grids (host numpy copies — donation-safe, and a
    #: dead host cannot take them down)
    grids: Dict[Tuple[int, ...], np.ndarray]
    plan: Any = None                   # representative executor plan
    plan_spec: Optional[ExecSpec] = None   # host spec the plan was built under
    deadline_ms: Optional[float] = None
    priority: int = 0
    dropped: Tuple[Tuple[int, ...], ...] = ()   # grids lost to failovers
    ingest_seq: int = 0                # cluster-side submission counter
    committed_seq: int = 0             # newest ack folded into ``grids``
    #: restart-in-progress: the primary serves its restored-snapshot
    #: state while the WAL replay catches up; queries get stale_seq
    recovering: bool = False
    stale_seq: Optional[int] = None    # committed seq of the served state


class ClusterFuture:
    """Result handle of a routed request.  Wraps the owner engine's
    ``CTFuture`` and stays valid ACROSS failover: when the owner dies,
    the cluster retargets this handle at the new owner (queries are
    resubmitted, replicated ingests re-point at a surviving replica's
    acknowledgement) or resolves it with the named ``HostFailed`` —
    never a silent drop, never a hang past the failover."""

    def __init__(self, cluster: "CTCluster", kind: str, name: str,
                 host_id: str, inner: CTFuture, *,
                 levels: Tuple[Tuple[int, ...], ...] = (),
                 updates: Optional[Dict] = None,
                 updates_new: Optional[Dict] = None,
                 points=None, query_kwargs: Optional[Dict] = None,
                 seq: int = 0):
        self._cluster = cluster
        self.kind = kind                    # "ingest" | "query"
        self.name = name
        self._host_id = host_id
        self._inner = inner
        self._secondaries: List[Tuple[str, CTFuture]] = []
        self.levels = levels                # ingest: NEW level vectors carried
        self._updates = updates             # ingest: full projected payload
        self._updates_new = updates_new     # ingest: this request's delta
        self._points = points               # query: validated points
        self._query_kwargs = query_kwargs or {}
        self._seq = seq
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None
        self.retargeted = 0
        #: queries against a tenant mid-recovery: the cluster committed
        #: seq of the (older) state this answer reflects; None = fresh
        self.stale_seq: Optional[int] = None
        self.submitted_at = time.monotonic()
        self.done_at: Optional[float] = None
        #: per-future leaf lock making retarget-vs-resolve ATOMIC.
        #: ``done_at``/``retargeted``/``_inner`` are written from the
        #: monitor thread (failover retarget) and from whichever waiter
        #: thread polls the inner future first; without this lock a
        #: future retargeted while resolving could double-resolve or
        #: stamp ``done_at`` from the WRONG inner.  Lock order is
        #: strictly ``cluster -> future`` and nothing is called while
        #: holding it, so it cannot deadlock.
        self._flock = _lockdep.make_lock("future")

    # -- state transitions (cluster lock held by callers in CTCluster; the
    #    per-future lock serializes them against each other regardless) ----

    def _finalize_locked(self, value=None,
                         error: Optional[BaseException] = None) -> None:
        with self._flock:
            if self._done:
                return
            self._value, self._error = value, error
            # resolution time = when the ENGINE resolved the inner
            # future (the wrapper may be polled much later); failover-
            # resolved wrappers (named error, no inner resolution)
            # stamp now.  Stamped BEFORE ``_done`` flips so no reader
            # can observe a done future without its ``done_at``.
            inner_t = getattr(self._inner, "done_at", None)
            self.done_at = inner_t if inner_t is not None else \
                time.monotonic()
            self._done = True

    def _retarget_locked(self, host_id: str, inner: CTFuture) -> bool:
        """Re-point this handle at a new owner; a no-op returning False
        when the future already resolved (retarget-after-done must not
        clobber ``_inner``/``done_at`` or count as a retarget)."""
        with self._flock:
            if self._done:
                return False
            self._host_id = host_id
            self._inner = inner
            self.retargeted += 1
            return True

    # -- waiting (no cluster lock held while blocked) ---------------------

    def done(self) -> bool:
        self._cluster._poll(self)
        return self._done

    def error(self) -> Optional[BaseException]:
        """Peek at a resolved request's failure (None while pending or
        on success)."""
        self._cluster._poll(self)
        return self._error

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._cluster._poll(self)
            if self._done:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self._cluster._progress(self)
            with self._flock:      # snapshot: retarget may swap _inner
                inner = self._inner
            inner.wait(0.02)

    def result(self, timeout: Optional[float] = None):
        if not self.wait(timeout):
            raise TimeoutError(
                f"ClusterFuture.result: {self.kind} for tenant "
                f"{self.name!r} still pending after {timeout:.3f}s "
                f"(host {self._host_id!r})")
        if self._error is not None:
            raise self._error
        return self._value


class FaultInjector:
    """Deterministic failure seams for tests and benchmarks.

    * ``kill(host)`` — the host drops dead: its scheduler stops, it
      reports ``killed`` to the next health check, queued work on it
      goes unanswered until failover resolves/retries it.
    * ``stall(host)`` — dispatch wedges WITHOUT an admission of death:
      the scheduler stops pumping, so the failure is only visible as a
      growing heartbeat age + missed probe deadlines (the slow-failure
      detection path).
    * ``poison_next_ingest(tenant=)`` — the next routed ingest carries
      NaN-poisoned data (a device/data fault): with the cluster's
      ``check_finite`` engines it must resolve ONLY its own future with
      ``FloatingPointError`` and leave host and siblings healthy.
    * ``crash_next_snapshot(host)`` — the host's next durable snapshot
      dies mid-write, AFTER the payload but BEFORE the atomic rename:
      the previous snapshot must stay intact and restorable.
    * ``tear_next_wal(host)`` — the host's next WAL append writes a
      torn record (header + half the payload) and raises: the
      submission must FAIL (nothing was admitted), and a later restore
      must tolerate the torn tail.
    """

    def __init__(self, cluster: "CTCluster"):
        self._cluster = cluster
        self._poison: Optional[str] = None     # tenant name or "*"

    def kill(self, host_id: str) -> None:
        c = self._cluster
        with c._lock:
            host = c._hosts[host_id]
            host.killed = True
        host.engine.stop(drain=False)

    def stall(self, host_id: str) -> None:
        c = self._cluster
        with c._lock:
            host = c._hosts[host_id]
            host.stalled = True
        host.engine.stop(drain=False)

    def poison_next_ingest(self, tenant: Optional[str] = None) -> None:
        with self._cluster._lock:
            self._poison = tenant if tenant is not None else "*"

    def crash_next_snapshot(self, host_id: str) -> None:
        with self._cluster._lock:
            store = self._cluster._hosts[host_id].store
        if store is None:
            raise ValueError(f"host {host_id!r} has no durable store")
        store.fail_next_snapshot()

    def tear_next_wal(self, host_id: str) -> None:
        with self._cluster._lock:
            store = self._cluster._hosts[host_id].store
        if store is None:
            raise ValueError(f"host {host_id!r} has no durable store")
        store.tear_next_append()

    def _maybe_poison(self, name: str, grids: Dict) -> Dict:
        """Caller holds the cluster lock."""
        if self._poison is None or self._poison not in ("*", name):
            return grids
        self._poison = None
        poisoned = dict(grids)
        ell = next(iter(poisoned))
        bad = np.array(poisoned[ell], dtype=float, copy=True)
        bad.flat[0] = np.nan
        poisoned[ell] = bad
        return poisoned


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` fires at ``at_s`` (seconds from the
    schedule's start) against ``target`` — a host id for host faults, a
    tenant name for ``poison`` (empty string = any tenant)."""

    at_s: float
    kind: str       # kill | restart | stall | poison | crash_snapshot | tear_wal
    target: str


class FaultSchedule:
    """Seeded, deterministic fault timeline for the ``chaos`` test tier.

    ``seeded`` grows a schedule from an explicit ``np.random.
    default_rng(seed)`` — same seed, same faults, same order, so a chaos
    failure reproduces from its seed alone.  Structural invariants the
    generator maintains: every ``kill`` is paired with a ``restart`` of
    the same host ``restart_delay_s`` later, and at most ONE host is
    down at a time (a kill drawn inside another kill's outage window is
    downgraded to a ``poison``), so the schedule never asks an R=1
    cluster to survive simultaneous failures it was not sized for.

    A chaos loop polls ``due(elapsed_s)`` and feeds each event to
    ``apply(cluster, event)``, which dispatches to the cluster's
    ``FaultInjector`` / ``restart_host`` with guards: an event that no
    longer applies (host already dead, no durable store) is recorded in
    ``skipped`` rather than raised — chaos runs must keep going."""

    #: kinds ``seeded`` draws from by default (``stall`` is excluded:
    #: it has no paired recovery and would eat the rest of the run)
    KINDS = ("kill", "poison", "crash_snapshot", "tear_wal")

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: e.at_s))
        self._idx = 0
        self.applied: List[FaultEvent] = []
        self.skipped: List[Tuple[FaultEvent, str]] = []

    @classmethod
    def seeded(cls, seed: int, *, hosts: Sequence[str],
               tenants: Sequence[str], duration_s: float,
               n_events: int = 6, restart_delay_s: float = 0.75,
               kinds: Optional[Sequence[str]] = None) -> "FaultSchedule":
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds) if kinds is not None else cls.KINDS
        hosts, tenants = list(hosts), list(tenants)
        events: List[FaultEvent] = []
        busy_until = 0.0
        # leave the tail of the run fault-free so every recovery (and
        # the paired restart) completes inside the schedule's window
        times = sorted(rng.uniform(0.05 * duration_s, 0.8 * duration_s,
                                   size=n_events))
        for t in times:
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "kill" and t < busy_until:
                kind = "poison"         # one dead host at a time
            if kind == "kill":
                hid = hosts[int(rng.integers(len(hosts)))]
                events.append(FaultEvent(float(t), "kill", hid))
                events.append(FaultEvent(float(t + restart_delay_s),
                                         "restart", hid))
                busy_until = t + restart_delay_s
            elif kind == "poison":
                tgt = (tenants[int(rng.integers(len(tenants)))]
                       if tenants else "")
                events.append(FaultEvent(float(t), "poison", tgt))
            else:
                hid = hosts[int(rng.integers(len(hosts)))]
                events.append(FaultEvent(float(t), kind, hid))
        return cls(events)

    @property
    def exhausted(self) -> bool:
        return self._idx >= len(self.events)

    def due(self, elapsed_s: float) -> List[FaultEvent]:
        """Pop (consume) every not-yet-delivered event scheduled at or
        before ``elapsed_s``, in schedule order."""
        out: List[FaultEvent] = []
        while self._idx < len(self.events) \
                and self.events[self._idx].at_s <= elapsed_s:
            out.append(self.events[self._idx])
            self._idx += 1
        return out

    def apply(self, cluster: "CTCluster", event: FaultEvent) -> bool:
        """Fire one event against ``cluster``; returns True when it
        actually fired, False when a guard skipped it (recorded in
        ``skipped`` with the reason)."""
        try:
            if event.kind == "kill":
                with cluster._lock:
                    host = cluster._hosts.get(event.target)
                    ok = (host is not None and host.alive
                          and not host.killed)
                    live = sum(1 for h in cluster._hosts.values()
                               if h.alive and not h.killed)
                if not ok or live <= 1:
                    self.skipped.append((event, "host not killable"))
                    return False
                cluster.injector.kill(event.target)
            elif event.kind == "restart":
                with cluster._lock:
                    host = cluster._hosts.get(event.target)
                    ok = host is not None and host.store is not None
                if not ok:
                    self.skipped.append((event, "no durable store"))
                    return False
                cluster.restart_host(event.target)
            elif event.kind == "stall":
                cluster.injector.stall(event.target)
            elif event.kind == "poison":
                cluster.injector.poison_next_ingest(event.target or None)
            elif event.kind == "crash_snapshot":
                cluster.injector.crash_next_snapshot(event.target)
            elif event.kind == "tear_wal":
                cluster.injector.tear_next_wal(event.target)
            else:
                self.skipped.append((event, f"unknown kind {event.kind!r}"))
                return False
        except Exception as e:          # noqa: BLE001 — chaos must go on
            self.skipped.append((event, repr(e)))
            return False
        self.applied.append(event)
        return True


class CTCluster:
    """Multi-host CT serving front door (see the module docstring for
    the placement/health/failover architecture and the lock rules).

    Exposes the ``CTEngine`` serving surface — ``register`` /
    ``submit_ingest`` / ``submit_query`` / ``query`` / ``update`` /
    ``refit`` / ``drop_grid`` / ``unregister`` / ``surplus`` /
    ``stats`` — routed by consistent-hash placement, so
    ``CTSurrogate(cluster=...)`` and other engine clients work
    unchanged on top of a fleet.
    """

    def __init__(self, n_hosts: int = 4, *,
                 host_specs: Optional[Sequence[ExecSpec]] = None,
                 spec: Optional[ExecSpec] = None,
                 replication: int = 1,
                 vnodes: int = 64, seed: int = 0,
                 health: Optional[HostHealthConfig] = None,
                 monitor_interval_s: float = 0.25,
                 durability_dir: Optional[str] = None,
                 snapshot_interval: int = 16,
                 fsync_every: int = 8,
                 retry: Optional[RetryPolicy] = None,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 device=None):
        if host_specs is not None:
            n_hosts = len(host_specs)
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if replication < 1:
            raise ValueError(f"replication must be >= 1, got {replication}")
        #: the one device every host engine (and so every tenant) lives on
        self.device = resolve_device(device)
        self._default_spec = spec or ExecSpec()
        if self._default_spec.mesh is not None:
            raise ValueError(
                "the cluster-default tenant spec must be mesh-free; "
                "meshes are HOST properties — pass per-host ExecSpecs "
                "via host_specs= (or over_device_slices())")
        self.replication = replication
        self.vnodes, self.seed = vnodes, seed
        self._health = HostHealthTracker(cfg=health or HostHealthConfig())
        self._monitor_interval_s = monitor_interval_s
        self._lock = _lockdep.make_rlock("cluster")
        self._hosts: Dict[str, _Host] = {}
        #: host ids reserved by an in-flight add_host (engine build +
        #: probe warmup run OFF the cluster lock; the id must not be
        #: handed out twice meanwhile)
        self._joining: set = set()
        self._records: Dict[str, _TenantRecord] = {}
        self._inflight: set = set()
        self._failovers: List[Dict[str, Any]] = []
        self._restarts: List[Dict[str, Any]] = []
        self._counters = {"queries": 0, "ingests": 0, "retried_queries": 0,
                          "promoted_ingests": 0, "host_failed": 0,
                          "replayed_ingests": 0}
        self._started = False
        self._monitor_thread: Optional[threading.Thread] = None
        self._monitor_stop: Optional[threading.Event] = None
        self._durability_dir = durability_dir
        self._snapshot_interval = snapshot_interval
        self._fsync_every = fsync_every
        #: one policy for every cluster-side retry loop (ingest fan-out
        #: re-route, query re-route) — bounded attempts, not while True
        self._retry = retry or RetryPolicy(attempts=8, base_delay_s=0.005,
                                           max_delay_s=0.1)
        ekw = dict(engine_kwargs or {})
        ekw.setdefault("check_finite", True)
        ekw["device"] = self.device
        self._engine_kwargs = dict(ekw)     # restart_host rebuilds from it
        for i in range(n_hosts):
            hid = f"host{i}"
            hspec = (host_specs[i] if host_specs is not None
                     else ExecSpec())
            engine = CTEngine(hspec, host_id=hid,
                              **self._engine_with_store_kwargs(
                                  self._make_store(hid)))
            self._add_probe_tenant(engine)
            self._hosts[hid] = _Host(host_id=hid, engine=engine, spec=hspec,
                                     store=engine.store)
        self._ring = self._build_ring()
        self.injector = FaultInjector(self)

    @classmethod
    def over_device_slices(cls, n_hosts: int = 4, *,
                           devices=None, axis_name: str = "slab",
                           members: int = 1, member_axis: str = "member",
                           **kwargs) -> "CTCluster":
        """A cluster whose hosts mesh DISJOINT slices of ``devices``
        (default: every CUDA device): ``n_hosts`` hosts x
        ``len(devices) // n_hosts`` devices each, every host running its
        tenants slab-sharded over its own slice.  With ``members > 1``
        each host's slice is folded into a 2-D (member x slab) mesh, so
        tenants run the 2-D ingest (hierarchization sharded too).  A
        device may be listed more than once (``["cpu"] * 8``, or one card
        repeated).  The hosts' engines live on the slices' device type:
        ``device`` defaults to the first device."""
        from repro_torch.core.mesh import make_mesh
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "over_device_slices: no CUDA device; pass devices= "
                    "(e.g. ['cpu'] * 8) to run on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        per = len(devices) // n_hosts
        if per < 1:
            raise ValueError(
                f"{len(devices)} devices cannot back {n_hosts} hosts")
        if members < 1 or per % members:
            raise ValueError(
                f"members={members} must divide the {per} devices of "
                f"each host slice")
        specs = []
        for i in range(n_hosts):
            sl = devices[i * per:(i + 1) * per]
            if members > 1:
                mesh = make_mesh((members, per // members),
                                 (member_axis, axis_name), devices=sl)
                specs.append(ExecSpec(mesh=mesh, axis_name=axis_name,
                                      member_axis=member_axis))
            else:
                specs.append(ExecSpec(
                    mesh=make_mesh((len(sl),), (axis_name,), devices=sl),
                    axis_name=axis_name))
        kwargs.setdefault("device", devices[0])
        return cls(host_specs=specs, **kwargs)

    # -- construction helpers ---------------------------------------------

    def _make_store(self, host_id: str) -> Optional[DurableStore]:
        """Per-host durable store under the cluster's durability root
        (None when durability is off)."""
        if self._durability_dir is None:
            return None
        return DurableStore(self._durability_dir, host_id,
                            fsync_every=self._fsync_every)

    def _engine_with_store_kwargs(
            self, store: Optional[DurableStore]) -> Dict[str, Any]:
        ekw = dict(self._engine_kwargs)
        if store is not None:
            ekw["store"] = store
            ekw["snapshot_interval"] = self._snapshot_interval
        return ekw

    def _add_probe_tenant(self, engine: CTEngine) -> None:
        """Per-host liveness tenant: a tiny d=2 scheme whose query is
        the health monitor's probe.  Registered directly on the engine
        (never placed on the ring) and warmed here so the first real
        probe measures the scheduler, not a compile.  Never durable:
        probe state is worthless across a restart."""
        probe_scheme = CombinationScheme(2, 2)
        grids = {ell: np.zeros(grid_shape(ell))
                 for ell, _ in probe_scheme.grids}
        engine.register(PROBE_TENANT, probe_scheme, grids, durable=False)
        engine.query(PROBE_TENANT, np.array([[0.5, 0.5]]))

    def _build_ring(self) -> HashRing:
        live = [h.host_id for h in self._hosts.values() if h.alive]
        return HashRing(live, vnodes=self.vnodes, seed=self.seed)

    def _host_exec_spec(self, host: _Host, tspec: ExecSpec) -> ExecSpec:
        """Placement decides the execution environment: the tenant's
        exec prefs (merge/fused/dtype/donate) combined with the HOST's
        mesh (or lack of one)."""
        if host.spec.mesh is not None:
            return dataclasses.replace(tspec, mesh=host.spec.mesh,
                                       axis_name=host.spec.axis_name,
                                       member_axis=host.spec.member_axis,
                                       n_slabs=None)
        return dataclasses.replace(tspec, mesh=None, member_axis=None,
                                   n_slabs=None)

    # -- introspection ------------------------------------------------------

    def hosts(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._hosts)

    def live_hosts(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(h.host_id for h in self._hosts.values() if h.alive)

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._records)

    def __contains__(self, name: str) -> bool:
        return name in self._records

    def owners_of(self, name: str) -> Tuple[str, ...]:
        with self._lock:
            return self._record(name).owners

    def scheme(self, name: str) -> SchemeLike:
        with self._lock:
            return self._record(name).scheme

    def plan(self, name: str):
        with self._lock:
            return self._record(name).plan

    def spec(self, name: str) -> ExecSpec:
        with self._lock:
            return self._record(name).spec

    def engine(self, host_id: str) -> CTEngine:
        with self._lock:
            return self._hosts[host_id].engine

    def _record(self, name: str) -> _TenantRecord:
        try:
            return self._records[name]
        except KeyError:
            raise KeyError(f"no tenant {name!r} (registered: "
                           f"{sorted(self._records)})") from None

    def _primary(self, rec: _TenantRecord) -> _Host:
        """First owner the cluster still considers alive (an injected
        kill stays routable — and unanswered — until detection, exactly
        like a real dead host)."""
        for hid in rec.owners:
            host = self._hosts.get(hid)
            if host is not None and host.alive:
                return host
        raise HostFailed(
            f"tenant {rec.name!r} has no live owner (owners: "
            f"{rec.owners}) — failover has not completed", None)

    def _tenant(self, name: str):
        """Primary host's engine-side tenant record (the ``CTSurrogate``
        introspection hook)."""
        with self._lock:
            rec = self._record(name)
            return self._primary(rec).engine._tenant(name)

    # -- registry -----------------------------------------------------------

    def register(self, name: str, scheme: SchemeLike, nodal_grids=None, *,
                 spec: Optional[ExecSpec] = None,
                 replication: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 priority: int = 0) -> "CTCluster":
        """Admit a tenant: place it on ``replication`` consistent-hash
        owners (cluster default when omitted) and register it — with an
        immediate ingest when ``nodal_grids`` is given — on every
        owner.  The nodal grids are RETAINED cluster-side (numpy
        copies) as the migration source of truth."""
        if name == PROBE_TENANT:
            raise ValueError(f"{PROBE_TENANT!r} is reserved for the "
                             f"health monitor")
        tspec = spec if spec is not None else self._default_spec
        if tspec.mesh is not None:
            raise ValueError(
                "tenant specs must be mesh-free: the cluster assigns "
                "each owner host's mesh at placement time")
        r = self.replication if replication is None else replication
        with self._lock:
            if name in self._records:
                raise ValueError(f"tenant {name!r} already registered "
                                 f"(unregister first, or refit)")
            owners = self._ring.owners(name, r)
            grids_np = {} if nodal_grids is None else {
                tuple(ell): _host_copy(v) for ell, v in nodal_grids.items()}
            rec = _TenantRecord(name=name, scheme=scheme, spec=tspec,
                                replication=r, owners=owners,
                                grids=grids_np, deadline_ms=deadline_ms,
                                priority=priority)
            with _lockdep.allowed_dispatch("admission barrier"):
                for hid in owners:
                    host = self._hosts[hid]
                    hspec = self._host_exec_spec(host, tspec)
                    # tag 0 = the tenant's initial state (committed_seq
                    # 0): durable hosts journal the admission under it
                    # ctlint: ok(block-under-lock): admission barrier — the tenant must be live on every owner before register() returns
                    host.engine.register(
                        name, scheme, grids_np if nodal_grids is not None
                        else None, spec=hspec, deadline_ms=deadline_ms,
                        priority=priority, tag=0)
            primary = self._hosts[owners[0]]
            rec.plan = primary.engine.plan(name)
            rec.plan_spec = self._host_exec_spec(primary, tspec)
            self._records[name] = rec
        return self

    def unregister(self, name: str) -> None:
        """Remove a tenant: drop the routing record under the lock,
        then tear the engines down WITHOUT it — engine unregister
        frees device buffers and discards the durable store (disk
        IO), and holding the cluster lock across that stalls serving
        traffic for every other tenant.  Once the record is gone no
        new work routes to the tenant; a concurrent re-register of
        the same name may observe the teardown in progress and raise
        from the engine, like any other admin-plane race."""
        with self._lock:
            rec = self._record(name)
            targets = [self._hosts[hid] for hid in rec.owners
                       if self._hosts.get(hid) is not None]
            del self._records[name]
        for host in targets:
            if name in host.engine:
                host.engine.unregister(name)

    # -- routed submission --------------------------------------------------

    def _rescue_saturated(self, host: Optional[_Host]) -> bool:
        """Called WITHOUT the cluster lock after a ``block=False`` engine
        submit was rejected.  A bounded-queue rejection from a host whose
        scheduler is dead is a failure SYMPTOM (the queue can only grow),
        not backpressure: fail the host over and tell the caller to
        re-route.  Returns False for genuine live saturation — the
        ``EngineSaturated`` then propagates to the submitter."""
        if host is None or not self._started:
            return False
        dead = (host.killed or host.stalled
                or not host.engine.heartbeat()["scheduler_alive"])
        if not dead:
            return False
        self.fail_host(host.host_id,
                       reason="saturated with dead scheduler")
        return True

    def submit_ingest(self, name: str, nodal_grids, **kw) -> ClusterFuture:
        """Route new solver output to every live owner of ``name``.
        ``nodal_grids`` may be a PARTIAL dict (a subset of the scheme's
        component grids): the cluster merges it over the retained
        last-acked grids before handing each engine the full dict.  The
        future tracks the PRIMARY's acknowledgement; replicas ingest the
        same merged payload, which is what makes primary failover
        transparent for replicated tenants.

        A ``WALTorn`` append failure on a durable host propagates to the
        caller as a NAMED admission failure (nothing was acked); the
        partially fanned-out submissions it may leave behind are benign —
        full-dict ingests are last-writer-wins, so a retry's payload
        supersedes the orphans."""
        kw.pop("block", None), kw.pop("timeout", None)
        new_np = {tuple(ell): _host_copy(v)
                  for ell, v in nodal_grids.items()}
        err: Optional[EngineSaturated] = None
        for delay in self._retry.delays():
            if delay:
                time.sleep(delay)
            sat_host: Optional[_Host] = None
            with self._lock:
                rec = self._record(name)
                # project the payload over last-ACKED state PLUS the
                # still-in-flight ingests in submission order: engines
                # apply full dicts per-tenant IN ORDER, so the record's
                # commit (the full projected payload, newest ack wins)
                # always converges to exactly the engines' state
                merged = dict(rec.grids)
                for f in sorted((f for f in self._inflight
                                 if f.kind == "ingest" and f.name == name
                                 and not f._done), key=lambda f: f._seq):
                    merged.update(f._updates_new)
                merged.update(new_np)
                seq_next = rec.ingest_seq + 1
                payload = self.injector._maybe_poison(name, merged)
                primary = self._primary(rec)
                inners: List[Tuple[str, CTFuture]] = []
                try:
                    for hid in rec.owners:
                        host = self._hosts.get(hid)
                        if host is None or not host.alive:
                            continue
                        # tag = the cluster's per-tenant seq, journaled
                        # host-side so a restart can tell which WAL
                        # entries the cluster had already committed
                        inners.append((hid, host.engine.submit_ingest(
                            name, payload, block=False, tag=seq_next,
                            **kw)))
                except EngineSaturated as e:
                    err, sat_host = e, self._hosts.get(hid)
                else:
                    rec.ingest_seq = seq_next
                    by_host = dict(inners)
                    fut = ClusterFuture(self, "ingest", name,
                                        primary.host_id,
                                        by_host[primary.host_id],
                                        levels=tuple(new_np),
                                        updates=merged,
                                        updates_new=new_np,
                                        seq=seq_next)
                    fut._secondaries = [x for x in inners
                                        if x[0] != primary.host_id]
                    self._inflight.add(fut)
                    self._counters["ingests"] += 1
                    return fut
            if not self._rescue_saturated(sat_host):
                raise err
        raise err   # RetryPolicy attempts exhausted: honest backpressure

    def submit_query(self, name: str, points, **kw) -> ClusterFuture:
        """Route a point-evaluation batch to ``name``'s primary owner.
        Accepts the engine scheduling keywords (``deadline_ms=``,
        ``priority=``).  Queries are idempotent, so on host failure the
        cluster resubmits this future to the new primary transparently.
        Against a tenant still REPLAYING its WAL after a host restart,
        the query serves the restored-snapshot state instead of waiting
        for the replay; the returned future carries ``stale_seq`` (the
        cluster committed seq of the state it reflects)."""
        kw.pop("block", None), kw.pop("timeout", None)
        err: Optional[EngineSaturated] = None
        for delay in self._retry.delays():
            if delay:
                time.sleep(delay)
            with self._lock:
                rec = self._record(name)
                primary = self._primary(rec)
                try:
                    inner = primary.engine.submit_query(
                        name, points, block=False,
                        stale_ok=rec.recovering, **kw)
                except EngineSaturated as e:
                    err = e
                else:
                    fut = ClusterFuture(self, "query", name,
                                        primary.host_id, inner,
                                        points=points, query_kwargs=kw)
                    if rec.recovering:
                        fut.stale_seq = rec.stale_seq
                    self._inflight.add(fut)
                    self._counters["queries"] += 1
                    return fut
            if not self._rescue_saturated(primary):
                raise err
        raise err   # RetryPolicy attempts exhausted: honest backpressure

    def query(self, name: str, points) -> np.ndarray:
        return self.submit_query(name, points).result(_SYNC_TIMEOUT_S)

    def update(self, name: str, nodal_grids):
        return self.submit_ingest(name, nodal_grids).result(_SYNC_TIMEOUT_S)

    def surplus(self, name: str):
        with self._lock:
            rec = self._record(name)
            primary = self._primary(rec)
        return primary.engine.surplus(name)

    # -- lifecycle (fanned out to every live owner) -------------------------

    def refit(self, name: str, scheme: SchemeLike, nodal_grids) -> None:
        """Swap the tenant onto a (refined) scheme on every live owner
        through the engines' incremental ``extend_plan`` path; the
        retained record follows."""
        with self._lock:
            rec = self._record(name)
            new_np = {tuple(ell): _host_copy(v)
                      for ell, v in nodal_grids.items()}
            merged = dict(rec.grids)
            merged.update(new_np)
            primary = self._primary(rec)
            with _lockdep.allowed_dispatch("scheme-swap barrier"):
                for hid in rec.owners:
                    host = self._hosts.get(hid)
                    if host is not None and host.alive:
                        # ctlint: ok(block-under-lock): scheme-swap barrier — serving must not observe half-refitted owners
                        host.engine.refit(name, scheme, merged)
            rec.scheme = scheme
            rec.grids = merged
            rec.plan = primary.engine.plan(name)
            rec.plan_spec = self._host_exec_spec(primary, rec.spec)
            rec.dropped = ()
            rec.committed_seq = rec.ingest_seq

    def drop_grid(self, name: str, failed, nodal_grids=None) -> None:
        """Coefficient-only fault recombination (lost SOLVER grids, as
        opposed to a lost serving host) on every live owner."""
        with self._lock:
            rec = self._record(name)
            merged = dict(rec.grids)
            if nodal_grids is not None:
                merged.update({tuple(ell): _host_copy(v)
                               for ell, v in nodal_grids.items()})
            primary = self._primary(rec)
            with _lockdep.allowed_dispatch("recombination barrier"):
                for hid in rec.owners:
                    host = self._hosts.get(hid)
                    if host is not None and host.alive:
                        # ctlint: ok(block-under-lock): recombination barrier — all owners drop the failed grids atomically
                        host.engine.drop_grid(name, failed, merged)
            rec.scheme = primary.engine.scheme(name)
            rec.plan = primary.engine.plan(name)
            rec.grids = merged
            rec.dropped = rec.dropped + tuple(tuple(f) for f in failed)

    # -- future progression (called by ClusterFuture, no lock held) ---------

    def _poll(self, fut: ClusterFuture) -> None:
        """Finalize ``fut`` if its inner engine future resolved."""
        if fut._done or not fut._inner.done():
            return
        with self._lock:
            self._finalize_from_inner_locked(fut)

    def _finalize_from_inner_locked(self, fut: ClusterFuture) -> None:  # ctlint: holds(cluster)
        if fut._done or not fut._inner.done():
            return
        err = fut._inner.error()
        if err is None:
            # ctlint: ok(block-under-lock): guarded by done() above — result() returns immediately
            fut._finalize_locked(value=fut._inner.result())
            if fut.kind == "ingest":
                rec = self._records.get(fut.name)
                # newest-wins: a later ingest's ack may finalize first —
                # never let an older payload overwrite it
                if rec is not None and fut._seq > rec.committed_seq:
                    rec.grids = dict(fut._updates)
                    rec.committed_seq = fut._seq
        else:
            # per-request engine error (validation, NaN check, ...):
            # already named, already isolated — surface as-is
            fut._finalize_locked(error=err)
        self._inflight.discard(fut)

    def _progress(self, fut: ClusterFuture) -> None:
        """Keep a wait on ``fut`` live: drive an un-started healthy host
        the way ``CTFuture.result`` would, and drive DETECTION (not the
        work) when the owner is failing and no monitor thread runs."""
        with self._lock:
            host = self._hosts.get(fut._host_id)
            monitor = (self._monitor_thread is not None
                       and self._monitor_thread.is_alive())
        if host is None or not host.alive:
            return                      # failover in progress will retarget
        if host.killed or host.stalled:
            if not monitor:
                self.check_health(probe=False)
            return
        hb = host.engine.heartbeat()
        if not hb["scheduler_alive"]:
            host.engine.flush()

    # -- health -------------------------------------------------------------

    def check_health(self, *, probe: bool = True) -> List[str]:
        """One monitor pass: heartbeat + (optionally) a deadline-bounded
        probe query per live host, strike accounting via
        ``HostHealthTracker``, and ``fail_host`` for every host that
        crossed the threshold.  Returns the host ids failed by this
        pass.  Heartbeat/probe checks only arm once ``start()`` runs
        the schedulers — before that, nobody is SUPPOSED to pump, and
        only an injected kill is a failure."""
        with self._lock:
            hosts = [h for h in self._hosts.values() if h.alive]
            started = self._started
        failed: List[str] = []
        cfg = self._health.cfg
        for host in hosts:
            if host.killed:
                if self._health.observe(host.host_id, killed=True):
                    failed.append(host.host_id)
                continue
            if not started:
                continue
            hb = host.engine.heartbeat()
            probe_ok: Optional[bool] = None
            if probe:
                t0 = time.monotonic()
                try:
                    pf = host.engine.submit_query(
                        PROBE_TENANT, np.array([[0.5, 0.5]]),
                        deadline_ms=0.0, priority=1_000_000,
                        block=False)
                except EngineSaturated:
                    # a full queue the scheduler isn't draining IS the
                    # failure the probe exists to catch; one it is
                    # draining (a fresh heartbeat) is load, answered by
                    # backpressure, and counts as no probe
                    probe_ok = None if hb["scheduler_alive"] and \
                        hb["age_s"] <= cfg.heartbeat_timeout_s else False
                else:
                    probe_ok = pf.wait(cfg.probe_deadline_s)
                    if probe_ok:
                        probe_ok = (time.monotonic() - t0
                                    <= cfg.probe_deadline_s)
            if self._health.observe(host.host_id,
                                    heartbeat_age_s=hb["age_s"],
                                    probe_ok=probe_ok):
                failed.append(host.host_id)
        for hid in failed:
            self.fail_host(hid, reason=self._health.events[-1]
                           if self._health.events else "health check")
        return failed

    def start(self) -> "CTCluster":
        """Start every live host's scheduler thread and the health
        monitor (idempotent)."""
        with self._lock:
            hosts = [h for h in self._hosts.values() if h.alive]
            self._started = True
            if self._monitor_thread is not None \
                    and self._monitor_thread.is_alive():
                return self
            stop_evt = threading.Event()
            t = threading.Thread(target=self._monitor_loop,
                                 args=(stop_evt,), name="ct-cluster-health",
                                 daemon=True)
            self._monitor_stop, self._monitor_thread = stop_evt, t
        for host in hosts:
            host.engine.start()
        t.start()
        return self

    def stop(self) -> None:
        """Stop the monitor, then every live host (draining queues)."""
        with self._lock:
            t, evt = self._monitor_thread, self._monitor_stop
            self._monitor_thread = self._monitor_stop = None
            self._started = False
            hosts = [h for h in self._hosts.values() if h.alive]
        if evt is not None:
            evt.set()
        if t is not None:
            t.join(timeout=30.0)
        for host in hosts:
            host.engine.stop(drain=True)

    def __enter__(self) -> "CTCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _monitor_loop(self, stop_evt: threading.Event) -> None:
        while not stop_evt.is_set():
            try:
                self.check_health(probe=True)
            except Exception:       # noqa: BLE001 — monitor must survive
                pass
            stop_evt.wait(self._monitor_interval_s)

    # -- failover -----------------------------------------------------------

    def fail_host(self, host_id: str, reason: str = "manual") -> Dict[str, str]:
        """Remove ``host_id`` from the ring and migrate its tenants to
        their new consistent-hash owners (see the module docstring for
        the replica-adoption vs recombination decision).  In-flight
        requests routed at the host are retried or resolved with
        ``HostFailed`` — never dropped.  Returns ``{tenant: outcome}``
        (``"replica"``, ``"retained"``, ``"recombined"``, or — with a
        durable store on the victim — ``"restored"``: the journaled
        in-flight ingests were replayed from the WAL onto the new
        owners instead of being dropped).

        The last live host is never failed: with no survivor to fail over
        to, that would only stop serving (and hang every future routed
        at it), so ``HostFailed`` is raised first and the host keeps
        serving.  The reference marks it dead before raising; on the port's
        CPU path a health monitor under overload reached that state."""
        with self._lock:
            host = self._hosts.get(host_id)
            if host is None or not host.alive:
                return {}
            if not any(h.alive for h in self._hosts.values()
                       if h is not host):
                raise HostFailed(
                    f"host {host_id!r} is the last live host — no "
                    f"survivors to fail over to", host_id)
        host.engine.stop(drain=False)       # outside the cluster lock
        t0 = time.monotonic()
        with self._lock:
            if not host.alive:              # lost a fail race
                return {}
            host.alive = False
            host.fail_reason = reason
            self._health.forget(host_id)
            if not any(h.alive for h in self._hosts.values()):
                raise HostFailed(
                    f"host {host_id!r} was the last live host — no "
                    f"survivors to fail over to", host_id)
            self._ring = self._build_ring()
            # requests that RESOLVED before the failure but were never
            # polled: commit them first, so migration re-registers from
            # the true last-acked state
            for fut in list(self._inflight):
                if fut._inner.done() and not fut._done:
                    self._finalize_from_inner_locked(fut)
            outcomes: Dict[str, str] = {}
            #: (tenant, cluster seq) -> (new host, inner future) for the
            #: WAL-replayed in-flight ingests: the sweep below retargets
            #: the victim's futures at these instead of ``HostFailed``
            replay_inner: Dict[Tuple[str, int], Tuple[str, CTFuture]] = {}
            for rec in self._records.values():
                if host_id in rec.owners:
                    # one tenant's migration failing must not strand the
                    # rest (or the in-flight retarget below) half-done —
                    # that would hang every future routed at this host
                    try:
                        outcomes[rec.name] = self._migrate_record(
                            rec, host_id, replay_inner)
                    except Exception as e:      # noqa: BLE001
                        outcomes[rec.name] = f"error: {e!r}"
            retried = promoted = lost = replayed = 0
            for fut in list(self._inflight):
                if fut._done or fut._host_id != host_id:
                    continue
                if fut.kind == "query":
                    rec = self._records.get(fut.name)
                    if rec is None:
                        fut._finalize_locked(error=KeyError(
                            f"tenant {fut.name!r} gone during failover"))
                        self._inflight.discard(fut)
                        continue
                    try:
                        new_primary = self._primary(rec)
                        inner = new_primary.engine.submit_query(
                            fut.name, fut._points, block=False,
                            **fut._query_kwargs)
                    except Exception as e:      # noqa: BLE001
                        # the heir is drowning (EngineSaturated) or the
                        # resubmission failed outright: resolve with the
                        # named error rather than block failover or
                        # leave the future hanging
                        fut._finalize_locked(error=e)
                        self._inflight.discard(fut)
                        continue
                    if fut._retarget_locked(new_primary.host_id, inner):
                        retried += 1
                else:
                    live_sec = next(
                        ((hid, f) for hid, f in fut._secondaries
                         if self._hosts[hid].alive), None)
                    replay_tgt = replay_inner.get((fut.name, fut._seq))
                    if live_sec is not None:
                        if fut._retarget_locked(*live_sec):
                            promoted += 1
                    elif replay_tgt is not None:
                        # the victim journaled this ingest at admission:
                        # it was resubmitted from the WAL onto the new
                        # owner — re-point the future at the replayed
                        # acknowledgement instead of failing it
                        if fut._retarget_locked(*replay_tgt):
                            replayed += 1
                    else:
                        recombined = outcomes.get(fut.name) == "recombined"
                        fut._finalize_locked(error=HostFailed(
                            f"ingest for tenant {fut.name!r} was in "
                            f"flight on failed host {host_id!r} with no "
                            f"replica; its component grid(s) "
                            f"{list(fut.levels)} were dropped and "
                            + ("the scheme recombined without them"
                               if recombined else
                               "the tenant serves its last-acked "
                               "pre-failure state"), host_id))
                        self._inflight.discard(fut)
                        lost += 1
            self._counters["retried_queries"] += retried
            self._counters["promoted_ingests"] += promoted
            self._counters["host_failed"] += lost
            self._counters["replayed_ingests"] += replayed
            self._failovers.append({
                "host": host_id, "reason": reason,
                "tenants": len(outcomes), "outcomes": dict(outcomes),
                "retried_queries": retried, "promoted_ingests": promoted,
                "host_failed_ingests": lost, "replayed_ingests": replayed,
                "recovery_ms": (time.monotonic() - t0) * 1e3,
            })
            return outcomes

    def _reroute_queries_locked(self, rec: _TenantRecord,
                                owners: Tuple[str, ...]) -> None:  # ctlint: holds(cluster)
        """Before live ex-owners drop tenant ``rec``, resubmit its queries
        still queued on them to the new primary ``owners[0]`` (queries are
        idempotent).  The reference leaves them on the ex-owner, whose
        unregister then fails them with ``KeyError``: a query routed just
        before a restart or a rebalance would be lost.  Caller holds the
        lock; the new primary already serves the tenant."""
        primary = self._hosts[owners[0]]
        for fut in list(self._inflight):
            if fut._done or fut.kind != "query" or fut.name != rec.name \
                    or fut._host_id in owners or fut._inner.done():
                continue
            try:
                inner = primary.engine.submit_query(
                    fut.name, fut._points, block=False,
                    stale_ok=rec.recovering, **fut._query_kwargs)
            except EngineSaturated:
                continue            # the ex-owner's answer still comes
            if fut._retarget_locked(primary.host_id, inner):
                fut.stale_seq = rec.stale_seq if rec.recovering else None
                self._counters["retried_queries"] += 1

    def _index_set(self, scheme: SchemeLike) -> set:
        return {tuple(ell) for ell, _ in scheme.grids}

    def _migrate_record(self, rec: _TenantRecord, dead_hid: str,
                        replay_inner: Optional[Dict[Tuple[str, int],
                                               Tuple[str, CTFuture]]] = None
                        ) -> str:  # ctlint: holds(cluster)
        """Move one tenant off a dead owner; caller holds the lock."""
        survivors = [o for o in rec.owners
                     if o != dead_hid and self._hosts[o].alive]
        outcome = "replica" if survivors else "retained"
        pending: List[WALEntry] = []
        if not survivors:
            # with a durable victim, ingests IN FLIGHT on the dead host
            # were journaled at admission: read everything newer than
            # the cluster's committed seq back from its WAL and replay
            # it onto the new owners below — no loss, no recombination
            victim = self._hosts.get(dead_hid)
            if victim is not None and victim.store is not None:
                try:
                    # ctlint: ok(block-under-lock): failover WAL read — the tenant is already stopped for the world
                    pending = victim.store.pending_after(
                        rec.name, rec.committed_seq)
                except (WALCorrupt, OSError):
                    pending = []
            if pending:
                outcome = "restored"
        if not survivors and not pending:
            # the only serving copy died with nothing replayable: grids
            # acked before the kill are retained; grids IN FLIGHT on the
            # dead host are lost — drop them and recombine
            # (Harding-style), coefficient-only
            lost = sorted({lvl for fut in self._inflight
                           if not fut._done and fut.kind == "ingest"
                           and fut.name == rec.name
                           and fut._host_id == dead_hid
                           and not fut._inner.done()
                           for lvl in fut.levels})
            if lost and set(lost) < self._index_set(rec.scheme):
                try:
                    scheme2, plan2, _ = recombine_after_fault(
                        rec.scheme, lost, plan=rec.plan)
                except ValueError:
                    # the downward-closed drop (lost vectors AND every
                    # dominating member) would empty the index set — a
                    # LOW lost level dominates everything above it; fall
                    # back to serving the retained last-acked state
                    # unreduced, same as a whole-index-set loss
                    pass
                else:
                    rec.scheme, rec.plan = scheme2, plan2
                    rec.dropped = rec.dropped + tuple(lost)
                    outcome = "recombined"
        new_owners = self._ring.owners(rec.name, rec.replication)
        donor = self._hosts[survivors[0]].engine if survivors else None
        with _lockdep.allowed_dispatch("failover barrier"):
            for hid in new_owners:
                host = self._hosts[hid]
                if rec.name in host.engine:
                    continue
                hspec = self._host_exec_spec(host, rec.spec)
                plan = rec.plan if hspec == rec.plan_spec else None
                if donor is not None:
                    surplus = donor._tenants[rec.name].surplus
                    # ctlint: ok(block-under-lock): failover barrier — serving resumes only once the tenant lives on its new owners
                    host.engine.register(rec.name, rec.scheme, spec=hspec,
                                         plan=plan, surplus=surplus,
                                         deadline_ms=rec.deadline_ms,
                                         priority=rec.priority,
                                         tag=rec.committed_seq)
                else:
                    # ctlint: ok(block-under-lock): failover barrier — serving resumes only once the tenant lives on its new owners
                    host.engine.register(rec.name, rec.scheme,
                                         rec.grids if rec.grids else None,
                                         spec=hspec, plan=plan,
                                         deadline_ms=rec.deadline_ms,
                                         priority=rec.priority,
                                         tag=rec.committed_seq)
        # drop serving copies on live ex-owners the ring walked past
        self._reroute_queries_locked(rec, new_owners)
        for hid in rec.owners:
            h = self._hosts.get(hid)
            if h is not None and h.alive and hid not in new_owners \
                    and rec.name in h.engine:
                # ctlint: ok(block-under-lock): failover barrier — ex-owners drop their copy before placement commits
                h.engine.unregister(rec.name)
        rec.owners = new_owners
        primary = self._hosts[new_owners[0]]
        rec.plan_spec = self._host_exec_spec(primary, rec.spec)
        if rec.plan is None or outcome != "recombined":
            rec.plan = primary.engine.plan(rec.name)
        # replay the victim's journaled not-yet-committed ingests onto
        # every new owner through the NORMAL ingest path (payloads are
        # full merged dicts — last-writer-wins, so order is the WAL's);
        # the primary's inner futures feed the fail_host retarget sweep
        for e in pending:
            inner: Optional[CTFuture] = None
            for hid in new_owners:
                host = self._hosts[hid]
                try:
                    f = host.engine.submit_ingest(
                        rec.name, e.grids, block=False, tag=e.tag)
                except Exception:       # noqa: BLE001 — best effort:
                    continue            # an unreplayable entry degrades
                if hid == new_owners[0]:
                    inner = f
            if replay_inner is not None and inner is not None \
                    and e.tag is not None and e.tag >= 0:
                replay_inner[(rec.name, int(e.tag))] = \
                    (new_owners[0], inner)
        return outcome

    def restart_host(self, host_id: str) -> Dict[str, str]:
        """Bring a (failed or live) durable host back: rebuild its
        engine over the SAME store, restore + rejoin + replay (the
        module docstring's recovery state machine).  Returns
        ``{tenant: outcome}`` with ``"restored"`` (served from the
        host's own store) or ``"adopted"`` (the tenant advanced on
        survivors during the outage and adopts back from a live donor).

        Because the ring is rebuilt under the same seeded vnodes,
        placement returns EXACTLY to the pre-failure assignment:
        relocation is bounded to the restarted host's tenants in both
        directions.  Tenants whose WAL replay is still pending after
        the rejoin serve stale-marked queries (``ClusterFuture.
        stale_seq``) until the replay — run as the last phase, outside
        the cluster lock — catches them up."""
        with self._lock:
            host = self._hosts.get(host_id)
            if host is None:
                raise KeyError(f"no host {host_id!r} (hosts: "
                               f"{sorted(self._hosts)})")
            if host.store is None:
                raise ValueError(
                    f"restart_host({host_id!r}): host has no durable "
                    f"store — build the cluster with durability_dir=")
            alive = host.alive
        if alive:
            # a restart of a live host is an orderly handoff: normal
            # failover first (replicas adopt, in-flights retarget), so
            # the rebuild below starts from a quiesced host
            try:
                self.fail_host(host_id, reason="restart")
            except HostFailed:
                # last live host: nobody to hand off to — take it down
                # here and recover purely from the store
                host.engine.stop(drain=False)
                with self._lock:
                    host.alive = False
                    host.fail_reason = "restart"
                    self._health.forget(host_id)
        total_t0 = time.monotonic()
        # -- phase 1: restore (NO cluster lock: compiles + store IO) ----
        engine = CTEngine(host.spec, host_id=host_id,
                          **self._engine_with_store_kwargs(host.store))
        self._add_probe_tenant(engine)

        def _spec_for(name: str) -> ExecSpec:
            with self._lock:
                rec = self._records.get(name)
                tspec = rec.spec if rec is not None else self._default_spec
            return self._host_exec_spec(host, tspec)

        restored = engine.restore(host.store, specs=_spec_for,
                                  replay=False)
        restore_ms = (time.monotonic() - total_t0) * 1e3
        if self._started:
            # started BEFORE the rejoin so the health monitor sees a
            # live heartbeat, not a fresh strike-out
            engine.start()
        # -- phase 2: rejoin the ring + freshness arbitration (locked) --
        t1 = time.monotonic()
        outcomes: Dict[str, str] = {}
        marked: List[str] = []
        with self._lock:
            host.engine = engine
            host.alive, host.killed, host.stalled = True, False, False
            host.fail_reason = ""
            self._health.forget(host_id)
            # same seeded vnodes -> the pre-failure placement, exactly
            self._ring = self._build_ring()
            for fut in list(self._inflight):
                if fut._inner.done() and not fut._done:
                    self._finalize_from_inner_locked(fut)
            for rec in self._records.values():
                desired = self._ring.owners(rec.name, rec.replication)
                info = restored.get(rec.name)
                if host_id not in desired:
                    # restored, but the (changed) ring no longer places
                    # the tenant here: hand the state back
                    if rec.name in engine:
                        # ctlint: ok(block-under-lock): restart phase 2 — the rejoining host is not serving yet
                        engine.unregister(rec.name)
                    continue
                fresh = (info is not None
                         and info.tag >= rec.committed_seq)
                if fresh:
                    outcomes[rec.name] = "restored"
                    if info.pending and desired[0] == host_id:
                        # primary mid-replay: serve the snapshot state,
                        # stale-marked, instead of blocking queries
                        rec.recovering = True
                        rec.stale_seq = max(info.snapshot_tag, 0)
                        marked.append(rec.name)
                else:
                    # the tenant advanced on survivors during the
                    # outage (or was registered during it): the store's
                    # state is stale — drop it, adopt from a live donor
                    outcomes[rec.name] = "adopted"
                    if rec.name in engine:
                        # ctlint: ok(block-under-lock): restart phase 2 — stale store must be discarded before adoption
                        engine.unregister(rec.name)     # discards store
                    donor = next(
                        (self._hosts[o].engine for o in rec.owners
                         if o != host_id and o in self._hosts
                         and self._hosts[o].alive
                         and rec.name in self._hosts[o].engine), None)
                    hspec = self._host_exec_spec(host, rec.spec)
                    plan = rec.plan if hspec == rec.plan_spec else None
                    with _lockdep.allowed_dispatch("restart adopt"):
                        if donor is not None:
                            # ctlint: ok(block-under-lock): restart phase 2 — adopt-from-donor must commit before the ring serves this host
                            engine.register(
                                rec.name, rec.scheme, spec=hspec,
                                plan=plan,
                                surplus=donor._tenants[rec.name].surplus,
                                deadline_ms=rec.deadline_ms,
                                priority=rec.priority,
                                tag=rec.committed_seq)
                        else:
                            # ctlint: ok(block-under-lock): restart phase 2 — adopt-from-record must commit before the ring serves this host
                            engine.register(
                                rec.name, rec.scheme,
                                rec.grids if rec.grids else None,
                                spec=hspec, plan=plan,
                                deadline_ms=rec.deadline_ms,
                                priority=rec.priority,
                                tag=rec.committed_seq)
                # live ex-owners the restored walk no longer reaches
                self._reroute_queries_locked(rec, desired)
                for hid in rec.owners:
                    h = self._hosts.get(hid)
                    if h is not None and h.alive and hid not in desired \
                            and hid != host_id and rec.name in h.engine:
                        # ctlint: ok(block-under-lock): restart phase 2 — ex-owners drop their copy before placement commits
                        h.engine.unregister(rec.name)
                rec.owners = desired
                primary = self._hosts[desired[0]]
                rec.plan_spec = self._host_exec_spec(primary, rec.spec)
                rec.plan = primary.engine.plan(rec.name)
            # futures still routed at this host (only possible when it
            # was the LAST live host, so no failover swept them): re-
            # point them at the rebuilt engine
            for fut in list(self._inflight):
                if fut._done or fut._host_id != host_id:
                    continue
                rec = self._records.get(fut.name)
                if rec is None or host_id not in rec.owners:
                    fut._finalize_locked(error=HostFailed(
                        f"{fut.kind} for tenant {fut.name!r} could not "
                        f"be re-routed after restarting {host_id!r}",
                        host_id))
                    self._inflight.discard(fut)
                    continue
                try:
                    if fut.kind == "query":
                        inner = engine.submit_query(
                            fut.name, fut._points, block=False,
                            stale_ok=rec.recovering, **fut._query_kwargs)
                        if rec.recovering:
                            fut.stale_seq = rec.stale_seq
                    else:
                        # resubmit the full retained payload under the
                        # SAME cluster seq: idempotent against the WAL
                        # replay of the journaled original (same
                        # payload; newest engine seq wins)
                        inner = engine.submit_ingest(
                            fut.name, fut._updates, block=False,
                            tag=fut._seq)
                except Exception as e:          # noqa: BLE001
                    fut._finalize_locked(error=e)
                    self._inflight.discard(fut)
                    continue
                fut._retarget_locked(host_id, inner)
        replace_ms = (time.monotonic() - t1) * 1e3
        # -- phase 3: WAL replay (NO lock: device work), then unmark ----
        t2 = time.monotonic()
        replay_out = engine.replay()
        replay_ms = (time.monotonic() - t2) * 1e3
        with self._lock:
            for name in marked:
                rec = self._records.get(name)
                if rec is not None:
                    rec.recovering = False
                    rec.stale_seq = None
            self._restarts.append({
                "host": host_id,
                "tenants": len(outcomes), "outcomes": dict(outcomes),
                "replayed": sum(r["replayed"] for r in
                                replay_out.values()),
                "restore_ms": restore_ms, "replace_ms": replace_ms,
                "replay_ms": replay_ms,
                "total_ms": (time.monotonic() - total_t0) * 1e3,
            })
        return outcomes

    def add_host(self, host_id: Optional[str] = None,
                 spec: Optional[ExecSpec] = None) -> str:
        """Join a fresh host and rebalance tenant placement onto the new
        ring (``repro_torch.runtime.elastic.rebalance_cluster``).

        The engine build and probe-tenant warmup (a plan build, an
        ingest and a query) run OUTSIDE the cluster lock: holding it across
        them stalls serving traffic for every tenant; the lock only
        reserves the host id and later publishes the ready host."""
        from repro_torch.runtime.elastic import rebalance_cluster
        with self._lock:
            hid = host_id or \
                f"host{len(self._hosts) + len(self._joining)}"
            if hid in self._hosts or hid in self._joining:
                raise ValueError(f"host {hid!r} already exists")
            self._joining.add(hid)
            hspec = spec or ExecSpec()
            started = self._started
        try:
            store = self._make_store(hid)
            engine = CTEngine(hspec, host_id=hid,
                              **self._engine_with_store_kwargs(store))
            self._add_probe_tenant(engine)
            if started:
                engine.start()
            with self._lock:
                self._hosts[hid] = _Host(host_id=hid, engine=engine,
                                         spec=hspec, store=store)
                self._ring = self._build_ring()
        finally:
            with self._lock:
                self._joining.discard(hid)
        rebalance_cluster(self)
        return hid

    def reconcile(self, name: str) -> str:
        """Re-spread one tenant onto its CURRENT ring owners (the
        ``rebalance_cluster`` work item): new owners adopt the primary's
        plan + surplus, ex-owners are unregistered.  Returns ``"kept"``
        or ``"moved"``."""
        with self._lock:
            rec = self._record(name)
            desired = self._ring.owners(name, rec.replication)
            if desired == rec.owners:
                return "kept"
            donor = self._primary(rec).engine
            surplus = donor._tenants[name].surplus
            with _lockdep.allowed_dispatch("rebalance barrier"):
                for hid in desired:
                    host = self._hosts[hid]
                    if name in host.engine:
                        continue
                    hspec = self._host_exec_spec(host, rec.spec)
                    plan = rec.plan if hspec == rec.plan_spec else None
                    # ctlint: ok(block-under-lock): rebalance barrier — new owners adopt before placement commits
                    host.engine.register(name, rec.scheme, spec=hspec,
                                         plan=plan, surplus=surplus,
                                         deadline_ms=rec.deadline_ms,
                                         priority=rec.priority,
                                         tag=rec.committed_seq)
            self._reroute_queries_locked(rec, desired)
            for hid in rec.owners:
                host = self._hosts.get(hid)
                if host is not None and host.alive \
                        and hid not in desired and name in host.engine:
                    # ctlint: ok(block-under-lock): rebalance barrier — ex-owners drop their copy before placement commits
                    host.engine.unregister(name)
            rec.owners = desired
            primary = self._hosts[desired[0]]
            rec.plan_spec = self._host_exec_spec(primary, rec.spec)
            rec.plan = primary.engine.plan(name)
            return "moved"

    # -- accounting ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Cluster-wide serving statistics: per-host queue depth /
        compile-cache / scheduler / durability counters (each host's
        ``CTEngine.stats()``), the tenant placement map, ring
        parameters, failover + restart history and routing counters.
        The whole tree is plain JSON types — ``json.dumps`` on it never
        raises (the benchmark/CI upload contract)."""
        with self._lock:
            hosts = dict(self._hosts)
            records = dict(self._records)
            counters = dict(self._counters)
            failovers = list(self._failovers)
            restarts = list(self._restarts)
            recovering = sorted(n for n, r in records.items()
                                if r.recovering)
            inflight = sum(1 for f in self._inflight if not f._done)
        per_host: Dict[str, Any] = {}
        for hid, host in hosts.items():
            hb = host.engine.heartbeat()
            entry: Dict[str, Any] = {
                "alive": host.alive, "killed": host.killed,
                "stalled": host.stalled, "fail_reason": host.fail_reason,
                "pending": hb["pending"],
                "heartbeat_age_s": hb["age_s"],
                "tenants": sorted(n for n in host.engine.names()
                                  if n != PROBE_TENANT),
            }
            if host.alive:
                es = host.engine.stats()
                entry["ingest_cache"] = es["ingest_cache"]
                entry["scheduler"] = es["scheduler"]
                entry["ingests"] = es["ingests"]
                entry["eval"] = es["eval"]
                entry["durability"] = es.get("durability")
            per_host[hid] = entry
        return _json_safe({
            "hosts": per_host,
            "live_hosts": sorted(h.host_id for h in hosts.values()
                                 if h.alive),
            "tenants": len(records),
            "placement": {n: list(r.owners) for n, r in records.items()},
            "recovering": recovering,
            "replication": self.replication,
            "ring": {"vnodes": self.vnodes, "seed": self.seed},
            "durability_dir": self._durability_dir,
            "inflight": inflight,
            "failovers": failovers,
            "restarts": restarts,
            **counters,
        })
