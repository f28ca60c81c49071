"""CT execution front door: ``ExecSpec`` and the multi-tenant ``CTEngine``.

Port of ``repro.core.engine`` on one device (CUDA, or the CPU where the
caller asks for it).

* ``ExecSpec`` — one frozen, hashable dataclass of execution policy,
  accepted as ``spec=`` by ``build_plan``, ``extend_plan``, the
  ``ct_transform`` / ``ct_scatter`` / ``ct_embedded`` families,
  ``recombine_after_fault``, ``AdaptiveDriver``, ``make_ct_step`` /
  ``make_ct_eval_step`` and ``CTSurrogate``.  The precedence rules are the
  reference's (``core.executor.resolve_spec``): an explicit spec wins and a
  conflicting legacy keyword raises; legacy keywords alone fold into a
  spec and warn once per call-site family.  The device is no spec field:
  an engine takes ``device=`` and every tenant lives there.
* ``CTEngine`` — a thread-safe registry of named tenants (scheme + plan +
  spec each) behind a deadline-aware batching queue, with ingest
  executables shared by every tenant of one plan signature.

Meshes: ``ExecSpec(mesh=..., axis_name=..., n_slabs=..., member_axis=...)``
(a ``repro_torch.core.mesh.Mesh``) makes a tenant's plan a ``ShardedPlan``
and its ingest the slab-sharded one of ``repro_torch.core.distributed``
(1-D fused, 1-D unfused, or 2-D member x slab), on the mesh's devices,
which must be of the engine device's type; the served surplus is the
gathered fine grid on the engine's device, so queries, durability and
donation read it as an unmeshed tenant's, and it is bitwise the unmeshed
tenant's.  ``rebind`` moves a live tenant onto another mesh or slab layout
without recomputing its surplus.  The cluster's seams are here:
``heartbeat()`` (pump liveness) and ``submit_probe()`` (a no-op request
through the queue), which ``repro_torch.runtime.cluster`` reads.

Ingest executables
------------------

``register`` binds a tenant to the executable of its plan signature (the
canonical bucket levels and axis permutations, the fine grid, and the
execution-relevant spec fields), built once per signature in a
process-global LRU of 64 and shared across engines.  The reference jits
one XLA executable per signature; here the executable is an object that
holds what the signature determines — each bucket's ``(shape, levels,
axes)`` for ``hier_forward_grouped``, the stacks' layout for
``assemble_grouped`` and the fused flag — and the device tables built from
them at the first bind on a device (the spec gives the dtype policy).  The
per-tenant arguments, bound once at ``register`` or a refit, are the
plan's slot-owner table (``executor._ingest_table``) and its coefficients
on the device.  A fused ingest on CUDA is then a fine-buffer fill, one
copy of the assembly's pointer table and four launches (assembly, forward
passes, two of the ordered scatter), however many grids the scheme has.

Queries
-------

Queries coalesce by signature (surplus shape and dtype, point dtype and
the padded batch extent) into eval batches, with the reference's counters
and scheduling rules.  The reference stacks the group's surpluses for one
vmapped eval; at ``prod_3d`` that stack would copy 1.07 GB per tenant,
so here the group's requests are evaluated one by one inside the batch,
each against its own tenant's surplus and its own unpadded points —
exactly the call a one-tenant query makes, so every answer is bitwise
that query's, whatever the batch.

Threading
---------

As in the reference: ``submit_*`` from any thread; ``flush`` drains all,
``pump`` what is due, ``start``/``stop`` run a scheduler thread.  Ingests
run on a pool (shared, private with ``ingest_workers=N``, inline with
``ingest_workers=0``), one ordered chain per tenant; a per-tenant
watermark makes a query wait for the ingests submitted before it; an
ingest commits by compare-and-swap on the tenant record, newest sequence
number winning; an ingest whose tenant was unregistered and registered
anew meanwhile commits onto the new record (``_ingest_one``).  Before the
commit the pool thread synchronises its CUDA stream, so a failed launch
resolves the owning future.  One engine lock
(an ``RLock`` under two conditions) guards the registry, queue, watermarks
and counters; the executable cache's lock is a leaf; no device work runs
under a lock.  The lock classes, their ranks and these rules are
machine-checked: the registry is ``repro_torch.analysis.invariants``,
enforced by the static pass (``python -m repro_torch.analysis``) and the
runtime sanitizer (``REPRO_TORCH_LOCKDEP=1``, whose ``note_dispatch``
sits in ``_dispatch_ingest`` and ``_dispatch_query_groups``).  The kernel
wrappers' launch counters and ``record_calls``
are not thread-safe: count with ``ingest_workers=0`` or one chain at a
time.

Durability
----------

As in the reference (``repro_torch.runtime.durability``): with
``store=`` every admitted ingest is journaled to the tenant's WAL before it
is queued (a grid on the card is copied to the host there, on the
submitter's thread), the served surplus is snapshotted every
``snapshot_interval`` acked ingests on the ingest chain's thread after the
ack (copied to the host, written as npz, checksummed), and
``restore(store)`` adopts each tenant's newest intact snapshot onto the
engine's device and replays the newer WAL entries through the normal
ingest, so the restored surplus is bitwise that of an engine that never
crashed.  The store's bytes are the reference's: a store written by either
package restores in the other.  One deliberate difference (ROADMAP Queue C,
C16): ``snapshot_interval`` must be an int >= 0 (0 turns snapshots off)
and anything else is refused at construction, and a snapshot that raises
is logged and counted (``stats()["durability"]["snapshot_errors"]``)
without ending the ingest chain; the reference's ``snapshot_interval=None``
raises on the pool thread after the ack and strands the tenant's later
queued ingests, whose futures never resolve.

Donation
--------

``ExecSpec(donate=True)`` hands the caller's grid tensors to the ingest.
JAX deletes a donated buffer; here the engine frees the storage of each
grid the assembly read in place (``untyped_storage().resize_(0)``, after
``record_stream`` on the ingest's stream, so the caching allocator reuses
the memory only after the assembly ran).  A grid is released only when
it is the very tensor the assembly read (on the engine's device, in the
ingest's dtype), owns its storage whole (offset 0, no bytes beyond its
own) and its storage is resizable; anything else is kept, and a warning
saying so (it contains "donated") fires once per tenant.  Numpy input is
staged per call and is never donated.  A released tensor is recognised
from its metadata (``kernels.hierarchize.storage_released``) before
anything reads it: handing one in again raises ``IngestBuffersDonated``
(and the WAL's host copy is never attempted), a NaN found by
``check_finite`` after a donated ingest raises ``IngestBuffersDonated``
instead of ``FloatingPointError``, and a lost compare-and-swap never
dispatches released grids again.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import lockdep as _lockdep
from repro_torch.core.executor import (ExecutorPlan, MergeConfig,
                                       ShardedPlan, _base, _grids_on,
                                       _ingest_fused, _ingest_table,
                                       _ingest_unfused, _pass_specs,
                                       build_plan, extend_plan,
                                       plan_launch_stats,
                                       reset_legacy_warnings, shard_plan)
from repro_torch.core.mesh import mesh_axes
from repro_torch.core.interpolation import interpolate_hierarchical
from repro_torch.core.levels import SchemeLike
from repro_torch.kernels.hierarchize import storage_released
from repro_torch.runtime.durability import DurableStore, RetryPolicy

__all__ = ["ExecSpec", "CTEngine", "CTFuture", "EngineSaturated",
           "IngestBuffersDonated", "RestoreInfo", "RetryPolicy",
           "plan_signature", "reset_deprecation_warnings",
           "clear_compile_cache"]


def reset_deprecation_warnings() -> None:
    """Re-arm the once-per-call-site legacy-keyword warnings (tests)."""
    reset_legacy_warnings()


class EngineSaturated(RuntimeError):
    """The engine's bounded request queue is full (admission control)."""


class _RebindRace(RuntimeError):
    """An ingest commit lost the compare-and-swap against a concurrent
    refit's record swap; retried under the engine's ``RetryPolicy``."""


@dataclass(frozen=True)
class RestoreInfo:
    """What ``CTEngine.restore`` recovered for one tenant."""

    name: str
    snapshot_seq: int           # watermark of the adopted snapshot (0 none)
    base_seq: int               # highest journaled seq (snapshot + WAL)
    tag: int                    # newest caller ordering tag recovered; -1
    snapshot_tag: int           # caller tag of the adopted snapshot; -1
    pending: int                # WAL entries newer than the snapshot
    replayed: int               # entries already applied (replay=True)
    restore_s: float
    replay_s: float
    events: Tuple[str, ...]     # tolerated anomalies (torn tails, ...)


class IngestBuffersDonated(RuntimeError):
    """An ingest under ``ExecSpec(donate=True)`` failed (or lost a refit
    race) after its input grids were donated, or was handed grids whose
    storage an earlier donated ingest released: the storage is gone, so
    the ingest can neither be retried in place nor resubmitted.  The
    owning future resolves with this error instead of dispatching released
    grids; resubmit from host copies to recover."""


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


@dataclass(frozen=True)
class ExecSpec:
    """One frozen config of execution policy (hashable: a mesh hashes by
    its devices and axis names, ``MergeConfig`` is a frozen dataclass and
    ``dtype`` is canonicalized to its name), so a spec can sit in cache
    keys.  Fields and validation as the reference's."""

    #: bucket-merging cost model (``None`` = one bucket per canonical
    #: shape): part of the PLAN
    merge: Optional[MergeConfig] = None
    #: device mesh of the slab-sharded ingest (``repro_torch.core.mesh``)
    mesh: Optional[Any] = None
    #: mesh axis the fine grid's leading axis is slab-sharded over
    axis_name: str = "slab"
    #: slab count; ``None`` = the mesh axis's extent (1 without a mesh)
    n_slabs: Optional[int] = None
    #: ingest epilogue: ``None``/``True`` fused, ``False`` unfused
    fused: Optional[bool] = None
    #: the reference's Pallas interpret mode.  The port's kernels have no
    #: interpret mode: on the CPU the plain versions run whatever this
    #: says, and ``True`` with a CUDA device raises (``resolve_interpret``)
    interpret: Optional[bool] = None
    #: accumulation dtype of an engine ingest (a name, e.g. ``"float64"``);
    #: ``None`` = promote the input grid dtypes
    dtype: Optional[str] = None
    #: hand the caller's grid tensors to the ingest, which releases their
    #: storage once the assembly has read them (module docstring,
    #: "Donation"); opt-in, part of the plan signature
    donate: bool = False
    #: second mesh axis of the 2-D (member x slab) ingest: the
    #: hierarchization is then sharded over ``members * slabs`` groups.
    #: Inert without a mesh (so de-meshing a spec keeps it valid)
    member_axis: Optional[str] = None

    def __post_init__(self):
        if self.dtype is not None:
            object.__setattr__(self, "dtype", _dtype_name(self.dtype))
        if self.n_slabs is not None and self.n_slabs < 1:
            raise ValueError(f"n_slabs must be >= 1, got {self.n_slabs}")
        if self.mesh is not None:
            axes = mesh_axes(self.mesh)
            if self.axis_name not in axes:
                raise ValueError(
                    f"axis_name {self.axis_name!r} is not an axis of the "
                    f"mesh (axes: {tuple(axes)})")
            extent = int(axes[self.axis_name])
            if self.n_slabs is not None and self.n_slabs != extent:
                raise ValueError(
                    f"n_slabs={self.n_slabs} conflicts with mesh axis "
                    f"{self.axis_name!r} of {extent} device(s); set ONE of "
                    f"them (precedence rule 1: conflicts raise)")
            if self.member_axis is not None:
                if self.member_axis == self.axis_name:
                    raise ValueError(
                        f"member_axis and axis_name must differ, both "
                        f"{self.axis_name!r}")
                if self.member_axis not in axes:
                    raise ValueError(
                        f"member_axis {self.member_axis!r} is not an axis "
                        f"of the mesh (axes: {tuple(axes)})")

    @property
    def slabs(self) -> int:
        """Effective slab count: ``n_slabs``, else the mesh axis's extent,
        else 1 (unsharded)."""
        if self.n_slabs is not None:
            return self.n_slabs
        if self.mesh is not None:
            return int(mesh_axes(self.mesh)[self.axis_name])
        return 1

    @property
    def members(self) -> int:
        """Member-axis extent of a 2-D mesh (1 when not member-meshed)."""
        if self.member_axis is not None and self.mesh is not None:
            return int(mesh_axes(self.mesh).get(self.member_axis, 1))
        return 1

    @property
    def groups(self) -> int:
        """Compute groups of the 2-D ingest: ``members * slabs`` when a
        member axis is meshed, else 1 (hierarchization replicated)."""
        if self.member_axis is not None and self.mesh is not None \
                and self.member_axis in mesh_axes(self.mesh):
            return self.members * self.slabs
        return 1

    @property
    def torch_dtype(self) -> Optional[torch.dtype]:
        return None if self.dtype is None else getattr(torch, self.dtype)

    def resolve_interpret(self, device) -> bool:
        """Whether the plain versions run on ``device``: on the CPU always,
        on CUDA never.  ``interpret=True`` with a CUDA device raises — the
        kernels have no interpret mode, and the card never falls back to
        the plain versions."""
        device = torch.device(device)
        if device.type != "cpu" and self.interpret:
            raise ValueError(
                f"ExecSpec(interpret=True) on {device}: the CUDA kernels "
                f"have no interpret mode and never fall back to their plain "
                f"versions; run on device='cpu' for those")
        return device.type == "cpu"

    def result_dtype(self, *input_dtypes) -> torch.dtype:
        """Accumulation dtype under this spec's dtype policy."""
        if self.dtype is not None:
            return self.torch_dtype
        out = input_dtypes[0]
        for d in input_dtypes[1:]:
            out = torch.promote_types(out, d)
        return out

    def plan(self, scheme: SchemeLike, full_levels=None) -> ExecutorPlan:
        """The executor plan this spec prescribes for ``scheme``."""
        return build_plan(scheme, full_levels, spec=self)


# ---------------------------------------------------------------------------
# Signature-shared ingest executables
# ---------------------------------------------------------------------------

def plan_signature(plan, spec: ExecSpec) -> Tuple:
    """Hashable shape signature of (plan, spec), laid out as the
    reference's: canonical bucket member levels and axis permutations, the
    fine grid, the slab split ``(n_slabs, n_groups)`` and the
    execution-relevant spec fields (the mesh, its axis and member axis
    for a sharded plan).  Not included: coefficients and the plan's index
    arrays, which are the per-tenant arguments."""
    sharded = isinstance(plan, ShardedPlan)
    base = plan.plan if sharded else plan
    buckets = tuple((b.levels, b.perms) for b in base.buckets)
    shard = (plan.n_slabs, plan.n_groups) if sharded else None
    return (base.full_levels, buckets, shard, spec.fused, spec.interpret,
            spec.dtype, spec.donate,
            spec.mesh if sharded else None,
            spec.axis_name if sharded else None,
            spec.member_axis if sharded else None)


@dataclass
class _Binding:
    """One tenant's arguments of its executable, on the engine's device
    (and, meshed, on the mesh's): the plan, its tables — the slot-owner
    table (fused), the per-slab scatter tables (1-D sharded fused) or the
    2-D tables — or its index maps (unfused; per bucket and slab when
    sharded), and its coefficients, uploaded once in float64 and kept per
    dtype, split per bucket for the unsharded unfused ingest.

    Every tenant of one signature has the same index maps (a member's map
    depends only on its canonical levels, permutation, bucket target, the
    fine grid and the slab split, all in the signature), so the tables
    could be shared; each binding takes its plan's own from the
    identity-keyed caches (``executor._ingest_table``,
    ``distributed.slab_scatter_tables`` / ``two_d_tables``), which already
    share them between the plans of a coefficient-only update, and holds
    them for as long as the record lives."""

    plan: Any
    table: Any
    idxs: tuple
    coeffs64: torch.Tensor
    split: bool = False
    _coeffs: Dict[torch.dtype, Any] = dataclasses.field(default_factory=dict)

    def coeffs(self, dtype: torch.dtype):
        """The coefficients in ``dtype``: concatenated, or per bucket with
        ``split``, cast once."""
        c = self._coeffs.get(dtype)
        if c is None:
            c = self.coeffs64.to(dtype)
            if self.split:
                c = tuple(torch.split(c, [len(b.ells)
                                          for b in self.plan.buckets]))
            self._coeffs[dtype] = c
        return c


class _IngestExecutable:
    """The ingest of one plan signature, shared by its tenants:
    ``(grids on the device, binding, dtype) -> surplus``.  Holds what the
    signature determines — the passes, the assembly's layout, the fused
    flag and, for a sharded plan, the mesh and its axes — and, per device
    it ran on, the grouped forward launch's work table
    (``kernels.hierarchize._grouped_table``) and the assembly's layout."""

    def __init__(self, plan, spec: ExecSpec):
        base = _base(plan, "CTEngine.register")
        self.sharded = isinstance(plan, ShardedPlan)
        if self.sharded and spec.mesh is None:
            raise ValueError(
                "a slab-sharded plan needs a meshed spec (ExecSpec(mesh="
                "...)) to execute; n_slabs alone only shapes the plan")
        self.stacks = _pass_specs(base)[0]
        self.layout = tuple((b.shape, b.perms) for b in base.buckets)
        self.fused = spec.fused is not False
        self.mesh, self.axis_name = spec.mesh, spec.axis_name
        self.member_axis = spec.member_axis \
            if self.sharded and plan.n_groups > 1 else None
        self._on: Dict[torch.device, tuple] = {}
        self._lock = _lockdep.make_lock("ingest-tables")

    def _tables(self, device: torch.device) -> None:
        from repro_torch.kernels.hierarchize import (_assembly_layout,
                                                     _grouped_table)
        with self._lock:
            if device in self._on:
                return
        tables = (_assembly_layout(self.layout),
                  _grouped_table(self.stacks, device) if self.fused
                  and device.type == "cuda" else None)
        with self._lock:
            self._on.setdefault(device, tables)

    def bind(self, plan, device: torch.device) -> _Binding:
        """Upload a tenant's arguments (at ``register``, a refit or a
        rebind)."""
        self._tables(device)
        coeffs = torch.from_numpy(np.concatenate(
            [b.coeffs for b in plan.buckets])).to(device)
        if self.sharded:
            return self._bind_sharded(plan, device, coeffs)
        if self.fused:
            table = _ingest_table(plan)
            if device.type == "cuda":
                table.scatter.on(device)
            return _Binding(plan, table, (), coeffs)
        idxs = tuple(torch.from_numpy(b.index).to(device)
                     for b in plan.buckets)
        return _Binding(plan, None, idxs, coeffs, split=True)

    def _bind_sharded(self, plan: ShardedPlan, device: torch.device,
                      coeffs: torch.Tensor) -> _Binding:
        from repro_torch.core.distributed import (_check_mesh,
                                                  slab_scatter_tables,
                                                  two_d_tables)
        mesh = _check_mesh(self.mesh, self.axis_name)
        if mesh.device_type != device.type:
            raise ValueError(
                f"the tenant's mesh holds {mesh.device_type} devices but the "
                f"engine runs on {device}: no path mixes the CPU with a "
                f"card")
        if mesh.shape[self.axis_name] != plan.n_slabs:
            raise ValueError(
                f"plan is sharded for {plan.n_slabs} slab(s) but mesh axis "
                f"{self.axis_name!r} has {mesh.shape[self.axis_name]}")
        slab_devices = mesh.axis_devices(self.axis_name)
        if self.member_axis is not None:
            return _Binding(plan, two_d_tables(plan), (), coeffs)
        if self.fused:
            tables = slab_scatter_tables(plan)
            if device.type == "cuda":
                for t, dev in zip(tables, slab_devices):
                    t.on(dev)
            return _Binding(plan, tables, (), coeffs)
        idxs = tuple([torch.from_numpy(sb.index[s]).to(dev)
                      for s, dev in enumerate(slab_devices)]
                     for sb in plan.slab_buckets)
        return _Binding(plan, None, idxs, coeffs)

    def __call__(self, grids, binding: _Binding, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
        if self.sharded:
            from repro_torch.core.distributed import _sharded_ingest
            return _sharded_ingest(
                grids, binding.plan, self.mesh, self.axis_name,
                member_axis=self.member_axis, fused=self.fused,
                coeffs=binding.coeffs(dtype), dtype=dtype, device=device,
                tables=binding.table, idxs=binding.idxs or None)
        if self.fused:
            return _ingest_fused(grids, binding.plan, binding.table,
                                 binding.coeffs(dtype), dtype, device)
        return _ingest_unfused(grids, binding.plan, binding.idxs,
                               binding.coeffs(dtype), dtype, device)


#: Process-global executable cache: signature -> executable, shared by
#: every engine (and so every surrogate).  LRU-bounded; a live tenant keeps
#: its executable after eviction, which only makes the NEXT tenant of that
#: signature build anew.  ``_INGEST_CACHE_LOCK`` is a leaf lock.
_INGEST_EXECUTABLES: "collections.OrderedDict[Tuple, _IngestExecutable]" = \
    collections.OrderedDict()
_INGEST_CACHE_MAX = 64
_INGEST_CACHE_LOCK = _lockdep.make_lock("ingest-cache")


def clear_compile_cache() -> None:
    """Drop the shared ingest-executable cache (tests / benchmarks)."""
    with _INGEST_CACHE_LOCK:
        _INGEST_EXECUTABLES.clear()


def _ingest_executable(signature: Tuple, plan,
                       spec: ExecSpec) -> Tuple[_IngestExecutable, bool]:
    """Fetch-or-build the shared executable; returns ``(executable,
    was_hit)``.  One lock over get/build/insert/evict, so concurrent
    binders of one signature see exactly one miss (building is host-side
    and cheap: the device tables come at bind time, outside the lock)."""
    with _INGEST_CACHE_LOCK:
        ex = _INGEST_EXECUTABLES.get(signature)
        if ex is not None:
            _INGEST_EXECUTABLES.move_to_end(signature)
            return ex, True
        ex = _IngestExecutable(plan, spec)
        _INGEST_EXECUTABLES[signature] = ex
        while len(_INGEST_EXECUTABLES) > _INGEST_CACHE_MAX:
            _INGEST_EXECUTABLES.popitem(last=False)
        return ex, False


#: How long a draining flush waits for another thread's in-flight ingest
#: before failing the dependent query futures with TimeoutError.
_DRAIN_TIMEOUT_S = 120.0

_SHARED_POOL: Optional[ThreadPoolExecutor] = None
_SHARED_POOL_LOCK = _lockdep.make_lock("shared-pool")


def _shared_pool() -> ThreadPoolExecutor:
    """Lazy process-wide ingest pool, shared by every engine constructed
    with ``ingest_workers=None``."""
    global _SHARED_POOL
    with _SHARED_POOL_LOCK:
        if _SHARED_POOL is None:
            _SHARED_POOL = ThreadPoolExecutor(
                max_workers=min(8, (os.cpu_count() or 1) + 2),
                thread_name_prefix="ct-ingest")
        return _SHARED_POOL


def _synchronize(device: torch.device) -> None:
    """Wait for the work queued on this thread's stream of ``device``, so
    that a failed launch surfaces here (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class CTFuture:
    """Result handle of ``submit_ingest`` / ``submit_query``, safe to wait
    on from any thread.  ``result(timeout=)`` blocks until the request
    resolves, flushing the owning engine's queue while it waits; a failed
    request re-raises its own exception from ``result()``.  ``wait``
    blocks without driving the engine."""

    __slots__ = ("_engine", "_event", "_payload", "_error", "done_at")

    def __init__(self, engine: "CTEngine"):
        self._engine = engine
        self._event = threading.Event()
        self._payload = None
        self._error: Optional[BaseException] = None
        #: ``time.monotonic()`` at resolution (latency accounting)
        self.done_at: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def error(self) -> Optional[BaseException]:
        return self._error

    def _set(self, payload) -> None:
        self._payload = payload
        self.done_at = time.monotonic()
        self._event.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self.done_at = time.monotonic()
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._event.is_set():
            self._engine.flush()
            if self._event.wait(0.02):
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"CTFuture.result: request still pending after "
                    f"{timeout:.3f}s")
        if self._error is not None:
            raise self._error
        return self._payload() if callable(self._payload) else self._payload


@dataclass
class _Tenant:
    """One named surrogate: scheme + plan + spec, its executable and the
    arguments bound to it, its served surplus and scheduling defaults."""

    name: str
    scheme: SchemeLike
    spec: ExecSpec
    plan: Any                       # ExecutorPlan | ShardedPlan
    signature: Tuple
    executable: _IngestExecutable
    binding: _Binding
    surplus: Optional[torch.Tensor] = None
    surplus_seq: int = 0            # ingest seq of the committed surplus
    deadline_ms: Optional[float] = None   # None = engine default
    priority: int = 0
    #: one per ``register``, carried over by a refit's record swap: tells a
    #: refit (retry the ingest) from an unregister and a new register
    incarnation: Any = dataclasses.field(default_factory=object)

    @property
    def base_plan(self) -> ExecutorPlan:
        return self.plan.plan if isinstance(self.plan, ShardedPlan) \
            else self.plan


@dataclass
class _Request:
    """One queued unit of work, holding the tenant NAME (resolved at
    dispatch, so a refit's record swap or an unregister applies to queued
    work).  ``ingest_seq``: an ingest's own generation, or the generation
    a query must wait for."""

    kind: str                       # "ingest" | "query" | "probe"
    name: str
    payload: Any    # (grids, check_finite, tag) | (points, q, qpad) | None
    future: CTFuture
    ingest_seq: int = 0
    priority: int = 0
    deadline: Optional[float] = None      # absolute time.monotonic()


def _same_ingest(a: _Tenant, b: _Tenant) -> bool:
    """Whether two tenant records compute bitwise the same surplus from one
    payload: one plan signature and equal coefficients (the index maps
    follow from the signature)."""
    return a.signature == b.signature and torch.equal(
        a.binding.coeffs64, b.binding.coeffs64)


def _validate_points(points, dim: int, name: str) -> np.ndarray:
    """Named errors for malformed query points."""
    points = np.asarray(points)
    if points.ndim == 1:
        points = points[None, :]
    if points.ndim != 2 or points.shape[1] != dim:
        raise ValueError(
            f"query points for tenant {name!r} must have shape (Q, {dim}) "
            f"— the scheme is {dim}-dimensional — got {points.shape}")
    if not np.issubdtype(points.dtype, np.floating):
        raise TypeError(
            f"query points for tenant {name!r} must be a floating dtype "
            f"(coordinates in [0,1]^{dim}), got {points.dtype}")
    return points


def _qpad(q: int) -> int:
    """The reference's padded batch extent (a power of two, >= 16): part of
    a query's coalescing key, so batches split as the reference's do."""
    return max(16, 1 << max(0, q - 1).bit_length())


_UNSET = object()


class CTEngine:
    """Thread-safe multi-tenant CT surrogate server on one device (see the
    module docstring).  ``device`` defaults to CUDA; every tenant's plan
    tables, coefficients and surplus live there.  ``store=`` (a
    ``DurableStore``) journals every admitted ingest and snapshots each
    tenant every ``snapshot_interval`` acked ingests; ``None`` keeps the
    engine in memory only."""

    def __init__(self, spec: Optional[ExecSpec] = None, *,
                 device=None, max_batch: int = 32, max_pending: int = 1024,
                 deadline_ms: float = 10.0,
                 ingest_workers: Optional[int] = None,
                 check_finite: bool = False,
                 host_id: Optional[str] = None,
                 store: Optional[DurableStore] = None,
                 snapshot_interval: int = 16,
                 retry: Optional[RetryPolicy] = None):
        if spec is not None and not isinstance(spec, ExecSpec):
            raise TypeError(f"CTEngine: spec must be an ExecSpec, got "
                            f"{type(spec).__name__}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if isinstance(snapshot_interval, bool) or not isinstance(
                snapshot_interval, int):
            raise TypeError(f"CTEngine: snapshot_interval must be an int "
                            f"(0 turns snapshots off), got "
                            f"{snapshot_interval!r}")
        if snapshot_interval < 0:
            raise ValueError(f"CTEngine: snapshot_interval must be >= 0 "
                             f"(0 turns snapshots off), got "
                             f"{snapshot_interval}")
        self.device = resolve_device(device)
        self._default_spec = spec or ExecSpec()
        self._default_spec.resolve_interpret(self.device)
        self._max_batch = max_batch
        self._max_pending = max_pending
        self._deadline_ms = deadline_ms
        self._check_finite = check_finite
        self._store = store
        self._snapshot_interval = snapshot_interval
        self._retry = retry or RetryPolicy(attempts=5, base_delay_s=0.0)
        self._snap_seq: Dict[str, int] = {}     # last snapshotted watermark
        self._last_tag: Dict[str, int] = {}     # newest caller ordering tag
        self._replay_pending: Dict[str, List[Any]] = {}
        self._donation_warned: set = set()      # tenants warned of kept grids
        #: name of this engine in error messages and ``stats()``
        self.host_id = host_id
        self._lock = _lockdep.make_rlock("engine")
        self._work = threading.Condition(self._lock)    # new work / progress
        self._space = threading.Condition(self._lock)   # queue has room
        self._work_seq = 0          # bumped on every submit/progress event
        self._tenants: Dict[str, _Tenant] = {}
        self._pending: List[_Request] = []
        self._ingest_submitted: Dict[str, int] = {}
        self._ingest_done: Dict[str, int] = {}
        self._counters = {"ingests": 0, "queries": 0, "eval_batches": 0,
                          "coalesced_queries": 0, "cache_hits": 0,
                          "cache_misses": 0, "snapshot_errors": 0}
        self._sched = {"dispatch_deadline": 0, "dispatch_batch_full": 0,
                       "flushes": 0, "rejected": 0, "requeued": 0,
                       "ingest_retries": 0, "promoted": 0}
        self._inline_ingest = ingest_workers == 0
        self._private_pool = ThreadPoolExecutor(
            max_workers=ingest_workers, thread_name_prefix="ct-ingest") \
            if ingest_workers else None
        self._sched_thread: Optional[threading.Thread] = None
        self._stop_evt: Optional[threading.Event] = None
        #: ``time.monotonic()`` of the last scheduler pass (``pump``,
        #: ``flush`` or a scheduler-loop iteration): ``heartbeat``'s signal
        self._last_pump = time.monotonic()

    # -- registry -----------------------------------------------------------

    def register(self, name: str, scheme: SchemeLike, nodal_grids=None, *,
                 spec: Optional[ExecSpec] = None,
                 deadline_ms: Optional[float] = None,
                 priority: int = 0, plan=None, surplus=None,
                 tag: Optional[int] = None,
                 durable: bool = True) -> "CTEngine":
        """Admit tenant ``name``: build its plan under ``spec`` (engine
        default when omitted), bind the signature-shared executable, and —
        when ``nodal_grids`` is given — ingest at once.  ``plan=`` /
        ``surplus=`` adopt a retained plan and an already-computed surplus
        (the failover lane): no plan build, no ingest; the caller owns the
        triple's consistency.  ``surplus=`` and ``nodal_grids=`` exclude
        each other.

        With a store attached (and ``durable=True``) the tenant's identity
        is registered in the store, an initial ingest is journaled at
        admission, and an adopted ``surplus`` is snapshotted at once.
        ``tag`` is the caller's own ordering tag, journaled beside the
        engine's watermark; ``durable=False`` is for ``restore`` itself,
        whose state is already on disk."""
        if spec is not None and not isinstance(spec, ExecSpec):
            raise TypeError(f"register: spec must be an ExecSpec, got "
                            f"{type(spec).__name__}")
        if surplus is not None and nodal_grids is not None:
            raise ValueError(
                "register: pass nodal_grids= (ingest now) or surplus= "
                "(adopt precomputed state), not both")
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered "
                                 f"(unregister first, or refit)")
        spec = spec or self._default_spec
        if plan is None:
            plan = build_plan(scheme, spec=spec)      # outside the lock
        tenant = self._bind(name, scheme, spec, plan)
        tenant.deadline_ms, tenant.priority = deadline_ms, priority
        if surplus is not None:
            tenant.surplus = torch.as_tensor(surplus, device=self.device)
        durable = durable and self._store is not None
        if durable:
            # identity first (atomic meta.json): a crash between here and
            # the first journal append restores an empty tenant
            self._store.register(name, scheme,
                                 full_levels=tenant.plan.full_levels,
                                 deadline_ms=deadline_ms, priority=priority)
        with self._work:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered "
                                 f"(unregister first, or refit)")
            self._tenants[name] = tenant
            if nodal_grids is not None:
                # a query submitted before the commit below waits for it
                seq0 = self._ingest_submitted.get(name, 0) + 1
                self._ingest_submitted[name] = seq0
                if durable:
                    try:
                        # journal at admission: a crash after this append
                        # replays the initial ingest
                        self._journal(name, seq0, nodal_grids, tag)
                    except Exception:
                        del self._tenants[name]
                        self._ingest_submitted[name] = seq0 - 1
                        raise
                if tag is not None:
                    self._last_tag[name] = tag
            self._work_seq += 1
            self._work.notify_all()
        if durable and surplus is not None:
            # adopted state never flows through submit_ingest: make it
            # durable now (this also rotates away a stale journal of an
            # earlier tenant of the name)
            seq0 = self._ingest_submitted.get(name, 0)
            if tag is not None:
                self._last_tag[name] = tag
            self._snapshot_now(name, seq0, tag, tenant.surplus,
                               scheme=scheme,
                               full_levels=tenant.plan.full_levels)
        if nodal_grids is not None:
            try:
                surplus = self._dispatch_ingest(tenant, nodal_grids)
                _synchronize(self.device)
                with self._lock:
                    tenant.surplus = surplus
                    self._counters["ingests"] += 1
            except Exception:
                with self._lock:
                    if self._tenants.get(name) is tenant:
                        del self._tenants[name]
                raise
            finally:
                # advance even on failure: waiters re-check and fail fast.
                # To ``seq0``, not by one (the reference): an ingest of an
                # earlier incarnation still in flight would otherwise leave
                # the watermark one short of the admitted one for good
                with self._work:
                    self._ingest_done[name] = max(
                        self._ingest_done.get(name, 0), seq0)
                    self._work_seq += 1
                    self._work.notify_all()
        return self

    def unregister(self, name: str) -> None:
        """Remove tenant ``name``.  Work queued for it fails its future
        with a named ``KeyError`` at dispatch; the per-name watermark stays
        monotonic, so a later re-register is race-free.  Its durable state
        is discarded: an unregister is a deliberate handoff, not a crash,
        and a later ``restore`` must not bring the tenant back."""
        with self._work:
            del self._tenants[name]
            dropped = self._replay_pending.pop(name, None)
            if dropped:
                # deferred WAL entries that will never run: a later
                # incarnation must not wait for them (the reference leaves
                # the watermark behind, and its queries then wait forever)
                self._ingest_done[name] = max(
                    self._ingest_done.get(name, 0),
                    max(e.seq for e in dropped))
            self._work_seq += 1
            self._work.notify_all()
        if self._store is not None:
            self._store.discard(name)

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._tenants)

    def _tenant(self, name: str) -> _Tenant:
        with self._lock:
            try:
                return self._tenants[name]
            except KeyError:
                raise KeyError(f"no tenant {name!r} (registered: "
                               f"{sorted(self._tenants)})") from None

    def scheme(self, name: str) -> SchemeLike:
        return self._tenant(name).scheme

    def plan(self, name: str):
        return self._tenant(name).plan

    def spec(self, name: str) -> ExecSpec:
        return self._tenant(name).spec

    def surplus(self, name: str) -> torch.Tensor:
        """The tenant's served surplus (flushes and waits if an ingest for
        it is still queued or in flight)."""
        t = self._tenant(name)
        with self._lock:
            target = self._ingest_submitted.get(name, 0)
            behind = self._ingest_done.get(name, 0) < target
        if behind:
            self.flush()
            deadline = time.monotonic() + _DRAIN_TIMEOUT_S
            with self._work:
                while self._ingest_done.get(name, 0) < target:
                    if name not in self._tenants:
                        break
                    if not self._work.wait(1.0) \
                            and time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"surplus({name!r}): in-flight ingest did not "
                            f"complete within {_DRAIN_TIMEOUT_S:.0f}s")
            t = self._tenant(name)
        if t.surplus is None:
            raise RuntimeError(f"tenant {name!r} has no ingested state yet")
        return t.surplus

    # -- executable binding -------------------------------------------------

    def _bind(self, name: str, scheme: SchemeLike, spec: ExecSpec,
              plan) -> _Tenant:
        _base(plan, "CTEngine.register")
        spec.resolve_interpret(self.device)
        signature = plan_signature(plan, spec)
        executable, hit = _ingest_executable(signature, plan, spec)
        with self._lock:
            self._counters["cache_hits" if hit else "cache_misses"] += 1
        return _Tenant(name=name, scheme=scheme, spec=spec, plan=plan,
                       signature=signature, executable=executable,
                       binding=executable.bind(plan, self.device))

    def _check_not_donated(self, name: str, nodal_grids) -> None:
        """Raise the named ``IngestBuffersDonated`` if a grid of the payload
        is a tensor whose storage a donated ingest released, before
        anything reads it."""
        dead = [ell for ell, v in nodal_grids.items()
                if isinstance(v, torch.Tensor) and storage_released(v)]
        if dead:
            raise IngestBuffersDonated(
                f"{self._host()}: ingest for tenant {name!r} cannot be "
                f"dispatched: {len(dead)} input grid(s) (first: {dead[0]}) "
                f"were donated to an earlier ingest and their storage is "
                f"released (deleted) — resubmit from host copies")

    def _release_donated(self, tenant: _Tenant, nodal_grids, staged,
                         dtype: torch.dtype) -> None:
        """Release the storage of each caller's grid that the assembly read
        in place (``staged`` holds what it read), after ``record_stream``
        on the ingest's stream; warn once per tenant of the grids kept."""
        stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        kept = []
        for b in tenant.plan.buckets:
            for ell in b.ells:
                v = nodal_grids[ell]
                if not isinstance(v, torch.Tensor):
                    continue        # staged per call: nothing to hand over
                storage = v.untyped_storage()
                if staged[ell] is v and v.dtype == dtype \
                        and v.storage_offset() == 0 and storage.nbytes() \
                        == v.numel() * v.element_size() \
                        and storage.resizable():
                    if stream is not None:
                        v.record_stream(stream)
                    storage.resize_(0)
                else:
                    kept.append(ell)
        with self._lock:
            warn = bool(kept) and tenant.name not in self._donation_warned
            if warn:
                self._donation_warned.add(tenant.name)
        if warn:
            warnings.warn(
                f"{self._host()}: tenant {tenant.name!r} donated its ingest's "
                f"grids (ExecSpec(donate=True)), but {len(kept)} of them "
                f"(first: {kept[0]}) cannot be released and were kept: not "
                f"on {self.device} in {dtype}, a view into a larger "
                f"storage, or a storage that cannot be resized (numpy "
                f"memory)", stacklevel=3)

    def _dispatch_ingest(self, tenant: _Tenant, nodal_grids) -> torch.Tensor:
        _lockdep.note_dispatch("engine._dispatch_ingest")
        if tenant.spec.donate:
            self._check_not_donated(tenant.name, nodal_grids)
        grids, dtype = _grids_on(nodal_grids, tenant.plan, self.device)
        dtype = tenant.spec.result_dtype(dtype)
        surplus = tenant.executable(grids, tenant.binding, dtype, self.device)
        if tenant.spec.donate:
            self._release_donated(tenant, nodal_grids, grids, dtype)
        return surplus

    def _journal(self, name: str, seq: int, nodal_grids,
                 tag: Optional[int]) -> None:  # ctlint: holds(engine)
        """Append an admitted ingest to the store's WAL (the caller holds
        the lock, so journal order is admission order).  Its host copy
        would read a released grid: that raises first."""
        self._check_not_donated(name, nodal_grids)
        # ctlint: ok(block-under-lock): journal order must equal admission order
        self._store.append(name, seq, nodal_grids, tag=tag)

    # -- thread-safe submission ---------------------------------------------

    def _host(self) -> str:
        return f"engine[{self.host_id}]" if self.host_id else "engine"

    def _admit(self, block: bool, timeout: Optional[float],
               name: str) -> None:  # ctlint: holds(engine)
        """Bounded-queue admission control; the caller holds the lock."""
        if len(self._pending) < self._max_pending:
            return
        if not block:
            self._sched["rejected"] += 1
            raise EngineSaturated(
                f"{self._host()}: rejecting request for tenant {name!r}: "
                f"queue depth {len(self._pending)} >= max_pending="
                f"{self._max_pending}; flush(), start() the scheduler, "
                f"or raise max_pending")
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(self._pending) >= self._max_pending:
            if deadline is None:
                self._space.wait(0.1)
            else:
                left = deadline - time.monotonic()
                if left <= 0 or not self._space.wait(left):
                    if len(self._pending) < self._max_pending:
                        break
                    self._sched["rejected"] += 1
                    raise EngineSaturated(
                        f"{self._host()}: request for tenant {name!r} "
                        f"still blocked after {timeout:.3f}s: queue depth "
                        f"{len(self._pending)} >= max_pending="
                        f"{self._max_pending}")

    def submit_ingest(self, name: str, nodal_grids, *, priority: int = 0,
                      check_finite: Optional[bool] = None, block: bool = True,
                      timeout: Optional[float] = None,
                      tag: Optional[int] = None) -> CTFuture:
        """Enqueue new solver output for ``name`` (any thread); the future
        resolves to the new surplus once it is committed.  Ingests of one
        tenant apply in submission order; its later queries observe
        them.  With a store attached the payload is journaled here, at
        admission, before it can be acknowledged; a failed append (a torn
        record) fails the admission.  ``tag`` is the caller's own ordering
        tag, stored beside the engine's seq."""
        self._tenant(name)                      # raise early on a bad name
        check = self._check_finite if check_finite is None else check_finite
        fut = CTFuture(self)
        with self._work:
            self._admit(block, timeout, name)
            if name not in self._tenants:
                raise KeyError(f"no tenant {name!r} (registered: "
                               f"{sorted(self._tenants)})")
            seq = self._ingest_submitted.get(name, 0) + 1
            self._ingest_submitted[name] = seq
            if self._store is not None:
                try:
                    # under the lock: an append outside it could ack seq
                    # N+1 before N is on disk
                    self._journal(name, seq, nodal_grids, tag)
                except Exception:
                    self._ingest_submitted[name] = seq - 1
                    raise
            if tag is not None:
                self._last_tag[name] = tag
            self._pending.append(
                _Request("ingest", name, (nodal_grids, check, tag), fut,
                         ingest_seq=seq, priority=priority,
                         deadline=time.monotonic()))
            self._work_seq += 1
            self._work.notify_all()
        return fut

    def submit_query(self, name: str, points, *,
                     deadline_ms: Optional[float] = None,
                     priority: Optional[int] = None, block: bool = True,
                     timeout: Optional[float] = None,
                     stale_ok: bool = False) -> CTFuture:
        """Enqueue a point evaluation against ``name``'s surplus (any
        thread); the future resolves to the (Q,) values once the scheduler
        dispatches its signature group.  ``stale_ok=True`` waits only for
        the ingests already committed."""
        tenant = self._tenant(name)
        points = _validate_points(points, tenant.plan.dim, name)
        q = points.shape[0]
        if deadline_ms is None:
            deadline_ms = tenant.deadline_ms if tenant.deadline_ms \
                is not None else self._deadline_ms
        prio = tenant.priority if priority is None else priority
        fut = CTFuture(self)
        dl = (time.monotonic() + deadline_ms / 1000.0
              if deadline_ms is not None and math.isfinite(deadline_ms)
              else None)
        with self._work:
            self._admit(block, timeout, name)
            if name not in self._tenants:
                raise KeyError(f"no tenant {name!r} (registered: "
                               f"{sorted(self._tenants)})")
            watermark = (self._ingest_done if stale_ok
                         else self._ingest_submitted).get(name, 0)
            self._pending.append(
                _Request("query", name, (points, q, _qpad(q)), fut,
                         ingest_seq=watermark, priority=prio, deadline=dl))
            self._work_seq += 1
            self._work.notify_all()
        return fut

    def submit_probe(self, *, block: bool = False,
                     timeout: Optional[float] = None) -> CTFuture:
        """Liveness probe: a no-op request that rides the queue and
        resolves to ``True`` when a pump, a flush or the scheduler thread
        reaches it.  Wait on it with ``CTFuture.wait(deadline)``, not
        ``result()``, whose flush would mask a dead scheduler.  Always due,
        never coalesced, never counted as tenant work."""
        fut = CTFuture(self)
        with self._work:
            self._admit(block, timeout, "__probe__")
            self._pending.append(_Request("probe", "__probe__", None, fut,
                                          deadline=time.monotonic()))
            self._work_seq += 1
            self._work.notify_all()
        return fut

    def heartbeat(self) -> Dict[str, Any]:
        """Pump liveness: the time of the last scheduler pass, its age,
        the queue depth and whether the scheduler thread is alive.  A
        cluster's health monitor reads a stall from a growing ``age_s``."""
        now = time.monotonic()
        with self._lock:
            alive = (self._sched_thread is not None
                     and self._sched_thread.is_alive())
            return {"host_id": self.host_id,
                    "last_pump": self._last_pump,
                    "age_s": now - self._last_pump,
                    "pending": len(self._pending),
                    "scheduler_alive": alive}

    # -- draining: flush / pump / scheduler ---------------------------------

    def flush(self) -> None:
        """Drain the whole queue now and return once all of it completed.
        The queue swap is atomic under the engine lock; a failing request
        resolves its own future, siblings proceed."""
        with self._work:
            self._last_pump = time.monotonic()
            pending, self._pending = self._pending, []
            if pending:
                self._sched["flushes"] += 1
                self._space.notify_all()
        if pending:
            self._run(pending, drain=True)

    def pump(self, now: Optional[float] = None) -> int:
        """One scheduler step: dispatch only the due work (ingests always;
        queries on batch-full or deadline expiry).  Returns the number of
        requests resolved or handed to the pool."""
        with self._work:
            self._last_pump = time.monotonic()
            take, _ = self._take_due(time.monotonic() if now is None
                                     else now)
        if not take:
            return 0
        return self._run(take, drain=False)

    def start(self) -> "CTEngine":
        """Start the background scheduler thread (idempotent)."""
        with self._lock:
            if self._sched_thread is not None \
                    and self._sched_thread.is_alive():
                return self
            stop_evt = threading.Event()
            t = threading.Thread(target=self._scheduler_loop,
                                 args=(stop_evt,), name="ct-scheduler",
                                 daemon=True)
            self._stop_evt, self._sched_thread = stop_evt, t
        t.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler thread; ``drain=True`` flushes what is left."""
        with self._lock:
            t, evt = self._sched_thread, self._stop_evt
            self._sched_thread = self._stop_evt = None
        if evt is not None:
            evt.set()
            with self._work:
                self._work.notify_all()
        if t is not None:
            t.join(timeout=30.0)
        if drain:
            self.flush()

    def close(self) -> None:
        """Stop the scheduler, drain the queue, shut down a private pool;
        an attached store gets a final fsync (it belongs to the host, so
        it is flushed, not closed)."""
        self.stop(drain=True)
        if self._private_pool is not None:
            self._private_pool.shutdown(wait=True)
        if self._store is not None:
            try:
                self._store.flush()
            except OSError:
                pass        # a store removed at shutdown is moot

    def __enter__(self) -> "CTEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _scheduler_loop(self, stop_evt: threading.Event) -> None:
        while not stop_evt.is_set():
            now = time.monotonic()
            with self._work:
                self._last_pump = now
                seq = self._work_seq
                take, next_wake = self._take_due(now)
            if take:
                if self._run(take, drain=False) == 0:
                    # everything requeued (queries waiting on in-flight
                    # ingests): block briefly instead of spinning
                    with self._work:
                        if self._work_seq == seq:
                            self._work.wait(0.01)
                continue
            with self._work:
                if self._work_seq != seq:
                    continue                    # raced a submit: rescan
                delay = 0.05
                if next_wake is not None:
                    delay = min(delay, next_wake - time.monotonic())
                self._work.wait(max(delay, 0.001))

    def _take_due(self, now: float) -> Tuple[List[_Request],  # ctlint: holds(engine)
                                             Optional[float]]:
        """Pull the due requests off the queue; the caller holds the lock.
        Ingests are always due; a query when its tenant's pending batch is
        full, its deadline expired, or its tenant is gone; probes are always
        due.  The reference's two anti-head-of-line rules: a batch-full
        tenant contributes at most ``max_batch`` queries per pump (highest
        priority first), and when any query dispatches, every pending query
        of strictly higher priority is taken along."""
        pending = self._pending
        counts: Dict[str, int] = {}
        for r in pending:
            if r.kind == "query":
                counts[r.name] = counts.get(r.name, 0) + 1
        full = {n for n, c in counts.items() if c >= self._max_batch}
        self._sched["dispatch_batch_full"] += len(full)
        take_idx = set()
        for i, r in enumerate(pending):
            if r.kind != "query" or r.name not in self._tenants:
                take_idx.add(i)
            elif r.deadline is not None and r.deadline <= now:
                take_idx.add(i)
                self._sched["dispatch_deadline"] += 1
        for name in full:
            cand = [i for i, r in enumerate(pending)
                    if r.kind == "query" and r.name == name
                    and i not in take_idx]
            cand.sort(key=lambda i: (-pending[i].priority, i))
            take_idx.update(cand[:self._max_batch])
        due_q = [pending[i].priority for i in take_idx
                 if pending[i].kind == "query"]
        if due_q:
            pmax = max(due_q)
            for i, r in enumerate(pending):
                if i not in take_idx and r.kind == "query" \
                        and r.priority > pmax:
                    take_idx.add(i)
                    self._sched["promoted"] += 1
        take, keep = [], []
        next_wake: Optional[float] = None
        for i, r in enumerate(pending):
            if i in take_idx:
                take.append(r)
            else:
                keep.append(r)
                if r.deadline is not None and (next_wake is None
                                               or r.deadline < next_wake):
                    next_wake = r.deadline
        self._pending = keep
        if take:
            self._space.notify_all()
        return take, next_wake

    # -- execution ----------------------------------------------------------

    def _run(self, requests: List[_Request], drain: bool) -> int:
        """Per-tenant ingest chains go to the pool (or run inline), queries
        resolve on the calling thread; ``drain=True`` waits for the chains.
        Returns the number of requests resolved or handed to the pool."""
        chains: Dict[str, List[_Request]] = {}
        queries: List[_Request] = []
        probes = 0
        for r in requests:
            if r.kind == "ingest":
                chains.setdefault(r.name, []).append(r)
            elif r.kind == "probe":
                # the round trip to here is the signal a probe measures
                r.future._set(True)
                probes += 1
            else:
                queries.append(r)
        progress = probes + sum(len(c) for c in chains.values())
        pool = None if self._inline_ingest \
            else (self._private_pool or _shared_pool())
        chain_futures = []
        for reqs in chains.values():
            if pool is None:
                self._run_ingest_chain(reqs)
            else:
                chain_futures.append(pool.submit(self._run_ingest_chain,
                                                 reqs))
        try:
            progress += self._run_queries(queries, drain=drain)
        finally:
            if drain:
                for f in chain_futures:
                    f.result()      # engine bugs only; request errors
                    #                 resolved their own futures already
        return progress

    def _run_ingest_chain(self, reqs: List[_Request]) -> None:
        """One tenant's queued ingests, in order.  Every exit path advances
        the watermark and notifies, so a failed ingest still unblocks the
        queries waiting on it."""
        for req in reqs:
            grids, check, tag = req.payload
            committed = None
            try:
                surplus = self._ingest_one(req.name, grids, check,
                                           req.ingest_seq)
            except Exception as exc:
                req.future._set_error(exc)
            else:
                req.future._set(surplus)
                committed = surplus
            finally:
                with self._work:
                    if req.ingest_seq > self._ingest_done.get(req.name, 0):
                        self._ingest_done[req.name] = req.ingest_seq
                    self._work_seq += 1
                    self._work.notify_all()
            if committed is not None:
                # after the ack: a snapshot speeds up a later recovery and
                # never fails an ingest that succeeded, nor ends the chain
                try:
                    self._maybe_snapshot(req.name, req.ingest_seq, tag,
                                         committed)
                except Exception as exc:
                    self._snapshot_failed(req.name, req.ingest_seq, exc)

    def _ingest_one(self, name: str, nodal_grids, check_finite: bool,
                    seq: int = 0) -> torch.Tensor:
        """Dispatch and commit one ingest.  Device work runs outside the
        lock and is synchronised before the commit, a compare-and-swap on
        the tenant record read before dispatch, newest seq winning: an
        older ingest finishing last does not clobber a newer committed
        surplus (its future still gets its own value).  When the record
        changed meanwhile the ingest runs against the new one, as in the
        reference: a refit's record is retried, and so is a tenant
        unregistered and registered anew, unless the new record has the
        same plan signature and coefficients, whose surplus is bitwise the
        one already computed: that is committed without a second dispatch
        (on a slow host a churning tenant would otherwise exhaust the
        retries)."""
        def attempt():
            with self._lock:
                tenant = self._tenants.get(name)
            if tenant is None:
                raise KeyError(f"tenant {name!r} was unregistered before "
                               f"its queued ingest ran")
            # a donated payload released by an earlier attempt raises here
            # ctlint: ok(donate-reuse): _dispatch_ingest runs _check_not_donated on a donating tenant's payload before anything reads it
            surplus = self._dispatch_ingest(tenant, nodal_grids)
            # device failures surface here, on the owning request
            _synchronize(self.device)
            if check_finite and not bool(torch.isfinite(surplus).all()):
                if tenant.spec.donate:
                    raise IngestBuffersDonated(
                        f"ingest for tenant {name!r} produced non-finite "
                        f"surplus values and its input grids were donated "
                        f"— cannot retry; resubmit from host copies")
                raise FloatingPointError(
                    f"ingest for tenant {name!r} produced non-finite "
                    f"surplus values")
            with self._work:
                cur = self._tenants.get(name)
                if cur is None:
                    raise KeyError(f"tenant {name!r} was unregistered "
                                   f"before its queued ingest ran")
                if cur is tenant or (
                        cur.incarnation is not tenant.incarnation
                        and _same_ingest(cur, tenant)):
                    if seq >= cur.surplus_seq:
                        cur.surplus = surplus
                        cur.surplus_seq = seq
                    self._counters["ingests"] += 1
                    return surplus
                self._sched["ingest_retries"] += 1
                raise _RebindRace(name)
        try:
            return self._retry.run(attempt, retry_on=(_RebindRace,),
                                   sleep=False)
        except _RebindRace:
            raise RuntimeError(
                f"ingest for tenant {name!r} kept losing the rebind race "
                f"({self._retry.attempts} attempts) — engine bug") from None

    def _run_queries(self, queries: List[_Request], drain: bool) -> int:
        """Group the watermark-eligible queries by signature and dispatch;
        park the rest (requeue when pumping, wait for the in-flight ingests
        when draining)."""
        if not queries:
            return 0
        resolved = 0
        remaining = list(queries)
        give_up = time.monotonic() + _DRAIN_TIMEOUT_S
        while remaining:
            groups: Dict[Tuple, List[Tuple[_Request, torch.Tensor]]] = {}
            waiting: List[_Request] = []
            with self._lock:
                for req in remaining:
                    t = self._tenants.get(req.name)
                    if t is None:
                        req.future._set_error(KeyError(
                            f"tenant {req.name!r} was unregistered before "
                            f"its queued query ran"))
                        resolved += 1
                        continue
                    if self._ingest_done.get(req.name, 0) < req.ingest_seq:
                        waiting.append(req)     # its ingest is in flight
                        continue
                    if t.surplus is None:
                        if self._ingest_done.get(req.name, 0) < \
                                self._ingest_submitted.get(req.name, 0):
                            waiting.append(req)
                            continue
                        req.future._set_error(RuntimeError(
                            f"tenant {req.name!r} has no ingested state "
                            f"to query"))
                        resolved += 1
                        continue
                    points, _, qpad = req.payload
                    key = (tuple(t.surplus.shape), str(t.surplus.dtype),
                           str(points.dtype), qpad)
                    groups.setdefault(key, []).append((req, t.surplus))
            if groups:
                resolved += self._dispatch_query_groups(groups)
            if not waiting:
                break
            if not drain:
                with self._work:
                    self._pending[:0] = waiting
                    self._sched["requeued"] += len(waiting)
                break
            with self._work:
                def _unblocked(r):
                    t = self._tenants.get(r.name)
                    if t is None:
                        return True
                    done = self._ingest_done.get(r.name, 0)
                    return done >= r.ingest_seq and (
                        t.surplus is not None
                        or done >= self._ingest_submitted.get(r.name, 0))
                if not any(_unblocked(r) for r in waiting):
                    self._work.wait(0.05)
                    if time.monotonic() >= give_up:
                        for r in waiting:
                            r.future._set_error(TimeoutError(
                                f"query for tenant {r.name!r} timed out "
                                f"waiting for its in-flight ingest"))
                        resolved += len(waiting)
                        break
            remaining = waiting
        return resolved

    def _dispatch_query_groups(self, groups) -> int:
        """Eval batches of the signature groups, highest priority and
        earliest deadline first, chunked to ``max_batch`` and at priority
        boundaries.  Each request of a chunk is evaluated on its own (its
        tenant's surplus, its unpadded points: the one-tenant query's
        call), then the chunk is synchronised so a device failure fails
        the chunk's futures.  After each chunk the queries queued since
        with a strictly higher priority run at once (``_run_urgent``).
        Runs outside the lock."""
        _lockdep.note_dispatch("engine._dispatch_query_groups")

        def group_rank(item):
            entries = item[1]
            return (-max(r.priority for r, _ in entries),
                    min((r.deadline if r.deadline is not None else math.inf)
                        for r, _ in entries))

        count = 0
        for _, entries in sorted(groups.items(), key=group_rank):
            entries.sort(key=lambda e: (
                -e[0].priority,
                e[0].deadline if e[0].deadline is not None else math.inf))
            chunks: List[List] = []
            for e in entries:
                if chunks and len(chunks[-1]) < self._max_batch \
                        and chunks[-1][0][0].priority == e[0].priority:
                    chunks[-1].append(e)
                else:
                    chunks.append([e])
            for chunk in chunks:
                try:
                    outs = [interpolate_hierarchical(
                        surplus, torch.from_numpy(r.payload[0]).to(
                            self.device)) for r, surplus in chunk]
                    _synchronize(self.device)
                except Exception as exc:
                    for r, _ in chunk:
                        r.future._set_error(exc)
                else:
                    for (r, _), out in zip(chunk, outs):
                        r.future._set(lambda out=out: out.cpu().numpy())
                    with self._lock:
                        self._counters["eval_batches"] += 1
                        self._counters["queries"] += len(chunk)
                        self._counters["coalesced_queries"] += len(chunk) - 1
                count += len(chunk)
                count += self._run_urgent(chunk[0][0].priority)
        return count

    def _run_urgent(self, priority: int) -> int:
        """Dispatch, between two chunks of a pass, the queued queries whose
        priority is strictly above the chunk's: the reference's promotion
        rule, applied to work that arrived during the pass (one pass over a
        deep queue evaluates each request on its own, so it can take long
        enough to starve a health probe).  The pass proves the scheduler
        alive, so the heartbeat is stamped here too."""
        with self._work:
            self._last_pump = time.monotonic()
            urgent = [r for r in self._pending
                      if r.kind == "query" and r.priority > priority]
            if not urgent:
                return 0
            self._pending = [r for r in self._pending
                             if not (r.kind == "query"
                                     and r.priority > priority)]
            self._sched["promoted"] += len(urgent)
            self._space.notify_all()
        return self._run_queries(urgent, drain=False)

    # -- synchronous conveniences -------------------------------------------

    def update(self, name: str, nodal_grids) -> torch.Tensor:
        """Synchronous re-ingest (same scheme: same executable)."""
        fut = self.submit_ingest(name, nodal_grids)
        self.flush()
        return fut.result()

    def query(self, name: str, points) -> np.ndarray:
        """Synchronous point query (a one-tenant batch)."""
        fut = self.submit_query(name, points)
        self.flush()
        return fut.result()

    # -- lifecycle: incremental plan paths per tenant -----------------------

    def refit(self, name: str, scheme: SchemeLike, nodal_grids) -> None:
        """Swap tenant ``name`` onto a (refined) scheme through the
        incremental ``extend_plan`` path, re-binding the shared executable.
        A failing ingest raises before any tenant state changes."""
        tenant = self._tenant(name)
        plan = extend_plan(tenant.plan, scheme, spec=tenant.spec)
        self._commit(tenant, scheme, plan, nodal_grids)

    def extend(self, name: str, new_levels, nodal_grids) -> None:
        """Grow tenant ``name``'s downward-closed index set by
        ``new_levels`` (``refit`` onto ``scheme.with_levels``)."""
        scheme = self._tenant(name).scheme
        if not hasattr(scheme, "with_levels"):
            scheme = scheme.as_general()
        self.refit(name, scheme.with_levels(new_levels), nodal_grids)

    def drop_grid(self, name: str, failed, nodal_grids) -> None:
        """Recombine tenant ``name`` without grid(s) ``failed``
        (``recombine_after_fault``: coefficient-only when possible, so the
        plan's tables and the executable are reused).  Raises and leaves
        the tenant unchanged when the reduced scheme needs data the caller
        did not supply."""
        from repro_torch.runtime.fault_tolerance import recombine_after_fault
        tenant = self._tenant(name)
        scheme, plan, _ = recombine_after_fault(tenant.scheme, failed,
                                                plan=tenant.plan)
        self._commit(tenant, scheme, plan, nodal_grids)

    def rebind(self, name: str, *, mesh: Any = _UNSET,
               axis_name: Any = _UNSET, n_slabs: Any = _UNSET,
               member_axis: Any = _UNSET) -> str:
        """Move tenant ``name`` onto another mesh or slab layout WITHOUT
        recomputing its surplus: the base plan is re-sharded incrementally
        (``shard_plan(..., old=)`` reuses unchanged slab buckets), the
        signature-shared executable is re-bound, and the served surplus
        (the gathered fine grid) carries over; queued queries keep
        resolving.  Returns ``"kept"`` (spec unchanged), ``"sharded"``,
        ``"resharded"``, ``"unsharded"`` or ``"rebound"``."""
        tenant = self._tenant(name)
        changes = {k: v for k, v in (
            ("mesh", mesh), ("axis_name", axis_name), ("n_slabs", n_slabs),
            ("member_axis", member_axis)) if v is not _UNSET}
        new_spec = dataclasses.replace(tenant.spec, **changes) \
            if changes else tenant.spec
        if new_spec == tenant.spec:
            return "kept"
        was_sharded = isinstance(tenant.plan, ShardedPlan)
        if new_spec.slabs > 1 or new_spec.groups > 1:
            plan = shard_plan(tenant.base_plan, new_spec.slabs,
                              old=tenant.plan if was_sharded else None,
                              n_groups=new_spec.groups)
            outcome = "resharded" if was_sharded else "sharded"
        else:
            plan = tenant.base_plan
            outcome = "unsharded" if was_sharded else "rebound"
        nxt = self._bind(name, tenant.scheme, new_spec, plan)
        nxt.deadline_ms, nxt.priority = tenant.deadline_ms, tenant.priority
        nxt.incarnation = tenant.incarnation
        with self._work:
            if self._tenants.get(name) is not tenant:
                raise RuntimeError(
                    f"tenant {name!r} changed during rebind (concurrent "
                    f"refit/unregister) — retry")
            # carried over, no recompute: under the lock, so an ingest
            # committing meanwhile is not lost (it then retries onto nxt)
            nxt.surplus, nxt.surplus_seq = tenant.surplus, tenant.surplus_seq
            self._tenants[name] = nxt
            self._work_seq += 1
            self._work.notify_all()
        return outcome

    def _commit(self, tenant: _Tenant, scheme: SchemeLike,
                plan: ExecutorPlan, nodal_grids) -> None:
        """Re-bind a tenant onto (scheme, plan) and ingest: bind and device
        work outside the lock, the record swap one locked step keyed by
        name (queued work picks up the new record at dispatch)."""
        nxt = self._bind(tenant.name, scheme, tenant.spec, plan)
        nxt.deadline_ms, nxt.priority = tenant.deadline_ms, tenant.priority
        nxt.incarnation = tenant.incarnation
        surplus = self._dispatch_ingest(nxt, nodal_grids)  # raises first
        _synchronize(self.device)
        nxt.surplus = surplus
        with self._work:
            if tenant.name not in self._tenants:
                raise KeyError(f"tenant {tenant.name!r} was unregistered "
                               f"during refit")
            self._counters["ingests"] += 1
            self._tenants[tenant.name] = nxt
            self._work_seq += 1
            self._work.notify_all()
        if self._store is not None:
            # the scheme changed: refresh the durable identity and snapshot
            # at once, superseding every WAL entry journaled against the
            # old scheme (its grids would fail the new plan's validation)
            name = tenant.name
            self._store.register(name, scheme,
                                 full_levels=nxt.plan.full_levels,
                                 deadline_ms=nxt.deadline_ms,
                                 priority=nxt.priority)
            with self._lock:
                seq = self._ingest_submitted.get(name, 0)
                tag = self._last_tag.get(name)
            self._snapshot_now(name, seq, tag, surplus, scheme=scheme,
                               full_levels=nxt.plan.full_levels)

    # -- durability: snapshot / restore / replay ----------------------------

    def _snapshot_now(self, name: str, seq: int, tag: Optional[int],
                      surplus, *, scheme: SchemeLike,
                      full_levels) -> Optional[str]:
        """Best-effort durable snapshot.  A failed snapshot (disk trouble,
        the injected crash-mid-snapshot) never fails serving: the previous
        snapshot and the WAL still cover every acked ingest, so the failure
        is recorded and swallowed."""
        if self._store is None:
            return None
        try:
            path = self._store.snapshot(
                name, seq, surplus, tag=-1 if tag is None else int(tag),
                scheme=scheme, full_levels=full_levels)
        except Exception as exc:
            self._snapshot_failed(name, seq, exc)
            return None
        with self._lock:
            if seq > self._snap_seq.get(name, 0):
                self._snap_seq[name] = seq
        return path

    def _snapshot_failed(self, name: str, seq: int, exc: Exception) -> None:
        """Record a snapshot that raised: an event in the store's log and
        the ``snapshot_errors`` count of ``stats()["durability"]``."""
        with self._lock:
            self._counters["snapshot_errors"] += 1
        self._store.events.append(
            f"{self._host()}: snapshot of tenant {name!r} at seq {seq} "
            f"failed ({exc!r}); previous snapshot + WAL still cover all "
            f"acked ingests")

    def _maybe_snapshot(self, name: str, seq: int, tag: Optional[int],
                        surplus) -> None:
        """Snapshot when the done watermark advanced ``snapshot_interval``
        past the last snapshot (the ingest chain calls this after the ack).
        The claim on ``_snap_seq`` is taken under the lock, so concurrent
        chains of one tenant snapshot once; a failed snapshot undoes it."""
        if self._store is None or self._snapshot_interval <= 0:
            return
        with self._lock:
            last = self._snap_seq.get(name, 0)
            tenant = self._tenants.get(name)
            if tenant is None or seq - last < self._snapshot_interval:
                return
            self._snap_seq[name] = seq          # claim before the IO
            scheme = tenant.scheme
            full_levels = tenant.plan.full_levels
        if self._snapshot_now(name, seq, tag, surplus, scheme=scheme,
                              full_levels=full_levels) is None:
            with self._lock:
                if self._snap_seq.get(name, 0) == seq:
                    self._snap_seq[name] = last     # un-claim: retry later

    def snapshot_tenant(self, name: str, *,
                        tag: Optional[int] = None) -> Optional[str]:
        """Force a durable snapshot of ``name``'s served surplus at the
        current watermark (``None`` without a store or without state)."""
        if self._store is None:
            return None
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None or tenant.surplus is None:
                return None
            seq = self._ingest_submitted.get(name, 0)
            if tag is None:
                tag = self._last_tag.get(name)
            scheme = tenant.scheme
            full_levels = tenant.plan.full_levels
            surplus = tenant.surplus
        return self._snapshot_now(name, seq, tag, surplus, scheme=scheme,
                                  full_levels=full_levels)

    def restore(self, store: Optional[DurableStore] = None, *,
                specs=None, names=None,
                replay: bool = True) -> Dict[str, RestoreInfo]:
        """Rebuild tenants from a durable store: adopt each tenant's newest
        intact snapshot onto the engine's device, then replay the WAL
        entries newer than it through the normal ingest executable, so the
        restored surplus is bitwise that of an engine that never crashed.

        ``specs`` maps a tenant name to its ``ExecSpec`` (a dict or a
        callable; the engine default otherwise).  ``replay=False`` defers
        the replay to an explicit ``replay()``: until then ``stale_ok``
        queries serve the snapshot, and other queries wait on the admitted
        watermark as behind a long ingest queue."""
        store = store if store is not None else self._store
        if store is None:
            raise ValueError("restore: no store attached and none given")
        out: Dict[str, RestoreInfo] = {}
        for name in store.tenants():
            if names is not None and name not in names:
                continue
            t0 = time.monotonic()
            state = store.load(name)
            if callable(specs):
                spec = specs(name)
            elif isinstance(specs, dict):
                spec = specs.get(name)
            else:
                spec = None
            spec = spec or self._default_spec
            plan = build_plan(state.scheme, state.full_levels, spec=spec)
            self.register(
                name, state.scheme, spec=spec, plan=plan,
                surplus=(None if state.surplus is None
                         else torch.from_numpy(state.surplus)),
                deadline_ms=state.deadline_ms, priority=state.priority,
                durable=False)      # its durable state is this store
            with self._work:
                base = max(state.max_seq,
                           self._ingest_submitted.get(name, 0))
                self._ingest_submitted[name] = base
                self._ingest_done[name] = \
                    max(state.snapshot_seq, self._ingest_done.get(name, 0))
                self._snap_seq[name] = state.snapshot_seq
                if state.max_tag >= 0:
                    self._last_tag[name] = state.max_tag
                self._tenants[name].surplus_seq = state.snapshot_seq
                if state.entries:
                    self._replay_pending[name] = list(state.entries)
                self._work_seq += 1
                self._work.notify_all()
            out[name] = RestoreInfo(
                name=name, snapshot_seq=state.snapshot_seq,
                base_seq=state.max_seq, tag=state.max_tag,
                snapshot_tag=state.snapshot_tag,
                pending=len(state.entries), replayed=0,
                restore_s=time.monotonic() - t0, replay_s=0.0,
                events=tuple(state.events))
        if replay:
            replayed = self.replay(
                names=list(out) if names is None else list(names))
            for name, r in replayed.items():
                if name in out:
                    out[name] = dataclasses.replace(
                        out[name], replayed=r["replayed"],
                        replay_s=r["seconds"])
        return out

    def replay(self, names=None) -> Dict[str, Dict[str, Any]]:
        """Apply the deferred WAL entries of ``restore(replay=False)``
        through the normal ingest executable, advancing the done watermark
        per entry (newest seq wins against a live ingest submitted after
        the restore).  An entry whose surplus is not finite under
        ``check_finite`` is skipped, as its live ingest would have failed;
        the watermark still advances."""
        if names is None:
            with self._lock:
                names = list(self._replay_pending)
        out: Dict[str, Dict[str, Any]] = {}
        for name in names:
            with self._lock:
                entries = self._replay_pending.pop(name, [])
            t0 = time.monotonic()
            applied, skipped, last_tag = 0, 0, None
            for e in entries:
                with self._lock:
                    tenant = self._tenants.get(name)
                if tenant is None:
                    break               # unregistered mid-replay: moot
                surplus = self._dispatch_ingest(tenant, e.grids)
                _synchronize(self.device)
                if self._check_finite and \
                        not bool(torch.isfinite(surplus).all()):
                    with self._work:
                        if e.seq > self._ingest_done.get(name, 0):
                            self._ingest_done[name] = e.seq
                        self._work_seq += 1
                        self._work.notify_all()
                    skipped += 1
                    continue
                with self._work:
                    cur = self._tenants.get(name)
                    if cur is not None and e.seq >= cur.surplus_seq:
                        cur.surplus = surplus
                        cur.surplus_seq = e.seq
                    if e.seq > self._ingest_done.get(name, 0):
                        self._ingest_done[name] = e.seq
                    if e.tag >= 0:
                        self._last_tag[name] = e.tag
                    self._counters["ingests"] += 1
                    self._work_seq += 1
                    self._work.notify_all()
                applied += 1
                if e.tag >= 0:
                    last_tag = e.tag
            out[name] = {"replayed": applied, "skipped": skipped,
                         "seconds": time.monotonic() - t0,
                         "last_tag": last_tag}
        return out

    @property
    def store(self) -> Optional[DurableStore]:
        return self._store

    # -- accounting ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Per-tenant and summed ``plan_launch_stats`` (one ingest's
        launches and bytes on CUDA), the shared executable cache's
        counters, the eval batching counters and the scheduler's."""
        with self._lock:
            tenants = dict(self._tenants)
            counters = dict(self._counters)
            sched = dict(self._sched)
            pending = len(self._pending)
        per_tenant = {}
        gather = {"buckets": 0, "members": 0, "launches": 0,
                  "pallas_launches": 0, "einsum_dispatches": 0,
                  "scatter_dispatches": 0, "transform_bytes": 0,
                  "stack_bytes": 0}
        for name, t in tenants.items():
            s = plan_launch_stats(t.plan, fused=t.spec.fused)
            per_tenant[name] = s
            for k in gather:
                gather[k] += s[k]
        # the LIVE tenants' executables: one evicted from the cache keeps
        # serving its tenants
        uniq = {id(t.executable) for t in tenants.values()}
        with _INGEST_CACHE_LOCK:
            cache_entries = len(_INGEST_EXECUTABLES)
        return {
            "host_id": self.host_id,
            "tenants": len(tenants),
            "per_tenant": per_tenant,
            "gather": gather,
            "ingests": counters["ingests"],
            "ingest_cache": {
                "entries": cache_entries,
                "hits": counters["cache_hits"],
                "misses": counters["cache_misses"],
                "executables": len(uniq),
            },
            "eval": {
                "queries": counters["queries"],
                "batches": counters["eval_batches"],
                "coalesced_queries": counters["coalesced_queries"],
            },
            "scheduler": {
                "pending": pending,
                "max_batch": self._max_batch,
                "max_pending": self._max_pending,
                "deadline_ms": self._deadline_ms,
                **sched,
            },
            "durability": (None if self._store is None else {
                "snapshot_interval": self._snapshot_interval,
                "snapshot_errors": counters["snapshot_errors"],
                "replay_pending": {n: len(v) for n, v
                                   in self._replay_pending.items()},
                **self._store.stats(),
            }),
        }
