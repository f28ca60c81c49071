"""Machine-readable registry of the port's concurrency and bit-identity
invariants.

The single source of truth that both the static pass
(``repro_torch.analysis.locklint``) and the runtime sanitizer
(``repro_torch.analysis.lockdep``) consume; the threading notes in the
docstrings of ``core/engine.py`` and ``runtime/cluster.py`` point here.
It is the reference's registry (``repro.analysis.invariants``) rewritten
for the port's names.  Plain data, standard library only: no torch, so
the linter and the lock seams stay usable from any context.

Lock classes and ranks
----------------------
A lock may only be acquired while holding locks of *strictly lower*
rank (a reentrant re-acquire of the same class excepted)::

    cluster(10) -> engine(20) -> future(30) -> store(40)
        -> plan-cache(50) -> ingest-cache(60) -> shared-pool(61)
        -> warn-once(62) -> ingest-tables(70) -> plan-tables(71)
        -> two-d-tables(72) -> owner-tables(73) -> kernel-build(90)

The first eight classes and ranks are the reference's.  The port adds
five leaves the reference has no twin of (its device tables are XLA
constants): the per-device tables of an ingest executable, the per-plan
table cache, the 2-D ingest's per-group tables, the owner tables'
per-device tensors, and the lock ``kernels/_build.py`` takes at every
launch (``kernel`` -> ``load_all``) and holds across the nvcc builds and
library loads of a process's first.  Their ranks sit above every class
the sanitizer recorded them under (on the CPU tests and in the card
phase of ``chip_smoke.py``: the cluster lock, over the registrations
and launches of its barriers); the build lock ranks last, since a launch
can happen anywhere a dispatch can, inside a cluster barrier included
(an engine dispatches outside its own lock).  No lock is taken while one
of these leaves is held.

Rule identifiers
----------------
``lock-order``            nested ``with`` acquiring a lock of rank <=
                          a held lock's rank (wrong direction).
``lock-order-call``       call whose (transitive or registered
                          external) summary acquires a lock of rank <=
                          a held lock's rank.
``block-under-lock``      blocking primitive (a device synchronisation,
                          ``.item()``/``.tolist()``, ``Future.result``,
                          ``join``, ``sleep``, fsync-backed store IO,
                          synchronous engine control-plane methods,
                          ...) executed while any registered lock is
                          held.
``dispatch-under-lock``   device dispatch (the ingest executable, the
                          query evaluation, a batched transform) while
                          any registered lock is held.
``wait-wrong-lock``       ``Condition.wait``/``wait_for`` without
                          holding the condition's owning lock.
``notify-outside-lock``   ``Condition.notify``/``notify_all`` without
                          holding the owning lock.
``blocking-submit-under-lock``  ``submit_ingest``/``submit_query``/
                          ``submit_probe`` under the cluster lock
                          without an explicit ``block=False``.
``donate-reuse``          a donating dispatch that can run more than
                          once for the same payload (retry wrapper or
                          loop whose payload does not derive from the
                          loop variable) without a preceding
                          donation guard.
``bit-identity-reassoc``  reassociating or unordered reduction
                          (``torch.sum``, ``index_add_``,
                          ``scatter_add_``, ...) inside a function on
                          the left-fold scatter path, or an atomic add
                          in a CUDA source of that path.

Blocking names
--------------
The reference's ``block_until_ready`` becomes the port's blocking forms:
``synchronize`` (``torch.cuda.synchronize``, ``Stream``/``Event``
``.synchronize``), the engine's ``_synchronize`` and the implicit syncs
``.item()`` and ``.tolist()``.  ``.cpu()`` and ``.numpy()`` are left out:
on the port's payload paths they mostly run on host tensors and arrays,
and the WAL's device-to-host copies are covered by the store's
``append`` summary, as in the reference.

Pragmas
-------
``# ctlint: ok(rule[,rule2...])[: justification]`` on the offending
line (or the line directly above it) suppresses the named rules at
that site; in a CUDA source the pragma is a ``//`` comment.
``# ctlint: holds(lockname)`` on a ``def`` line declares that the
function is only ever called with that lock already held (the
``_locked`` helper convention), so the intra-procedural pass starts
with it in the held set.
"""

from __future__ import annotations

# --------------------------------------------------------------------
# Lock classes.
# --------------------------------------------------------------------

#: lock class -> rank.  Acquire order must be strictly increasing.
LOCK_RANKS = {
    "cluster": 10,        # runtime/cluster.py CTCluster._lock (RLock)
    "engine": 20,         # core/engine.py CTEngine._lock/_work/_space
    "future": 30,         # runtime/cluster.py ClusterFuture._flock
    "store": 40,          # runtime/durability.py DurableStore._lock
    "plan-cache": 50,     # core/executor.py _PlanCache._lock
    "ingest-cache": 60,   # core/engine.py _INGEST_CACHE_LOCK
    "shared-pool": 61,    # core/engine.py _SHARED_POOL_LOCK
    "warn-once": 62,      # core/executor.py _WARNED_LEGACY_LOCK
    "ingest-tables": 70,  # core/engine.py _IngestExecutable._lock
    "plan-tables": 71,    # core/executor.py _PLAN_TABLES_LOCK
    "two-d-tables": 72,   # core/distributed.py TwoDTables._lock
    "owner-tables": 73,   # kernels/hierarchize.py OwnerTable._lock
    "kernel-build": 90,   # kernels/_build.py _BUILD_LOCK
}

#: What each class guards, by the file that creates it.
LOCK_GUARDS = {
    "cluster": ("runtime/cluster.py", "placement, host states, the "
                "tenant records and the open futures"),
    "engine": ("core/engine.py", "tenant registry, request queue, "
               "watermarks and counters (the _work/_space conditions "
               "share it)"),
    "future": ("runtime/cluster.py", "one ClusterFuture's inner future "
               "and its resolution"),
    "store": ("runtime/durability.py", "the tenant index, WAL segments "
              "and snapshots of one DurableStore"),
    "plan-cache": ("core/executor.py", "the LRU of host-side plans"),
    "ingest-cache": ("core/engine.py", "the LRU of ingest executables "
                     "shared by every engine"),
    "shared-pool": ("core/engine.py", "the lazy process-wide ingest "
                    "pool"),
    "warn-once": ("core/executor.py", "the legacy-keyword warnings "
                  "already given"),
    "ingest-tables": ("core/engine.py", "an ingest executable's device "
                      "tables, per device"),
    "plan-tables": ("core/executor.py", "the per-plan table cache "
                    "keyed by the plan's index arrays"),
    "two-d-tables": ("core/distributed.py", "the 2-D ingest's per-group "
                     "tables on each device"),
    "owner-tables": ("kernels/hierarchize.py", "an owner table's "
                     "tensors, per device"),
    "kernel-build": ("kernels/_build.py", "the nvcc builds and ctypes "
                     "loads of the kernel libraries"),
}

#: lock classes backed by an RLock (same-class re-acquire is legal).
REENTRANT_LOCKS = frozenset({"cluster", "engine", "store"})

#: Classification of source expressions to lock classes, per file.
#: Entries are (path_suffix, expr_suffix, lock_class, is_condition,
#: enclosing_class).  An expression matches when the file path ends with
#: ``path_suffix``, the unparsed ``with``-item expression equals or ends
#: with ``expr_suffix`` and, where ``enclosing_class`` is set, the code
#: sits in that class.  First match wins: the engine conditions come
#: before the generic ``._lock``, and ``core/engine.py``'s two
#: ``self._lock``s are told apart by their class.
LOCK_PATTERNS = (
    ("core/engine.py", "._work", "engine", True, None),
    ("core/engine.py", "._space", "engine", True, None),
    ("core/engine.py", "._lock", "ingest-tables", False,
     "_IngestExecutable"),
    ("core/engine.py", "._lock", "engine", False, "CTEngine"),
    ("core/engine.py", "_INGEST_CACHE_LOCK", "ingest-cache", False, None),
    ("core/engine.py", "_SHARED_POOL_LOCK", "shared-pool", False, None),
    ("core/executor.py", "_WARNED_LEGACY_LOCK", "warn-once", False, None),
    ("core/executor.py", "_PLAN_TABLES_LOCK", "plan-tables", False, None),
    ("core/executor.py", "._lock", "plan-cache", False, None),
    ("core/distributed.py", "._lock", "two-d-tables", False, None),
    ("kernels/hierarchize.py", "._lock", "owner-tables", False, None),
    ("kernels/_build.py", "_BUILD_LOCK", "kernel-build", False, None),
    ("runtime/cluster.py", "._flock", "future", False, None),
    ("runtime/cluster.py", "._lock", "cluster", False, None),
    ("runtime/durability.py", "._lock", "store", False, None),
)


def classify_lock(path: str, expr: str, class_name=None):
    """Map an unparsed ``with``-item expression to a lock class.

    Returns ``(lock_class, is_condition)`` or ``None`` when the
    expression is not a known lock.  ``path`` uses forward slashes;
    ``class_name`` is the class the expression's code sits in (``None``
    at module level).
    """
    for suffix, tail, name, is_cond, owner in LOCK_PATTERNS:
        if (path.endswith(suffix)
                and (expr == tail or expr.endswith(tail))
                and (owner is None or owner == class_name)):
            return name, is_cond
    return None


# --------------------------------------------------------------------
# External call summaries.
# --------------------------------------------------------------------
# The static pass is intra-module; cross-module effects are declared
# here.  A call is matched by (receiver suffix, method name): the
# unparsed receiver expression must end with the suffix.

#: CTEngine public/entry methods that take the engine lock.  Matched
#: on receivers ending in "engine" (``host.engine.X``, ``engine.X``,
#: ``self._engine.X``).
ENGINE_LOCKING_METHODS = frozenset({
    "submit_ingest", "submit_query", "submit_probe",
    "register", "unregister", "refit", "extend", "drop_grid",
    "rebind", "update", "query", "flush", "pump", "start", "stop",
    "close", "heartbeat", "stats", "surplus", "restore", "replay",
    "snapshot_tenant",
})

#: CTEngine methods that can block (drain queues, run device work,
#: join worker threads, or do disk IO) in addition to locking.
ENGINE_BLOCKING_METHODS = frozenset({
    "register",        # synchronous initial ingest when grids given
    "refit", "extend", "drop_grid", "rebind",   # drain + re-dispatch
    "update", "query", "surplus",               # synchronous device work
    "flush", "stop", "close",                   # drain / join workers
    "restore", "replay",                        # WAL read + re-dispatch
    "snapshot_tenant", "unregister",            # device->host copy / IO
})

#: DurableStore methods (receivers ending in "store" / "_store").
STORE_LOCKING_METHODS = frozenset({
    "register", "discard", "append", "flush", "snapshot", "load",
    "pending_after", "tenants", "stats", "close",
})

#: DurableStore methods that hit the disk (fsync / rmtree / read).
STORE_BLOCKING_METHODS = frozenset({
    "append", "flush", "snapshot", "load", "pending_after",
    "discard", "close",
})

#: ClusterFuture leaf-lock helpers callable on any receiver.
FUTURE_LOCKING_METHODS = frozenset({
    "_finalize_locked", "_retarget_locked",
})


def external_call_effects(receiver: str, method: str):
    """Summarize a cross-object call ``receiver.method(...)``.

    Returns ``(acquires, blocks)`` where ``acquires`` is a lock class
    or ``None`` and ``blocks`` is a bool.  Matching is by receiver
    suffix so ``host.engine``, ``self._engine`` and a bare ``engine``
    local all resolve the same way.
    """
    if method in FUTURE_LOCKING_METHODS:
        return "future", False
    if receiver.endswith("engine") and method in ENGINE_LOCKING_METHODS:
        return "engine", method in ENGINE_BLOCKING_METHODS
    if receiver.endswith("store") and method in STORE_LOCKING_METHODS:
        return "store", method in STORE_BLOCKING_METHODS
    return None, False


# --------------------------------------------------------------------
# Blocking / dispatch primitives (direct calls).
# --------------------------------------------------------------------

#: Attribute or function names that block the calling thread.
BLOCKING_CALL_NAMES = frozenset({
    "synchronize",         # torch.cuda / Stream / Event synchronize
    "_synchronize",        # core/engine.py: the stream of this thread
    "item",                # device -> host scalar (implicit sync)
    "tolist",              # device -> host list (implicit sync)
    "result",              # concurrent.futures / ClusterFuture
    "join",                # thread join
    "sleep",               # time.sleep
    "shutdown",            # executor shutdown(wait=True)
})

#: Attribute/function names that launch device work.  ``locklint``
#: flags these under ANY held lock; ``lockdep.note_dispatch`` is the
#: runtime twin.
DISPATCH_CALL_NAMES = frozenset({
    "_dispatch_ingest",        # core/engine.py: the ingest executable
    "_dispatch_query_groups",  # core/engine.py: the query evaluation
    "hierarchize_batched",     # kernels/hierarchize.py
    "interpolate_hierarchical",           # core/interpolation.py
    "interpolate_hierarchical_batched",   # core/interpolation.py
})

#: Cluster submit entry points that must pass block=False when
#: invoked under the cluster lock (rule blocking-submit-under-lock).
CLUSTER_SUBMIT_METHODS = frozenset({
    "submit_ingest", "submit_query", "submit_probe",
})

# --------------------------------------------------------------------
# Donation safety.
# --------------------------------------------------------------------

#: Calls that hand buffers to the donating ingest.  The donated payload
#: is the *second* positional argument
#: (``self._dispatch_ingest(tenant, nodal_grids)``).
DONATING_CALLS = frozenset({"_dispatch_ingest"})

#: Index of the donated-payload argument in a donating call.
DONATED_ARG_INDEX = 1

#: Guard calls that make a repeated donating dispatch safe: the engine's
#: check, and ``storage_released`` (the port's twin of ``is_deleted``).
DONATION_GUARDS = frozenset({"_check_not_donated", "storage_released"})

# --------------------------------------------------------------------
# Bit-identity (the left-fold scatter order).
# --------------------------------------------------------------------

#: Function-name prefixes on the bit-identical scatter path.  The
#: documented NON-bit-identical path (``gather_full_psum`` /
#: ``ct_transform_psum``) is deliberately absent.
BIT_CRITICAL_FUNC_PREFIXES = (
    "_gather_unfused",       # core/executor.py unfused bucket fold
    "gather_slab_scatter",   # core/distributed.py (also _fused, _2d)
    "_finish_slab_gather",   # core/distributed.py
    "hier_axis0_scatter",    # kernels/hierarchize.py row 9's wrapper
    "hier_scatter_grouped",  # kernels/hierarchize.py grouped scatter
    "owner_fold",            # kernels/hierarchize.py row 12's wrapper
    "_axis_scatter_plain",   # kernels/hierarchize.py row 9's plain fold
)

#: Reassociating or unordered reductions forbidden inside bit-critical
#: functions: the reference's names, plus torch's index/scatter
#: accumulations (atomics on CUDA, so unordered unless each call's map
#: is injective and the calls run in member order).
FORBIDDEN_REASSOC_NAMES = frozenset({
    "sum", "nansum", "psum", "segment_sum", "cumsum", "einsum",
    "logsumexp", "mean",
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_put_",
})

#: The CUDA sources on the left-fold path (paths under the package
#: root); their kernels are the bodies of the bit-critical wrappers.
BIT_CRITICAL_CUDA_SOURCES = (
    "kernels/csrc/axis_pass_scatter_fwd.cu",
    "kernels/csrc/owner_fold.cu",
    "kernels/csrc/hier3.cuh",
    "kernels/csrc/assemble_members.cu",
)

#: Atomic read-modify-write adds that reorder a fold in CUDA C++ or
#: inline PTX (a regular expression over comment-free source).
CUDA_ATOMIC_ADD_PATTERN = (
    r"\batomic(?:Add|Sub)(?:_block|_system)?\s*\("
    r"|\b(?:red|atom)(?:\.[a-z0-9_]+)*\.(?:add|sub)\b")

# --------------------------------------------------------------------
# Invariant catalogue (rule -> provenance).  Rendered in reports;
# keep in sync with the rule implementations.
# --------------------------------------------------------------------

INVARIANTS = {
    "lock-order": (
        "Locks are acquired in strictly increasing rank order: "
        "cluster -> engine -> future -> store -> plan-cache -> "
        "ingest-cache/shared-pool/warn-once -> the port's table leaves "
        "-> kernel-build.  Module-leaf locks are leaves; nothing may be "
        "acquired while one is held.  (core/engine.py, "
        "runtime/cluster.py; the ranks are LOCK_RANKS.)"
    ),
    "lock-order-call": (
        "A call made under a lock must not (transitively) acquire a "
        "lock of lower or equal rank.  (runtime/cluster.py: cluster "
        "methods call into engines, never the reverse while locked.)"
    ),
    "block-under-lock": (
        "No blocking primitive under a registered lock: a device "
        "synchronisation, .item()/.tolist(), Future.result, "
        "Thread.join, time.sleep, synchronous engine control-plane "
        "calls, fsync-backed store IO.  Exception (pragma'd): the WAL "
        "append at admission runs under the engine lock so journal "
        "order equals admission order (CTEngine._journal)."
    ),
    "dispatch-under-lock": (
        "Device dispatch never runs under any lock; workers drop the "
        "engine lock before _dispatch_ingest/_dispatch_query_groups and "
        "reacquire it only to commit (core/engine.py).  The cluster's "
        "barriers are allowed_dispatch sections (runtime/cluster.py)."
    ),
    "wait-wrong-lock": (
        "Condition.wait/wait_for only with the owning lock held "
        "(the _work/_space conditions share the engine RLock; helpers "
        "called with it held carry a '# ctlint: holds(engine)' "
        "annotation).  (core/engine.py.)"
    ),
    "notify-outside-lock": (
        "Condition.notify/notify_all only with the owning lock held; "
        "an unlocked notify races the waiter's predicate check. "
        "(core/engine.py.)"
    ),
    "blocking-submit-under-lock": (
        "Every engine submit made while holding the cluster lock "
        "passes block=False; a full engine queue must surface as "
        "EngineSaturated to the failover path, not wedge the cluster "
        "(runtime/cluster.py)."
    ),
    "donate-reuse": (
        "A grid handed to a donating ingest has its storage released "
        "once the assembly read it; any path that can dispatch the same "
        "payload twice (retry wrapper, replay loop with a hoisted "
        "payload) must guard with _check_not_donated/storage_released "
        "first (core/engine.py IngestBuffersDonated)."
    ),
    "bit-identity-reassoc": (
        "Surplus scatter is a left fold in global member order; "
        "reassociating or unordered reductions (torch.sum, index_add_, "
        "scatter_add_, ...) are forbidden on the scatter path, and "
        "atomic adds in its CUDA sources, so sharded and single-device "
        "runs stay bit-identical (core/executor.py, "
        "core/distributed.py, kernels/hierarchize.py, kernels/csrc).  "
        "gather_full_psum is the documented non-bit-identical path and "
        "is out of scope."
    ),
}
