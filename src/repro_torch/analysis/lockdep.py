"""Runtime lock-order sanitizer of the port (mini-lockdep).

The port's engine, cluster, store, executor and kernel modules create
every lock through :func:`make_lock` / :func:`make_rlock`.  When the
sanitizer is off (the default) those return plain
``threading.Lock``/``RLock`` objects: no overhead, no change of
behaviour.  With ``REPRO_TORCH_LOCKDEP=1`` in the environment (or after
:func:`enable` in-process) they return thin wrappers that keep a
per-thread stack of held locks and record, per acquisition:

* the acquisition edge ``held-class -> acquired-class`` with the
  first caller site, feeding a global graph;
* a cycle check on every *new* edge (DFS), so an A->B ordering in one
  thread plus B->A in another is flagged without needing the actual
  interleaving to deadlock;
* a rank-regression check against
  :data:`repro_torch.analysis.invariants.LOCK_RANKS` (acquiring rank <=
  held rank outside a reentrant same-class re-acquire);
* same-class different-instance nesting (two engine locks at once).

:func:`note_dispatch` is the runtime twin of the static
``dispatch-under-lock`` rule: device-dispatch sites call it and any
instrumented lock held at that moment is recorded as a violation.
When the sanitizer is off it is a single predicate check.

The wrappers expose ``acquire/release/__enter__/__exit__`` plus the
``_is_owned/_release_save/_acquire_restore`` protocol, so
``threading.Condition(make_rlock("engine"))`` works unchanged,
including the re-entrant bookkeeping across ``Condition.wait``.

The environment variable is the port's own (the reference reads
``REPRO_LOCKDEP``), so a sanitized run of one package does not
instrument the other.  Standard library only.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

from repro_torch.analysis.invariants import LOCK_RANKS, REENTRANT_LOCKS

_ENV_ENABLED = os.environ.get("REPRO_TORCH_LOCKDEP", "") not in (
    "", "0", "false")
_FORCED = None          # True/False from enable()/disable(), None = env
_GRAPH_LOCK = threading.Lock()   # internal; never wrapped
_TLS = threading.local()

_edges = {}             # (from_class, to_class) -> {"count", "site"}
_order_violations = []  # rank regressions / same-class nesting
_cycles = []            # cycle paths through the edge graph
_dispatch_violations = []
_dispatch_notes = [0]   # note_dispatch calls while enabled


def enabled():
    """True when new locks should be instrumented."""
    return _ENV_ENABLED if _FORCED is None else _FORCED


def enabled_by_env():
    """True only for the REPRO_TORCH_LOCKDEP=1 environment opt-in."""
    return _ENV_ENABLED


def enable():
    """Force instrumentation on for locks created from now on."""
    global _FORCED
    _FORCED = True


def disable():
    """Force instrumentation off for locks created from now on
    (overrides REPRO_TORCH_LOCKDEP=1: the bit-identity self-test needs
    an uninstrumented baseline even inside a sanitized run)."""
    global _FORCED
    _FORCED = False


def restore_default():
    """Drop back to the environment-variable default."""
    global _FORCED
    _FORCED = None


def reset():
    """Clear the acquisition graph and all recorded violations."""
    with _GRAPH_LOCK:
        _edges.clear()
        del _order_violations[:]
        del _cycles[:]
        del _dispatch_violations[:]
        _dispatch_notes[0] = 0


def make_lock(name):
    """A (possibly instrumented) non-reentrant lock of class ``name``."""
    if not enabled():
        return threading.Lock()
    return _DepLock(name, threading.Lock(), reentrant=False)


def make_rlock(name):
    """A (possibly instrumented) reentrant lock of class ``name``."""
    if not enabled():
        return threading.RLock()
    return _DepLock(name, threading.RLock(), reentrant=True)


@contextlib.contextmanager
def allowed_dispatch(reason):
    """Runtime twin of an ``ok(dispatch-under-lock)`` pragma of locklint.

    The cluster's control-plane barriers (admission, failover,
    refit/recombination, restart adoption, rebalance) intentionally run
    synchronous engine work, device dispatch included, under the
    cluster lock; they enter this section so :func:`note_dispatch`
    does not flag them.  ``reason`` documents the barrier at the
    call site.
    """
    prev = getattr(_TLS, "allow_dispatch", 0)
    _TLS.allow_dispatch = prev + 1
    try:
        yield
    finally:
        _TLS.allow_dispatch = prev


def note_dispatch(site):
    """Record a device dispatch; flags any lock held at this point."""
    if _FORCED is None and not _ENV_ENABLED:
        return
    with _GRAPH_LOCK:
        _dispatch_notes[0] += 1
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return
    if getattr(_TLS, "allow_dispatch", 0):
        return
    held = sorted({e.name for e in stack})
    with _GRAPH_LOCK:
        _dispatch_violations.append({
            "rule": "dispatch-under-lock",
            "site": site,
            "held": held,
            "thread": threading.current_thread().name,
        })


def violations():
    """All recorded violations (order + cycles + dispatch)."""
    with _GRAPH_LOCK:
        return list(_order_violations) + list(_cycles) + \
            list(_dispatch_violations)


def report():
    """Structured snapshot of the graph and violations."""
    with _GRAPH_LOCK:
        return {
            "enabled": enabled(),
            "edges": [
                {"from": a, "to": b, "count": info["count"],
                 "site": info["site"]}
                for (a, b), info in sorted(_edges.items())
            ],
            "order_violations": list(_order_violations),
            "cycles": list(_cycles),
            "dispatch_under_lock": list(_dispatch_violations),
            "dispatch_notes": _dispatch_notes[0],
        }


class _HeldEntry:
    __slots__ = ("obj", "name")

    def __init__(self, obj, name):
        self.obj = obj
        self.name = name


def _stack():
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _caller_site():
    # First frame outside this module is the acquisition site.
    f = sys._getframe(2)
    here = __file__
    for _ in range(6):
        if f is None:
            break
        if f.f_code.co_filename != here:
            return "%s:%d" % (f.f_code.co_filename, f.f_lineno)
        f = f.f_back
    return "<unknown>"


def _find_cycle(start, target):
    """DFS: a path start -> ... -> target through the edge graph.

    Called with _GRAPH_LOCK held, right after inserting the edge
    ``target -> start``; a returned path closes a cycle.
    """
    seen = set()
    path = [start]

    def walk(node):
        if node == target:
            return True
        seen.add(node)
        for (a, b) in _edges:
            if a == node and b not in seen:
                path.append(b)
                if walk(b):
                    return True
                path.pop()
        return False

    return path + [target] if walk(start) else None


def _note_acquire(lock, restore=False):
    stack = _stack()
    # A pure reentrant re-acquire of the same object is not an
    # ordering decision; just balance the release bookkeeping.
    if any(e.obj is lock for e in stack):
        if lock._reentrant:
            stack.append(_HeldEntry(lock, lock.name))
            return
        # Non-reentrant same-object re-acquire would self-deadlock;
        # record it (single-threaded tests can still reach here when
        # acquire(blocking=False) fails upstream, so be permissive).
    if stack and not restore:
        site = _caller_site()
        new_rank = LOCK_RANKS.get(lock.name)
        seen_names = set()
        for held in stack:
            if held.name in seen_names:
                continue
            seen_names.add(held.name)
            if held.name == lock.name:
                with _GRAPH_LOCK:
                    _order_violations.append({
                        "rule": "lock-order",
                        "kind": "same-class-nesting",
                        "lock": lock.name,
                        "site": site,
                        "thread": threading.current_thread().name,
                    })
                continue
            held_rank = LOCK_RANKS.get(held.name)
            if (new_rank is not None and held_rank is not None
                    and new_rank <= held_rank):
                with _GRAPH_LOCK:
                    _order_violations.append({
                        "rule": "lock-order",
                        "kind": "rank-regression",
                        "held": held.name,
                        "acquired": lock.name,
                        "site": site,
                        "thread": threading.current_thread().name,
                    })
            with _GRAPH_LOCK:
                key = (held.name, lock.name)
                info = _edges.get(key)
                if info is None:
                    _edges[key] = {"count": 1, "site": site}
                    cyc = _find_cycle(lock.name, held.name)
                    if cyc is not None:
                        _cycles.append({
                            "rule": "lock-cycle",
                            "path": cyc,
                            "site": site,
                            "thread":
                                threading.current_thread().name,
                        })
                else:
                    info["count"] += 1
    stack.append(_HeldEntry(lock, lock.name))


def _note_release(lock):
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return
    for i in range(len(stack) - 1, -1, -1):
        if stack[i].obj is lock:
            del stack[i]
            return


class _DepLock:
    """Instrumented Lock/RLock, Condition-compatible."""

    __slots__ = ("name", "_inner", "_reentrant")

    def __init__(self, name, inner, reentrant):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    def release(self):
        _note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # ---- Condition protocol -------------------------------------
    def _is_owned(self):
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        # Plain Lock fallback (CPython Condition does the same).
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        # Condition.wait drops the lock fully (all recursion
        # levels); pop every bookkeeping entry and remember how
        # many to push back on _acquire_restore.
        stack = getattr(_TLS, "stack", None)
        count = 0
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i].obj is self:
                    del stack[i]
                    count += 1
        save = getattr(self._inner, "_release_save", None)
        if save is not None:
            state = save()
        else:
            self._inner.release()
            state = None
        return (state, count)

    def _acquire_restore(self, state):
        inner_state, count = state
        restore = getattr(self._inner, "_acquire_restore", None)
        if restore is not None:
            restore(inner_state)
        else:
            self._inner.acquire()
        stack = _stack()
        for _ in range(max(count, 1)):
            stack.append(_HeldEntry(self, self.name))

    def __repr__(self):
        return "<lockdep %s %r>" % (self.name, self._inner)
