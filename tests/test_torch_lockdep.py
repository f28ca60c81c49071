"""The port's runtime lock-order sanitizer (``repro_torch.analysis.lockdep``)
on the CPU, held to the reference's (``repro.analysis.lockdep``).

* One case of every test of ``tests/test_lockdep.py`` on the port's
  sanitizer: a synthetic A->B/B->A cycle flagged without the deadlock,
  rank regressions and same-class nesting flagged, ``note_dispatch``
  under a lock flagged unless in an ``allowed_dispatch`` section, the
  ``Condition`` protocol across ``wait``, and the 4-thread engine
  workload sanitized bitwise the uninstrumented one.
* Parity: the same synthetic acquisition sequences through both
  sanitizers give the same edges, cycles and violation rules (the
  reference's side runs once, in a module fixture).
* A light durable 3-host ``CTCluster`` with a ``fail_host`` and a
  ``restart_host`` under the sanitizer (monitor off): no violation.
* One subprocess with ``REPRO_TORCH_LOCKDEP=1`` from its start, so the
  module-level locks made at import are instrumented too: its edges
  include those module leaves, and nothing is violated.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import lockdep as ref_lockdep
from repro_torch.analysis import lockdep
from repro_torch.analysis.invariants import LOCK_RANKS
from repro_torch.core.engine import CTEngine, clear_compile_cache
from repro_torch.core.levels import CombinationScheme, grid_shape

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture()
def dep():
    """Instrumentation forced on, graph cleared, restored after."""
    lockdep.enable()
    lockdep.reset()
    yield lockdep
    lockdep.reset()
    lockdep.restore_default()


def _violation_rules(d):
    return [v["rule"] for v in d.violations()]


# ---------------------------------------------------------------------------
# detector (the reference's cases on the port's sanitizer)
# ---------------------------------------------------------------------------

def test_disabled_returns_plain_locks():
    lockdep.disable()       # forced off, even under REPRO_TORCH_LOCKDEP=1
    try:
        assert type(lockdep.make_lock("x")) is type(threading.Lock())
        assert type(lockdep.make_rlock("x")) is type(threading.RLock())
    finally:
        lockdep.restore_default()


def test_synthetic_cycle_flagged_deterministically(dep):
    a = dep.make_lock("alpha")
    b = dep.make_lock("beta")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    cycles = dep.report()["cycles"]
    assert len(cycles) == 1
    assert set(cycles[0]["path"]) == {"alpha", "beta"}
    assert "lock-cycle" in _violation_rules(dep)


def test_no_cycle_for_consistent_order(dep):
    a = dep.make_lock("alpha")
    b = dep.make_lock("beta")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = dep.report()
    assert rep["cycles"] == []
    assert [(e["from"], e["to"]) for e in rep["edges"]] == \
        [("alpha", "beta")]
    assert rep["edges"][0]["count"] == 3


def test_rank_regression_flagged(dep):
    engine = dep.make_rlock("engine")
    cluster = dep.make_rlock("cluster")
    with engine:
        with cluster:      # cluster(10) under engine(20): wrong way
            pass
    kinds = [v.get("kind") for v in dep.violations()]
    assert "rank-regression" in kinds


def test_rank_increasing_order_clean(dep):
    cluster = dep.make_rlock("cluster")
    engine = dep.make_rlock("engine")
    build = dep.make_lock("kernel-build")
    with cluster:
        with engine:
            with build:     # the first launch inside a cluster barrier
                pass
    assert dep.violations() == []


def test_port_leaf_under_build_lock_flagged(dep):
    build = dep.make_lock("kernel-build")
    tables = dep.make_lock("owner-tables")
    with build:
        with tables:       # owner-tables(73) under kernel-build(90)
            pass
    kinds = [v.get("kind") for v in dep.violations()]
    assert kinds == ["rank-regression"]


def test_same_class_two_instances_flagged(dep):
    e1 = dep.make_rlock("engine")
    e2 = dep.make_rlock("engine")
    with e1:
        with e2:
            pass
    kinds = [v.get("kind") for v in dep.violations()]
    assert "same-class-nesting" in kinds


def test_reentrant_reacquire_not_flagged(dep):
    e = dep.make_rlock("engine")
    with e:
        with e:
            pass
    assert dep.violations() == []


def test_note_dispatch_under_lock_flagged(dep):
    e = dep.make_rlock("engine")
    with e:
        dep.note_dispatch("test-site")
    v = dep.report()["dispatch_under_lock"]
    assert len(v) == 1
    assert v[0]["held"] == ["engine"]
    assert v[0]["site"] == "test-site"
    assert dep.report()["dispatch_notes"] == 1


def test_note_dispatch_without_lock_clean(dep):
    dep.note_dispatch("test-site")
    assert dep.violations() == []
    assert dep.report()["dispatch_notes"] == 1


def test_allowed_dispatch_section_suppresses(dep):
    e = dep.make_rlock("cluster")
    with e:
        with dep.allowed_dispatch("control-plane barrier"):
            dep.note_dispatch("test-site")
    assert dep.violations() == []


def test_condition_wait_notify_roundtrip(dep):
    lock = dep.make_rlock("engine")
    cond = threading.Condition(lock)
    state = {"ready": False, "seen": False}

    def waiter():
        with cond:
            while not state["ready"]:
                cond.wait(5)
            state["seen"] = True

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        state["ready"] = True
        cond.notify_all()
    t.join(5)
    assert state["seen"]
    assert dep.violations() == []


def test_condition_wait_releases_reentrant_levels(dep):
    lock = dep.make_rlock("engine")
    cond = threading.Condition(lock)
    acquired_elsewhere = threading.Event()

    def other():
        with lock:
            acquired_elsewhere.set()
            with cond:
                cond.notify_all()

    with lock:          # level 1
        with cond:      # level 2 (same RLock through the Condition)
            t = threading.Thread(target=other)
            t.start()
            while not acquired_elsewhere.is_set():
                cond.wait(5)
        assert lock._is_owned()
    t.join(5)
    assert dep.violations() == []


def test_wrapper_stack_balanced_after_exceptions(dep):
    lock = dep.make_lock("alpha")
    with pytest.raises(RuntimeError):
        with lock:
            raise RuntimeError("boom")
    with lock:
        pass
    assert dep.report()["edges"] == []


def test_environment_variable_is_the_ports_own():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from repro.analysis import lockdep as r\n"
            "from repro_torch.analysis import lockdep as p\n"
            "print(r.enabled(), p.enabled())" % str(SRC))
    outs = []
    for var in ("REPRO_LOCKDEP", "REPRO_TORCH_LOCKDEP"):
        env = {k: v for k, v in os.environ.items()
               if k not in ("REPRO_LOCKDEP", "REPRO_TORCH_LOCKDEP")}
        env[var] = "1"
        outs.append(subprocess.run(
            [sys.executable, "-c", code], env=env, capture_output=True,
            text=True, timeout=120, check=True).stdout.split())
    assert outs == [["True", "False"], ["False", "True"]]


# ---------------------------------------------------------------------------
# Parity with the reference's sanitizer
# ---------------------------------------------------------------------------

def _seq_cycle(ld):
    a, b = ld.make_lock("alpha"), ld.make_lock("beta")
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _seq_consistent(ld):
    a, b, c = (ld.make_lock(n) for n in ("alpha", "beta", "gamma"))
    for _ in range(3):
        with a:
            with b:
                with c:
                    pass


def _seq_registry_order(ld):
    locks = [ld.make_rlock("cluster"), ld.make_rlock("engine"),
             ld.make_lock("future"), ld.make_rlock("store"),
             ld.make_lock("plan-cache"), ld.make_lock("ingest-cache")]
    for i in range(len(locks)):
        with locks[0]:
            with locks[i]:
                pass


def _seq_rank_regression(ld):
    engine, cluster = ld.make_rlock("engine"), ld.make_rlock("cluster")
    store = ld.make_rlock("store")
    with store:
        with engine:
            pass
    with engine:
        with cluster:
            pass


def _seq_same_class(ld):
    e1, e2 = ld.make_rlock("engine"), ld.make_rlock("engine")
    with e1:
        with e2:
            pass
    with e1:
        with e1:
            pass


def _seq_dispatch(ld):
    e, c = ld.make_rlock("engine"), ld.make_rlock("cluster")
    ld.note_dispatch("free")
    with e:
        ld.note_dispatch("under-engine")
    with c:
        with ld.allowed_dispatch("barrier"):
            ld.note_dispatch("barrier")
        ld.note_dispatch("under-cluster")


def _seq_condition(ld):
    lock = ld.make_rlock("engine")
    cond = threading.Condition(lock)
    inner = ld.make_lock("shared-pool")
    with cond:
        cond.wait(0.01)
        with inner:
            pass


def _seq_three_cycle(ld):
    a, b, c = (ld.make_lock(n) for n in ("alpha", "beta", "gamma"))
    for x, y in ((a, b), (b, c), (c, a)):
        with x:
            with y:
                pass


SEQUENCES = {f.__name__[5:]: f for f in (
    _seq_cycle, _seq_consistent, _seq_registry_order, _seq_rank_regression,
    _seq_same_class, _seq_dispatch, _seq_condition, _seq_three_cycle)}


def _observe(ld, seq):
    """``seq`` under ``ld`` forced on: the edges, cycles and violations,
    sites left out (they name each package's own frames alike)."""
    ld.enable()
    ld.reset()
    try:
        seq(ld)
        rep = ld.report()
        return {
            "edges": [(e["from"], e["to"], e["count"]) for e in rep["edges"]],
            "cycles": [sorted(c["path"]) for c in rep["cycles"]],
            "violations": sorted((v["rule"], v.get("kind", ""),
                                  v.get("held", v.get("lock", "")).__repr__())
                                 for v in ld.violations()),
        }
    finally:
        ld.reset()
        ld.restore_default()


@pytest.fixture(scope="module")
def reference_reports():
    """Every sequence through the reference's sanitizer, once."""
    return {name: _observe(ref_lockdep, seq)
            for name, seq in SEQUENCES.items()}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_parity_with_reference_sanitizer(name, reference_reports):
    assert _observe(lockdep, SEQUENCES[name]) == reference_reports[name]


# ---------------------------------------------------------------------------
# bit-identity: instrumented engine == plain engine
# ---------------------------------------------------------------------------

def _threaded_workload():
    """4 tenants x 4 threads: ingest chains and queries, deterministic per
    tenant because one tenant's ingests apply in submission order.
    Returns ``{tenant: (surplus, query answer)}``."""
    scheme = CombinationScheme(2, 3)
    names = [f"t{i}" for i in range(4)]
    eng = CTEngine(device="cpu")
    for i, name in enumerate(names):
        rng = np.random.default_rng(100 + i)
        grids = {ell: rng.standard_normal(grid_shape(ell))
                 for ell, _ in scheme.grids}
        eng.register(name, scheme, grids)
    eng.start()

    def work(name, i):
        rng = np.random.default_rng(200 + i)
        for _ in range(3):
            grids = {ell: rng.standard_normal(grid_shape(ell))
                     for ell, _ in scheme.grids}
            eng.submit_ingest(name, grids).result(30)

    threads = [threading.Thread(target=work, args=(n, i))
               for i, n in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    pts = np.random.default_rng(7).random((16, 2))
    out = {n: (eng.surplus(n).clone(), eng.submit_query(n, pts).result(30))
           for n in names}
    eng.stop()
    return out


@pytest.mark.threaded
def test_instrumented_engine_bit_identical():
    clear_compile_cache()
    lockdep.disable()       # uninstrumented baseline, even in a sanitized
    try:                    # run
        plain = _threaded_workload()
        lockdep.enable()
        lockdep.reset()
        instrumented = _threaded_workload()
        rep = lockdep.report()
        assert rep["cycles"] == [] and lockdep.violations() == []
        assert rep["dispatch_notes"] >= 4 * 4 + 4
    finally:
        lockdep.reset()
        lockdep.restore_default()
    for name, (surplus, answer) in plain.items():
        got_surplus, got_answer = instrumented[name]
        assert torch.equal(surplus.view(torch.int64),
                           got_surplus.view(torch.int64)), name
        assert np.array_equal(answer.view(np.uint8),
                              got_answer.view(np.uint8)), name


# ---------------------------------------------------------------------------
# a sanitized durable cluster with a host's loss and restart
# ---------------------------------------------------------------------------

@pytest.mark.cluster
def test_sanitized_durable_cluster_fail_and_restart(tmp_path):
    from repro_torch.runtime.cluster import CTCluster
    scheme = CombinationScheme(2, 3)
    rng = np.random.default_rng(5)
    grids = {n: {ell: rng.standard_normal(grid_shape(ell))
                 for ell, _ in scheme.grids} for n in ("a", "b", "c")}
    pts = np.random.default_rng(6).random((8, 2))
    clear_compile_cache()
    lockdep.enable()
    lockdep.reset()
    try:
        cl = CTCluster(3, replication=1, seed=3, device="cpu",
                       durability_dir=str(tmp_path), snapshot_interval=2)
        for n, g in grids.items():
            cl.register(n, scheme, g)
        before = {n: cl.owners_of(n) for n in grids}
        want = {n: cl.query(n, pts) for n in grids}
        victim = before["a"][0]
        futs = [cl.submit_query(n, pts) for n in grids]
        outcome = cl.fail_host(victim, reason="test")
        futs += [cl.submit_query(n, pts) for n in grids]
        cl.update("b", grids["b"])
        restart = cl.restart_host(victim)
        futs += [cl.submit_query(n, pts) for n in grids]
        answers = [f.result(60) for f in futs]
        after = {n: cl.owners_of(n) for n in grids}
        rep = lockdep.report()
        violations = lockdep.violations()
        cl.stop()
    finally:
        lockdep.reset()
        lockdep.restore_default()
    assert set(outcome) and set(restart) and after == before
    for i, out in enumerate(answers):
        assert np.allclose(out, want[list(grids)[i % 3]], rtol=1e-12)
    assert violations == [] and rep["cycles"] == []
    edges = {(e["from"], e["to"]) for e in rep["edges"]}
    assert ("cluster", "engine") in edges and ("engine", "store") in edges
    assert all(LOCK_RANKS[a] < LOCK_RANKS[b] for a, b in edges)


# ---------------------------------------------------------------------------
# REPRO_TORCH_LOCKDEP=1 from the start: the module-level locks too
# ---------------------------------------------------------------------------

_SUBPROCESS = """
import json, sys, threading
sys.path.insert(0, %r)
import numpy as np
from repro_torch.analysis import lockdep
from repro_torch.core import engine as E
from repro_torch.core.engine import CTEngine
from repro_torch.core.levels import CombinationScheme, grid_shape
from repro_torch.runtime.cluster import CTCluster

assert lockdep.enabled_by_env()
assert type(E._INGEST_CACHE_LOCK).__name__ == "_DepLock"
scheme = CombinationScheme(2, 3)
rng = np.random.default_rng(1)
grid = lambda: {ell: rng.standard_normal(grid_shape(ell))
                for ell, _ in scheme.grids}
eng = CTEngine(device="cpu").start()
for i in range(4):
    eng.register(f"t{i}", scheme, grid())
def work(i):
    for _ in range(3):
        eng.submit_ingest(f"t{i}", grid()).result(30)
        eng.submit_query(f"t{i}", rng.random((4, 2))).result(30)
threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
[t.start() for t in threads]
[t.join(60) for t in threads]
eng.stop()
cl = CTCluster(2, device="cpu")
cl.register("x", CombinationScheme(2, 4), {
    ell: rng.standard_normal(grid_shape(ell))
    for ell, _ in CombinationScheme(2, 4).grids})
cl.query("x", rng.random((4, 2)))
rep = lockdep.report()
print(json.dumps({"edges": [(e["from"], e["to"]) for e in rep["edges"]],
                  "violations": lockdep.violations(),
                  "cycles": rep["cycles"],
                  "alive": [t.name for t in threads if t.is_alive()]}))
"""


@pytest.mark.threaded
def test_lockdep_env_instruments_module_locks():
    env = dict(os.environ, REPRO_TORCH_LOCKDEP="1")
    r = subprocess.run([sys.executable, "-c", _SUBPROCESS % str(SRC)],
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["violations"] == [] and out["cycles"] == []
    assert out["alive"] == []
    edges = {tuple(e) for e in out["edges"]}
    # locks made at import, instrumented only because the variable was set
    # before it: the shared executable cache and the per-plan table cache
    assert {("cluster", "ingest-cache"), ("cluster", "plan-tables")} <= edges
    assert all(LOCK_RANKS[a] < LOCK_RANKS[b] for a, b in edges)
