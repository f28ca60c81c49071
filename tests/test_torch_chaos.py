"""Chaos tier of the port's ``CTCluster`` on the CPU: seeded fault
schedules (kill, restart, NaN poison, crash mid-snapshot, torn WAL append)
against a small durable cluster under live load, as the reference's
``tests/test_chaos.py``.  The invariants every run holds:

* **zero lost acked ingests**: afterwards each tenant serves exactly the
  newest payload whose ingest future resolved with a value, bitwise a
  never-crashed engine fed that payload;
* **zero hung futures**: every submitted future resolves, with a value or
  a named exception.

``FaultSchedule.seeded`` is pure Python on both sides and is held to the
reference's event lists exactly.  Every wait has its own timeout.
"""

import json
import time

import numpy as np
import pytest

from repro.runtime import cluster as rcluster
from repro_torch.core.engine import CTEngine, clear_compile_cache
from repro_torch.core.levels import CombinationScheme, grid_shape
from repro_torch.runtime.cluster import (CTCluster, FaultEvent,
                                         FaultSchedule, HostFailed)

pytestmark = pytest.mark.chaos

SCHEME = CombinationScheme(2, 2)
WAIT = 60.0


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_compile_cache()
    yield


def _grids(seed):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(grid_shape(ell))
            for ell, _ in SCHEME.grids}


def _payload(base, k):
    """Distinct, recognisable payload for submission ``k``."""
    return {ell: g * (1.0 + 0.01 * k) for ell, g in base.items()}


def _oracle_query(name, payload, pts):
    oracle = CTEngine(device="cpu", ingest_workers=0, host_id="oracle")
    oracle.register(name, SCHEME, payload)
    return oracle.query(name, pts)


def _events(schedule):
    return [(e.at_s, e.kind, e.target) for e in schedule.events]


# ---------------------------------------------------------------------------
# Schedules: the reference's event lists, and their invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [
    (123, dict(hosts=["h0", "h1", "h2"], tenants=["a", "b"],
               duration_s=10.0, n_events=12)),
    (124, dict(hosts=["h0", "h1", "h2"], tenants=["a", "b"],
               duration_s=10.0, n_events=12)),
    (7, dict(hosts=["h0", "h1", "h2", "h3"], tenants=["a", "b", "c"],
             duration_s=10.0, n_events=10, restart_delay_s=1.0)),
    (101, dict(hosts=["host0", "host1", "host2"], tenants=["a", "b", "c"],
               duration_s=4.0, n_events=8, restart_delay_s=0.6)),
    (202, dict(hosts=["host0", "host1", "host2"], tenants=["a", "b", "c"],
               duration_s=4.0, n_events=8, restart_delay_s=0.6)),
    (5, dict(hosts=["h0", "h1"], tenants=[], duration_s=3.0, n_events=9,
             kinds=("kill", "stall", "poison"))),
])
def test_fault_schedule_equals_the_reference(seed, kw):
    port = FaultSchedule.seeded(seed, **kw)
    ref = rcluster.FaultSchedule.seeded(seed, **kw)
    assert _events(port) == _events(ref)
    assert _events(FaultSchedule.seeded(seed, **kw)) == _events(port)


def test_fault_schedule_structural_invariants():
    """Every kill is paired with a restart of its host; one host down at a
    time; every other event inside the fault window."""
    for seed in range(20):
        sched = FaultSchedule.seeded(
            seed, hosts=["h0", "h1", "h2", "h3"], tenants=["a", "b", "c"],
            duration_s=10.0, n_events=10, restart_delay_s=1.0)
        kills = [e for e in sched.events if e.kind == "kill"]
        restarts = [e for e in sched.events if e.kind == "restart"]
        assert len(kills) == len(restarts)
        down_until = 0.0
        for k in kills:
            assert k.at_s >= down_until
            r = next(r for r in restarts
                     if r.target == k.target and r.at_s > k.at_s)
            assert r.at_s == pytest.approx(k.at_s + 1.0)
            down_until = r.at_s
        for e in sched.events:
            if e.kind != "restart":
                assert 0.05 * 10.0 <= e.at_s <= 0.8 * 10.0
        assert all(e.kind in FaultSchedule.KINDS + ("restart",)
                   for e in sched.events)


def test_fault_schedule_due_consumes_in_order():
    sched = FaultSchedule([FaultEvent(1.0, "poison", "a"),
                           FaultEvent(2.0, "poison", "b"),
                           FaultEvent(3.0, "poison", "c")])
    assert [e.target for e in sched.due(2.5)] == ["a", "b"]
    assert sched.due(2.5) == []
    assert not sched.exhausted
    assert [e.target for e in sched.due(99.0)] == ["c"]
    assert sched.exhausted


def test_fault_schedule_apply_guards_skip_not_raise(tmp_path):
    cl = CTCluster(1, durability_dir=str(tmp_path), seed=3, device="cpu")
    cl.register("t", SCHEME, _grids(0))
    sched = FaultSchedule([FaultEvent(0.0, "kill", "host0"),
                           FaultEvent(0.0, "restart", "nonexistent"),
                           FaultEvent(0.0, "bogus", "host0")])
    for ev in sched.events:
        assert sched.apply(cl, ev) is False
    assert len(sched.skipped) == 3 and sched.applied == []
    assert cl.live_hosts() == ("host0",)


def test_injected_store_faults_keep_acked_state(tmp_path):
    """``tear_next_wal`` fails the next admission by name and nothing is
    acked; ``crash_next_snapshot`` leaves serving untouched; a host without
    a store refuses both seams."""
    cl = CTCluster(1, durability_dir=str(tmp_path), seed=3,
                   snapshot_interval=1, device="cpu")
    base = _grids(0)
    cl.register("t", SCHEME, base)
    pts = np.random.default_rng(1).random((8, 2))
    cl.injector.tear_next_wal("host0")
    with pytest.raises(Exception, match="torn"):
        cl.submit_ingest("t", _payload(base, 1))
    cl.injector.crash_next_snapshot("host0")
    cl.update("t", _payload(base, 2))
    np.testing.assert_array_equal(cl.query("t", pts),
                                  _oracle_query("t", _payload(base, 2), pts))
    assert any("snapshot" in e for e in
               cl.stats()["hosts"]["host0"]["durability"]["events"])
    plain = CTCluster(1, device="cpu")
    with pytest.raises(ValueError, match="no durable store"):
        plain.injector.crash_next_snapshot("host0")


# ---------------------------------------------------------------------------
# R=1 kill -> restart: bitwise the never-crashed engine
# ---------------------------------------------------------------------------

def test_r1_kill_restart_bit_identical_to_uncrashed_oracle(tmp_path):
    cl = CTCluster(3, replication=1, seed=7, durability_dir=str(tmp_path),
                   snapshot_interval=3, device="cpu")
    base = {n: _grids(i) for i, n in enumerate(["a", "b", "c", "d"])}
    for n, g in base.items():
        cl.register(n, SCHEME, g)
    acked = {}
    for k in range(8):                   # spans a snapshot and a WAL tail
        for n in base:
            p = _payload(base[n], k)
            cl.submit_ingest(n, p, block=True).result(WAIT)
            acked[n] = p
    victim = cl.owners_of("a")[0]
    before = {n: cl.owners_of(n) for n in base}
    cl.injector.kill(victim)
    assert cl.check_health() == [victim]
    outcomes = cl.restart_host(victim)
    assert victim in cl.live_hosts()
    assert {n: cl.owners_of(n) for n in base} == before
    assert outcomes and set(outcomes.values()) <= {"restored", "adopted"}
    pts = np.random.default_rng(5).random((24, 2))
    for n, payload in acked.items():
        oracle = CTEngine(device="cpu", ingest_workers=0, host_id="oracle")
        oracle.register(n, SCHEME, payload)
        np.testing.assert_array_equal(cl.query(n, pts),
                                      oracle.query(n, pts))
        got, want = cl.surplus(n).numpy(), oracle.surplus(n).numpy()
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    st = cl.stats()
    assert st["restarts"][-1]["host"] == victim
    assert st["restarts"][-1]["replayed"] >= 0


def test_restart_replays_unreplicated_inflight_ingest(tmp_path):
    """An ingest in flight on a dying R=1 owner is replayed from the
    victim's WAL onto the new owner, and its future resolves with a value
    (``"restored"``, not ``HostFailed``)."""
    cl = CTCluster(2, replication=1, seed=7, durability_dir=str(tmp_path),
                   snapshot_interval=100, device="cpu")
    g = _grids(0)
    cl.register("t", SCHEME, g)
    victim = cl.owners_of("t")[0]
    fut = cl.submit_ingest("t", _payload(g, 1))
    cl.injector.kill(victim)
    assert cl.check_health() == [victim]
    fut.result(WAIT)
    assert fut.retargeted >= 1
    pts = np.random.default_rng(6).random((16, 2))
    np.testing.assert_array_equal(cl.query("t", pts),
                                  _oracle_query("t", _payload(g, 1), pts))
    assert cl.stats()["failovers"][-1]["outcomes"]["t"] == "restored"
    assert cl.stats()["replayed_ingests"] == 1


def test_stale_seq_marks_queries_while_the_primary_replays(tmp_path):
    """While a restarted primary replays its WAL, its queries serve the
    snapshot state with ``stale_seq`` set; after the replay they are fresh
    and bitwise the never-crashed engine."""
    cl = CTCluster(2, replication=1, seed=7, durability_dir=str(tmp_path),
                   snapshot_interval=2, device="cpu")
    g = _grids(0)
    cl.register("t", SCHEME, g)
    for k in (1, 2):                     # seqs 2, 3: a snapshot at 2
        cl.update("t", _payload(g, k))
    host = cl.owners_of("t")[0]
    pts = np.random.default_rng(7).random((8, 2))
    seen = {}
    from repro_torch.core.engine import CTEngine as _E
    orig = _E.replay

    def spy(engine, names=None):
        fut = cl.submit_query("t", pts)
        seen["stale_seq"] = fut.stale_seq
        seen["answer"] = fut.result(WAIT)
        return orig(engine, names)

    _E.replay = spy
    try:
        assert cl.restart_host(host) == {"t": "restored"}
    finally:
        _E.replay = orig
    assert seen["stale_seq"] == 1        # the snapshot's cluster seq
    np.testing.assert_array_equal(seen["answer"],
                                  _oracle_query("t", _payload(g, 1), pts))
    fresh = cl.submit_query("t", pts)
    assert fresh.stale_seq is None
    np.testing.assert_array_equal(fresh.result(WAIT),
                                  _oracle_query("t", _payload(g, 2), pts))


# ---------------------------------------------------------------------------
# The full seeded chaos run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [101, 202])
def test_seeded_chaos_run_no_lost_acks_no_hung_futures(tmp_path, seed):
    cl = CTCluster(3, replication=1, seed=13, durability_dir=str(tmp_path),
                   snapshot_interval=4, monitor_interval_s=0.1, device="cpu")
    tenants = ["a", "b", "c"]
    base = {n: _grids(i) for i, n in enumerate(tenants)}
    for n, g in base.items():
        cl.register(n, SCHEME, g)
    pts = np.random.default_rng(8).random((12, 2))
    duration = 4.0
    sched = FaultSchedule.seeded(
        seed, hosts=list(cl.live_hosts()), tenants=tenants,
        duration_s=duration, n_events=8, restart_delay_s=0.6)
    futs = []
    cl.start()
    try:
        t0 = time.monotonic()
        k = 0
        while True:
            elapsed = time.monotonic() - t0
            for ev in sched.due(elapsed):
                sched.apply(cl, ev)
            if elapsed >= duration and sched.exhausted:
                break
            assert elapsed < duration + 60.0, "schedule never drained"
            name = tenants[k % len(tenants)]
            try:
                futs.append(("ingest", name, k, cl.submit_ingest(
                    name, _payload(base[name], k))))
            except Exception:            # torn-WAL admission failure
                pass
            try:
                futs.append(("query", name, k, cl.submit_query(name, pts)))
            except Exception:
                pass
            k += 1
            time.sleep(0.04)
    finally:
        cl.stop()
    acked = {n: None for n in tenants}
    deadline = time.monotonic() + 120.0
    for kind, name, kk, f in futs:
        try:
            f.result(max(1.0, deadline - time.monotonic()))
            if kind == "ingest" and (acked[name] is None
                                     or kk > acked[name]):
                acked[name] = kk
        except (HostFailed, FloatingPointError):
            pass                         # named resolution, not hung
        assert f.done(), f"hung {kind} future for {name!r} (k={kk})"
    for n in tenants:
        payload = (_payload(base[n], acked[n]) if acked[n] is not None
                   else base[n])
        assert np.array_equal(cl.query(n, pts),
                              _oracle_query(n, payload, pts)), \
            f"tenant {n!r}: acked ingest k={acked[n]} lost (seed {seed})"
    assert sched.exhausted
    assert len(sched.applied) + len(sched.skipped) == len(sched.events)
    st = cl.stats()
    assert st["inflight"] == 0
    json.dumps(st)
