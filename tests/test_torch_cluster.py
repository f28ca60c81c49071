"""The port's ``CTCluster`` (``repro_torch.runtime.cluster``) on the CPU,
held to the reference's ``repro.runtime.cluster`` and to the invariants of
its ``tests/test_cluster.py``.

One module-scoped fleet scenario runs on both packages with the same
hosts, seed, tenants, payloads, kill and restart: placement before the
kill, after the failover and after the restart, the failover's and the
restart's outcome dicts, the retained state and the surpluses (bitwise)
and the queries (rtol 1e-12: the eval's products sum in another order)
are held equal.  The reference's other scenarios run on the port alone at
small sizes (``CombinationScheme(2-3, 3)``), each answer bitwise a fresh
port engine serving the same state.  Every wait has its own timeout.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from proptest import cases, integers, seeds

from repro.core import engine as rengine
from repro.core import levels as rlev
from repro.runtime import cluster as rcluster
from repro_torch.core.engine import (CTEngine, EngineSaturated, ExecSpec,
                                     clear_compile_cache)
from repro_torch.core.executor import build_plan
from repro_torch.core.levels import CombinationScheme, grid_shape
from repro_torch.runtime.cluster import (PROBE_TENANT, ClusterFuture,
                                         CTCluster, HashRing, HostFailed)
from repro_torch.runtime.elastic import rebalance_cluster
from repro_torch.runtime.fault_tolerance import HostHealthConfig

pytestmark = pytest.mark.cluster

SCHEME = CombinationScheme(3, 3)
WAIT = 60.0


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_compile_cache()
    yield


def _grids(scheme, seed):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(grid_shape(ell))
            for ell, _ in scheme.grids}


def _wait_for(cond, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _cluster(n_hosts=4, n_tenants=6, scheme=SCHEME, **kw):
    kw.setdefault("seed", 11)
    cl = CTCluster(n_hosts, device="cpu", **kw)
    for i in range(n_tenants):
        cl.register(f"t{i}", scheme, _grids(scheme, i))
    return cl


def _fresh_oracle(cl, name, pts):
    """A fresh port engine serving ``name``'s post-fault scheme from the
    cluster's retained grids on the same fine grid: the bitwise oracle of
    failed-over serving."""
    rec = cl._records[name]
    eng = CTEngine(device="cpu", ingest_workers=0)
    plan = build_plan(rec.scheme, cl.plan(name).full_levels)
    eng.register(name, rec.scheme, rec.grids, plan=plan)
    return eng.query(name, pts)


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


# ---------------------------------------------------------------------------
# Placement: the reference's owner tuples exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "seed,n", cases(lambda r: (seeds(r), integers(r, 3, 8)), n=6))
def test_ring_owners_equal_the_reference(seed, n):
    """Same (hosts, vnodes, seed): owner tuples equal the reference's at
    r = 1..3, before and after removing a host (whose removal moves only
    the keys it owned, and whose return restores the map exactly)."""
    hosts = [f"host{i}" for i in range(n)]
    keys = [f"tenant-{k}" for k in range(120)]
    for hs, vnodes in ((hosts, 64), (hosts[:-1], 64), (hosts, 16)):
        port = HashRing(hs, vnodes=vnodes, seed=seed)
        ref = rcluster.HashRing(hs, vnodes=vnodes, seed=seed)
        for r in (1, 2, 3):
            assert [port.owners(k, r) for k in keys] \
                == [ref.owners(k, r) for k in keys]
    full = HashRing(hosts, seed=seed)
    shrunk = HashRing(hosts[:-1], seed=seed)
    for k in keys:
        if hosts[-1] not in full.owners(k, 2):
            assert shrunk.owners(k, 2) == full.owners(k, 2)
    assert all(HashRing(list(hosts), seed=seed).owners(k, 2)
               == full.owners(k, 2) for k in keys)


def test_ring_needs_a_host_and_stats_are_json():
    with pytest.raises(ValueError, match="at least one host"):
        HashRing([])
    cl = _cluster(2, 2, scheme=CombinationScheme(2, 3))
    st = cl.stats()
    json.dumps(st)
    assert st["placement"] == {n: list(cl.owners_of(n)) for n in cl.names()}
    assert PROBE_TENANT not in st["hosts"]["host0"]["tenants"]


def test_cluster_restart_recomputes_identical_placement():
    """A rebuilt cluster (same hosts, vnodes, seed) places every tenant on
    the same owners, whatever the registration order."""
    scheme = CombinationScheme(2, 3)
    a = _cluster(4, 8, scheme=scheme, replication=2)
    b = CTCluster(4, replication=2, seed=11, device="cpu")
    for i in reversed(range(8)):
        b.register(f"t{i}", scheme, _grids(scheme, i))
    assert {n: a.owners_of(n) for n in a.names()} \
        == {n: b.owners_of(n) for n in b.names()}


# ---------------------------------------------------------------------------
# One fleet, both packages: kill, fail over, restart
# ---------------------------------------------------------------------------

def _fleet_run(cluster_cls, scheme, directory, **kw):
    """The scenario, on either package's ``CTCluster``: four durable hosts,
    six tenants, three rounds of acked updates, a kill of ``t0``'s owner
    detected by a manual health pass, one more update of ``t0`` on its
    new owner, then a restart of the victim."""
    cl = cluster_cls(4, replication=1, seed=11, durability_dir=directory,
                     snapshot_interval=2, **kw)
    names = [f"t{i}" for i in range(6)]
    for i, n in enumerate(names):
        cl.register(n, scheme, _grids(scheme, i))
    for k in range(3):
        for i, n in enumerate(names):
            cl.update(n, _grids(scheme, 100 * k + i))
    out = {"before": {n: cl.owners_of(n) for n in names}}
    victim = cl.owners_of("t0")[0]
    cl.injector.kill(victim)
    out["failed"] = cl.check_health()
    out["after_kill"] = {n: cl.owners_of(n) for n in names}
    out["failover"] = cl.stats()["failovers"][-1]["outcomes"]
    cl.update("t0", _grids(scheme, 999))
    out["restart"] = cl.restart_host(victim)
    out["after_restart"] = {n: cl.owners_of(n) for n in names}
    st = cl.stats()
    out["replayed"] = st["restarts"][-1]["replayed"]
    out["counters"] = {k: st[k] for k in ("queries", "ingests",
                                          "retried_queries", "host_failed",
                                          "replayed_ingests")}
    pts = np.random.default_rng(2).random((32, 3))
    out["surplus"] = {n: np.asarray(cl.surplus(n)) for n in names}
    out["query"] = {n: np.asarray(cl.query(n, pts)) for n in names}
    out["retained"] = {n: cl._records[n].grids for n in names}
    return out


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    clear_compile_cache()
    rengine.clear_compile_cache()
    root = tmp_path_factory.mktemp("fleet")
    ref = _fleet_run(rcluster.CTCluster, rlev.CombinationScheme(3, 3),
                     str(root / "ref"))
    port = _fleet_run(CTCluster, SCHEME, str(root / "port"), device="cpu")
    return ref, port


def test_fleet_placement_equal_before_kill_after_failover_and_restart(
        fleets):
    ref, port = fleets
    for key in ("before", "after_kill", "after_restart", "failed"):
        assert port[key] == ref[key], key
    victim = port["failed"][0]
    assert all(victim not in o for o in port["after_kill"].values())
    assert port["after_restart"] == port["before"]


def test_fleet_failover_and_restart_outcomes_equal(fleets):
    ref, port = fleets
    assert port["failover"] == ref["failover"]
    assert port["restart"] == ref["restart"]
    assert set(port["restart"].values()) == {"restored", "adopted"}
    assert port["replayed"] == ref["replayed"]
    assert port["counters"] == ref["counters"]


def test_fleet_surpluses_bitwise_and_queries_at_1e12(fleets):
    ref, port = fleets
    for n in ref["surplus"]:
        _bitwise(port["surplus"][n], ref["surplus"][n])
        np.testing.assert_allclose(port["query"][n], ref["query"][n],
                                   rtol=1e-12, atol=0)
        assert set(port["retained"][n]) == set(ref["retained"][n])
        for ell, v in ref["retained"][n].items():
            _bitwise(port["retained"][n][ell], v)


# ---------------------------------------------------------------------------
# Failover: the reference's scenarios on the port
# ---------------------------------------------------------------------------

def test_kill_one_of_four_hosts_every_tenant_stays_queryable():
    """In flight on the victim: a query (retried on the new primary) and a
    partial unreplicated ingest (named ``HostFailed``, its grid recombined
    away); every tenant answers bitwise a fresh engine on the post-fault
    state, and the victim's other tenants are untouched."""
    cl = _cluster(replication=1)
    pts = np.random.default_rng(2).random((32, 3))
    want = {n: cl.query(n, pts) for n in cl.names()}
    victim = cl.owners_of("t0")[0]
    victim_tenants = [n for n in cl.names() if cl.owners_of(n)[0] == victim]
    q_inflight = cl.submit_query("t0", pts)
    lost_level = next(ell for ell, c in cl.scheme("t0").grids if c != 0)
    i_inflight = cl.submit_ingest(
        "t0", {lost_level: np.full(grid_shape(lost_level), 2.0)})
    cl.injector.kill(victim)
    assert cl.check_health() == [victim]
    assert victim not in cl.live_hosts()
    assert q_inflight.retargeted == 1
    np.testing.assert_array_equal(q_inflight.result(WAIT),
                                  cl.query("t0", pts))
    with pytest.raises(HostFailed, match="t0.*no replica") as ei:
        i_inflight.result(WAIT)
    assert ei.value.host_id == victim
    assert lost_level in cl._records["t0"].dropped
    assert lost_level not in {ell for ell, _ in cl.scheme("t0").grids}
    st = cl.stats()
    assert st["failovers"][0]["recovery_ms"] > 0
    assert st["failovers"][0]["outcomes"]["t0"] == "recombined"
    for n in cl.names():
        assert victim not in cl.owners_of(n)
        np.testing.assert_array_equal(cl.query(n, pts),
                                      _fresh_oracle(cl, n, pts))
    for n in set(cl.names()) - set(victim_tenants):
        np.testing.assert_array_equal(cl.query(n, pts), want[n])


def test_replicated_tenant_survives_primary_kill_without_data_loss():
    cl = _cluster(replication=2)
    cl.start()
    try:
        pts = np.random.default_rng(3).random((16, 3))
        base = cl.query("t1", pts)
        victim = cl.owners_of("t1")[0]
        f_new = cl.submit_ingest("t1", _grids(SCHEME, 99))
        cl.injector.kill(victim)
        assert torch.isfinite(f_new.result(WAIT)).all()
        assert _wait_for(lambda: victim not in cl.live_hosts())
        after = cl.query("t1", pts)
        assert not np.array_equal(after, base)
        np.testing.assert_array_equal(after, _fresh_oracle(cl, "t1", pts))
        assert cl.stats()["host_failed"] == 0
    finally:
        cl.stop()


def test_replica_adoption_shares_the_donors_surplus_and_executable():
    """R=2 failover adopts the survivor's surplus (the very tensor: hosts
    share the device) and binds the same signature-shared executable."""
    cl = _cluster(4, 3, scheme=CombinationScheme(2, 3), replication=2)
    victim, survivor = cl.owners_of("t0")
    cl.injector.kill(victim)
    assert cl.check_health() == [victim]
    new = [h for h in cl.owners_of("t0") if h != survivor]
    assert cl.stats()["failovers"][0]["outcomes"]["t0"] == "replica"
    donor = cl.engine(survivor)._tenants["t0"]
    adopted = cl.engine(new[0])._tenants["t0"]
    assert adopted.surplus is donor.surplus
    assert adopted.executable is donor.executable


def test_stall_detection_via_heartbeat_and_probe_deadline():
    cl = _cluster(4, 4, health=HostHealthConfig(heartbeat_timeout_s=0.3,
                                                probe_deadline_s=0.3,
                                                max_strikes=2),
                  monitor_interval_s=0.1)
    cl.start()
    try:
        pts = np.random.default_rng(4).random((16, 3))
        want = {n: cl.query(n, pts) for n in cl.names()}
        victim = cl.owners_of("t0")[0]
        cl.injector.stall(victim)
        assert _wait_for(lambda: victim not in cl.live_hosts())
        reason = cl.stats()["failovers"][0]["reason"]
        assert "strike" in reason or "heartbeat" in reason \
            or "probe" in reason
        assert not cl.stats()["hosts"][victim]["alive"]
        for n in cl.names():
            np.testing.assert_array_equal(cl.query(n, pts), want[n])
    finally:
        cl.stop()


def test_poisoned_ingest_fails_only_its_future_host_stays_up():
    cl = _cluster(4, 4)
    pts = np.random.default_rng(5).random((16, 3))
    want = {n: cl.query(n, pts) for n in cl.names()}
    cl.injector.poison_next_ingest("t2")
    bad = cl.submit_ingest("t2", _grids(SCHEME, 42))
    ok = cl.submit_query("t3", pts)
    with pytest.raises(FloatingPointError, match="non-finite"):
        bad.result(WAIT)
    np.testing.assert_array_equal(ok.result(WAIT), want["t3"])
    assert len(cl.live_hosts()) == 4
    assert cl.stats()["failovers"] == []
    np.testing.assert_array_equal(cl.query("t2", pts), want["t2"])
    clean = cl.submit_ingest("t2", _grids(SCHEME, 42))
    assert torch.isfinite(clean.result(WAIT)).all()


def test_unregister_and_saturated_routing_errors_are_named():
    cl = _cluster(4, 2)
    with pytest.raises(KeyError, match="no tenant 'nope'"):
        cl.submit_query("nope", np.zeros((1, 3)))
    with pytest.raises(ValueError, match="reserved"):
        cl.register(PROBE_TENANT, SCHEME, _grids(SCHEME, 0))
    with pytest.raises(ValueError, match="already registered"):
        cl.register("t1", SCHEME, _grids(SCHEME, 0))
    cl.unregister("t0")
    assert "t0" not in cl.names()
    with pytest.raises(KeyError, match="t0"):
        cl.query("t0", np.zeros((1, 3)))
    # a live host's full queue is backpressure, named, with no failover
    host = cl._hosts[cl.owners_of("t1")[0]]
    host.engine._max_pending = 1
    cl.submit_query("t1", np.zeros((1, 3)))
    with pytest.raises(EngineSaturated, match="max_pending"):
        cl.submit_query("t1", np.zeros((1, 3)))
    assert cl.stats()["failovers"] == []


def test_unregister_tears_engines_down_outside_the_cluster_lock():
    cl = _cluster(4, 2, replication=2)
    owners = list(cl._records["t0"].owners)
    owned = []
    for hid in owners:
        eng = cl._hosts[hid].engine
        orig = eng.unregister

        def spy(name, _orig=orig):
            owned.append(cl._lock._is_owned())
            return _orig(name)

        eng.unregister = spy
    cl.unregister("t0")
    assert len(owned) == len(owners) and not any(owned)
    for hid in owners:
        assert "t0" not in cl._hosts[hid].engine
    assert cl.query("t1", np.random.default_rng(3).random((4, 3))).shape \
        == (4,)


def test_add_host_warms_probe_outside_the_lock_and_rebalances():
    """``add_host`` builds and warms the new engine with the cluster lock
    released, relocates about 1/(N+1) of the tenants (adopting plan and
    surplus, no re-ingest) and every answer is unchanged."""
    cl = _cluster(4, 8)
    pts = np.random.default_rng(1).random((16, 3))
    want = {n: cl.query(n, pts) for n in cl.names()}
    before = {n: cl.owners_of(n) for n in cl.names()}
    owned = []
    orig = CTCluster._add_probe_tenant

    def spy(self, engine):
        owned.append(self._lock._is_owned())
        return orig(self, engine)

    CTCluster._add_probe_tenant = spy
    try:
        hid = cl.add_host()
    finally:
        CTCluster._add_probe_tenant = orig
    assert owned == [False] and hid in cl._hosts and not cl._joining
    moved = [n for n in cl.names() if cl.owners_of(n) != before[n]]
    assert len(moved) <= 2 * 8 // 5 + 1
    assert set(rebalance_cluster(cl).values()) <= {"kept"}
    for n in cl.names():
        np.testing.assert_array_equal(cl.query(n, pts), want[n])
    with pytest.raises(ValueError, match="already exists"):
        cl.add_host(hid)


def test_surrogate_rides_the_cluster_unchanged():
    from repro_torch.launch.serve import CTSurrogate
    cl = CTCluster(3, seed=5, device="cpu")
    g = _grids(SCHEME, 7)
    sur = CTSurrogate(SCHEME, g, cluster=cl)
    assert sur.engine is cl and sur.device == cl.device
    eng = CTEngine(device="cpu", ingest_workers=0)
    eng.register("oracle", SCHEME, g)
    pts = np.random.default_rng(6).random((24, 3))
    np.testing.assert_array_equal(sur.query(pts), eng.query("oracle", pts))
    g2 = _grids(SCHEME, 8)
    sur.update(g2)
    eng.update("oracle", g2)
    np.testing.assert_array_equal(sur.query(pts), eng.query("oracle", pts))
    _bitwise(sur.surplus, eng.surplus("oracle"))
    assert cl.owners_of("surrogate")
    with pytest.raises(ValueError, match="not both"):
        CTSurrogate(SCHEME, g, engine=eng, cluster=cl)
    with pytest.raises(ValueError, match="durability"):
        CTSurrogate(SCHEME, g, cluster=cl, store=object())


def test_over_device_slices_raises_naming_a9():
    """Twin of the reference's ``test_meshed_hosts_over_disjoint_device_
    slices`` (once unported, ROADMAP A9): hosts over disjoint slices of 8
    devices (the CPU repeated), each tenant slab-sharded on its owner's
    slice, answers bitwise an unmeshed engine's, before and after its
    primary is killed."""
    cl = CTCluster.over_device_slices(4, seed=11, devices=["cpu"] * 8)
    assert all(h.spec.mesh.shape == {"slab": 2}
               for h in cl._hosts.values())
    g = _grids(SCHEME, 1)
    cl.register("t", SCHEME, g)
    eng = CTEngine(device="cpu", ingest_workers=0)
    eng.register("t", SCHEME, g)
    pts = np.random.default_rng(7).random((16, 3))
    _bitwise(cl.query("t", pts), eng.query("t", pts))
    victim = cl.owners_of("t")[0]
    cl.injector.kill(victim)
    cl.check_health()
    _bitwise(cl.query("t", pts), eng.query("t", pts))


def test_cluster_failover_retry_is_donation_safe():
    """Twin of the reference's donation-safety test: the cluster routes
    host numpy copies, so each engine stages fresh tensors per dispatch,
    the caller's tensors are never released, and the promoted future of a
    ``donate=True`` tenant resolves with a value."""
    scheme = CombinationScheme(2, 3)
    cl = CTCluster(4, replication=2, seed=11, spec=ExecSpec(donate=True),
                   device="cpu")
    cl.register("t", scheme, _grids(scheme, 6))
    pts = np.random.default_rng(60).random((8, 2))
    base = cl.query("t", pts)
    payload = {ell: torch.from_numpy(v)
               for ell, v in _grids(scheme, 7).items()}
    cl.start()
    try:
        victim = cl.owners_of("t")[0]
        fut = cl.submit_ingest("t", payload)
        cl.injector.kill(victim)
        assert torch.isfinite(fut.result(WAIT)).all()
        after = cl.query("t", pts)
        assert not np.array_equal(after, base)
        assert cl.stats()["host_failed"] == 0
        from repro_torch.kernels.hierarchize import storage_released
        assert not any(storage_released(v) for v in payload.values())
    finally:
        cl.stop()


# ---------------------------------------------------------------------------
# Threaded stress: 8 submitters, mid-run kill, zero hung or dropped futures
# ---------------------------------------------------------------------------

def test_stress_eight_submitters_mid_run_kill_no_dropped_futures():
    cl = _cluster(replication=1)
    cl.start()
    futures, flock = [], threading.Lock()
    stop_evt = threading.Event()
    pts = np.random.default_rng(8).random((8, 3))

    def submitter(tid):
        rng = np.random.default_rng(100 + tid)
        k = 0
        while not stop_evt.is_set():
            name = f"t{int(rng.integers(6))}"
            try:
                if tid < 2 and k % 3 == 0:
                    ell = SCHEME.grids[int(rng.integers(
                        len(SCHEME.grids)))][0]
                    f = cl.submit_ingest(name, {
                        ell: rng.standard_normal(grid_shape(ell))})
                else:
                    f = cl.submit_query(name, pts)
                with flock:
                    futures.append(f)
            except (KeyError, HostFailed, EngineSaturated):
                pass                          # named routing errors
            k += 1
            time.sleep(0.002)

    threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
               for i in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.6)
        victim = cl.owners_of("t0")[0]
        cl.injector.kill(victim)
        assert _wait_for(lambda: victim not in cl.live_hosts())
        time.sleep(0.6)
    finally:
        stop_evt.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    hung = dropped = 0
    for f in futures:
        if not f.wait(WAIT):
            hung += 1
            continue
        err = f.error()
        if err is not None and not isinstance(
                err, (HostFailed, FloatingPointError, KeyError,
                      EngineSaturated)):
            dropped += 1
    assert hung == 0 and dropped == 0
    assert len(futures) > 50
    cl.stop()
    assert cl.stats()["inflight"] == 0
    for n in cl.names():
        assert victim not in cl.owners_of(n)
        out = cl.query(n, pts)
        assert np.all(np.isfinite(out))
        np.testing.assert_array_equal(out, _fresh_oracle(cl, n, pts))


# ---------------------------------------------------------------------------
# ClusterFuture: retarget and resolve are atomic
# ---------------------------------------------------------------------------

class _FakeInner:
    def __init__(self, done_at=None):
        self.done_at = done_at

    def done(self):
        return False

    def wait(self, timeout=None):
        return False


def test_cluster_future_retarget_vs_resolve_atomic():
    for _ in range(200):
        fut = ClusterFuture(None, "ingest", "t", "h0",
                            _FakeInner(done_at=123.0))
        barrier = threading.Barrier(3)
        new_inner = _FakeInner(done_at=None)

        def resolve():
            barrier.wait()
            fut._finalize_locked(value="v")

        def retarget():
            barrier.wait()
            fut._retarget_locked("h1", new_inner)

        threads = [threading.Thread(target=resolve),
                   threading.Thread(target=retarget)]
        for t in threads:
            t.start()
        barrier.wait()
        for t in threads:
            t.join(timeout=30)
        assert fut._done and fut._value == "v" and fut._error is None
        assert fut.done_at is not None
        if fut.retargeted == 0:
            assert fut._host_id == "h0" and fut.done_at == 123.0
        else:
            assert fut.retargeted == 1 and fut._host_id == "h1"
        fut._finalize_locked(error=RuntimeError("late"))
        assert fut._value == "v" and fut._error is None
        assert fut.stale_seq is None


# ---------------------------------------------------------------------------
# Deliberate deviations from the reference (ROADMAP Queue C), pinned
# ---------------------------------------------------------------------------

def test_last_live_host_is_never_failed():
    """The reference marks the last live host dead before raising, and
    everything routed at it then hangs; the port raises first and the host
    keeps serving."""
    scheme = CombinationScheme(2, 3)
    cl = _cluster(2, 2, scheme=scheme)
    ref = rcluster.CTCluster(2, seed=11)
    rscheme = rlev.CombinationScheme(2, 3)
    for i in range(2):
        ref.register(f"t{i}", rscheme, _grids(rscheme, i))
    for c, named in ((cl, HostFailed), (ref, rcluster.HostFailed)):
        survivor = [h for h in c.hosts() if h != "host0"][0]
        c.fail_host("host0")
        assert c.live_hosts() == (survivor,)
        with pytest.raises(named, match="last live host"):
            c.fail_host(survivor)
    assert ref.live_hosts() == ()
    assert cl.live_hosts() == (survivor,)
    pts = np.random.default_rng(9).random((4, 2))
    for n in cl.names():
        assert cl.query(n, pts).shape == (4,)


def test_queued_queries_follow_a_moved_tenant():
    """Queries queued on a host that a rebalance takes a tenant from are
    resubmitted to the new primary and resolve with values; the
    reference's ex-owner fails them with ``KeyError``."""
    scheme = CombinationScheme(2, 3)
    rscheme = rlev.CombinationScheme(2, 3)
    pts = np.random.default_rng(10).random((4, 2))
    outcomes = {}
    for pkg, make, sch in (
            ("port", lambda: CTCluster(3, seed=11, device="cpu"), scheme),
            ("ref", lambda: rcluster.CTCluster(3, seed=11), rscheme)):
        cl = make()
        for i in range(8):
            cl.register(f"t{i}", sch, _grids(sch, i))
        futs = {n: cl.submit_query(n, pts) for n in cl.names()}  # queued
        before = {n: cl.owners_of(n) for n in cl.names()}
        cl.add_host()
        moved = [n for n in cl.names() if cl.owners_of(n) != before[n]]
        assert moved
        errs = {}
        for n in moved:
            assert futs[n].wait(WAIT)
            errs[n] = type(futs[n].error()).__name__ \
                if futs[n].error() is not None else None
        outcomes[pkg] = errs
    assert set(outcomes["port"].values()) == {None}
    assert set(outcomes["ref"].values()) == {"KeyError"}


def test_adopted_restart_with_a_wal_tail_serves_the_adopted_state(tmp_path):
    """A restarted host whose restored tenant advanced elsewhere adopts it
    from the live owner; the restore's deferred WAL entries die with the
    stale copy.  The port's watermark steps past them, so the adopted
    state serves; the reference's stays behind (its ``surplus()`` and
    fresh queries would wait for entries that never run)."""
    scheme = CombinationScheme(2, 3)
    rscheme = rlev.CombinationScheme(2, 3)
    pts = np.random.default_rng(11).random((8, 2))
    got = {}
    for pkg, cls, sch, kw in (
            ("port", CTCluster, scheme, dict(device="cpu")),
            ("ref", rcluster.CTCluster, rscheme, {})):
        cl = cls(2, replication=1, seed=7, snapshot_interval=2,
                 durability_dir=str(tmp_path / pkg), **kw)
        cl.register("t", sch, _grids(sch, 50))
        for seed in (51, 52):           # a snapshot at 2, a WAL entry at 3
            cl.update("t", _grids(sch, seed))
        victim = cl.owners_of("t")[0]
        cl.injector.kill(victim)
        assert cl.check_health() == [victim]
        cl.update("t", _grids(sch, 53))  # advances on the new owner
        assert cl.restart_host(victim) == {"t": "adopted"}
        eng = cl.engine(victim)
        got[pkg] = (eng._ingest_done["t"], eng._ingest_submitted["t"], cl)
    done, submitted, cl = got["port"]
    assert done >= submitted
    oracle = CTEngine(device="cpu", ingest_workers=0)
    oracle.register("t", scheme, _grids(scheme, 53))
    _bitwise(cl.surplus("t"), oracle.surplus("t"))
    np.testing.assert_array_equal(cl.query("t", pts),
                                  oracle.query("t", pts))
    rdone, rsubmitted, _ = got["ref"]
    assert rdone < rsubmitted


def test_a_saturated_host_that_pumps_is_not_struck():
    """A full queue on a host whose scheduler pumps (fresh heartbeat) is
    load, answered by backpressure: the probe counts as no probe, and the
    host is not failed over (the reference strikes it)."""
    cl = _cluster(2, 2, scheme=CombinationScheme(2, 3))
    cl.start()
    try:
        host = cl._hosts["host0"]
        host.engine._max_pending = 0         # every admission refused
        for _ in range(4):
            assert cl.check_health() == []
        assert host.alive and cl._health.strikes.get("host0", 0) == 0
    finally:
        cl._hosts["host0"].engine._max_pending = 1024
        cl.stop()
