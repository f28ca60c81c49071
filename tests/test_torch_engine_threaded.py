"""Concurrency stress tier of the port's ``CTEngine``, on the CPU: the eight
scenarios of the reference's ``tests/test_engine_threaded.py``.

Each hammers the engine (or the process-global caches) from many threads
and asserts the serving contract: no dropped or hung futures, exact cache
accounting, results bitwise a single-threaded replay, warn-once under
contention.  The first scenario is also held to the reference's engine on
the same seeds (surpluses bitwise, answers at rtol 1e-12: the eval's
products sum in another order).  Every join and wait is bounded.  The
kernel wrappers' launch counters and ``record_calls`` are not
thread-safe, so nothing here reads them.
"""

import threading
import time
import warnings
import zlib

import numpy as np
import pytest

from repro.core import engine as rengine
from repro.core import levels as rlev
from repro_torch.core import engine as E
from repro_torch.core import executor as X
from repro_torch.core.engine import (CTEngine, clear_compile_cache,
                                     plan_signature)
from repro_torch.core.executor import build_plan, clear_plan_cache
from repro_torch.core.levels import CombinationScheme, GeneralScheme, grid_shape

pytestmark = pytest.mark.threaded

N_THREADS = 8
RESULT_TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_compile_cache()
    clear_plan_cache()
    E.reset_deprecation_warnings()
    yield


def _random_grids(scheme, rng):
    return {ell: rng.standard_normal(grid_shape(ell))
            for ell, _ in scheme.grids}


def _engine(**kw) -> CTEngine:
    return CTEngine(device="cpu", **kw)


def _run_threads(fns):
    """Run one callable per thread; re-raise the first worker error."""
    errors = []
    barrier = threading.Barrier(len(fns))

    def wrap(fn):
        try:
            barrier.wait(timeout=30)
            fn()
        except BaseException as exc:           # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=wrap, args=(fn,), daemon=True)
               for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RESULT_TIMEOUT)
        assert not t.is_alive(), "worker thread hung"
    if errors:
        raise errors[0]


def test_threaded_mixed_load_bit_identical_to_serial_replay():
    """8 submitter threads drive 9 tenants (3 schemes x 3 tenants) with
    closed-loop ingest/query traffic against one started engine; every
    tenant's answers are bitwise the same workload replayed on one thread,
    and its final surplus bitwise the reference's fed the same ingests."""
    dims = [(2, 3), (2, 4), (3, 3)]
    schemes = [CombinationScheme(*d) for d in dims]
    tenants = [(f"t{s}_{k}", s) for s in range(3) for k in range(3)]
    rounds = 4

    def tenant_workload(name, scheme):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        return [(_random_grids(scheme, rng), rng.random((8, scheme.dim)))
                for _ in range(rounds)]

    workloads = {name: tenant_workload(name, schemes[s])
                 for name, s in tenants}

    def drive(engine, results, my_tenants):
        """Closed loop per tenant: ingest_r -> query_r -> wait."""
        cursors = {name: 0 for name in my_tenants}
        while cursors:
            for name in list(cursors):
                r = cursors[name]
                grids, pts = workloads[name][r]
                fi = engine.submit_ingest(name, grids)
                fq = engine.submit_query(name, pts)
                val = fq.result(timeout=RESULT_TIMEOUT)
                fi.result(timeout=RESULT_TIMEOUT)
                results[name].append(np.asarray(val).copy())
                cursors[name] = r + 1
                if cursors[name] == rounds:
                    del cursors[name]

    eng = _engine(deadline_ms=5.0)
    for name, s in tenants:
        eng.register(name, schemes[s], workloads[name][0][0])
    got = {name: [] for name, _ in tenants}
    shards = [[] for _ in range(N_THREADS)]
    for i, (name, _) in enumerate(tenants):
        shards[i % N_THREADS].append(name)
    with eng:
        _run_threads([(lambda names=names: drive(eng, got, names))
                      for names in shards if names])
    eng.close()

    serial = _engine(ingest_workers=0)
    ref_eng = rengine.CTEngine()
    for name, s in tenants:
        serial.register(name, schemes[s], workloads[name][0][0])
        ref_eng.register(name, rlev.CombinationScheme(*dims[s]),
                         workloads[name][0][0])
    want = {name: [] for name, _ in tenants}
    ref = {name: [] for name, _ in tenants}
    for name, _ in tenants:
        drive(serial, want, [name])
        drive(ref_eng, ref, [name])

    for name, _ in tenants:
        assert len(got[name]) == rounds, f"{name}: dropped results"
        for r in range(rounds):
            assert got[name][r].tobytes() == want[name][r].tobytes(), \
                f"{name} round {r} diverged from the serial replay"
            np.testing.assert_allclose(got[name][r], ref[name][r],
                                       rtol=1e-12, atol=1e-14)
        surplus = eng.surplus(name).numpy()
        assert surplus.tobytes() == np.asarray(
            ref_eng.surplus(name)).tobytes(), name
    st = eng.stats()
    assert st["scheduler"]["pending"] == 0
    assert st["ingests"] >= 9 * rounds


def test_ingest_cache_accounting_two_engines_eight_threads():
    """8 threads bind tenants across 2 engines at once: every signature is
    in the shared cache once, and hits + misses account for every bind
    (one miss per signature)."""
    schemes = [CombinationScheme(2, 2), CombinationScheme(2, 3),
               CombinationScheme(3, 2), CombinationScheme(2, 4)]
    engines = [_engine(), _engine()]
    binds_per_thread = 8

    def worker(tid):
        rng = np.random.default_rng(tid)
        for j in range(binds_per_thread):
            eng = engines[(tid + j) % 2]
            scheme = schemes[(tid * binds_per_thread + j) % len(schemes)]
            eng.register(f"w{tid}_{j}", scheme, _random_grids(scheme, rng))

    _run_threads([lambda tid=t: worker(tid) for t in range(N_THREADS)])

    sigs = {plan_signature(build_plan(s), E.ExecSpec()) for s in schemes}
    with E._INGEST_CACHE_LOCK:
        cached = set(E._INGEST_EXECUTABLES)
    assert sigs <= cached, "lost executables under concurrent binding"
    hits = sum(e._counters["cache_hits"] for e in engines)
    misses = sum(e._counters["cache_misses"] for e in engines)
    assert hits + misses == N_THREADS * binds_per_thread
    assert misses == len(schemes), \
        f"expected exactly one miss per signature, got {misses}"
    pts2 = np.random.default_rng(1).random((4, 2))
    pts3 = np.random.default_rng(2).random((4, 3))
    for eng in engines:
        for name in eng.names():
            dim = eng.scheme(name).dim
            assert eng.query(name, pts3 if dim == 3 else pts2).shape == (4,)


def test_concurrent_flush_never_drops_submissions():
    scheme = CombinationScheme(2, 3)
    eng = _engine(max_pending=10_000)
    eng.register("t", scheme, _random_grids(scheme, np.random.default_rng(3)))
    pts = np.random.default_rng(30).random((4, 2))
    per_thread = 50
    all_futs = [[] for _ in range(N_THREADS)]
    stop = threading.Event()

    def flusher():
        while not stop.is_set():
            eng.flush()
        eng.flush()

    def submitter(tid):
        for _ in range(per_thread):
            all_futs[tid].append(eng.submit_query("t", pts))

    fl = threading.Thread(target=flusher, daemon=True)
    fl.start()
    try:
        _run_threads([lambda tid=t: submitter(tid) for t in range(N_THREADS)])
    finally:
        stop.set()
        fl.join(timeout=30)
    assert not fl.is_alive()
    want = eng.query("t", pts)
    for futs in all_futs:
        assert len(futs) == per_thread
        for f in futs:
            assert f.result(timeout=RESULT_TIMEOUT).tobytes() == \
                want.tobytes()
    assert eng.stats()["scheduler"]["pending"] == 0


def test_unregister_racing_queued_work_resolves_every_future():
    scheme = CombinationScheme(2, 3)
    grids = _random_grids(scheme, np.random.default_rng(4))
    eng = _engine(max_pending=10_000)
    eng.register("t", scheme, grids)
    pts = np.random.default_rng(40).random((4, 2))
    rounds = 30
    futs_lock = threading.Lock()
    futs = []

    def submitter():
        for _ in range(rounds):
            batch = []
            try:
                batch.append(eng.submit_ingest("t", grids))
                batch.append(eng.submit_query("t", pts))
            except KeyError:
                pass                       # raced the unregister window
            with futs_lock:
                futs.extend(batch)
            eng.flush()

    def churner():
        for _ in range(rounds):
            eng.unregister("t")
            eng.register("t", scheme, grids)
            time.sleep(0.002)              # dwell registered

    _run_threads([submitter] * (N_THREADS - 1) + [churner])
    eng.flush()
    futs.append(eng.submit_ingest("t", grids))
    futs.append(eng.submit_query("t", pts))
    eng.flush()

    outcomes = {"ok": 0, "keyerror": 0}
    for f in futs:
        try:
            f.result(timeout=RESULT_TIMEOUT)
            outcomes["ok"] += 1
        except KeyError as exc:
            assert "unregistered" in str(exc)
            outcomes["keyerror"] += 1
    assert outcomes["ok"] + outcomes["keyerror"] == len(futs)
    assert outcomes["ok"] > 0
    assert eng.stats()["scheduler"]["pending"] == 0


@pytest.mark.parametrize("respec", [False, True])
def test_reregistered_mid_flight_ingest_resolves_as_the_reference(respec):
    """A queued ingest whose tenant is unregistered and registered anew
    while it runs (inside ``_dispatch_ingest``, deterministically) resolves
    with a value on both engines, as the reference's CAS retries it
    against the new record; the port commits the surplus it computed when
    the new record has the same signature and coefficients (no second
    dispatch), and dispatches again when it does not (``respec``: the new
    record is unfused).  Surpluses and served state are bitwise equal."""
    scheme = CombinationScheme(2, 3)
    first = _random_grids(scheme, np.random.default_rng(6))
    second = _random_grids(scheme, np.random.default_rng(7))
    out = {}
    for pkg, make, spec in (
            ("port", lambda: _engine(ingest_workers=0), E.ExecSpec),
            ("ref", lambda: rengine.CTEngine(ingest_workers=0),
             rengine.ExecSpec)):
        eng = make()
        eng.register("t", scheme, first)
        orig = eng._dispatch_ingest
        calls = []

        def spy(tenant, grids, _eng=eng, _orig=orig, _calls=calls,
                _spec=spec):
            _calls.append(tenant)
            if len(_calls) == 1:
                _eng.unregister("t")
                _eng.register("t", scheme, first, spec=_spec(
                    fused=False) if respec else None)
            return _orig(tenant, grids)

        eng._dispatch_ingest = spy
        fut = eng.submit_ingest("t", second)
        eng.flush()
        value = fut.result(timeout=RESULT_TIMEOUT)
        # the served record, read directly: the reference's re-register
        # leaves its done watermark one short of the admitted one, so its
        # ``surplus()`` would wait for an ingest that never comes
        served = eng._tenants["t"].surplus
        if pkg == "port":
            assert eng.surplus("t") is served
        out[pkg] = (np.asarray(value), np.asarray(served),
                    len(calls), eng.stats()["scheduler"]["ingest_retries"])
    port, ref = out["port"], out["ref"]
    for got, want in ((port[0], ref[0]), (port[1], ref[1])):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    assert np.array_equal(port[0], port[1])     # the served state is it
    assert ref[2:] == (3, 1)                    # ingest, register, retry
    assert port[2:] == ((3, 1) if respec else (2, 0))


def test_refit_racing_queued_ingests_commits_consistently():
    gs = GeneralScheme.regular(2, 2)
    grown = gs.with_levels([(3, 1)])
    rng = np.random.default_rng(5)
    grids_small = _random_grids(gs, rng)
    grids_big = _random_grids(grown, rng)
    eng = _engine(max_pending=10_000)
    rounds = 20
    futs_lock = threading.Lock()
    futs = []
    eng.register("t", gs, grids_small)

    def submitter():
        for _ in range(rounds):
            try:
                f = eng.submit_ingest("t", grids_big)   # valid on both plans
            except KeyError:
                continue
            with futs_lock:
                futs.append(f)
            eng.flush()

    def refitter():
        for i in range(rounds):
            try:
                if i % 2 == 0:
                    eng.refit("t", grown, grids_big)
                else:
                    eng.unregister("t")
                    eng.register("t", gs, grids_small)
            except KeyError:
                pass                       # raced another lifecycle op
            eng.flush()

    _run_threads([submitter] * (N_THREADS - 1) + [refitter])
    eng.flush()
    for f in futs:
        try:
            f.result(timeout=RESULT_TIMEOUT)
        except (KeyError, ValueError):
            pass                # a named failure is fine; a hang is not
    assert bool(np.all(np.isfinite(eng.surplus("t").numpy())))


def test_legacy_warning_fires_once_per_family_under_threads():
    E.reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _run_threads([
            (lambda: [X.warn_legacy_kwargs("stress_fn", ["mesh"])
                      for _ in range(100)])
            for _ in range(N_THREADS)])
        deps = [x for x in w if issubclass(x.category, DeprecationWarning)]
        assert len(deps) == 1, \
            f"warn-once family fired {len(deps)} times under threads"
        E.reset_deprecation_warnings()
        X.warn_legacy_kwargs("stress_fn", ["mesh"])
        deps = [x for x in w if issubclass(x.category, DeprecationWarning)]
        assert len(deps) == 2


def test_plan_cache_identity_stable_under_threads():
    scheme = CombinationScheme(2, 4)
    plans = [None] * N_THREADS

    def worker(tid):
        plans[tid] = build_plan(scheme)

    _run_threads([lambda tid=t: worker(tid) for t in range(N_THREADS)])
    assert all(p is plans[0] for p in plans), \
        "concurrent builders observed different cached plan objects"
    stop = threading.Event()

    def clearer():
        while not stop.is_set():
            clear_plan_cache()

    def builder():
        for _ in range(200):
            p = build_plan(scheme)
            assert p.fine_shape == plans[0].fine_shape

    cl = threading.Thread(target=clearer, daemon=True)
    cl.start()
    try:
        _run_threads([builder for _ in range(4)])
    finally:
        stop.set()
        cl.join(timeout=30)
    assert not cl.is_alive()


def test_started_engine_sustains_threaded_submitters_without_flush():
    scheme = CombinationScheme(2, 3)
    eng = _engine(deadline_ms=2.0, max_pending=10_000)
    eng.register("t", scheme, _random_grids(scheme, np.random.default_rng(6)))
    pts = np.random.default_rng(60).random((4, 2))
    want = eng.query("t", pts)
    per_thread = 25

    def submitter():
        for _ in range(per_thread):
            f = eng.submit_query("t", pts)
            assert f.wait(timeout=RESULT_TIMEOUT), "future hung"
            assert f.result().tobytes() == want.tobytes()

    with eng:
        _run_threads([submitter for _ in range(N_THREADS)])
    st = eng.stats()
    assert st["scheduler"]["pending"] == 0
    assert st["eval"]["queries"] >= N_THREADS * per_thread
