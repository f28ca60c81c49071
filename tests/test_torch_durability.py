"""The port's durable tenant store (``repro_torch.runtime.durability``) and
the engine's store seams, on the CPU: the scenarios of the reference's
``tests/test_durability.py`` on the port (WAL roundtrip and rotation, torn
against corrupt records, crash-mid-snapshot fallback, ``RetryPolicy``, and
the bar that a restored engine answers bitwise as one that never
crashed), and three cross-package tests on ``CombinationScheme(2, 4)`` in
f64: a store the port's engine writes restores in the reference's
``CTEngine`` (bitwise the reference fed the same ingests), a store the
reference writes restores in the port (bitwise), and equal appends at an
equal clock give byte-equal WAL segments and ``meta.json`` files.
"""

import os
import time

import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.core import levels as rlev
from repro.runtime import durability as rdur
from repro_torch.core.engine import CTEngine
from repro_torch.core.levels import CombinationScheme, GeneralScheme, grid_shape
from repro_torch.launch.serve import CTSurrogate
from repro_torch.runtime.durability import (DurableStore, RetryPolicy,
                                            SnapshotCrashed, WALCorrupt,
                                            WALTorn, scheme_from_json,
                                            scheme_to_json)

SCHEME = CombinationScheme(2, 3)
CROSS = CombinationScheme(2, 4)
RCROSS = rlev.CombinationScheme(2, 4)       # the reference's twin


def _grids(seed, scheme=SCHEME):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(grid_shape(ell))
            for ell, _ in scheme.grids}


def _engine(**kw) -> CTEngine:
    return CTEngine(device="cpu", ingest_workers=0, **kw)


def _bitwise(got, want) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.fixture
def store(tmp_path):
    return DurableStore(str(tmp_path), "hostA", fsync_every=2)


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

def test_retry_policy_delay_shape():
    p = RetryPolicy(attempts=5, base_delay_s=0.01, max_delay_s=0.04,
                    multiplier=2.0, jitter=0.0)
    ds = list(p.delays())
    assert len(ds) == 5
    assert ds[0] == 0.0
    assert ds[1:] == [0.01, 0.02, 0.04, 0.04]


def test_retry_policy_jitter_deterministic_under_seeded_rng():
    p = RetryPolicy(attempts=4, base_delay_s=0.01, jitter=0.5)
    a = list(p.delays(np.random.default_rng(7)))
    b = list(p.delays(np.random.default_rng(7)))
    assert a == b
    assert all(d >= 0.0 for d in a)
    assert a == list(rdur.RetryPolicy(attempts=4, base_delay_s=0.01,
                                      jitter=0.5).delays(
        np.random.default_rng(7)))


def test_retry_policy_run_retries_then_raises():
    calls = []

    def flaky():
        calls.append(1)
        raise KeyError("nope")

    p = RetryPolicy(attempts=3, base_delay_s=0.0)
    with pytest.raises(KeyError):
        p.run(flaky, retry_on=(KeyError,), sleep=False)
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(ValueError):
        p.run(lambda: (_ for _ in ()).throw(ValueError("x")),
              retry_on=(KeyError,), sleep=False)


def test_retry_policy_validates_attempts():
    with pytest.raises(ValueError):
        RetryPolicy(attempts=0)


# ---------------------------------------------------------------------------
# Scheme (de)serialization
# ---------------------------------------------------------------------------

def test_scheme_json_roundtrip():
    for scheme in (CombinationScheme(3, 4),
                   GeneralScheme(dim=2, index_set=((1, 1), (2, 1), (1, 2)))):
        back = scheme_from_json(scheme_to_json(scheme))
        assert type(back) is type(scheme)
        assert {tuple(e) for e, _ in back.grids} \
            == {tuple(e) for e, _ in scheme.grids}


# ---------------------------------------------------------------------------
# WAL roundtrip, rotation, torn/corrupt records
# ---------------------------------------------------------------------------

def test_wal_roundtrip_bit_identical(store):
    store.register("t", SCHEME)
    payloads = {s: _grids(s) for s in (1, 2, 3)}
    for seq, g in payloads.items():
        # tensors are journaled through their host copies
        store.append("t", seq, {k: torch.from_numpy(v) for k, v in g.items()}
                     if seq == 2 else g, tag=seq * 10)
    state = store.load("t")
    assert [e.seq for e in state.entries] == [1, 2, 3]
    assert [e.tag for e in state.entries] == [10, 20, 30]
    for e in state.entries:
        for ell, v in payloads[e.seq].items():
            _bitwise(e.grids[tuple(ell)], v)
    assert state.max_seq == 3 and state.max_tag == 30


def test_snapshot_rotates_and_prunes_wal(store):
    store.register("t", SCHEME)
    for seq in (1, 2, 3):
        store.append("t", seq, _grids(seq), tag=seq)
    surplus = torch.arange(12.0, dtype=torch.float64)
    store.snapshot("t", 3, surplus, tag=3, scheme=SCHEME)
    store.append("t", 4, _grids(4), tag=4)
    state = store.load("t")
    assert state.snapshot_seq == 3 and state.snapshot_tag == 3
    _bitwise(state.surplus, surplus.numpy())
    assert [e.seq for e in state.entries] == [4]
    segs = [fn for fn in os.listdir(store._dir("t"))
            if fn.startswith("wal-")]
    assert len(segs) == 1
    assert store.stats()["rotations"] == 1


def test_torn_tail_tolerated_mid_log_corruption_raises(store):
    store.register("t", SCHEME)
    for seq in (1, 2):
        store.append("t", seq, _grids(seq), tag=seq)
    store.flush("t")
    seg = next(os.path.join(store._dir("t"), fn)
               for fn in os.listdir(store._dir("t"))
               if fn.startswith("wal-"))
    data = open(seg, "rb").read()
    with open(seg, "wb") as f:
        f.write(data[:-7])
    state = store.load("t")
    assert [e.seq for e in state.entries] == [1]
    assert any("torn" in ev for ev in state.events)
    with open(seg, "wb") as f:
        bad = bytearray(data)
        bad[40] ^= 0xFF
        f.write(bad)
    with pytest.raises(WALCorrupt):
        store.load("t")


def test_tear_next_append_seam(store):
    store.register("t", SCHEME)
    store.append("t", 1, _grids(1), tag=1)
    store.tear_next_append()
    with pytest.raises(WALTorn):
        store.append("t", 2, _grids(2), tag=2)
    state = store.load("t")
    assert [e.seq for e in state.entries] == [1]
    store.append("t", 2, _grids(2), tag=2)
    assert [e.seq for e in store.load("t").entries] == [1, 2]


def test_crash_mid_snapshot_previous_snapshot_survives(store):
    store.register("t", SCHEME)
    s1 = np.arange(4.0)
    store.snapshot("t", 2, s1, tag=2, scheme=SCHEME)
    store.append("t", 3, _grids(3), tag=3)
    store.fail_next_snapshot()
    with pytest.raises(SnapshotCrashed):
        store.snapshot("t", 3, np.arange(8.0), tag=3, scheme=SCHEME)
    state = store.load("t")
    assert state.snapshot_seq == 2
    _bitwise(state.surplus, s1)
    assert [e.seq for e in state.entries] == [3]
    assert store.stats()["snapshot_failures"] == 1


def test_pending_after_filters_by_tag(store):
    store.register("t", SCHEME)
    for seq, tag in ((1, 5), (2, 6), (3, 7)):
        store.append("t", seq, _grids(seq), tag=tag)
    assert [e.tag for e in store.pending_after("t", 5)] == [6, 7]
    assert store.pending_after("t", 7) == []
    assert store.pending_after("missing", 0) == []


def test_discard_drops_state(store):
    store.register("t", SCHEME)
    store.append("t", 1, _grids(1))
    store.discard("t")
    assert "t" not in store.tenants()
    with pytest.raises(KeyError):
        store.load("t")


# ---------------------------------------------------------------------------
# Engine-level: journal at admission, snapshot on interval, restore
# ---------------------------------------------------------------------------

def _oracle(payloads, scheme=SCHEME):
    e = _engine(host_id="oracle")
    e.register("t", scheme, payloads[0])
    for g in payloads[1:]:
        e.update("t", g)
    return e


def test_engine_restore_bit_identical_to_never_crashed(tmp_path):
    store = DurableStore(str(tmp_path), "h0")
    eng = _engine(host_id="h0", store=store, snapshot_interval=3)
    payloads = [_grids(s) for s in range(8)]
    eng.register("t", SCHEME, payloads[0])
    for g in payloads[1:]:
        eng.update("t", g)
    # crash: the engine is abandoned; the store survives
    eng2 = _engine(host_id="h0", store=store, snapshot_interval=3)
    info = eng2.restore(store)["t"]
    assert info.snapshot_seq > 0
    assert info.pending >= 1
    assert info.replayed == info.pending
    oracle = _oracle(payloads)
    _bitwise(eng2.surplus("t"), oracle.surplus("t").numpy())
    pts = np.random.default_rng(3).random((17, 2))
    _bitwise(eng2.query("t", pts), oracle.query("t", pts))


def test_engine_restore_survives_crashed_snapshot(tmp_path):
    store = DurableStore(str(tmp_path), "h0")
    eng = _engine(host_id="h0", store=store, snapshot_interval=2)
    payloads = [_grids(s) for s in range(5)]
    eng.register("t", SCHEME, payloads[0])
    eng.update("t", payloads[1])
    store.fail_next_snapshot()
    for g in payloads[2:]:
        eng.update("t", g)
    eng2 = _engine(host_id="h0", store=store, snapshot_interval=2)
    eng2.restore(store)
    _bitwise(eng2.surplus("t"), _oracle(payloads).surplus("t").numpy())
    assert store.stats()["snapshot_failures"] == 1


def test_engine_restore_replay_deferred_serves_stale_then_catches_up(
        tmp_path):
    store = DurableStore(str(tmp_path), "h0")
    eng = _engine(host_id="h0", store=store, snapshot_interval=3)
    payloads = [_grids(s) for s in range(7)]
    eng.register("t", SCHEME, payloads[0])
    for g in payloads[1:]:
        eng.update("t", g)
    eng2 = _engine(host_id="h0", store=store, snapshot_interval=3)
    info = eng2.restore(store, replay=False)["t"]
    assert info.pending > 0 and info.replayed == 0
    pts = np.random.default_rng(4).random((9, 2))
    snap_oracle = _oracle(payloads[:info.snapshot_seq])
    stale = eng2.submit_query("t", pts, stale_ok=True, block=True)
    eng2.flush()
    _bitwise(stale.result(60.0), snap_oracle.query("t", pts))
    out = eng2.replay()["t"]
    assert out["replayed"] == info.pending
    _bitwise(eng2.query("t", pts), _oracle(payloads).query("t", pts))


def test_engine_torn_append_fails_admission_nothing_acked_lost(tmp_path):
    store = DurableStore(str(tmp_path), "h0")
    eng = _engine(host_id="h0", store=store, snapshot_interval=100)
    payloads = [_grids(s) for s in range(3)]
    eng.register("t", SCHEME, payloads[0])
    eng.update("t", payloads[1])
    store.tear_next_append()
    with pytest.raises(WALTorn):
        eng.update("t", payloads[2])
    eng2 = _engine(host_id="h0", store=store, snapshot_interval=100)
    eng2.restore(store)
    _bitwise(eng2.surplus("t"), _oracle(payloads[:2]).surplus("t").numpy())


def test_engine_unregister_discards_durable_state(tmp_path):
    store = DurableStore(str(tmp_path), "h0")
    eng = _engine(host_id="h0", store=store)
    eng.register("t", SCHEME, _grids(0))
    assert "t" in store.tenants()
    eng.unregister("t")
    assert "t" not in store.tenants()
    assert _engine(host_id="h0", store=store).restore(store) == {}


def test_surrogate_store_passthrough_and_restore(tmp_path):
    store = DurableStore(str(tmp_path), "h0")
    payloads = [_grids(s) for s in range(5)]
    sur = CTSurrogate(SCHEME, payloads[0], store=store, snapshot_interval=2,
                      device="cpu")
    for g in payloads[1:]:
        sur.update(g)
    back = CTSurrogate.restore(store, device="cpu")
    pts = np.random.default_rng(9).random((11, 2))
    oracle = _oracle(payloads)
    _bitwise(back.query(pts), oracle.query("t", pts))
    _bitwise(back.surplus, oracle.surplus("t").numpy())
    with pytest.raises(ValueError, match="store="):
        CTSurrogate(SCHEME, payloads[0], store=store,
                    engine=_engine(host_id="x"))
    with pytest.raises(KeyError):
        CTSurrogate.restore(store, name="missing", device="cpu")


def test_engine_stats_expose_durability(tmp_path):
    store = DurableStore(str(tmp_path), "h0")
    eng = _engine(host_id="h0", store=store, snapshot_interval=2)
    eng.register("t", SCHEME, _grids(0))
    eng.update("t", _grids(1))
    d = eng.stats()["durability"]
    assert d["snapshot_interval"] == 2
    assert d["appends"] >= 2
    assert _engine(host_id="plain").stats()["durability"] is None


@pytest.mark.parametrize("bad,error", [(None, TypeError), (2.5, TypeError),
                                       (True, TypeError), (-1, ValueError)])
def test_engine_refuses_a_bad_snapshot_interval(tmp_path, bad, error):
    """ROADMAP Queue C, C16: the port refuses at construction what the
    reference takes and fails on later, on the pool thread."""
    with pytest.raises(error, match="snapshot_interval"):
        _engine(store=DurableStore(str(tmp_path), "h0"),
                snapshot_interval=bad)
    _engine(store=DurableStore(str(tmp_path), "h1"), snapshot_interval=0)


def test_a_failing_snapshot_does_not_strand_the_chain(tmp_path):
    """C16.  A snapshot that raises on the ingest pool's thread (here the
    reference's own trigger, ``snapshot_interval=None`` set past the
    constructor's check) is logged and counted, and the tenant's later
    queued ingests still run.  The reference's chain ends at the first
    snapshot: its second ingest's future never resolves."""
    payloads = [_grids(s) for s in range(4)]
    store = DurableStore(str(tmp_path / "port"), "h0")
    eng = CTEngine(device="cpu", ingest_workers=1, store=store,
                   snapshot_interval=2)
    eng._snapshot_interval = None
    eng.register("t", SCHEME, payloads[0])
    futs = [eng.submit_ingest("t", g) for g in payloads[1:]]
    eng.pump()
    for f in futs:
        f.result(timeout=30.0)
    _bitwise(eng.surplus("t"), _oracle(payloads).surplus("t").numpy())
    assert eng.stats()["durability"]["snapshot_errors"] == 3
    assert sum("TypeError" in e for e in store.events) == 3
    eng.close()

    ref = rengine.CTEngine(store=rdur.DurableStore(str(tmp_path / "ref"),
                                                   "h0"),
                           snapshot_interval=None, ingest_workers=1)
    ref.register("t", rlev.CombinationScheme(2, 3), payloads[0])
    first, second = (ref.submit_ingest("t", g) for g in payloads[1:3])
    ref.pump()
    first.result(timeout=30.0)
    with pytest.raises(TimeoutError):
        second.result(timeout=1.0)
    ref.close()


# ---------------------------------------------------------------------------
# Across the packages: one store format
# ---------------------------------------------------------------------------

PAYLOADS = [_grids(100 + s, CROSS) for s in range(3)]


@pytest.fixture(scope="module")
def reference_surpluses():
    """The reference's surpluses after the first 2 and all 3 ingests of
    ``PAYLOADS`` (its engine, in memory)."""
    e = rengine.CTEngine(host_id="oracle")
    e.register("t", RCROSS, PAYLOADS[0])
    e.update("t", PAYLOADS[1])
    two = np.asarray(e.surplus("t"))
    e.update("t", PAYLOADS[2])
    return two, np.asarray(e.surplus("t"))


def test_port_store_restores_in_the_reference(tmp_path, reference_surpluses):
    """The port's engine writes a snapshot at seq 2 and one WAL entry; the
    reference's engine adopts the snapshot (bitwise its own seq-2 surplus)
    and replays the entry (bitwise its own final surplus)."""
    eng = _engine(host_id="h0", store=DurableStore(str(tmp_path), "h0"),
                  snapshot_interval=2)
    eng.register("t", CROSS, {k: torch.from_numpy(v) for k, v in
                              PAYLOADS[0].items()})
    for g in PAYLOADS[1:]:
        eng.update("t", g)
    two, three = reference_surpluses
    ref = rengine.CTEngine(host_id="h0",
                           store=rdur.DurableStore(str(tmp_path), "h0"))
    info = ref.restore(replay=False)["t"]
    assert (info.snapshot_seq, info.pending) == (2, 1)
    # the served state before the replay (surplus() would wait for it)
    _bitwise(np.asarray(ref._tenants["t"].surplus), two)
    assert ref.replay()["t"]["replayed"] == 1
    _bitwise(np.asarray(ref.surplus("t")), three)
    _bitwise(eng.surplus("t"), three)


def test_reference_store_restores_in_the_port(tmp_path, reference_surpluses):
    ref = rengine.CTEngine(host_id="h0",
                           store=rdur.DurableStore(str(tmp_path), "h0"),
                           snapshot_interval=2)
    ref.register("t", RCROSS, PAYLOADS[0])
    for g in PAYLOADS[1:]:
        ref.update("t", g)
    ref.close()
    two, three = reference_surpluses
    eng = _engine(host_id="h0", store=DurableStore(str(tmp_path), "h0"))
    info = eng.restore(replay=False)["t"]
    assert (info.snapshot_seq, info.pending) == (2, 1)
    _bitwise(eng._tenants["t"].surplus, two)
    assert eng.replay()["t"]["replayed"] == 1
    _bitwise(eng.surplus("t"), three)


def test_wal_segments_byte_equal_across_packages(tmp_path, monkeypatch):
    """The same appends (tensors in the port, numpy in the reference) at
    the same clock (npz members carry their write time) give byte-equal
    segments and ``meta.json`` files."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ours = DurableStore(str(tmp_path / "port"), "h0")
    theirs = rdur.DurableStore(str(tmp_path / "ref"), "h0")
    for st, scheme in ((ours, CROSS), (theirs, RCROSS)):
        st.register("tenant/ü", scheme, full_levels=(4, 4), deadline_ms=5.0,
                    priority=2)
    for seq, g in enumerate(PAYLOADS, 1):
        ours.append("tenant/ü", seq, {k: torch.from_numpy(v)
                                      for k, v in g.items()},
                    tag=None if seq == 2 else 7 * seq)
        theirs.append("tenant/ü", seq, g, tag=None if seq == 2 else 7 * seq)
    ours.close()
    theirs.close()
    assert os.listdir(ours.root) == os.listdir(theirs.root)
    d_ours, d_theirs = ours._dir("tenant/ü"), theirs._dir("tenant/ü")
    assert os.path.basename(d_ours) == os.path.basename(d_theirs)
    for fn in ("meta.json", "wal-000000.log"):
        with open(os.path.join(d_ours, fn), "rb") as a, \
                open(os.path.join(d_theirs, fn), "rb") as b:
            assert a.read() == b.read(), fn
