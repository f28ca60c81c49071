"""``ExecSpec(donate=True)`` on the port, on the CPU: the non-cluster
scenarios of the reference's ``tests/test_donate_failures.py`` (a NaN
after a donated ingest, a lost compare-and-swap, grids already released)
and its donation case of ``tests/test_engine.py`` (bitwise with and
without donation and against the reference, released or warned, ``donate``
in the plan signature, numpy input safe to ingest again); then what the
port adds: a numpy-backed input is never released, views are kept, a
store refuses released grids before its host copy, and the assembly and
the executor refuse a released grid before anything reads it.

A released tensor must never be read (a read faults: on the CPU the
process crashes, on the card the CUDA context is lost), so these tests
look at released grids only through ``storage_released``.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.core import levels as rlev
from repro_torch.core import executor as tex
from repro_torch.core.engine import (CTEngine, ExecSpec, IngestBuffersDonated,
                                     clear_compile_cache, plan_signature)
from repro_torch.core.levels import CombinationScheme, grid_shape
from repro_torch.kernels import hierarchize as H
from repro_torch.kernels.hierarchize import storage_released
from repro_torch.runtime.durability import DurableStore

SCHEME = CombinationScheme(2, 3)


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_compile_cache()
    yield


def _engine(spec=None, **kw) -> CTEngine:
    return CTEngine(spec, device="cpu", ingest_workers=0, **kw)


def _host_grids(seed, scheme=SCHEME):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(grid_shape(ell))
            for ell, _ in scheme.grids}


def _owned(grids):
    """Tensors that own their storage (releasable), one per grid."""
    return {ell: torch.from_numpy(v).clone() for ell, v in grids.items()}


def _all_released(grids) -> bool:
    return all(storage_released(v) for v in grids.values())


def _bitwise(got, want) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_nan_ingest_with_donation_resolves_named_error():
    """The NaN is found after the grids were donated: the failure surfaces
    as ``IngestBuffersDonated``, not ``FloatingPointError``; the tenant
    keeps its last good surplus and the engine stays healthy."""
    eng = _engine(ExecSpec(donate=True), check_finite=True)
    eng.register("t", SCHEME, _host_grids(0))
    good = eng.surplus("t").clone()

    host = _host_grids(1)
    ell = next(iter(host))
    host[ell] = host[ell].copy()
    host[ell].flat[0] = np.nan
    bad = _owned(host)
    with pytest.raises(IngestBuffersDonated, match="non-finite.*donated"):
        eng.update("t", bad)
    assert _all_released(bad)
    _bitwise(eng.surplus("t"), good.numpy())
    eng.update("t", _host_grids(2))             # still serving

    eng2 = _engine(check_finite=True)
    eng2.register("t", SCHEME, _host_grids(0))
    with pytest.raises(FloatingPointError, match="non-finite"):
        eng2.update("t", host)


def test_refit_race_retry_never_redispatches_donated_grids():
    """A concurrent refit (to the same scheme: the record is replaced, as
    the reference's rebind does) swaps the tenant record while the first
    attempt's donated grids are released: the compare-and-swap fails and
    the retry raises the named error instead of reading released
    storage."""
    eng = _engine(ExecSpec(donate=True))
    eng.register("t", SCHEME, _host_grids(2))
    staged = _owned(_host_grids(3))
    orig = eng._dispatch_ingest
    fired = []

    def racy(tenant, nodal_grids):
        out = orig(tenant, nodal_grids)
        if not fired:
            fired.append(True)
            eng.refit("t", SCHEME, _host_grids(4))
        return out

    eng._dispatch_ingest = racy
    with pytest.raises(IngestBuffersDonated, match="donated.*deleted"):
        eng.update("t", staged)
    assert fired and _all_released(staged)
    assert eng.stats()["scheduler"]["ingest_retries"] == 1


def test_explicitly_released_payload_fails_named_before_any_read():
    eng = _engine(ExecSpec(donate=True))
    eng.register("t", SCHEME, _host_grids(4))
    staged = _owned(_host_grids(5))
    for v in staged.values():
        v.untyped_storage().resize_(0)
    with H.record_calls() as calls:
        with pytest.raises(IngestBuffersDonated, match="donated"):
            eng.update("t", staged)
    assert calls == []                          # no kernel call was made


def test_donated_ingest_bit_identical_and_released_or_warned():
    scheme = CombinationScheme(2, 4)
    host_grids = _host_grids(29, scheme)
    e_plain = _engine()
    e_plain.register("t", scheme, host_grids)
    want = e_plain.surplus("t").numpy()
    ref = rengine.CTEngine()
    ref.register("t", rlev.CombinationScheme(2, 4), host_grids)
    _bitwise(want, np.asarray(ref.surplus("t")))

    staged = _owned(host_grids)
    e_don = _engine(ExecSpec(donate=True))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        e_don.register("t", scheme, staged)
    _bitwise(e_don.surplus("t"), want)
    donation_warned = any("donated" in str(w.message).lower()
                          for w in caught)
    assert donation_warned or _all_released(staged)
    assert _all_released(staged) and not donation_warned

    # donate is part of the plan signature: no cache collision
    assert plan_signature(e_plain.plan("t"), e_plain.spec("t")) \
        != plan_signature(e_don.plan("t"), e_don.spec("t"))

    # numpy inputs are staged per call: always safe to ingest again
    pts = np.random.default_rng(290).random((8, 2))
    e_don.update("t", host_grids)
    e_don.update("t", host_grids)
    _bitwise(e_don.query("t", pts), e_plain.query("t", pts))


def test_numpy_backed_and_view_inputs_are_kept_with_one_warning():
    """A tensor sharing numpy's memory cannot be released, nor can a view
    into a larger storage or a grid the ingest copies to another dtype:
    each is kept intact, and the tenant is warned once."""
    host = _host_grids(6)
    backed = {ell: torch.from_numpy(v) for ell, v in host.items()}
    big = {ell: torch.from_numpy(np.concatenate([v.ravel(), [0.0]]))
           for ell, v in host.items()}
    views = {ell: big[ell][:-1].view(v.shape) for ell, v in host.items()}
    f32 = {ell: torch.from_numpy(v).float() for ell, v in host.items()}
    eng = _engine(ExecSpec(donate=True, dtype="float64"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.register("t", SCHEME, backed)
        eng.update("t", views)
        eng.update("t", f32)
    msgs = [str(w.message) for w in caught if "donated" in str(w.message)]
    assert len(msgs) == 1 and "cannot be released" in msgs[0]
    for grids in (backed, views, f32):
        assert not any(storage_released(v) for v in grids.values())
    for ell, v in host.items():
        _bitwise(backed[ell], v)
        _bitwise(views[ell], v)


def test_store_refuses_released_grids_before_its_host_copy(tmp_path):
    store = DurableStore(str(tmp_path), "h0")
    eng = _engine(ExecSpec(donate=True), store=store)
    grids = _owned(_host_grids(7))
    eng.register("t", SCHEME, grids)            # journaled, then released
    assert _all_released(grids)
    with pytest.raises(IngestBuffersDonated):
        eng.submit_ingest("t", grids)
    assert [e.seq for e in store.load("t").entries] == [1]
    eng.update("t", _host_grids(8))
    assert [e.seq for e in store.load("t").entries] == [1, 2]


def test_assembly_and_executor_refuse_a_released_grid():
    """``assemble_grouped`` (and its plain version) refuse a part whose
    storage is smaller than its extent before building anything; the
    executor's staging refuses it before a device or dtype copy reads
    it."""
    plan = tex.build_plan(SCHEME)
    stacks = tuple((b.shape, b.perms) for b in plan.buckets)
    parts = [torch.from_numpy(_host_grids(9)[ell]).clone()
             for b in plan.buckets for ell in b.ells]
    whole = H.assemble_grouped(parts, stacks)
    dead = parts[1].clone()
    dead.untyped_storage().resize_(0)
    strided = parts[2].clone().t()
    strided.untyped_storage().resize_(8)        # shorter than its extent
    assert storage_released(dead) and storage_released(strided)
    assert not storage_released(parts[2].t()) \
        and not storage_released(torch.zeros(0))
    for bad, m in ((dead, 1), (strided, 2)):
        broken = list(parts)
        broken[m] = bad
        for fn in (H.assemble_grouped, H.assemble_grouped.plain):
            with pytest.raises(ValueError, match=f"member {m} .*released"):
                fn(broken, stacks)
    _bitwise(H.assemble_grouped(parts, stacks), whole.numpy())

    grids = _owned(_host_grids(10))
    ell = next(iter(grids))
    dead32 = grids[ell].float()
    grids[ell].untyped_storage().resize_(0)
    dead32.untyped_storage().resize_(0)
    with pytest.raises(ValueError, match="released"):      # the assembly
        tex.ct_transform(grids, SCHEME, device="cpu")
    with pytest.raises(ValueError, match="released"):      # the f64 cast
        tex.ct_transform({**grids, ell: dead32}, SCHEME, device="cpu")
