"""The port's CT engine (``repro_torch.core.engine``: ``ExecSpec``, the
signature-shared ingest executables, coalesced queries, ``CTSurrogate`` as
its view) against the reference's, on the CPU.

The reference's ``CTEngine`` runs once, in a module-scoped fixture, on
three tenants (two sharing one signature).  The port is held to it:
surpluses bitwise, queries at rtol 1e-12 (the eval's matrix products sum
in another order), executable-cache hits and misses and eval counters
equal, ``plan_ingest_stats`` equal.  Coalesced answers are bitwise the
port's one-tenant queries.  The other scenarios of the reference's
``tests/test_engine.py`` run on the port alone, with ``ingest_workers=0``
where the scenario allows.  The assembly wrapper's plain version is held
to the reference's ``_assemble_members`` bucket by bucket, bitwise.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import engine as rengine
from repro.core import executor as rex
from repro.core import levels as rlev
from repro_torch.core import combination as tcomb
from repro_torch.core import engine as E
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.core.engine import CTEngine, ExecSpec
from repro_torch.core.executor import MergeConfig, build_plan, ct_transform
from repro_torch.core.levels import (CombinationScheme, GeneralScheme,
                                     admissible_extensions, grid_shape)
from repro_torch.kernels import hierarchize as H
from repro_torch.launch.serve import CTSurrogate


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


def _np_grids(scheme, seed):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(grid_shape(ell))
            for ell, _ in scheme.grids}


def _grids(scheme, seed):
    return {k: torch.from_numpy(v) for k, v in _np_grids(scheme, seed).items()}


def _engine(**kw) -> CTEngine:
    return CTEngine(device="cpu", ingest_workers=kw.pop("ingest_workers", 0),
                    **kw)


def _random_general_scheme(seed, dim, steps, max_level=4):
    rng = np.random.default_rng(seed)
    gs = GeneralScheme.regular(dim, 1)
    for _ in range(steps):
        cands = [c for c in admissible_extensions(gs.index_set)
                 if max(c) <= max_level]
        if not cands:
            break
        gs = gs.with_levels([cands[int(rng.integers(len(cands)))]])
    return gs


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Deterministic cache counters and warnings per test."""
    E.clear_compile_cache()
    E.reset_deprecation_warnings()
    yield


# ---------------------------------------------------------------------------
# The reference's engine, run once
# ---------------------------------------------------------------------------

#: tenant -> (scheme constructor name, args, grid seed, query points)
TENANTS = {"a": ("CombinationScheme", (2, 4), 1, (20, 2)),
           "b": ("regular", (2, 4), 2, (29, 2)),     # a's signature
           "c": ("CombinationScheme", (3, 3), 3, (17, 3))}


def _scheme(levels_mod, kind, args):
    if kind == "regular":
        return levels_mod.GeneralScheme.regular(*args)
    return getattr(levels_mod, kind)(*args)


def _points(name):
    return np.random.default_rng(50 + ord(name)).random(TENANTS[name][3])


@pytest.fixture(scope="module")
def reference():
    """The reference's engine on the three tenants: its surpluses, its
    answers to one query per tenant submitted before one flush, its
    counters and its plans' ``plan_ingest_stats``."""
    rengine.clear_compile_cache()
    eng = rengine.CTEngine()
    for name, (kind, args, seed, _) in TENANTS.items():
        scheme = _scheme(rlev, kind, args)
        eng.register(name, scheme, {k: jnp.asarray(v) for k, v in
                                    _np_grids(scheme, seed).items()})
    futs = {n: eng.submit_query(n, _points(n)) for n in TENANTS}
    eng.flush()
    stats = eng.stats()
    return {"surplus": {n: np.asarray(eng.surplus(n)) for n in TENANTS},
            "answers": {n: f.result() for n, f in futs.items()},
            "cache": stats["ingest_cache"], "eval": stats["eval"],
            "ingest_stats": {n: rex.plan_ingest_stats(eng.plan(n))
                             for n in TENANTS}}


@pytest.fixture
def port():
    eng = _engine()
    for name, (kind, args, seed, _) in TENANTS.items():
        scheme = _scheme(tlev, kind, args)
        eng.register(name, scheme, _grids(scheme, seed))
    return eng


def test_engine_surpluses_and_cache_counts_equal_reference(reference, port):
    for name in TENANTS:
        _bitwise(port.surplus(name), reference["surplus"][name])
    got = port.stats()["ingest_cache"]
    want = reference["cache"]
    assert (got["hits"], got["misses"]) == (want["hits"], want["misses"]) \
        == (1, 2)


def test_engine_queries_match_reference_and_coalesce(reference, port):
    futs = {n: port.submit_query(n, _points(n)) for n in TENANTS}
    assert not any(f.done() for f in futs.values())
    port.flush()
    ev = port.stats()["eval"]
    want = reference["eval"]
    assert (ev["batches"], ev["queries"], ev["coalesced_queries"]) == \
        (want["batches"], want["queries"], want["coalesced_queries"]) \
        == (2, 3, 1)
    for name, fut in futs.items():
        got = fut.result()
        np.testing.assert_allclose(got, reference["answers"][name],
                                   rtol=1e-12, atol=1e-13)
        # coalesced answers: bitwise the one-tenant query
        assert np.array_equal(got.view(np.uint8),
                              port.query(name, _points(name)).view(np.uint8))


def test_plan_ingest_stats_equal_reference(reference, port):
    for name in TENANTS:
        assert tex.plan_ingest_stats(port.plan(name)) == \
            reference["ingest_stats"][name]


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("kind,args", [("CombinationScheme", (3, 4)),
                                       ("from_levels", ((6, 5), (5, 6)))])
def test_assemble_grouped_plain_equals_reference_assembly(kind, args, merged):
    """Bucket by bucket, bitwise the reference's ``_assemble_members``, with
    members given as strided views (a transposed copy's transpose)."""
    if kind == "from_levels":
        rs = rlev.GeneralScheme.from_levels(list(args), close=True)
        ts = GeneralScheme.from_levels(list(args), close=True)
    else:
        rs, ts = rlev.CombinationScheme(*args), CombinationScheme(*args)
    merge = MergeConfig(launch_cost_bytes=1 << 30) if merged else None
    rplan = rex.build_plan(rs, merge=None if merge is None else
                           rex.MergeConfig(launch_cost_bytes=1 << 30))
    tplan = build_plan(ts, merge=merge)
    grids = _np_grids(ts, 9)
    parts = [torch.from_numpy(grids[ell].T.copy()).permute(
        *reversed(range(len(ell)))) for b in tplan.buckets for ell in b.ells]
    assert not all(p.is_contiguous() for p in parts)
    x = H.assemble_grouped(parts, tuple((b.shape, b.perms)
                                        for b in tplan.buckets))
    a = 0
    for rb, tb in zip(rplan.buckets, tplan.buckets):
        want = rex._assemble_members([jnp.asarray(grids[ell])
                                      for ell in rb.ells], rb.perms, rb.shape)
        n = int(np.prod(want.shape))
        _bitwise(x[a:a + n].view(want.shape), want)
        a += n
    assert a == x.numel()


# ---------------------------------------------------------------------------
# ExecSpec
# ---------------------------------------------------------------------------

def test_execspec_defaults_and_resolution():
    spec = ExecSpec()
    assert spec.merge is None and spec.fused is None and spec.n_slabs is None
    assert spec.resolve_interpret("cpu") is True
    assert ExecSpec(interpret=False).resolve_interpret("cpu") is True
    assert spec.resolve_interpret(torch.device("cuda")) is False
    with pytest.raises(ValueError, match="no interpret mode"):
        ExecSpec(interpret=True).resolve_interpret(torch.device("cuda"))
    for dtype in (torch.float32, np.float32, "float32"):
        assert ExecSpec(dtype=dtype).dtype == "float32"
    assert ExecSpec(dtype="float32").torch_dtype == torch.float32
    assert spec.result_dtype(torch.float32, torch.float64) == torch.float64
    assert ExecSpec(dtype="float32").result_dtype(torch.float64) == \
        torch.float32
    assert ExecSpec(n_slabs=1).n_slabs == 1
    with pytest.raises(ValueError, match="n_slabs"):
        ExecSpec(n_slabs=0)


@pytest.mark.parametrize("fields,item", [
    (dict(mesh=object()), "A9"), (dict(n_slabs=4), "A9"),
    (dict(member_axis="member"), "A9")])
def test_execspec_unported_fields_raise_naming_their_item(fields, item):
    """The sharding fields (once unported, ROADMAP A9) validate and shard
    as the reference's: a mesh without the slab axis raises its validation
    error, ``n_slabs`` shards the plan, ``member_axis`` is inert without a
    mesh."""
    scheme = CombinationScheme(2, 3)
    if "mesh" in fields:
        with pytest.raises(ValueError, match="is not an axis of the mesh"):
            ExecSpec(**fields)
        return
    spec = ExecSpec(**fields)
    if "n_slabs" in fields:
        assert (spec.slabs, spec.members, spec.groups) == (4, 1, 1)
        plan = spec.plan(scheme)
        assert isinstance(plan, tex.ShardedPlan) and plan.n_slabs == 4
        assert plan.plan is build_plan(scheme)
    else:
        assert (spec.slabs, spec.members, spec.groups) == (1, 1, 1)
        assert spec.plan(scheme) is build_plan(scheme)


def test_execspec_is_hashable_and_plan_constructor():
    s1, s2 = ExecSpec(merge=MergeConfig()), ExecSpec(merge=MergeConfig())
    assert s1 == s2 and hash(s1) == hash(s2)
    scheme = CombinationScheme(2, 3)
    assert s1.plan(scheme) is build_plan(scheme, merge=MergeConfig())
    with pytest.raises(ValueError, match="not both"):
        build_plan(scheme, merge=MergeConfig(), spec=s1)


def test_spec_conflicts_and_positional_non_specs_raise():
    scheme = CombinationScheme(2, 3)
    grids = _grids(scheme, 0)
    with pytest.raises(ValueError, match="not both"):
        ct_transform(grids, scheme, spec=ExecSpec(), merge=MergeConfig(),
                     device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tex.ct_transform_with_plan(grids, build_plan(scheme),
                                   spec=ExecSpec(), fused=False, device="cpu")
    with pytest.raises(TypeError, match="ExecSpec"):
        CTSurrogate(scheme, grids, True, device="cpu")
    with pytest.raises(TypeError, match="ExecSpec"):
        ct_transform(grids, scheme, spec=True, device="cpu")
    with pytest.raises(TypeError, match="ExecSpec"):
        build_plan(scheme, spec="merge-me")
    with pytest.raises(TypeError, match="ExecSpec"):
        CTEngine(spec=object(), device="cpu")


def _deprecations(w):
    return [x for x in w if issubclass(x.category, DeprecationWarning)]


def test_legacy_kwargs_warn_once_and_match_spec():
    from repro_torch.launch.steps import make_ct_step
    scheme = CombinationScheme(2, 4)
    grids = _grids(scheme, 13)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        legacy = ct_transform(grids, scheme, merge=MergeConfig(),
                              device="cpu")
        ct_transform(grids, scheme, merge=MergeConfig(), device="cpu")
        assert len(_deprecations(w)) == 1       # once per call-site family
    spec_way = ct_transform(grids, scheme, spec=ExecSpec(merge=MergeConfig()),
                            device="cpu")
    _bitwise(legacy, spec_way.numpy())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        step = make_ct_step(scheme, fused=False, device="cpu")
        ct_transform(grids, scheme, fused=False, device="cpu")
        assert len(_deprecations(w)) == 2       # two families, one each
    _bitwise(step(grids), make_ct_step(scheme, spec=ExecSpec(fused=False),
                                       device="cpu")(grids).numpy())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        a = CTSurrogate(scheme, grids, merge=MergeConfig(), device="cpu")
        b = CTSurrogate(scheme, grids, merge=MergeConfig(), device="cpu")
        assert len(_deprecations(w)) == 1
    pts = np.random.default_rng(140).random((16, 2))
    want = CTSurrogate(scheme, grids, ExecSpec(merge=MergeConfig()),
                       device="cpu").query(pts)
    assert np.array_equal(a.query(pts), want)
    assert np.array_equal(b.query(pts), want)


def test_spec_reaches_adaptive_and_fault_recombination():
    from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveDriver
    from repro_torch.runtime.fault_tolerance import recombine_after_fault
    solver = lambda ell: np.zeros(grid_shape(ell))
    cpu = AdaptiveConfig(device="cpu")
    with pytest.raises(ValueError, match="ONE place"):
        AdaptiveDriver(solver, dim=2, config=AdaptiveConfig(
            merge=MergeConfig(), device="cpu"),
            spec=ExecSpec(merge=MergeConfig(launch_cost_bytes=1)))
    with pytest.raises(ValueError, match="dtype"):
        AdaptiveDriver(solver, dim=2, config=cpu,
                       spec=ExecSpec(dtype="float32"))
    drv = AdaptiveDriver(solver, dim=2, config=cpu,
                         spec=ExecSpec(merge=MergeConfig()))
    assert drv.config.merge == MergeConfig() == drv.plan.merge
    gs = GeneralScheme.regular(2, 4)
    _, plan, _ = recombine_after_fault(gs, [(4, 1)],
                                       spec=ExecSpec(merge=MergeConfig()))
    assert plan.merge == MergeConfig()


# ---------------------------------------------------------------------------
# Signature-shared executables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,misses,hits", [
    ("same", 1, 1), ("distinct", 3, 0), ("merge", 2, 0)])
def test_executable_cache_counts(case, misses, hits):
    """Tenants of one signature (the classical scheme and its
    GeneralScheme spelling) share one executable; distinct shapes and a
    merged plan do not.  Every surplus is bitwise ``ct_transform``'s."""
    tenants = {
        "same": [(CombinationScheme(2, 4), None),
                 (GeneralScheme.regular(2, 4), None)],
        "distinct": [(CombinationScheme(2, 3), None),
                     (CombinationScheme(2, 4), None),
                     (CombinationScheme(3, 3), None)],
        "merge": [(CombinationScheme(4, 3), None),
                  (CombinationScheme(4, 3), ExecSpec(merge=MergeConfig()))],
    }[case]
    eng = _engine()
    grids = {}
    for i, (scheme, spec) in enumerate(tenants):
        grids[i] = _grids(scheme, 30 + i if case != "merge" else 30)
        eng.register(f"t{i}", scheme, grids[i], spec=spec)
    st = eng.stats()["ingest_cache"]
    assert (st["misses"], st["hits"]) == (misses, hits)
    assert st["executables"] == misses
    for i, (scheme, spec) in enumerate(tenants):
        _bitwise(eng.surplus(f"t{i}"),
                 ct_transform(grids[i], scheme, spec=spec,
                              device="cpu").numpy())


def test_coefficient_only_fault_reuses_executable_and_table():
    gs = GeneralScheme.from_levels([(4, 1), (3, 2), (2, 3), (1, 4)],
                                   close=True)
    grids = _grids(gs, 3)
    eng = _engine()
    eng.register("t", gs, grids)
    table = eng._tenant("t").binding.table
    dropped = (4, 1)
    after = dict(grids)
    after[dropped] = torch.zeros_like(grids[dropped])
    eng.drop_grid("t", [dropped], after)
    st = eng.stats()["ingest_cache"]
    assert (st["misses"], st["hits"]) == (1, 1)          # no new executable
    assert eng._tenant("t").binding.table is table       # same index maps
    reduced = eng.scheme("t")
    assert reduced == gs.without_levels([dropped])
    want = ct_transform({ell: after[ell] for ell, _ in reduced.grids},
                        reduced, full_levels=eng.plan("t").full_levels,
                        device="cpu")
    _bitwise(eng.surplus("t"), want.numpy())


def test_ingest_executable_cache_is_lru_bounded(monkeypatch):
    monkeypatch.setattr(E, "_INGEST_CACHE_MAX", 2)
    eng = _engine()
    for i, scheme in enumerate([CombinationScheme(2, 2),
                                CombinationScheme(2, 3),
                                CombinationScheme(3, 2)]):
        eng.register(f"t{i}", scheme, _grids(scheme, 81 + i))
    assert len(E._INGEST_EXECUTABLES) == 2              # oldest evicted
    pts = np.random.default_rng(810).random((8, 2))
    assert eng.query("t0", pts).shape == (8,)           # still serves
    assert eng.stats()["ingest_cache"]["executables"] == 3


@pytest.mark.parametrize("fused", [None, False])
def test_plan_launch_stats_count_the_ports_launches(fused):
    plan = build_plan(CombinationScheme(3, 4))
    s = tex.plan_launch_stats(plan, fused=fused)
    assert s["members"] == plan.num_grids and s["einsum_dispatches"] == 0
    if fused is None:
        assert s["pallas_launches"] == s["launches"] == 4
        assert s["scatter_dispatches"] == s["stack_bytes"] == 0
    else:
        passes = sum((b.shape[0] > 1) + any(n > 1 for n in b.shape[1:])
                     for b in plan.buckets)
        assert s["pallas_launches"] == 1 + passes
        assert s["scatter_dispatches"] == plan.num_grids
        assert s["launches"] == 1 + passes + plan.num_grids


# ---------------------------------------------------------------------------
# Queries, ingests and the queue
# ---------------------------------------------------------------------------

def test_mixed_signature_query_batch_splits_correctly():
    schemes = {"small": CombinationScheme(2, 3),
               "big": CombinationScheme(2, 5),
               "deep": CombinationScheme(3, 3),
               "small2": CombinationScheme(2, 3)}
    eng = _engine()
    grids = {}
    for i, (name, scheme) in enumerate(schemes.items()):
        grids[name] = _grids(scheme, 60 + i)
        eng.register(name, scheme, grids[name])
    pts = {2: np.random.default_rng(60).random((17, 2)),
           3: np.random.default_rng(61).random((17, 3))}
    futs = {n: eng.submit_query(n, pts[s.dim]) for n, s in schemes.items()}
    eng.flush()
    ev = eng.stats()["eval"]
    assert (ev["batches"], ev["queries"], ev["coalesced_queries"]) == (3, 4, 1)
    for name, scheme in schemes.items():
        got = futs[name].result()
        assert np.array_equal(got, eng.query(name, pts[scheme.dim]))
        oracle = tcomb.combined_interpolant_points(
            grids[name], scheme, torch.from_numpy(pts[scheme.dim])).numpy()
        np.testing.assert_allclose(got, oracle, rtol=1e-9, atol=1e-10)


def test_ingest_overlaps_query_in_one_flush():
    scheme = CombinationScheme(2, 4)
    grids = _grids(scheme, 7)
    eng = _engine(ingest_workers=None)                  # the shared pool
    eng.register("t", scheme, grids)
    pts = np.random.default_rng(70).random((16, 2))
    before = eng.query("t", pts)
    fi = eng.submit_ingest("t", {k: 2.0 * v for k, v in grids.items()})
    fq = eng.submit_query("t", pts)
    eng.flush()
    np.testing.assert_array_equal(fq.result(), 2.0 * before)
    assert fi.result() is eng.surplus("t")


def test_failing_request_resolves_only_its_own_future():
    scheme = CombinationScheme(2, 3)
    grids = _grids(scheme, 77)
    eng = _engine()
    eng.register("a", scheme, grids)
    eng.register("b", scheme, _grids(scheme, 78))
    bad = dict(grids)
    del bad[next(iter(bad))]
    before = eng.surplus("a")
    f_bad = eng.submit_ingest("a", bad)
    pts = np.random.default_rng(770).random((8, 2))
    f_ok = eng.submit_query("b", pts)
    eng.flush()
    with pytest.raises(ValueError, match="missing"):
        f_bad.result()
    assert eng.surplus("a") is before
    np.testing.assert_array_equal(f_ok.result(), eng.query("b", pts))
    eng.register("empty", scheme, None)
    f_q = eng.submit_query("empty", pts)
    eng.flush()
    with pytest.raises(RuntimeError, match="no ingested state"):
        f_q.result()


def test_queued_requests_resolve_tenant_by_name_at_flush():
    gs = GeneralScheme.regular(2, 2)
    eng = _engine()
    eng.register("t", gs, _grids(gs, 82))
    grown = gs.with_levels([(3, 1)])
    grids2 = _grids(grown, 83)
    fut = eng.submit_ingest("t", grids2)        # queued before the refit
    eng.refit("t", grown, grids2)
    eng.flush()
    assert fut.result() is eng.surplus("t")
    _bitwise(eng.surplus("t"), ct_transform(grids2, grown,
                                            device="cpu").numpy())
    f_i = eng.submit_ingest("t", grids2)
    f_q = eng.submit_query("t", np.random.default_rng(820).random((4, 2)))
    eng.unregister("t")
    eng.flush()
    for f in (f_i, f_q):
        with pytest.raises(KeyError, match="unregistered"):
            f.result()


def test_check_finite_ingest_fails_only_its_own_future():
    scheme = CombinationScheme(2, 3)
    grids = _grids(scheme, 25)
    eng = _engine(check_finite=True)
    eng.register("a", scheme, grids)
    eng.register("b", scheme, _grids(scheme, 26))
    before = eng.surplus("a")
    bad = dict(grids)
    first = next(iter(bad))
    bad[first] = torch.full_like(bad[first], float("nan"))
    f_bad = eng.submit_ingest("a", bad)
    pts = np.random.default_rng(250).random((8, 2))
    f_q = eng.submit_query("b", pts)
    eng.flush()
    with pytest.raises(FloatingPointError, match="non-finite"):
        f_bad.result()
    assert eng.surplus("a") is before
    np.testing.assert_array_equal(f_q.result(), eng.query("b", pts))
    f_ok = eng.submit_ingest("a", bad, check_finite=False)
    eng.flush()
    assert not bool(torch.isfinite(f_ok.result()).all())


def test_future_autoflushes_and_times_out():
    scheme = CombinationScheme(2, 3)
    eng = _engine()
    eng.register("t", scheme, _grids(scheme, 8))
    pts = np.random.default_rng(80).random((8, 2))
    fut = eng.submit_query("t", pts)
    np.testing.assert_array_equal(fut.result(), eng.query("t", pts))
    with pytest.raises(TimeoutError, match="pending"):
        E.CTFuture(eng).result(timeout=0.05)


@pytest.mark.parametrize("dim,steps,seed", [(2, 5, 11), (3, 4, 12),
                                            (3, 6, 13)])
def test_multi_tenant_bit_identical_to_per_scheme_transform(dim, steps, seed):
    from repro_torch.launch.steps import make_ct_step
    rng = np.random.default_rng(seed)
    eng = _engine()
    schemes, grids = {}, {}
    for i in range(3):
        gs = _random_general_scheme(seed + i, dim, steps)
        schemes[f"t{i}"], grids[f"t{i}"] = gs, _grids(gs, seed + 10 * i)
        eng.register(f"t{i}", gs, grids[f"t{i}"])
    pts = rng.random((23, dim))
    futs = {name: eng.submit_query(name, pts) for name in schemes}
    eng.flush()
    for name, gs in schemes.items():
        _bitwise(eng.surplus(name),
                 make_ct_step(gs, device="cpu")(grids[name]).numpy())
        oracle = tcomb.combined_interpolant_points(
            grids[name], gs, torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(futs[name].result(), oracle, rtol=1e-9,
                                   atol=1e-10)


# ---------------------------------------------------------------------------
# Lifecycle and the registry
# ---------------------------------------------------------------------------

def test_extend_and_failed_lifecycle():
    gs = GeneralScheme.regular(2, 2)
    eng = _engine()
    eng.register("t", gs, _grids(gs, 9))
    plan_before = eng.plan("t")
    grown = gs.with_levels([(3, 1)])
    grids2 = _grids(grown, 10)
    eng.extend("t", [(3, 1)], grids2)
    assert eng.scheme("t") == grown and eng.plan("t") is not plan_before
    _bitwise(eng.surplus("t"), ct_transform(grids2, grown,
                                            device="cpu").numpy())
    gs3 = GeneralScheme.regular(2, 3)
    grids3 = _grids(gs3, 11)
    eng.register("u", gs3, grids3)
    before = eng.surplus("u")
    with pytest.raises(ValueError, match=r"\(1, 1\)"):
        eng.drop_grid("u", [(2, 2)], grids3)       # (1, 1) not supplied
    assert eng.scheme("u") == gs3 and eng.surplus("u") is before


def test_register_twice_unknown_tenant_and_point_validation():
    scheme = CombinationScheme(2, 3)
    eng = _engine()
    eng.register("t", scheme, _grids(scheme, 11))
    with pytest.raises(ValueError, match="already registered"):
        eng.register("t", scheme, None)
    with pytest.raises(KeyError, match="nope"):
        eng.query("nope", np.zeros((4, 2)))
    with pytest.raises(ValueError, match=r"\(Q, 2\).*got \(4, 3\)"):
        eng.query("t", np.zeros((4, 3)))
    with pytest.raises(TypeError, match="floating"):
        eng.query("t", np.zeros((4, 2), np.int32))
    assert eng.query("t", np.full(2, 0.5)).shape == (1,)
    eng.unregister("t")
    assert "t" not in eng and eng.names() == ()


def test_surrogates_share_engine_and_executable():
    scheme = CombinationScheme(2, 4)
    eng = _engine()
    a = CTSurrogate(scheme, _grids(scheme, 17), engine=eng, name="a")
    b = CTSurrogate(scheme, _grids(scheme, 18), engine=eng, name="b")
    assert a.engine is b.engine is eng and a.device == torch.device("cpu")
    st = eng.stats()
    assert st["tenants"] == 2
    assert (st["ingest_cache"]["misses"], st["ingest_cache"]["hits"]) == (1, 1)
    assert st["gather"]["members"] == 2 * len(scheme.grids)
    pts = np.random.default_rng(170).random((9, 2))
    fa, fb = a.submit_query(pts), b.submit_query(pts)
    eng.flush()
    assert eng.stats()["eval"]["coalesced_queries"] == 1
    assert np.array_equal(fb.result(), b.query(pts))
    fu = a.submit_update({k: -v for k, v in _grids(scheme, 17).items()})
    assert fu.result() is a.surplus
    np.testing.assert_allclose(a.query(pts), -fa.result(), rtol=1e-12,
                               atol=1e-14)
    with pytest.raises(ValueError, match="differs"):
        CTSurrogate(scheme, None, engine=eng, name="c", device="meta")


def test_register_adoption_lane_plan_and_surplus():
    scheme = CombinationScheme(2, 4)
    donor = _engine()
    donor.register("t", scheme, _grids(scheme, 31))
    pts = np.random.default_rng(310).random((8, 2))
    heir = _engine()
    heir.register("t", scheme, plan=donor.plan("t"),
                  surplus=donor.surplus("t"))
    assert heir.plan("t") is donor.plan("t")
    assert heir.stats()["ingest_cache"]["hits"] == 1     # signature shared
    np.testing.assert_array_equal(heir.query("t", pts), donor.query("t", pts))
    with pytest.raises(ValueError, match="surplus"):
        _engine().register("u", scheme, _grids(scheme, 32),
                           surplus=donor.surplus("t"))


def test_plan_cache_contract_and_explicit_clear():
    tex.clear_plan_cache()
    scheme = CombinationScheme(2, 4)
    p1 = build_plan(scheme)
    assert build_plan(scheme) is p1 is build_plan(scheme, spec=ExecSpec())
    for key in tex._PLAN_CACHE._data:
        assert not any(isinstance(part, ExecSpec) for part in key)
    tex.clear_plan_cache()
    assert len(tex._PLAN_CACHE._data) == 0
    assert build_plan(scheme) is not p1


def _cpu_mesh(shape, names):
    from repro_torch.core.mesh import make_mesh
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _rebind_onto_slabs():
    """``rebind`` onto a slab mesh carries the surplus; ``n_slabs`` alone,
    without a mesh, raises as the reference's (it only shapes a plan)."""
    scheme = CombinationScheme(2, 3)
    eng = _engine()
    eng.register("t", scheme, _grids(scheme, 1))
    before = eng.surplus("t")
    with pytest.raises(ValueError, match="meshed spec"):
        eng.rebind("t", n_slabs=2)
    assert eng.rebind("t", mesh=_cpu_mesh((2,), ("slab",))) == "sharded"
    assert eng.surplus("t") is before
    assert isinstance(eng.plan("t"), tex.ShardedPlan)
    _bitwise(eng.update("t", _grids(scheme, 1)), before.numpy())
    return True


def _over_device_slices():
    """Hosts over disjoint slices of a repeated CPU device serve a tenant
    bitwise as a plain engine."""
    from repro_torch.runtime.cluster import CTCluster
    scheme = CombinationScheme(2, 3)
    cl = CTCluster.over_device_slices(2, devices=["cpu"] * 4)
    cl.register("t", scheme, _np_grids(scheme, 2))
    eng = _engine()
    eng.register("t", scheme, _np_grids(scheme, 2))
    pts = np.random.default_rng(3).random((8, 2))
    np.testing.assert_array_equal(cl.query("t", pts), eng.query("t", pts))
    return True


def _rebalance_engine():
    """``rebalance_engine`` moves every tenant onto a mesh and off it."""
    from repro_torch.runtime.elastic import rebalance_engine
    scheme = CombinationScheme(2, 3)
    eng = _engine()
    for n in ("a", "b"):
        eng.register(n, scheme, _grids(scheme, 4))
    before = eng.surplus("a")
    assert rebalance_engine(eng, _cpu_mesh((3,), ("slab",))) == \
        {"a": "sharded", "b": "sharded"}
    assert rebalance_engine(eng, None) == {"a": "unsharded",
                                           "b": "unsharded"}
    assert eng.surplus("a") is before and eng.plan("a") is build_plan(scheme)
    return True


def _member_axis():
    """``member_axis`` on a 2-D mesh compute-shards the plan."""
    spec = ExecSpec(mesh=_cpu_mesh((2, 2), ("member", "slab")),
                    member_axis="member")
    assert (spec.slabs, spec.members, spec.groups) == (2, 2, 4)
    plan = spec.plan(CombinationScheme(2, 3))
    assert (plan.n_slabs, plan.n_groups) == (2, 4)
    return True


@pytest.mark.parametrize("call,item", [
    (_rebind_onto_slabs, "A9"),
    (_over_device_slices, "A9"),
    (_rebalance_engine, "A9"),
    (_member_axis, "A9")])
def test_unported_engine_surface_raises_naming_its_item(call, item):
    """The engine surface once unported (ROADMAP A9) now runs:
    ``rebind``, ``CTCluster.over_device_slices``, ``rebalance_engine`` and
    ``member_axis``."""
    assert call() is True


def test_probe_and_heartbeat_as_the_reference():
    """The cluster's seams: a probe resolves to True only when a pump, a
    flush or the scheduler reaches it (``wait`` never drives the engine),
    counts as no tenant work, and the heartbeat has the reference's keys
    and stamps each scheduler pass."""
    scheme = CombinationScheme(2, 2)
    ref = rengine.CTEngine(host_id="h")
    eng = _engine(host_id="h")
    for e in (ref, eng):
        e.register("t", scheme, _np_grids(scheme, 33))
    hb_ref, hb = ref.heartbeat(), eng.heartbeat()
    assert set(hb) == set(hb_ref)
    assert hb["host_id"] == "h" and hb["pending"] == 0
    assert hb["scheduler_alive"] is False and hb["age_s"] >= 0.0
    before = eng.stats()
    probe = eng.submit_probe()
    assert not probe.wait(0.05)             # nobody pumps: no answer
    assert eng.heartbeat()["pending"] == 1
    stamp = eng.heartbeat()["last_pump"]
    assert eng.pump() == 1
    assert probe.wait(1.0) and probe.result() is True
    assert eng.heartbeat()["last_pump"] > stamp
    after = eng.stats()
    assert after["eval"] == before["eval"]
    assert after["ingests"] == before["ingests"]
    eng.start()
    try:
        assert eng.heartbeat()["scheduler_alive"] is True
        assert eng.submit_probe().wait(30.0)
    finally:
        eng.stop()
    flushed = eng.submit_probe()
    eng.flush()
    assert flushed.done() and eng.stats()["eval"] == before["eval"]


# ---------------------------------------------------------------------------
# The scheduler: pump, deadlines, priorities, backpressure
# ---------------------------------------------------------------------------

def test_pump_dispatches_on_deadline_or_batch_full():
    scheme = CombinationScheme(2, 3)
    eng = _engine(max_batch=4, deadline_ms=10_000.0)
    eng.register("t", scheme, _grids(scheme, 20))
    pts = np.random.default_rng(200).random((4, 2))
    fut = eng.submit_query("t", pts)
    assert eng.pump() == 0 and not fut.done()       # budget not expired
    assert eng.pump(now=1e18) == 1 and fut.done()   # deadline passed
    np.testing.assert_array_equal(fut.result(), eng.query("t", pts))
    futs = [eng.submit_query("t", pts) for _ in range(4)]
    assert eng.pump() == 4 and all(f.done() for f in futs)   # batch full
    sched = eng.stats()["scheduler"]
    assert sched["dispatch_batch_full"] >= 1
    assert sched["dispatch_deadline"] >= 1
    f_i = eng.submit_ingest("t", _grids(scheme, 21))        # always due
    assert eng.pump() >= 1
    f_i.result(timeout=30)


def test_scheduler_thread_serves_without_explicit_flush():
    scheme = CombinationScheme(2, 3)
    eng = CTEngine(device="cpu", deadline_ms=5.0)          # the shared pool
    eng.register("t", scheme, _grids(scheme, 22))
    pts = np.random.default_rng(220).random((8, 2))
    want = eng.query("t", pts)
    with eng:
        fut = eng.submit_query("t", pts)
        assert fut.wait(timeout=30.0)                       # never flushed
        fi = eng.submit_ingest("t", _grids(scheme, 23))
        assert fi.wait(timeout=30.0)
    np.testing.assert_array_equal(fut.result(), want)
    assert fi.result() is eng.surplus("t")


def test_priority_orders_dispatch_and_splits_chunks():
    s_small, s_big = CombinationScheme(2, 3), CombinationScheme(2, 4)
    eng = _engine(max_batch=64)
    eng.register("low", s_small, _grids(s_small, 23))
    eng.register("high", s_big, _grids(s_big, 24))
    pts = np.random.default_rng(230).random((4, 2))
    f_low = eng.submit_query("low", pts, priority=0)
    f_high = eng.submit_query("high", pts, priority=5)
    assert eng.pump(now=1e18) == 2
    assert f_high.done_at <= f_low.done_at
    lows = [eng.submit_query("low", pts, priority=0) for _ in range(3)]
    top = eng.submit_query("low", pts, priority=5)
    assert eng.pump(now=1e18) == 4
    assert all(top.done_at <= f.done_at for f in lows)
    assert eng.stats()["eval"]["batches"] == 4        # split at priorities


def test_backpressure_bounded_queue():
    scheme = CombinationScheme(2, 3)
    eng = _engine(max_pending=2, host_id="h9")
    eng.register("t", scheme, _grids(scheme, 24))
    pts = np.random.default_rng(240).random((4, 2))
    eng.submit_query("t", pts)
    eng.submit_query("t", pts)
    with pytest.raises(E.EngineSaturated,
                       match=r"engine\[h9\].*tenant 't'.*depth 2 >= "
                             r"max_pending=2"):
        eng.submit_query("t", pts, block=False)
    with pytest.raises(E.EngineSaturated, match=r"tenant 't'.*max_pending=2"):
        eng.submit_query("t", pts, block=True, timeout=0.05)
    assert eng.stats()["scheduler"]["rejected"] == 2
    eng.flush()
    f = eng.submit_query("t", pts, block=False)
    np.testing.assert_array_equal(f.result(), eng.query("t", pts))


def test_hol_oversized_low_priority_backlog_does_not_block_high():
    scheme = CombinationScheme(2, 3)
    eng = _engine(max_batch=4, deadline_ms=10_000.0)
    eng.register("t", scheme, _grids(scheme, 27))
    pts = np.random.default_rng(270).random((4, 2))
    want = eng.query("t", pts)
    lows = [eng.submit_query("t", pts, priority=0) for _ in range(12)]
    high = eng.submit_query("t", pts, priority=10)
    n = eng.pump()
    assert high.done() and n <= 5
    done_lows = [f for f in lows if f.done()]
    assert 0 < len(done_lows) <= 4
    assert all(high.done_at <= f.done_at for f in done_lows)
    eng.flush()
    for f in lows + [high]:
        np.testing.assert_array_equal(f.result(), want)
    eng.register("u", scheme, _grids(scheme, 28))
    lows2 = [eng.submit_query("t", pts, priority=0) for _ in range(4)]
    high2 = eng.submit_query("u", pts, priority=10)
    eng.pump()
    assert high2.done()
    assert all(high2.done_at <= f.done_at for f in lows2 if f.done())
    assert eng.stats()["scheduler"]["promoted"] >= 1


def test_stale_ok_query_reads_the_committed_surplus():
    """With an ingest in flight (held on the pool), a ``stale_ok`` query
    answers from the committed surplus at once; a plain one waits for the
    ingest."""
    import threading
    scheme = CombinationScheme(2, 3)
    eng = _engine(ingest_workers=1)
    grids = _grids(scheme, 29)
    eng.register("t", scheme, grids)
    pts = np.random.default_rng(290).random((5, 2))
    before = eng.query("t", pts)
    gate = threading.Event()

    class Held(dict):
        def __getitem__(self, key):
            gate.wait(30.0)
            return super().__getitem__(key)

    eng.submit_ingest("t", Held({k: 3.0 * v for k, v in grids.items()}))
    stale = eng.submit_query("t", pts, stale_ok=True)
    fresh = eng.submit_query("t", pts)
    eng.pump(now=1e18)
    assert stale.done() and not fresh.done()
    np.testing.assert_array_equal(stale.result(), before)
    gate.set()
    np.testing.assert_allclose(fresh.result(), 3.0 * before, rtol=1e-12,
                               atol=1e-14)
    eng.close()


def test_higher_priority_queries_run_between_chunks_of_a_pass(monkeypatch):
    """A query queued during a long pass with a higher priority than the
    chunk being evaluated runs right after that chunk, not after the pass
    (so a health probe is never starved by a deep queue)."""
    scheme = CombinationScheme(2, 2)
    eng = _engine(max_batch=1)
    eng.register("t", scheme, _np_grids(scheme, 34))
    pts = np.random.default_rng(35).random((2, 2))
    order = []
    orig = E.interpolate_hierarchical

    def spy(surplus, points):
        order.append(float(points[0, 0]))
        if len(order) == 1:
            urgent.append(eng.submit_query("t", np.full((1, 2), 0.125),
                                           priority=5))
        return orig(surplus, points)

    urgent = []
    monkeypatch.setattr(E, "interpolate_hierarchical", spy)
    low = [eng.submit_query("t", pts + 0.01 * i) for i in range(3)]
    eng.flush()
    assert all(f.done() for f in low) and urgent[0].done()
    assert order[1] == 0.125                     # right after chunk one
    assert eng.stats()["scheduler"]["promoted"] >= 1
