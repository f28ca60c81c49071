"""The port's adaptivity, fault recombination and surrogate refits against
the reference, on the CPU.

The gather is bitwise equal to the reference's, so ``AdaptiveDriver``'s
indicators are too: both packages must add the same index at every
step and serve bitwise the same surplus.  Plans are array-equal; queries
are held to rtol 1e-12 (the eval's matrix products sum in another order).
The ``aniso_6d`` acceptance run (>= 3x fewer points at the regular
scheme's error) is a full-size run and is checked on the card by
``chip_smoke.py``, not here.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.configs import sparse_grid as rcfg
from repro.core import adaptive as rad
from repro.core import executor as rex
from repro.core import levels as rlev
from repro.launch.serve import CTSurrogate as RefSurrogate
from repro.runtime import fault_tolerance as rft
from repro_torch.configs import sparse_grid as tcfg
from repro_torch.core import adaptive as tad
from repro_torch.core import combination as tcomb
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.core.interpolation import sample_function
from repro_torch.launch.serve import CTSurrogate
from repro_torch.runtime import fault_tolerance as tft

REPO = Path(__file__).resolve().parents[1]


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


def _assert_plans_equal(tplan, rplan):
    assert (tplan.full_levels, tplan.fine_shape) == (rplan.full_levels,
                                                     rplan.fine_shape)
    assert len(tplan.buckets) == len(rplan.buckets)
    for tb, rb in zip(tplan.buckets, rplan.buckets):
        assert (tb.ells, tb.perms, tb.levels, tb.target) == \
            (rb.ells, rb.perms, rb.levels, rb.target)
        assert np.array_equal(tb.coeffs, rb.coeffs)
        assert np.array_equal(tb.index, rb.index)


def _u(a, b):
    return np.sin(2 * a) * (b - b * b)


def _sampled(scheme):
    """numpy samples of ``_u`` on every grid of ``scheme``."""
    return {ell: tad.nodal_sampler(_u)(ell) for ell, _ in scheme.grids}


# ---------------------------------------------------------------------------
# Dimension-adaptive refinement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("indicator,merged", [("max", False), ("l1", True)])
def test_adaptive_trajectory_matches_reference(indicator, merged):
    f = tad.make_anisotropic_target(3)
    rmerge = rex.MergeConfig(launch_cost_bytes=1 << 30) if merged else None
    tmerge = tex.MergeConfig(launch_cost_bytes=1 << 30) if merged else None
    ref = rad.AdaptiveDriver(rad.nodal_sampler(f), dim=3,
                             config=rad.AdaptiveConfig(
                                 max_points=300, indicator=indicator,
                                 merge=rmerge))
    drv = tad.AdaptiveDriver(tad.nodal_sampler(f), dim=3,
                             config=tad.AdaptiveConfig(
                                 max_points=300, indicator=indicator,
                                 merge=tmerge, device="cpu"))
    _bitwise(drv.surplus, ref.surplus)
    while True:
        want, got = ref.step(), drv.step()
        if want is None:
            assert got is None and drv.stop_reason == ref.stop_reason
            break
        # the same index, indicator and rebuild accounting
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        _bitwise(drv.surplus, ref.surplus)
        _assert_plans_equal(drv.plan, ref.plan)
    assert drv.stop_reason == "budget" and len(drv.history) > 3
    assert drv.scheme.index_set == ref.scheme.index_set
    assert drv.solved_points() <= 300


def test_refine_and_helpers_match_reference():
    f = tad.make_anisotropic_target(2, decay=8.0)
    rf = rad.make_anisotropic_target(2, decay=8.0)
    res = tad.refine(tad.nodal_sampler(f), 2,
                     tad.AdaptiveConfig(max_points=200, max_level=6,
                                        device="cpu"))
    want = rad.refine(rad.nodal_sampler(rf), 2,
                      rad.AdaptiveConfig(max_points=200, max_level=6))
    assert [dataclasses.astuple(r) for r in res.history] == \
        [dataclasses.astuple(r) for r in want.history]
    assert res.stop_reason == want.stop_reason
    _bitwise(res.surplus, want.surplus)
    pts = np.random.default_rng(3).random((300, 2))
    err = tad.interpolation_error(res.surplus, f, pts, chunk=64)
    assert err == pytest.approx(rad.interpolation_error(
        want.surplus, rf, jnp.asarray(pts)), rel=1e-9, abs=1e-14)
    for ell in ((3, 1), (2, 4)):
        assert np.array_equal(tad.nodal_sampler(f)(ell),
                              rad.nodal_sampler(rf)(ell))
    with pytest.raises(ValueError, match="dim"):
        tad.AdaptiveDriver(tad.nodal_sampler(f),
                           config=tad.AdaptiveConfig(device="cpu"))


def test_adaptive_skips_exactly_resolved_axis():
    """f = sin(pi x) * tent(y): the y-factor is the level-1 hat, so every
    y-refined subspace has zero surplus and the budget goes to x."""
    f = tad.make_anisotropic_target(2, decay=1e9)
    drv = tad.AdaptiveDriver(tad.nodal_sampler(f), dim=2,
                             config=tad.AdaptiveConfig(
                                 max_points=400, max_level=8, device="cpu"))
    drv.run()
    assert max(ell[0] for ell in drv.scheme.index_set) >= 4
    assert max(ell[1] for ell in drv.scheme.index_set) <= 2


def test_configs_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in tcfg.CT_CONFIGS.items()} \
        == {k: dataclasses.asdict(v) for k, v in rcfg.CT_CONFIGS.items()}
    assert {k: dataclasses.asdict(v)
            for k, v in tcfg.CT_ADAPTIVE_CONFIGS.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in rcfg.CT_ADAPTIVE_CONFIGS.items()}
    for name in ("prod_3d", "fig6_2d"):
        assert tcfg.get_ct_config(name).sizes() == \
            rcfg.get_ct_config(name).sizes()
        assert dict(tcfg.get_ct_config(name).scheme.grids) == \
            dict(rcfg.get_ct_config(name).scheme.grids)


# ---------------------------------------------------------------------------
# Fault recombination
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dropped,coefficient_only", [((3, 1), True),
                                                      ((2, 2), False)])
def test_recombine_after_fault_matches_reference(dropped, coefficient_only):
    rs, ts = rlev.GeneralScheme.regular(2, 3), tlev.GeneralScheme.regular(2,
                                                                          3)
    rplan, tplan = rex.build_plan(rs), tex.build_plan(ts)
    rs2, rp2, rco = rft.recombine_after_fault(rs, [dropped], plan=rplan)
    ts2, tp2, tco = tft.recombine_after_fault(ts, [dropped], plan=tplan)
    assert tco == rco == coefficient_only
    assert dict(ts2.grids) == dict(rs2.grids)
    _assert_plans_equal(tp2, rp2)
    if coefficient_only:
        assert all(a.index is b.index for a, b in zip(tp2.buckets,
                                                      tplan.buckets))
    else:
        assert tp2.full_levels == tplan.full_levels
    # a CombinationScheme is generalized first; the plan defaults
    ts3, tp3, _ = tft.recombine_after_fault(tlev.CombinationScheme(2, 3),
                                            [dropped])
    assert dict(ts3.grids) == dict(ts2.grids)
    _assert_plans_equal(tp3, rp2)
    with pytest.raises(TypeError, match="scheme"):
        tft.recombine_after_fault(object(), [dropped])


def test_health_trackers_match_reference():
    rng = np.random.default_rng(4)
    losses = list(1.0 + 0.05 * rng.random(12)) + [9.0, float("nan"), 1.0]
    times = list(0.1 + 0.01 * rng.random(12)) + [0.1, 0.1, 3.0]
    ref, mon = rft.HealthMonitor(), tft.HealthMonitor()
    for loss, t in zip(losses, times):
        want, got = ref.observe(loss, t), mon.observe(loss, t)
        assert (got.ok, got.reason, got.rollback) == (want.ok, want.reason,
                                                      want.rollback)
    assert mon.events == ref.events and mon.loss_ewma == ref.loss_ewma
    ref, trk = rft.HostHealthTracker(), tft.HostHealthTracker()
    for kw in ({"heartbeat_age_s": 0.1}, {"heartbeat_age_s": 5.0},
               {"probe_ok": False}, {"probe_ok": True}, {"killed": True}):
        assert trk.observe("h0", **kw) == ref.observe("h0", **kw)
    assert trk.events == ref.events and trk.strikes == ref.strikes
    trk.forget("h0")
    assert "h0" not in trk.strikes


# ---------------------------------------------------------------------------
# The surrogate: refit and drop_grid
# ---------------------------------------------------------------------------

def _pair(scheme_levels):
    return (rlev.GeneralScheme.from_levels(scheme_levels, close=True),
            tlev.GeneralScheme.from_levels(scheme_levels, close=True))


def test_surrogate_refit_matches_reference():
    rs, ts = _pair([(4, 1), (3, 2), (2, 3), (1, 4)])
    rs2, ts2 = _pair([(4, 1), (3, 2), (2, 3), (1, 4), (5, 1), (2, 4)])
    g1, g2 = _sampled(ts), _sampled(ts2)
    ref = RefSurrogate(rs, {k: jnp.asarray(v) for k, v in g1.items()})
    srv = CTSurrogate(ts, {k: torch.from_numpy(v) for k, v in g1.items()},
                      device="cpu")
    ref.refit(rs2, {k: jnp.asarray(v) for k, v in g2.items()})
    srv.refit(ts2, {k: torch.from_numpy(v) for k, v in g2.items()})
    assert srv.scheme == ts2
    _bitwise(srv.surplus, ref.surplus)
    _assert_plans_equal(srv._plan, ref._plan)
    pts = np.random.default_rng(5).random((40, 2))
    np.testing.assert_allclose(srv.query(pts), ref.query(pts), rtol=1e-12,
                               atol=1e-13)
    # a refit missing a grid raises, naming it, and changes nothing
    before = srv.surplus
    partial = {k: torch.from_numpy(v) for k, v in g2.items() if k != (5, 1)}
    rs3, ts3 = _pair([(5, 1), (3, 2), (2, 3), (1, 5)])
    with pytest.raises(ValueError, match=r"\(1, 5\)"):
        srv.refit(ts3, partial)
    assert srv.scheme == ts2 and srv.surplus is before


def test_surrogate_drop_grid_coefficient_only():
    rs, ts = _pair([(4, 1), (3, 2), (2, 3), (1, 4)])
    grids = {k: torch.from_numpy(v) for k, v in _sampled(ts).items()}
    srv = CTSurrogate(ts, grids, device="cpu")
    plan = srv._plan
    dropped = (4, 1)
    after = dict(grids)
    after[dropped] = torch.zeros_like(grids[dropped])    # stale, finite
    srv.drop_grid([dropped], after)
    reduced = ts.without_levels([dropped])
    assert srv.scheme == reduced
    assert all(a.index is b.index for a, b in zip(srv._plan.buckets,
                                                  plan.buckets))
    fresh = CTSurrogate(reduced, {k: grids[k] for k, _ in reduced.grids},
                        device="cpu")
    pts = np.random.default_rng(6).random((32, 2))
    np.testing.assert_allclose(srv.query(pts), fresh.query(pts), rtol=1e-12,
                               atol=1e-14)
    want = tcomb.combined_interpolant_points(
        {k: grids[k] for k, _ in reduced.grids}, reduced,
        torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(srv.query(pts), want, rtol=1e-9, atol=1e-10)
    # later updates recombine with the reduced coefficients
    srv.update({k: 2.0 * v for k, v in after.items()})
    np.testing.assert_allclose(srv.query(pts), 2 * fresh.query(pts),
                               rtol=1e-12, atol=1e-14)
    # and the reference agrees
    ref = RefSurrogate(rs, {k: jnp.asarray(v.numpy())
                            for k, v in grids.items()})
    ref.drop_grid([dropped], {k: jnp.asarray(v.numpy())
                              for k, v in after.items()})
    ref.update({k: jnp.asarray(2.0 * v.numpy()) for k, v in after.items()})
    _bitwise(srv.surplus, ref.surplus)


def test_surrogate_drop_grid_fallback_and_failure():
    """Dropping (2, 2) from the regular 2-D scheme activates (1, 1): without
    its data drop_grid raises, naming it, and leaves the state untouched;
    with it the surrogate recovers through the extend_plan fallback."""
    ts = tlev.GeneralScheme.regular(2, 3)
    grids = {ell: sample_function(lambda a, b: torch.sin(2 * a) * (b - b * b),
                                  ell, device="cpu")
             for ell, _ in ts.grids}
    srv = CTSurrogate(ts, grids, device="cpu")
    plan, surplus = srv._plan, srv.surplus
    pts = np.random.default_rng(9).random((32, 2))
    before = srv.query(pts)
    with pytest.raises(ValueError, match=r"\(1, 1\)"):
        srv.drop_grid([(2, 2)], grids)
    assert srv.scheme == ts and srv._plan is plan and srv.surplus is surplus
    np.testing.assert_array_equal(srv.query(pts), before)
    full = dict(grids)
    full[(1, 1)] = sample_function(lambda a, b: torch.sin(2 * a) * (b - b * b),
                                   (1, 1), device="cpu")
    srv.drop_grid([(2, 2)], full)
    reduced = ts.without_levels([(2, 2)])
    assert srv.scheme == reduced
    assert dict(reduced.grids) == {(1, 3): 1, (3, 1): 1, (1, 1): -1}
    fresh = CTSurrogate(reduced, full, device="cpu")
    _bitwise(srv.surplus, fresh.surplus.numpy())
    want = tcomb.combined_interpolant_points(
        {k: full[k] for k, _ in reduced.grids}, reduced,
        torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(srv.query(pts), want, rtol=1e-9, atol=1e-10)


# ---------------------------------------------------------------------------
# Guards: CUDA by default, no JAX
# ---------------------------------------------------------------------------

def test_new_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = tlev.CombinationScheme(2, 3)
    grids = {k: torch.from_numpy(v) for k, v in _sampled(ts).items()}
    full = torch.zeros(tlev.grid_shape(tlev.fine_levels(ts)),
                       dtype=torch.float64)
    f = tad.make_anisotropic_target(2)
    for call in (lambda: tex.ct_scatter(full, ts),
                 lambda: tex.ct_scatter_with_plan(full, tex.build_plan(ts)),
                 lambda: tex.ct_embedded(grids, ts),
                 lambda: tex.bucket_nodal_stacks(grids, tex.build_plan(ts)),
                 lambda: tad.AdaptiveDriver(tad.nodal_sampler(f), dim=2),
                 lambda: tad.refine(tad.nodal_sampler(f), 2),
                 lambda: CTSurrogate(ts, grids)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # refit and drop_grid run on the surrogate's device
    srv = CTSurrogate(ts, grids, device="cpu")
    srv.drop_grid([(3, 1)], grids)
    assert srv.surplus.device.type == "cpu"


def test_importing_the_new_modules_loads_no_jax():
    code = ("import sys, repro_torch.core.adaptive, "
            "repro_torch.runtime.fault_tolerance, "
            "repro_torch.configs.sparse_grid, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
