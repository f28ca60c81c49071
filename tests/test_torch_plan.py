"""The port's planning layer against the reference: levels, 1-D oracles,
pricing rules and executor plans (``repro_torch`` vs ``repro``).

Plans must be ARRAY-EQUAL: the port keeps the reference's TPU pricing in
its merge cost model precisely so that bucket partitions, member order and
index maps coincide, which the bitwise ingest tests then rely on."""

import numpy as np
import pytest
import torch
from proptest import cases, integers, seeds
from test_merge_plan import AGGRESSIVE, _random_general_scheme

from repro.core import executor as rex
from repro.core import levels as rlev
from repro.kernels import hierarchize as rh
from repro.kernels import ref as rref
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.kernels import hierarchize as th
from repro_torch.kernels import ref as tref

MERGES = {"none": (None, None),
          "default": (rex.MergeConfig(), tex.MergeConfig()),
          "aggressive": (AGGRESSIVE,
                         tex.MergeConfig(launch_cost_bytes=1 << 30))}


def _port_scheme(ref_scheme):
    if isinstance(ref_scheme, rlev.CombinationScheme):
        return tlev.CombinationScheme(ref_scheme.dim, ref_scheme.level)
    return tlev.GeneralScheme(ref_scheme.dim, ref_scheme.index_set)


def _assert_plans_equal(rp, tp):
    assert (tp.dim, tp.full_levels, tp.fine_shape) == \
        (rp.dim, rp.full_levels, rp.fine_shape)
    assert len(tp.buckets) == len(rp.buckets)
    for rb, tb in zip(rp.buckets, tp.buckets):
        assert (tb.ells, tb.perms, tb.levels, tb.target, tb.shape) == \
            (rb.ells, rb.perms, rb.levels, rb.target, rb.shape)
        assert np.array_equal(tb.coeffs, rb.coeffs)
        assert tb.coeffs.dtype == rb.coeffs.dtype
        assert np.array_equal(tb.index, rb.index)
        assert tb.index.dtype == rb.index.dtype == np.int32


REGULAR = [(1, 5), (2, 2), (2, 6), (3, 3), (3, 5), (4, 3), (4, 4)]


@pytest.mark.parametrize("merge", sorted(MERGES))
@pytest.mark.parametrize("dim,level", REGULAR)
def test_regular_scheme_plans_equal(dim, level, merge):
    rm, tm = MERGES[merge]
    _assert_plans_equal(
        rex.build_plan(rlev.CombinationScheme(dim, level), merge=rm),
        tex.build_plan(tlev.CombinationScheme(dim, level), merge=tm))


@pytest.mark.parametrize("merge", sorted(MERGES))
@pytest.mark.parametrize("dim,steps,seed", cases(
    lambda r: (integers(r, 2, 4), integers(r, 2, 10), seeds(r)), n=6))
def test_downward_closed_scheme_plans_equal(dim, steps, seed, merge):
    rs = _random_general_scheme(seed, dim, steps)
    rm, tm = MERGES[merge]
    _assert_plans_equal(rex.build_plan(rs, merge=rm),
                        tex.build_plan(_port_scheme(rs), merge=tm))


def test_plan_cache_normalizes_full_levels():
    s = tlev.CombinationScheme(3, 3)
    p = tex.build_plan(s)
    assert tex.build_plan(s, full_levels=[3, 3, 3]) is p
    assert tex.build_plan(s, merge=tex.MergeConfig()) is not p
    tex.clear_plan_cache()
    assert tex.build_plan(s) is not p


@pytest.mark.parametrize("dim,level", [(2, 5), (3, 4), (4, 3), (10, 2)])
def test_levels_copy_matches_reference(dim, level):
    r, t = rlev.CombinationScheme(dim, level), tlev.CombinationScheme(dim,
                                                                      level)
    assert t.grids == r.grids and t.subspaces == r.subspaces
    assert t.total_points() == r.total_points()
    assert t.sparse_points() == r.sparse_points()
    rg, tg = r.as_general(), t.as_general()
    assert tg.index_set == rg.index_set and tg.grids == rg.grids
    assert tlev.fine_levels(t) == rlev.fine_levels(r)
    for ell, _ in r.grids:
        assert tlev.canonical_levels(ell) == rlev.canonical_levels(ell)
        assert tlev.flops_exact(ell) == rlev.flops_exact(ell)


def test_general_scheme_refine_and_drop_match_reference():
    r = rlev.GeneralScheme.from_levels([(3, 1, 2), (1, 4, 1)], close=True)
    t = tlev.GeneralScheme.from_levels([(3, 1, 2), (1, 4, 1)], close=True)
    assert t.coefficients == r.coefficients
    assert tlev.admissible_extensions(t.index_set) == \
        rlev.admissible_extensions(r.index_set)
    ext = rlev.admissible_extensions(r.index_set)[:2]
    assert t.with_levels(ext).grids == r.with_levels(ext).grids
    assert t.without_levels([(2, 1, 1)]).grids == \
        r.without_levels([(2, 1, 1)]).grids


@pytest.mark.parametrize("level", [1, 2, 3, 5, 7])
def test_oracles_match_reference(level):
    for a, b in zip(tref.predecessor_indices(level),
                    rref.predecessor_indices(level)):
        assert np.array_equal(a, b)
    assert np.array_equal(tref.operator_matrix(level),
                          rref.operator_matrix(level))
    assert np.array_equal(tref.dehier_operator_matrix(level),
                          rref.dehier_operator_matrix(level))
    n = (1 << level) - 1
    assert [tref.level_of_position(p, level) for p in range(1, n + 1)] == \
        [rref.level_of_position(p, level) for p in range(1, n + 1)]
    x = np.random.default_rng(level).standard_normal((3, n, 2))
    for axis in (1, -2):
        want = np.array(rref.hierarchize_1d_ref(x, axis))
        got = tref.hierarchize_1d_ref(torch.from_numpy(x), axis).numpy()
        assert np.array_equal(got, want)
        np.testing.assert_allclose(tref.hierarchize_1d_bruteforce(x, axis),
                                   want, rtol=1e-13, atol=1e-13)
        back = tref.dehierarchize_1d_ref(torch.from_numpy(want), axis)
        np.testing.assert_allclose(back.numpy(), x, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            tref.dehierarchize_1d_bruteforce(want, axis),
            np.asarray(rref.dehierarchize_1d_bruteforce(want, axis)),
            rtol=0, atol=0)


SHAPES = [(1,), (7,), (2047,), (4095,), (15, 15), (7, 3), (511, 511, 511),
          (255, 1, 1), (3, 3, 3, 3, 3, 3), (31, 7, 3, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pricing_rules_match_reference(shape):
    assert th.tile_volume(shape) == rh.tile_volume(shape)
    assert th.pad_blowup(shape) == rh.pad_blowup(shape)
    assert th.batched_method(shape) == rh.batched_method(shape)
    assert th.hier_flops(shape, 3) == rh.hier_flops(shape, 3)
    expected = ((tuple(range(1, len(shape))) + (0,))
                if rh.batched_method(shape) == "pallas"
                else tuple(range(len(shape))))
    assert th.axis_order(shape) == expected


@pytest.mark.parametrize("shape,levels", [
    ((15, 7), ((4, 3), (3, 3), (4, 1))),
    ((7, 7, 3), ((3, 3, 2), (2, 1, 1))),
])
def test_member_pred_arrays_match_reference(shape, levels):
    for a, b in zip(th.member_pred_arrays(levels, shape),
                    rh.member_pred_arrays(levels, shape)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
