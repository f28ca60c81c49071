"""The port's scatter phase and incremental plans against the reference, on
the CPU.

Rows of the TPU-kernel table (``PERF.md``): 6 =
``hier_tail_batched_pallas(inverse=True)``, 8 =
``hier_axis0_batched_pallas(inverse=True)``.  The reference applies each
member's dense padded operator ``H^-1 (+) I`` as a matmul (run here in
interpret mode, as its own tests run it); the port runs the level-loop
stencil, so the two differ only in summation order and are held to f64
rtol 1e-12 / atol 1e-12 and f32 1e-5.  Everything that is forward only
(``hierarchize_batched_data``, ``ct_embedded``) and the plans are bitwise
or array-equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from test_merge_plan import AGGRESSIVE

from repro.core import executor as rex
from repro.core import levels as rlev
from repro.kernels import hierarchize as rh
from repro_torch.core import combination as tcomb
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.kernels import hierarchize as th
from repro_torch.kernels import ops

PORT_AGGRESSIVE = tex.MergeConfig(launch_cost_bytes=1 << 30)
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=1e-5)}


def _stack(rng, levels, shape, dtype=np.float64):
    """(G, *shape) stack, member g random at its own level vector and zero
    on the padding, as the executor assembles it."""
    x = np.zeros((len(levels),) + tuple(shape), dtype)
    for g, lv in enumerate(levels):
        sl = tuple(slice(0, (1 << l) - 1) for l in lv)
        x[(g,) + sl] = rng.standard_normal(rlev.grid_shape(lv))
    return x


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


# Members below the bucket target (merged buckets) and level-1 axes.
STACKS = [
    ((7, 15), ((3, 4), (3, 4), (2, 3))),
    ((15, 15), ((4, 4), (1, 4), (4, 1))),
    ((7, 7, 7), ((3, 3, 3), (3, 2, 1), (1, 3, 2))),
    ((15, 7, 3, 3), ((4, 3, 2, 2), (4, 1, 2, 1))),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape,levels", STACKS)
def test_inverse_tail_plain_matches_row6(dtype, shape, levels):
    x = _stack(np.random.default_rng(1), levels, shape, dtype)
    want = np.asarray(rh.hier_tail_batched_pallas(jnp.asarray(x), levels,
                                                  inverse=True))
    got = th.hier_tail_batched(torch.from_numpy(x), levels, inverse=True)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    # the padding is copied: zero in, zero out
    for g, lv in enumerate(levels):
        pad = np.ones(shape, bool)
        pad[tuple(slice(0, (1 << l) - 1) for l in lv)] = False
        assert not got[g].numpy()[pad].any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,b,levels0", [
    (15, 9, (4, 3, 1)), (31, 1, (5, 5)), (7, 130, (3, 2, 3, 1))])
def test_inverse_axis0_plain_matches_row8(dtype, n, b, levels0):
    rng = np.random.default_rng(2)
    x = _stack(rng, [(l, 1) for l in levels0], (n, 1), dtype)
    x = np.array(np.broadcast_to(x, x.shape[:2] + (b,)))
    x = x * rng.standard_normal(x.shape).astype(dtype)
    want = np.asarray(rh.hier_axis0_batched_pallas(jnp.asarray(x), levels0,
                                                   inverse=True))
    got = th.hier_axis0_batched(torch.from_numpy(x), levels0, inverse=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    _bitwise(th.dehier_axis0_batched.plain(torch.from_numpy(x), levels0),
             got.numpy())


@pytest.mark.parametrize("method", ["auto", "pallas", "jnp"])
@pytest.mark.parametrize("shape,levels", STACKS)
def test_batched_round_trip(shape, levels, method):
    x = torch.from_numpy(_stack(np.random.default_rng(3), levels, shape))
    alpha = th.hierarchize_batched(x, levels, method=method)
    back = th.dehierarchize_batched(alpha, levels, method=method)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=0, atol=1e-13)
    want = rh.dehierarchize_batched(jnp.asarray(alpha.numpy()), levels,
                                    method=method)
    np.testing.assert_allclose(back.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape,levels", STACKS)
def test_hierarchize_batched_data_bitwise(dtype, shape, levels):
    x = _stack(np.random.default_rng(4), levels, shape, dtype)
    pred = th.member_pred_arrays(levels, shape)
    got = th.hierarchize_batched_data(torch.from_numpy(x), pred)
    _bitwise(got, th.hierarchize_batched(torch.from_numpy(x),
                                         levels).numpy())
    want = rh.hierarchize_batched_data(
        jnp.asarray(x), tuple(jnp.asarray(a) for a in
                              rh.member_pred_arrays(levels, shape)))
    _bitwise(got, want)
    for method in ("pallas", "jnp"):
        _bitwise(th.hierarchize_batched_data(torch.from_numpy(x), pred,
                                             method=method),
                 th.hierarchize_batched(torch.from_numpy(x), levels,
                                        method=method).numpy())


def test_inverse_wrappers_are_recorded_under_their_own_names():
    levels = ((3, 3, 3), (3, 2, 1))
    x = torch.from_numpy(_stack(np.random.default_rng(5), levels, (7, 7, 7)))
    with th.record_calls() as calls:
        y = th.dehierarchize_batched(x, levels)
    assert sorted(w.__name__ for w, _ in calls) == [
        "dehier_axis0_batched", "dehier_tail_batched"]
    replay = x
    for wrapper, args in calls:
        replay = wrapper.plain(**{**args, "x": replay})
    _bitwise(replay, y.numpy())
    with pytest.raises(ValueError, match="forward only"):
        th.hier_tail_batched(x, levels, inverse=True,
                             pred=th.member_pred_arrays(levels, (7, 7, 7)))


def test_inverse_rejects_a_level_beyond_the_extent():
    x = torch.zeros((1, 7, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="does not fit"):
        th.dehier_axis0_batched(x, [4])


# ---------------------------------------------------------------------------
# Scatter phase and the per-grid embedding
# ---------------------------------------------------------------------------

def _general(levels):
    return (rlev.GeneralScheme.from_levels(levels, close=True),
            tlev.GeneralScheme.from_levels(levels, close=True))


SCHEMES = {
    "regular_2_4": (rlev.CombinationScheme(2, 4),
                    tlev.CombinationScheme(2, 4)),
    "regular_3_3": (rlev.CombinationScheme(3, 3),
                    tlev.CombinationScheme(3, 3)),
    # singleton buckets: an adaptive set is rarely permutation-symmetric
    "general_41_22_13": _general([(4, 1), (2, 2), (1, 3)]),
}


def _grids(scheme, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(rlev.grid_shape(ell)).astype(dtype)
            for ell, _ in scheme.grids}


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_ct_scatter_matches_reference(name, merged):
    rs, ts = SCHEMES[name]
    rm, tm = (AGGRESSIVE, PORT_AGGRESSIVE) if merged else (None, None)
    grids = _grids(rs, 6)
    full = np.array(rex.ct_transform({k: jnp.asarray(v)
                                        for k, v in grids.items()}, rs))
    want = rex.ct_scatter_with_plan(jnp.asarray(full),
                                    rex.build_plan(rs, merge=rm))
    tplan = tex.build_plan(ts, merge=tm)
    if merged:
        assert len(tplan.buckets) < len(tex.build_plan(ts).buckets)
    got = tex.ct_scatter_with_plan(torch.from_numpy(full), tplan,
                                   device="cpu")
    assert set(got) == set(want) == {ell for ell, _ in ts.grids}
    for ell, u in got.items():
        assert tuple(u.shape) == rlev.grid_shape(ell)
        np.testing.assert_allclose(u.numpy(), np.asarray(want[ell]),
                                   rtol=1e-12, atol=1e-12)
    # merging changes neither the bits of the scatter nor of ct_scatter
    same = tex.ct_scatter(torch.from_numpy(full), ts, device="cpu")
    for ell, u in same.items():
        np.testing.assert_allclose(u.numpy(), got[ell].numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_ct_scatter_matches_the_subspace_oracle(name):
    _, ts = SCHEMES[name]
    grids = {k: torch.from_numpy(v) for k, v in _grids(ts, 7).items()}
    full = tex.ct_transform(grids, ts, device="cpu")
    got = tex.ct_scatter(full, ts, device="cpu")
    hier = {ell: ops.hierarchize(u, "ref") for ell, u in grids.items()}
    combined = tcomb.scatter_subspaces(tcomb.gather_subspaces(hier, ts), ts)
    for ell, alpha in combined.items():
        np.testing.assert_allclose(got[ell].numpy(),
                                   ops.dehierarchize(alpha, "ref").numpy(),
                                   rtol=1e-11, atol=1e-12)


def test_ct_scatter_float32_and_shape_check():
    rs, ts = SCHEMES["regular_3_3"]
    full = np.random.default_rng(8).standard_normal(
        rlev.grid_shape(tlev.fine_levels(ts))).astype(np.float32)
    got = tex.ct_scatter(torch.from_numpy(full), ts, device="cpu")
    want = rex.ct_scatter(jnp.asarray(full), rs)
    for ell, u in got.items():
        assert u.dtype == torch.float32
        np.testing.assert_allclose(u.numpy(), np.asarray(want[ell]),
                                   **TOL[np.float32])
    with pytest.raises(ValueError, match="fine grid"):
        tex.ct_scatter(torch.zeros(5, dtype=torch.float64), ts, device="cpu")


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_ct_embedded_bitwise(name):
    rs, ts = SCHEMES[name]
    grids = _grids(rs, 9)
    emb, coeffs, order = rex.ct_embedded({k: jnp.asarray(v)
                                          for k, v in grids.items()}, rs)
    temb, tcoeffs, torder = tex.ct_embedded(
        {k: torch.from_numpy(v) for k, v in grids.items()}, ts,
        device="cpu")
    assert torder == order
    _bitwise(temb, emb)
    _bitwise(tcoeffs, coeffs)
    # the coefficient-weighted sum is the gather
    np.testing.assert_allclose(
        torch.einsum("g,g...->...", tcoeffs, temb).numpy(),
        tex.ct_transform({k: torch.from_numpy(v) for k, v in grids.items()},
                         ts, device="cpu").numpy(), rtol=1e-12, atol=1e-12)


def test_bucket_nodal_stacks_bitwise():
    rs, ts = SCHEMES["general_41_22_13"]
    grids = _grids(rs, 10)
    want = rex.bucket_nodal_stacks({k: jnp.asarray(v)
                                    for k, v in grids.items()},
                                   rex.build_plan(rs))
    got = tex.bucket_nodal_stacks({k: torch.from_numpy(v)
                                   for k, v in grids.items()},
                                  tex.build_plan(ts), device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _bitwise(g, w)


# ---------------------------------------------------------------------------
# Incremental plans
# ---------------------------------------------------------------------------

def _assert_plans_equal(tplan, rplan):
    assert tplan.full_levels == rplan.full_levels
    assert tplan.fine_shape == rplan.fine_shape
    assert len(tplan.buckets) == len(rplan.buckets)
    for tb, rb in zip(tplan.buckets, rplan.buckets):
        assert (tb.ells, tb.perms, tb.levels, tb.target) == \
            (rb.ells, rb.perms, rb.levels, rb.target)
        assert np.array_equal(tb.coeffs, rb.coeffs)
        assert np.array_equal(tb.index, rb.index)


@pytest.mark.parametrize("merged", [False, True])
def test_extend_plan_matches_reference_and_reuses_buckets(merged):
    rm, tm = (AGGRESSIVE, PORT_AGGRESSIVE) if merged else (None, None)
    base = [(5, 1, 1), (1, 5, 1), (1, 1, 3), (2, 2, 2)]
    grown = base + [(2, 3, 1)]              # same fine grid
    rs0, ts0 = _general(base)
    rs1, ts1 = _general(grown)
    rplan = rex.extend_plan(rex.build_plan(rs0, merge=rm), rs1)
    old = tex.build_plan(ts0, merge=tm)
    new = tex.extend_plan(old, ts1)
    assert new.merge == tm
    _assert_plans_equal(new, rplan)
    _assert_plans_equal(new, tex.build_plan(ts1, merge=tm))
    old_ids = {id(b) for b in old.buckets}
    old_index = {id(b.index) for b in old.buckets}
    assert any(id(b) in old_ids for b in new.buckets) or merged
    for b in new.buckets:
        if id(b) not in old_ids and id(b.index) in old_index:
            assert any(ob.ells == b.ells for ob in old.buckets)
    # a grown fine grid rebuilds from scratch
    rs2, ts2 = _general(grown + [(6, 1, 1)])
    _assert_plans_equal(tex.extend_plan(new, ts2),
                        rex.extend_plan(rplan, rs2))


def test_extend_plan_identity_contract():
    ts0 = tlev.CombinationScheme(3, 3).as_general()
    ts1 = ts0.with_levels([(2, 2, 2)])
    old = tex.build_plan(ts0)
    new = tex.extend_plan(old, ts1)
    by_ells = {b.ells: b for b in old.buckets}
    kept = moved = 0
    for b in new.buckets:
        ob = by_ells.get(b.ells)
        if ob is None or ob.target != b.target:
            continue
        if np.array_equal(ob.coeffs, b.coeffs):
            assert b is ob
            kept += 1
        else:
            assert b is not ob and b.index is ob.index
            moved += 1
    assert kept and moved
    assert tex.extend_plan(new, ts1).buckets == new.buckets


def test_update_plan_coefficients_matches_reference():
    rs, ts = SCHEMES["regular_3_3"]
    dropped = (3, 1, 1)
    rplan = rex.update_plan_coefficients(rex.build_plan(rs),
                                         rs.as_general().without_levels(
                                             [dropped]))
    plan = tex.build_plan(ts)
    new = tex.update_plan_coefficients(
        plan, ts.as_general().without_levels([dropped]))
    _assert_plans_equal(new, rplan)
    assert all(a.index is b.index for a, b in zip(new.buckets, plan.buckets))
    gs = tlev.GeneralScheme.regular(2, 3)     # dropping (2, 2) activates
    with pytest.raises(ValueError, match="extend_plan"):     # (1, 1)
        tex.update_plan_coefficients(tex.build_plan(gs),
                                     gs.without_levels([(2, 2)]))


def test_sharded_plans_are_refused():
    rs, ts = SCHEMES["regular_2_4"]
    sharded = rex.shard_plan(rex.build_plan(rs), 2)
    grids = {k: torch.from_numpy(v) for k, v in _grids(rs, 11).items()}
    full = torch.zeros(rlev.grid_shape(tlev.fine_levels(ts)),
                       dtype=torch.float64)
    for call in (lambda: tex.extend_plan(sharded, ts),
                 lambda: tex.update_plan_coefficients(sharded, ts),
                 lambda: tex.ct_transform_with_plan(grids, sharded,
                                                    device="cpu"),
                 lambda: tex.ct_scatter_with_plan(full, sharded,
                                                  device="cpu"),
                 lambda: tex.ct_embedded_with_plan(grids, sharded,
                                                   device="cpu")):
        with pytest.raises(TypeError, match="ExecutorPlan"):
            call()
