"""The grouped CT ingest of ``repro_torch`` on the CPU: the slot-owner table
of the grouped scatter, and the plain versions of the two grouped kernels
(``hier_forward_grouped``, ``hier_scatter_grouped``), against brute force
and the JAX reference, bitwise.

The reference's batched transforms run as its own tests run them: the jnp
path, and the Pallas kernels in interpret mode.  A stack's passes before
its last are the reference's ``hier_tail_batched_pallas`` on a bucket whose
last pass is axis 0 (its Pallas order), and its ``hierarchize_batched_jnp``
with every member at level 1 along the last axis (an identity pass) on a
bucket whose last pass is axis d-1 (its jnp order)."""

import gc

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import executor as rex
from repro.core import levels as rlev
from repro.kernels import hierarchize as rh
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.kernels import hierarchize as th

DTYPES = [np.float64, np.float32]


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


def _brute_table(plan):
    """The slot-owner table by brute force: every non-pad position of
    every member in plan order, grouped by slot, owners by run length
    (longest first) and then by slot."""
    runs, offset = {}, 0
    for b in plan.buckets:
        for row in b.index:
            for p, slot in enumerate(row.tolist()):
                if slot != plan.fine_size:
                    runs.setdefault(slot, []).append(offset + p)
            offset += row.size
    owners = sorted(runs, key=lambda s: (-len(runs[s]), s))
    counts = [len(runs[s]) for s in owners]
    return (np.asarray([e for s in owners for e in runs[s]], np.int32),
            np.asarray(owners, np.int32),
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int64))


PLANS = {
    "prod_3d": lambda: tex.build_plan(tlev.CombinationScheme(3, 9)),
    "prod_3d_merged": lambda: tex.build_plan(tlev.CombinationScheme(3, 9),
                                             merge=tex.MergeConfig()),
    "regular_2_11": lambda: tex.build_plan(tlev.CombinationScheme(2, 11)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_slot_owner_table_matches_brute_force(name):
    plan = PLANS[name]()
    table = tex._ingest_table(plan).scatter
    entries, slots, offsets = _brute_table(plan)
    assert np.array_equal(table.entries, entries)
    assert np.array_equal(table.slots, slots)
    assert np.array_equal(table.offsets, offsets)
    counts = np.diff(offsets)
    assert table.long_owners == int((counts > 32).sum())
    assert table.size == sum(b.index.size for b in plan.buckets)
    if name == "prod_3d":
        # 18,943 touched slots: 11,520 with one entry, the centre with all
        # 109 members
        assert table.owners == 18943 and int((counts == 1).sum()) == 11520
        assert counts[0] == 109 and counts[1] < 109
        assert table.slots[0] == plan.fine_size // 2
    if name == "prod_3d_merged":
        assert any(len(set(b.levels)) > 1 for b in plan.buckets)
        assert len(table.entries) < table.size     # pads are not listed


def _random_stacks(plan, seed, dtype):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        tex._ingest_table(plan).scatter.size).astype(dtype)


def _reference_passes(x, shape, levels, axes):
    """The reference's transform of one stack along ``axes``, the passes
    before its last (see the module docstring)."""
    order = rh.batched_method(shape)
    d = len(shape)
    if not axes:
        return x
    if order == "pallas":
        assert tuple(axes) == tuple(range(1, d))
        return np.asarray(rh.hier_tail_batched_pallas(jnp.asarray(x),
                                                      levels))
    assert tuple(axes) == tuple(range(d - 1))
    flat = [tuple(lv[:-1]) + (1,) for lv in levels]
    return np.asarray(rh.hierarchize_batched_jnp(jnp.asarray(x), flat))


FORWARD_PLANS = {
    "regular_3_5_merged": lambda: tex.build_plan(
        tlev.CombinationScheme(3, 5), merge=tex.MergeConfig(
            launch_cost_bytes=1 << 30)),
    # buckets the reference runs on its Pallas path (tail axes first)
    "general_65_56": lambda: tex.build_plan(tlev.GeneralScheme.from_levels(
        [(6, 5), (5, 6)], close=True)),
    "regular_4_4": lambda: tex.build_plan(tlev.CombinationScheme(4, 4)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(FORWARD_PLANS))
def test_grouped_forward_plain_equals_reference(name, dtype):
    plan = FORWARD_PLANS[name]()
    table = tex._ingest_table(plan)
    x = _random_stacks(plan, 1, dtype)
    got = th.hier_forward_grouped(torch.from_numpy(x), table.stacks)
    assert got.shape == x.shape
    orders = set()
    for (a, b), (shape, levels, axes) in zip(table.scatter.spans, table.stacks):
        stack = x[a:b].reshape((len(levels),) + shape)
        orders.add(rh.batched_method(shape))
        want = _reference_passes(stack, shape, levels, axes)
        _bitwise(got[a:b].reshape(stack.shape), want)
    if name == "general_65_56":
        assert "pallas" in orders


@pytest.fixture(scope="module")
def reference_4_6():
    """The reference's surplus of ``CombinationScheme(4, 6)`` (coefficients
    of +-1 and +-3) on seeded grids, unmerged and merged: JAX runs once."""
    scheme = rlev.CombinationScheme(4, 6)
    rng = np.random.default_rng(7)
    grids = {ell: rng.standard_normal(rlev.grid_shape(ell))
             for ell, _ in scheme.grids}
    out = {}
    for merged in (False, True):
        merge = rex.MergeConfig() if merged else None
        out[merged] = np.asarray(rex.ct_transform_with_plan(
            {k: jnp.asarray(v) for k, v in grids.items()},
            rex.build_plan(scheme, merge=merge)))
    return grids, out


@pytest.mark.parametrize("merged", [False, True])
def test_grouped_ingest_equals_reference_surplus(reference_4_6, merged):
    """The CSR fold (the plain version walks the table rank by rank) gives
    the reference's surplus bit for bit, products and sums rounded apart."""
    grids, want = reference_4_6
    scheme = tlev.CombinationScheme(4, 6)
    assert {abs(c) for _, c in scheme.grids} >= {3.0}
    plan = tex.build_plan(scheme, merge=tex.MergeConfig() if merged
                          else None)
    with th.record_calls() as calls:
        got = tex.ct_transform_with_plan(
            {k: torch.from_numpy(v) for k, v in grids.items()}, plan,
            device="cpu")
    assert [w for w, _ in calls] == [th.assemble_grouped,
                                     th.hier_forward_grouped,
                                     th.hier_scatter_grouped]
    _bitwise(got, want[merged])


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_scatter_plain_equals_per_bucket_scatters(dtype):
    """From any starting fine buffer: the grouped fold equals the
    per-bucket wrapper's plain version (one ordered ``index_add_`` per
    member) bucket after bucket, on a merged plan with pads."""
    scheme = tlev.CombinationScheme(3, 5)
    plan = tex.build_plan(scheme, merge=tex.MergeConfig(
        launch_cost_bytes=1 << 30))
    table = tex._ingest_table(plan)
    rng = np.random.default_rng(3)
    y = torch.from_numpy(_random_stacks(plan, 2, dtype))
    cs = torch.from_numpy(rng.choice([-3.0, -1.0, 1.0, 3.0],
                                     plan.num_grids).astype(dtype))
    acc = torch.from_numpy(rng.standard_normal(plan.fine_size + 1)
                           .astype(dtype))
    got = th.hier_scatter_grouped(y, table.scatter, cs, acc.clone())
    want, first = acc.clone(), 0
    for b, (a, e), (shape, levels, axis) in zip(
            plan.buckets, table.scatter.spans, table.scatter.stacks):
        g = len(levels)
        th.hier_axis0_scatter_batched(
            y[a:e].view((g,) + shape), levels, cs[first:first + g],
            torch.from_numpy(b.index), want, axis=axis)
        first += g
    _bitwise(got[:-1], want[:-1].numpy())


def test_ingest_table_reused_by_identity():
    scheme = tlev.CombinationScheme(3, 5)
    plan = tex._build_plan_uncached(scheme, (5, 5, 5), None)
    table = tex._ingest_table(plan)
    assert tex._ingest_table(plan) is table
    dropped = (5, 1, 1)
    reduced = scheme.as_general().without_levels([dropped])
    moved = tex.update_plan_coefficients(plan, reduced)
    assert all(a.index is b.index for a, b in zip(moved.buckets,
                                                  plan.buckets))
    assert tex._ingest_table(moved) is table
    grids = {ell: torch.from_numpy(np.random.default_rng(4).standard_normal(
        tlev.grid_shape(ell))) for ell, _ in scheme.grids}
    grids[dropped] = torch.zeros_like(grids[dropped])
    fresh = tex.ct_transform({k: grids[k] for k, _ in reduced.grids},
                             reduced, full_levels=(5, 5, 5), device="cpu")
    # the dropped grid adds zeros (its coefficient is 0): equal values
    np.testing.assert_array_equal(
        tex.ct_transform_with_plan(grids, moved, device="cpu").numpy(),
        fresh.numpy())
    key = ("ingest",) + tuple(id(b.index) for b in plan.buckets)
    assert key in tex._PLAN_TABLES
    del plan, moved, table
    gc.collect()
    assert key not in tex._PLAN_TABLES        # dropped with the plan


def test_grouped_wrappers_refuse_what_they_do_not_take():
    plan = tex.build_plan(tlev.CombinationScheme(2, 4))
    table = tex._ingest_table(plan)
    x = torch.zeros(table.scatter.size, dtype=torch.float64)
    with pytest.raises(ValueError, match="concatenation"):
        th.hier_forward_grouped(x[:-1], table.stacks)
    acc = torch.zeros(plan.fine_size + 1, dtype=torch.float64)
    cs = torch.ones(plan.num_grids, dtype=torch.float64)
    with pytest.raises(ValueError, match="fine buffer"):
        th.hier_scatter_grouped(x, table.scatter, cs, acc[:-1])
    with pytest.raises(ValueError, match="coefficients"):
        th.hier_scatter_grouped(x, table.scatter, cs[:-1], acc)
    with pytest.raises(TypeError):
        th.hier_scatter_grouped(x, table.scatter, cs.float(), acc)
