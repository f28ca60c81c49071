"""The port's CT ingest (``repro_torch.core.executor``) against the
reference executor and against the dict oracle, on the CPU.

The bar is bitwise in f64 and f32: the port runs the reference's per-shape
axis order and the same member-order left fold per fine slot, with every
product and sum rounded separately.  The reference's Pallas kernels run in
interpret mode, as its own tests run them."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from test_merge_plan import AGGRESSIVE, _random_general_scheme

from repro.core import executor as rex
from repro.core import levels as rlev
from repro_torch.core import combination as tcomb
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.kernels.ref import hierarchize_nd_ref

PORT_AGGRESSIVE = tex.MergeConfig(launch_cost_bytes=1 << 30)

SCHEMES = {
    "regular_4_3": (rlev.CombinationScheme(4, 3),
                    tlev.CombinationScheme(4, 3)),
    "regular_3_4": (rlev.CombinationScheme(3, 4),
                    tlev.CombinationScheme(3, 4)),
    # the reference runs these buckets on its Pallas path
    "general_65_56": (
        rlev.GeneralScheme.from_levels([(6, 5), (5, 6)], close=True),
        tlev.GeneralScheme.from_levels([(6, 5), (5, 6)], close=True)),
}


def _grids(scheme, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(rlev.grid_shape(ell)).astype(dtype)
            for ell, _ in scheme.grids}


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


def _reference(ref_scheme, grids, merge, fused):
    plan = rex.build_plan(ref_scheme, merge=merge)
    return rex.ct_transform_with_plan(
        {k: jnp.asarray(v) for k, v in grids.items()}, plan, fused=fused)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_ct_transform_bitwise_equals_reference(name, merged):
    rs, ts = SCHEMES[name]
    grids = _grids(rs, seed=7)
    tgrids = {k: torch.from_numpy(v) for k, v in grids.items()}
    rm, tm = (AGGRESSIVE, PORT_AGGRESSIVE) if merged else (None, None)
    want = np.asarray(_reference(rs, grids, rm, fused=False))
    _bitwise(torch.from_numpy(np.array(_reference(rs, grids, rm, None))),
             want)
    tplan = tex.build_plan(ts, merge=tm)
    for fused in (None, True, False):
        _bitwise(tex.ct_transform_with_plan(tgrids, tplan, fused=fused,
                                            device="cpu"), want)
    _bitwise(tex.ct_transform(tgrids, ts, merge=tm, device="cpu"), want)


@pytest.mark.parametrize("dim,steps,seed", [(2, 6, 3), (3, 8, 5),
                                            (4, 6, 9)])
def test_merged_below_target_members_bitwise(dim, steps, seed):
    """Seeded downward-closed schemes under aggressive merging: members
    below the bucket target, zero-padded, fused epilogue."""
    rs = _random_general_scheme(seed, dim, steps)
    ts = tlev.GeneralScheme(rs.dim, rs.index_set)
    grids = _grids(rs, seed)
    tplan = tex.build_plan(ts, merge=PORT_AGGRESSIVE)
    assert any(len(set(b.levels)) > 1 for b in tplan.buckets)
    want = _reference(rs, grids, AGGRESSIVE, None)
    _bitwise(tex.ct_transform_with_plan(
        {k: torch.from_numpy(v) for k, v in grids.items()}, tplan,
        device="cpu"), want)


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_ct_transform_float32(name):
    """f32: bitwise against the reference's f32 run, and within 1e-6 of
    the f64 dict oracle (the f32 rounding of inputs and arithmetic)."""
    rs, ts = SCHEMES[name]
    g64 = _grids(rs, seed=8)
    g32 = {k: v.astype(np.float32) for k, v in g64.items()}
    got = tex.ct_transform({k: torch.from_numpy(v) for k, v in g32.items()},
                           ts, device="cpu")
    assert got.dtype == torch.float32
    _bitwise(got, rex.ct_transform({k: jnp.asarray(v)
                                    for k, v in g32.items()}, rs))
    hier = {k: hierarchize_nd_ref(torch.from_numpy(v))
            for k, v in g64.items()}
    oracle = tcomb.combine_full(hier, ts)[0]
    np.testing.assert_allclose(got.double().numpy(), oracle.numpy(),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dim,level", [(1, 6), (2, 5), (3, 3), (4, 3)])
def test_ct_transform_matches_dict_oracle(dim, level):
    ts = tlev.CombinationScheme(dim, level)
    grids = {k: torch.from_numpy(v)
             for k, v in _grids(ts, seed=dim * 10 + level).items()}
    hier = {k: hierarchize_nd_ref(v) for k, v in grids.items()}
    want = tcomb.combine_full(hier, ts)[0]
    got = tex.ct_transform(grids, ts, device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_bucket_surpluses_bitwise(name):
    rs, ts = SCHEMES[name]
    grids = _grids(rs, seed=9)
    jg = {k: jnp.asarray(v) for k, v in grids.items()}
    tg = {k: torch.from_numpy(v) for k, v in grids.items()}
    rplan, tplan = rex.build_plan(rs), tex.build_plan(ts)
    for got, want in zip(tex.bucket_surpluses(tg, tplan, device="cpu"),
                         rex.bucket_surpluses(jg, rplan)):
        _bitwise(got, want)
    for got, want in zip(tex.bucket_tail_surpluses(tg, tplan, device="cpu"),
                         rex.bucket_tail_surpluses(jg, rplan)):
        _bitwise(got, want)


def test_missing_or_empty_grids_are_named():
    ts = tlev.CombinationScheme(2, 3)
    grids = {k: torch.from_numpy(v) for k, v in _grids(ts, 0).items()}
    dropped = next(iter(grids))
    partial = {k: v for k, v in grids.items() if k != dropped}
    with pytest.raises(ValueError, match=str(dropped)):
        tex.ct_transform(partial, ts, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tex.ct_transform({}, ts, device="cpu")


def test_embed_matches_reference_oracle():
    from repro.core import combination as rcomb
    a = np.random.default_rng(1).standard_normal((3, 7))
    want = rcomb.embed_to_full(jnp.asarray(a), (2, 3), (4, 5))
    _bitwise(tcomb.embed_to_full(torch.from_numpy(a), (2, 3), (4, 5)), want)


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_recorded_calls_replay_the_ingest_bitwise(name):
    """``record_calls`` sees every wrapper call of a fused ingest, with
    arguments that repeat it: replaying the plain versions into a fresh
    fine buffer gives the ingest's surplus bit for bit."""
    from repro_torch.kernels import hierarchize as th
    _, ts = SCHEMES[name]
    plan = tex.build_plan(ts)
    grids = {k: torch.from_numpy(v) for k, v in _grids(ts, 4).items()}
    with th.record_calls() as calls:
        surplus = tex.ct_transform_with_plan(grids, plan, device="cpu")
    wrappers = [w for w, _ in calls]
    assert wrappers == [th.assemble_grouped, th.hier_forward_grouped,
                        th.hier_scatter_grouped]
    acc = torch.zeros(plan.fine_size + 1, dtype=torch.float64)
    for wrapper, args in calls:
        assert wrapper in th.WRAPPERS
        wrapper.plain(**{**args, "acc": acc} if "acc" in args else args)
    _bitwise(acc[:-1].reshape(plan.fine_shape), surplus.numpy())
    with th.record_calls() as outside:
        pass
    assert outside == [] and th._RECORDING is None
