"""The port's multi-device layer (``repro_torch.core.distributed``, the
sharded plans of ``repro_torch.core.executor``, ``repro_torch.core.mesh``)
against the reference, on the CPU.

The port is single-controller, as the reference: a mesh is a grid of
``torch.device``s and may repeat one, so every mesh here is the CPU
repeated, and the kernels run their plain versions.  Bars:

* plans: the slab maps, row ranges and shipping maps are array-equal to
  the reference's ``shard_plan``;
* the 1-D slab-sharded gathers (fused and unfused; ``gather=True`` and
  ``False``): bitwise the port's and the reference's single-device
  ``ct_transform`` (the same per-slot left fold in global member order),
  and bitwise the reference's own ``ct_transform_sharded`` on its fake
  devices (``multidevice``); the 2-D gather is in
  ``test_torch_sharded_2d.py``;
* the psum and pole-parallel paths: their sums are reassociated, in the
  reference as here (the port's psum folds in rank order), so they are
  held to the reference at rtol 1e-12 (f64) and 1e-5 (f32).

The reference's sharded functions run only in a few small cases, in module
fixtures: its Pallas kernels run in interpret mode on 8 fake devices.
Those cases, the unfused 1-D path and row 9's slab-local plain version are
in ``test_torch_distributed_ref.py`` (each file under 32 cases: see
ROADMAP.md, test-time budget); the helpers here serve both."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_merge_plan import AGGRESSIVE, _random_general_scheme

from repro.compat import AxisType
from repro.compat import make_mesh as rmake_mesh
from repro.core import distributed as rdist
from repro.core import executor as rex
from repro.core import levels as rlev
from repro_torch.core import distributed as tdist
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.core.engine import ExecSpec
from repro_torch.core.mesh import SlabSharded, make_mesh

PORT_AGGRESSIVE = tex.MergeConfig(launch_cost_bytes=1 << 30)
SCHEMES = {
    "regular_3_4": lambda lev: lev.CombinationScheme(3, 4),
    "regular_2_4": lambda lev: lev.CombinationScheme(2, 4),
    "general_3_7": lambda lev: _port_scheme(_random_general_scheme(3, 3, 7),
                                            lev),
}
#: schemes whose sharded surpluses are also held to the reference's
#: single-device ct_transform (the others to the port's, which
#: test_torch_executor.py holds bitwise to the reference's)
REFERENCE_CHECKED = ("regular_2_4", "general_3_7")


def _port_scheme(rs, lev):
    return rs if lev is rlev else tlev.GeneralScheme(rs.dim, rs.index_set)


def _grids(scheme, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(rlev.grid_shape(ell)).astype(dtype)
            for ell, _ in scheme.grids}


def _t(grids):
    return {k: torch.from_numpy(v) for k, v in grids.items()}


def _bitwise(got, want) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


def _cpu_mesh(shape, names):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _rmesh(shape, names):
    n = int(np.prod(shape))
    return rmake_mesh(shape, names,
                      devices=np.array(jax.devices()[:n]),
                      axis_types=(AxisType.Auto,) * len(shape))


@functools.lru_cache(maxsize=None)
def _reference_surplus(name, dtype, merged):
    """The reference's single-device ``ct_transform`` (unfused: the bits
    of its every path) of scheme ``name``'s seeded grids."""
    rs = SCHEMES[name](rlev)
    grids = _grids(rs, 5, np.dtype(dtype))
    plan = rex.build_plan(rs, merge=AGGRESSIVE if merged else None)
    return np.asarray(rex.ct_transform_with_plan(
        {k: jnp.asarray(v) for k, v in grids.items()}, plan, fused=False))


def _single_device(name, dtype, merged, checked=REFERENCE_CHECKED):
    """Scheme ``name``'s seeded grids (port tensors) and their surplus by
    the port's single-device ``ct_transform``, checked bitwise against the
    reference's where ``name`` is in ``checked``."""
    ts = SCHEMES[name](tlev)
    grids = _t(_grids(ts, 5, np.dtype(dtype)))
    want = tex.ct_transform(grids, ts, spec=ExecSpec(
        merge=PORT_AGGRESSIVE if merged else None), device="cpu")
    if name in checked:
        _bitwise(want, _reference_surplus(name, dtype, merged))
    return ts, grids, want.numpy()


def _check_slabs(parts, want, n_slabs) -> None:
    """A ``gather=False`` result: its slabs bitwise the slices of the
    single-device surplus ``want``, its padding rows zero."""
    assert isinstance(parts, SlabSharded)
    rows = -(-want.shape[0] // n_slabs)
    assert parts.n_slabs == n_slabs and parts.shape == \
        (n_slabs * rows,) + want.shape[1:]
    assert not parts.concat()[want.shape[0]:].any()
    for s, slab in enumerate(parts.slabs):
        _bitwise(slab[:max(0, min(rows, want.shape[0] - s * rows))],
                 want[s * rows:(s + 1) * rows])
    _bitwise(parts.full(), want)


# ---------------------------------------------------------------------------
# Plans: array-equal to the reference's
# ---------------------------------------------------------------------------

def _assert_splans_equal(tp, rp):
    assert (tp.n_slabs, tp.slab_rows, tp.n_groups, tp.slab_size) == \
        (rp.n_slabs, rp.slab_rows, rp.n_groups, rp.slab_size)
    assert len(tp.slab_buckets) == len(rp.slab_buckets)
    for a, b in zip(tp.slab_buckets, rp.slab_buckets):
        np.testing.assert_array_equal(a.index, b.index)
        np.testing.assert_array_equal(a.row_ranges, b.row_ranges)
        assert a.group_size == b.group_size
        for x, y in ((a.ship_src, b.ship_src), (a.ship_idx, b.ship_idx)):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("members,n_slabs", [(1, 3), (1, 5), (1, 7),
                                             (2, 3), (3, 2), (2, 2)])
@pytest.mark.parametrize("name", ["regular_3_4", "general_3_7"])
def test_shard_plan_array_equal_reference(name, members, n_slabs):
    """Slab maps, row ranges, ship maps and group sizes as the
    reference's, ragged last slabs and ragged member groups included."""
    n_groups = members * n_slabs if members > 1 else 1
    tp = tex.shard_plan(tex.build_plan(SCHEMES[name](tlev)), n_slabs,
                        n_groups=n_groups)
    rp = rex.shard_plan(rex.build_plan(SCHEMES[name](rlev)), n_slabs,
                        n_groups=n_groups)
    _assert_splans_equal(tp, rp)
    for key, want in rex.plan_ingest_stats(rp).items():
        assert tex.plan_ingest_stats(tp)[key] == want, key


def test_extend_plan_across_slab_boundary_equals_reference():
    """A refinement that grows ``fine_shape[0]`` past the old slabs
    re-shards fully (no stale identity reuse), as the reference's."""
    gs = rlev.GeneralScheme.regular(2, 3)
    tgs = tlev.GeneralScheme.regular(2, 3)
    rsp = rex.shard_plan(rex.build_plan(gs), 3, n_groups=6)
    tsp = tex.shard_plan(tex.build_plan(tgs), 3, n_groups=6)
    lead = rlev.fine_levels(gs)[0]
    while rlev.fine_levels(gs)[0] == lead:
        cand = max(rlev.admissible_extensions(gs.index_set),
                   key=lambda c: c[0])
        gs, tgs = gs.with_levels([cand]), tgs.with_levels([cand])
    r2, t2 = rex.extend_plan(rsp, gs), tex.extend_plan(tsp, tgs)
    assert isinstance(t2, tex.ShardedPlan)
    old = {id(sb) for sb in tsp.slab_buckets}
    assert all(id(sb) not in old for sb in t2.slab_buckets)
    _assert_splans_equal(t2, r2)
    _assert_splans_equal(t2, tex.shard_plan(tex.build_plan(tgs), 3,
                                            n_groups=6))


def test_reshard_reuses_slab_buckets_when_geometry_unchanged():
    gs = tlev.GeneralScheme.regular(3, 3)
    splan = tex.shard_plan(tex.build_plan(gs), 4, n_groups=8)
    dropped = max(ell for ell, _ in gs.grids)
    s2 = tex.update_plan_coefficients(splan, gs.without_levels([dropped]))
    assert all(a is b for a, b in zip(s2.slab_buckets, splan.slab_buckets))
    assert isinstance(s2, tex.ShardedPlan) and s2.n_groups == 8
    # a group-count change alone rebuilds every split (ship maps bake it)
    s3 = tex.shard_plan(splan.plan, 4, old=splan, n_groups=4)
    assert all(a is not b for a, b in zip(s3.slab_buckets,
                                          splan.slab_buckets))
    # extend_plan onto the same fine grid keeps the untouched buckets' splits
    s4 = tex.extend_plan(splan, gs)
    assert all(a is b for a, b in zip(s4.slab_buckets, splan.slab_buckets))


def test_build_plan_under_sharded_specs_and_validation():
    scheme = tlev.CombinationScheme(2, 3)
    base = tex.build_plan(scheme)
    sp = tex.build_plan(scheme, spec=ExecSpec(n_slabs=4))
    assert isinstance(sp, tex.ShardedPlan) and sp.plan is base
    assert (sp.n_slabs, sp.n_groups) == (4, 1)
    mesh = _cpu_mesh((2, 2), ("member", "slab"))
    sp2 = ExecSpec(mesh=mesh, member_axis="member").plan(scheme)
    assert (sp2.n_slabs, sp2.n_groups) == (2, 4) and sp2.plan is base
    assert tex.build_plan(scheme, spec=ExecSpec(n_slabs=1)) is base
    with pytest.raises(ValueError, match="n_groups"):
        tex.shard_plan(base, 2, n_groups=0)
    with pytest.raises(TypeError, match="unsharded"):
        tex.shard_plan(sp, 2)
    with pytest.raises(ValueError, match="re-shard explicitly"):
        tex.extend_plan(sp, scheme, spec=ExecSpec(n_slabs=2))
    assert tex.plan_fused_ok(sp)
    stats = tex.plan_launch_stats(sp)
    assert stats["pallas_launches"] == 2 + 2 * 4


# ---------------------------------------------------------------------------
# The slab-sharded gathers: bitwise the single-device surplus
# ---------------------------------------------------------------------------

PATHS = {  # path -> (n_slabs, fused)
    "fused_1d": (3, None),
    "unfused_1d": (4, False),
}


def check_sharded_single_device(path, name, dtype, merged):
    """A 1-D slab-sharded gather of ``path``, gathered and not, and the
    same route through ``ct_transform``/``ct_transform_with_plan``:
    bitwise the single-device surplus."""
    n_slabs, fused = PATHS[path]
    ts, grids, want = _single_device(name, dtype, merged)
    spec = ExecSpec(merge=PORT_AGGRESSIVE if merged else None, fused=fused)
    mesh = _cpu_mesh((n_slabs,), ("slab",))
    _bitwise(tdist.ct_transform_sharded(grids, ts, mesh, "slab", spec=spec),
             want)
    _check_slabs(tdist.ct_transform_sharded(grids, ts, mesh, "slab",
                                            spec=spec, gather=False),
                 want, n_slabs)
    # the same route through ct_transform / ct_transform_with_plan
    meshed = dataclasses.replace(spec, mesh=mesh)
    _bitwise(tex.ct_transform(grids, ts, spec=meshed), want)
    _bitwise(tex.ct_transform_with_plan(grids, meshed.plan(ts),
                                        spec=meshed), want)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(SCHEMES))
@pytest.mark.parametrize("path", ["fused_1d"])
def test_ct_transform_sharded_bitwise_single_device(path, name, dtype,
                                                    merged):
    """The fused path here; the unfused one in
    ``test_torch_distributed_ref.py``."""
    check_sharded_single_device(path, name, dtype, merged)


def test_sharded_gather_validates_inputs():
    scheme = tlev.GeneralScheme.regular(2, 3)
    grids = _t(_grids(scheme, 1))
    splan = tex.shard_plan(tex.build_plan(scheme), 4)
    alphas = tex.bucket_surpluses(grids, splan, device="cpu")
    with pytest.raises(ValueError, match="8 device"):
        tdist.gather_slab_scatter(alphas, splan, _cpu_mesh((8,), ("slab",)),
                                  "slab")
    with pytest.raises(ValueError, match="bucket"):
        tdist.gather_slab_scatter(alphas[:-1], splan,
                                  _cpu_mesh((4,), ("slab",)), "slab")
    mesh = _cpu_mesh((2, 2), ("member", "slab"))
    with pytest.raises(ValueError, match="compute-sharded for 1"):
        tdist.gather_slab_scatter_2d(
            tex.bucket_nodal_stacks(grids, splan, device="cpu"),
            tex.shard_plan(splan.plan, 2), mesh, "member", "slab")
    with pytest.raises(TypeError, match="Mesh"):
        tdist.ct_transform_sharded(grids, scheme, object(), "slab")


def test_sharded_gather_after_fault_recombination():
    """recombine_after_fault on a ShardedPlan: the coefficient-only path
    keeps the slab splits, and the sharded gather through it is bitwise
    the single-device gather of the reduced plan."""
    from repro_torch.runtime.fault_tolerance import recombine_after_fault
    gs = tlev.GeneralScheme.regular(3, 3)
    splan = tex.shard_plan(tex.build_plan(gs), 5)
    dropped = max(ell for ell, _ in gs.grids)
    s2, p2, coeff_only = recombine_after_fault(gs, [dropped], plan=splan)
    assert coeff_only and isinstance(p2, tex.ShardedPlan)
    grids = _t(_grids(gs, 3))
    want = tex.ct_transform_with_plan(grids, p2.plan, device="cpu")
    _bitwise(tdist.ct_transform_sharded(
        grids, s2, _cpu_mesh((5,), ("slab",)), "slab", plan=p2), want)


# ---------------------------------------------------------------------------
# The psum and pole-parallel paths (``test_torch_distributed_ref.py``, and
# ``test_torch_sharded_2d_ref.py``): reassociated sums, rtol
# ---------------------------------------------------------------------------

RTOL = {"float64": 1e-12, "float32": 1e-5}


def _close(got, want, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * max(1.0, np.abs(want).max()))


def test_plan_grid_groups_equals_reference():
    for dim, level, groups in ((2, 5, 3), (3, 4, 4), (4, 3, 7)):
        assert tdist.plan_grid_groups(tlev.CombinationScheme(dim, level),
                                      groups) == \
            rdist.plan_grid_groups(rlev.CombinationScheme(dim, level),
                                   groups)
