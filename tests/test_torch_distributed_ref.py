"""The port's multi-device layer against the reference's own sharded
functions, on the CPU: the second half of ``test_torch_distributed.py``
(split so that each file holds under 32 cases and runs beside the
reference's long ``test_sharded_2d.py``; ROADMAP.md, test-time budget),
whose helpers and bars it shares.

The unfused 1-D slab-sharded gather bitwise the single-device surplus;
the reference's ``ct_transform_sharded`` on its 8 fake devices
(``multidevice``) bitwise the port's; the psum and comm-phase paths at
rtol 1e-12 (f64) and 1e-5 (f32); row 9's slab-local plain version bitwise
the reference's Pallas kernel (interpret mode) slab by slab."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distributed import (PATHS, SCHEMES, _bitwise, _close,
                                    _cpu_mesh, _grids, _reference_surplus,
                                    _rmesh, _t, check_sharded_single_device)

from repro.core import distributed as rdist
from repro.core import executor as rex
from repro.core import levels as rlev
from repro.core.engine import ExecSpec as RExecSpec
from repro.kernels.hierarchize import hier_axis0_scatter_batched_pallas
from repro_torch.core import distributed as tdist
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.core.engine import ExecSpec
from repro_torch.kernels import hierarchize as H


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(SCHEMES))
@pytest.mark.parametrize("path", ["unfused_1d"])
def test_ct_transform_sharded_bitwise_single_device(path, name, dtype,
                                                    merged):
    """The unfused path; the fused one in ``test_torch_distributed.py``."""
    check_sharded_single_device(path, name, dtype, merged)


# ---------------------------------------------------------------------------
# Against the reference's own sharded functions (8 fake devices)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_sharded():
    """The reference's ``ct_transform_sharded`` on each 1-D path, on
    ``CombinationScheme(2, 3)`` in f64 (module scope: it runs its Pallas
    kernels in interpret mode on the fake devices)."""
    rs = rlev.CombinationScheme(2, 3)
    grids = {k: jnp.asarray(v) for k, v in _grids(rs, 5).items()}
    out = {}
    for path, (n_slabs, fused) in PATHS.items():
        out[path] = np.asarray(rdist.ct_transform_sharded(
            grids, rs, _rmesh((n_slabs,), ("slab",)), "slab",
            spec=RExecSpec(fused=fused)))
    out["ungathered"] = np.asarray(rdist.ct_transform_sharded(
        grids, rs, _rmesh((3,), ("slab",)), "slab", gather=False))
    return out


@pytest.mark.multidevice
@pytest.mark.parametrize("path", sorted(PATHS))
def test_ct_transform_sharded_bitwise_reference_sharded(path,
                                                        reference_sharded):
    n_slabs, fused = PATHS[path]
    ts = tlev.CombinationScheme(2, 3)
    grids = _t(_grids(ts, 5))
    got = tdist.ct_transform_sharded(
        grids, ts, _cpu_mesh((n_slabs,), ("slab",)), "slab",
        spec=ExecSpec(fused=fused))
    _bitwise(got, reference_sharded[path])
    parts = tdist.ct_transform_sharded(
        grids, ts, _cpu_mesh((3,), ("slab",)), "slab", gather=False)
    _bitwise(parts.concat(), reference_sharded["ungathered"])


# ---------------------------------------------------------------------------
# The psum and pole-parallel paths: reassociated sums, rtol
# ---------------------------------------------------------------------------

@pytest.mark.multidevice
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["regular_2_4", "general_3_7"])
def test_psum_paths_match_reference(name, dtype):
    """``ct_transform_psum`` (G padded to the 8 devices), its slab route,
    and ``gather_full_psum`` on a stack of 6 grids over 3 devices."""
    rs, ts = SCHEMES[name](rlev), SCHEMES[name](tlev)
    grids = _grids(rs, 5, np.dtype(dtype))
    rgrids = {k: jnp.asarray(v) for k, v in grids.items()}
    want = rdist.ct_transform_psum(rgrids, rs, _rmesh((8,), ("grid",)),
                                   "grid")
    got = tdist.ct_transform_psum(_t(grids), ts, _cpu_mesh((8,), ("grid",)),
                                  "grid")
    _close(got, want, dtype)
    _close(got, _reference_surplus(name, dtype, False), dtype)
    via_slabs = tdist.ct_transform_psum(
        _t(grids), ts, _cpu_mesh((4,), ("slab",)), "slab",
        spec=ExecSpec(n_slabs=4))
    _bitwise(via_slabs, _reference_surplus(name, dtype, False))
    emb = np.random.default_rng(2).standard_normal((6, 7, 5)).astype(dtype)
    c = np.array([1.0, -1.0, 2.0, -3.0, 1.0, 0.5], dtype)
    _close(tdist.gather_full_psum(torch.from_numpy(emb), torch.from_numpy(c),
                                  _cpu_mesh((3,), ("g",)), "g"),
           rdist.gather_full_psum(jnp.asarray(emb), jnp.asarray(c),
                                  _rmesh((3,), ("g",)), "g"), dtype)


@pytest.mark.multidevice
@pytest.mark.parametrize("route", ["psum", "slab"])
def test_comm_phase_sharded_matches_reference(route):
    rs, ts = rlev.CombinationScheme(2, 3), tlev.CombinationScheme(2, 3)
    grids = _grids(rs, 1)
    from repro.kernels.ops import hierarchize as rhier
    from repro_torch.kernels.ops import hierarchize as thier
    rh = {k: rhier(jnp.asarray(v), "ref") for k, v in grids.items()}
    th = {k: thier(torch.from_numpy(v), "ref") for k, v in grids.items()}
    if route == "psum":
        want = rdist.comm_phase_sharded(rh, rs, _rmesh((8,), ("grid",)),
                                        "grid")
        got = tdist.comm_phase_sharded(th, ts, _cpu_mesh((8,), ("grid",)),
                                       "grid")
    else:
        want = rdist.comm_phase_sharded(
            rh, rs, _rmesh((4,), ("slab",)), "slab",
            plan=rex.shard_plan(rex.build_plan(rs), 4))
        got = tdist.comm_phase_sharded(
            th, ts, _cpu_mesh((4,), ("slab",)), "slab",
            spec=ExecSpec(n_slabs=4))
    assert set(got) == set(want)
    for ell in want:
        _close(got[ell], want[ell], "float64")


# ---------------------------------------------------------------------------
# The kernels' plain versions on the sharded paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slab_scatter_tables_plain_is_the_reference_per_slab_fold(dtype):
    """Row 9 slab-local: ``hier_scatter_grouped`` (plain) on each slab's
    table is bitwise the reference's ``hier_axis0_scatter_batched_pallas``
    run bucket by bucket on that slab's local map (interpret mode), its
    ``gather_slab_scatter_fused`` device body."""
    levels = [(6, 5), (5, 6)]
    rs = rlev.GeneralScheme.from_levels(levels, close=True)
    ts = tlev.GeneralScheme.from_levels(levels, close=True)
    grids = _grids(rs, 8, np.dtype(dtype))
    rplan = rex.shard_plan(rex.build_plan(rs), 2)
    tplan = tex.shard_plan(tex.build_plan(ts), 2)
    # every bucket on the reference's Pallas path: its fused epilogue runs
    assert rex.plan_fused_ok(rplan, np.dtype(dtype))
    tails = rex.bucket_tail_surpluses(
        {k: jnp.asarray(v) for k, v in grids.items()}, rplan)
    y = H.hier_forward_grouped(
        tex._assemble(_t(grids), tplan.buckets, torch.float64 if
                      dtype == "float64" else torch.float32),
        tex._pass_specs(tplan.plan)[0])
    tables = tdist.slab_scatter_tables(tplan)
    assert tdist.slab_scatter_tables(tplan) is tables     # built once
    coeffs = torch.from_numpy(np.concatenate(
        [b.coeffs for b in tplan.buckets]).astype(dtype))
    for s in range(2):
        buf = jnp.zeros(rplan.slab_size + 1, dtype)
        for b, t, sb in zip(rplan.buckets, tails, rplan.slab_buckets):
            buf = hier_axis0_scatter_batched_pallas(
                t, [lv[0] for lv in b.levels],
                jnp.asarray(b.coeffs, dtype),
                jnp.asarray(sb.index[s]).reshape(t.shape), buf,
                interpret=True)
        got = torch.zeros(tplan.slab_size + 1, dtype=y.dtype)
        H.hier_scatter_grouped(y, tables[s], coeffs, got)
        _bitwise(got[:-1], np.asarray(buf)[:-1])
