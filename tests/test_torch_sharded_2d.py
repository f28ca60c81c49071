"""The port's 2-D (member x slab) ingest and pole-parallel
hierarchization (``repro_torch.core.distributed``) against the
reference, on the CPU.

Each mesh here is the CPU repeated (a mesh may name one device more than
once) and the kernels run their plain versions.  The 2-D gather ships
every group's weighted payload to its slab owner, which folds them in
global member order with ``owner_fold``: bitwise the single-device
surplus, the reference's single-device ``ct_transform`` and the
reference's own 2-D gather on its fake devices (``multidevice``).  The
pole-parallel ``hierarchize_sharded`` reassociates its sums (a dense
product), so it is held to the reference at rtol 1e-12 (f64) and 1e-5
(f32).  The cases against the reference's own 2-D gather and
``hierarchize_sharded`` and those on the (2, 2) mesh are in
``test_torch_sharded_2d_ref.py`` (each file under 32 cases: ROADMAP.md,
test-time budget)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distributed import (PORT_AGGRESSIVE, SCHEMES, _bitwise,
                                    _check_slabs, _cpu_mesh, _grids,
                                    _single_device, _t)

from repro_torch.core import distributed as tdist
from repro_torch.core import executor as tex
from repro_torch.core import levels as tlev
from repro_torch.core.engine import ExecSpec
from repro_torch.kernels import hierarchize as H

#: (members, slabs): ragged member groups and a ragged last slab; the
#: (2, 2) mesh's cases are in ``test_torch_sharded_2d_ref.py``
MESHES = [(2, 3), (3, 2), (2, 2)]


def check_2d_gather_single_device(ms, name, dtype, merged):
    """The 2-D gather on a (members, slabs) mesh, gathered and not, and
    the meshed ``ct_transform``: bitwise the single-device surplus."""
    ts, grids, want = _single_device(name, dtype, merged,
                                     checked=("general_3_7",))
    mesh = _cpu_mesh(ms, ("member", "slab"))
    spec = ExecSpec(merge=PORT_AGGRESSIVE if merged else None,
                    member_axis="member")
    _bitwise(tdist.ct_transform_sharded(grids, ts, mesh, "slab", spec=spec),
             want)
    _check_slabs(tdist.ct_transform_sharded(grids, ts, mesh, "slab",
                                            spec=spec, gather=False),
                 want, ms[1])
    meshed = dataclasses.replace(spec, mesh=mesh)
    splan = meshed.plan(ts)
    assert (splan.n_slabs, splan.n_groups) == (ms[1], ms[0] * ms[1])
    _bitwise(tex.ct_transform(grids, ts, spec=meshed), want)
    _bitwise(tex.ct_transform_with_plan(grids, splan, spec=meshed), want)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(SCHEMES))
@pytest.mark.parametrize("ms", MESHES[:2])
def test_2d_gather_bitwise_single_device(ms, name, dtype, merged):
    check_2d_gather_single_device(ms, name, dtype, merged)


def test_2d_tables_and_validation():
    ts = tlev.CombinationScheme(3, 3)
    splan = tex.shard_plan(tex.build_plan(ts), 2, n_groups=4)
    tables = tdist.two_d_tables(splan)
    assert tdist.two_d_tables(splan) is tables        # built once
    # every real payload entry listed exactly once, in its slab's fold
    for s, fold in enumerate(tables.folds):
        real = sum(int((sb.ship_idx[s] != splan.slab_size).sum())
                   for sb in splan.slab_buckets)
        assert len(fold.entries) == real and fold.dump == splan.slab_size
    with pytest.raises(ValueError, match="not compute-sharded"):
        tdist.two_d_tables(tex.shard_plan(splan.plan, 2))
    grids = _t(_grids(ts, 2))
    stacks = tex.bucket_nodal_stacks(grids, splan, device="cpu")
    mesh = _cpu_mesh((2, 2), ("member", "slab"))
    with pytest.raises(ValueError, match="must differ"):
        tdist.gather_slab_scatter_2d(stacks, splan, mesh, "slab", "slab")
    with pytest.raises(ValueError, match="not an axis"):
        tdist.gather_slab_scatter_2d(stacks, splan, mesh, "rows", "slab")
    with pytest.raises(ValueError, match="compute-sharded for 4"):
        tdist.gather_slab_scatter_2d(
            stacks, splan, _cpu_mesh((3, 2), ("member", "slab")), "member",
            "slab")
    stats = tex.plan_launch_stats(splan)
    per_bucket = sum((b.shape[0] > 1) + any(n > 1 for n in b.shape[1:])
                     for b in splan.buckets)
    assert stats["pallas_launches"] == 1 + 4 * per_bucket + 2
    # a 1 x 1 mesh has nothing to compute-shard: the classic slab path
    one = _cpu_mesh((1, 1), ("member", "slab"))
    _bitwise(tdist.ct_transform_sharded(grids, ts, one, "slab",
                                        member_axis="member"),
             tex.ct_transform(grids, ts, device="cpu"))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_owner_fold_plain_is_the_reference_left_fold(dtype):
    """``owner_fold``'s plain version on a table from ``owner_table`` is
    bitwise the reference's scatter-add (``.at[dst].add``, a left fold in
    payload order), from a non-zero buffer, with repeated slots, a run
    longer than 32 and dump entries."""
    rng = np.random.default_rng(4)
    size, n = 50, 4000
    dst = rng.integers(0, size + 1, n).astype(np.int32)
    dst[:70] = 7                                   # one run of 70
    vals = (rng.choice([-3.0, -1.0, 0.5, 1.0, 3.0], n)
            * rng.standard_normal(n)).astype(dtype)
    acc0 = rng.standard_normal(size + 1).astype(dtype)
    want = np.asarray(jnp.asarray(acc0).at[dst].add(jnp.asarray(vals)))
    table = H.owner_table([dst[:1000], dst[1000:]], size)
    assert table.long_owners >= 1 and table.owners <= size
    for fold in (H.owner_fold, H.owner_fold.plain):
        got = fold(torch.from_numpy(vals), table,
                   torch.from_numpy(acc0.copy()))
        _bitwise(got[:size], want[:size])
    with pytest.raises(ValueError, match="dump slot last"):
        H.owner_fold(torch.from_numpy(vals), table,
                     torch.zeros(size, dtype=getattr(torch, dtype)))
