"""The port's 2-D ingest and pole-parallel hierarchization against the
reference's own sharded functions, on the CPU: the second half of
``test_torch_sharded_2d.py`` (split so that each file holds under 32 cases
and runs beside the reference's long ``test_sharded_2d.py``; ROADMAP.md,
test-time budget), whose helpers and bars it shares.

The 2-D gather on the (2, 2) mesh bitwise the single-device surplus; the
reference's own 2-D gather on its fake devices (``multidevice``) bitwise
the port's; ``hierarchize_sharded`` at rtol 1e-12 (f64) and 1e-5 (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distributed import (SCHEMES, _bitwise, _close, _cpu_mesh,
                                    _grids, _rmesh, _t)
from test_torch_sharded_2d import MESHES, check_2d_gather_single_device

from repro.core import distributed as rdist
from repro.core import levels as rlev
from repro.core.engine import ExecSpec as RExecSpec
from repro_torch.core import distributed as tdist
from repro_torch.core import levels as tlev


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(SCHEMES))
@pytest.mark.parametrize("ms", MESHES[2:])
def test_2d_gather_bitwise_single_device(ms, name, dtype, merged):
    check_2d_gather_single_device(ms, name, dtype, merged)


@pytest.mark.multidevice
def test_2d_gather_bitwise_reference_2d():
    """The reference's own ``gather_slab_scatter_2d`` route on a (2, 3)
    mesh of its fake devices."""
    rs, ts = rlev.CombinationScheme(2, 3), tlev.CombinationScheme(2, 3)
    grids = _grids(rs, 5)
    want = rdist.ct_transform_sharded(
        {k: jnp.asarray(v) for k, v in grids.items()}, rs,
        _rmesh((2, 3), ("member", "slab")), "slab",
        spec=RExecSpec(member_axis="member"))
    got = tdist.ct_transform_sharded(
        _t(grids), ts, _cpu_mesh((2, 3), ("member", "slab")), "slab",
        member_axis="member")
    _bitwise(got, want)


@pytest.mark.multidevice
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hierarchize_sharded_matches_reference(dtype):
    level0 = 4
    x = np.random.default_rng(0).standard_normal(
        (1 << level0, 7, 3)).astype(dtype)
    x[-1] = 0.0
    want = rdist.hierarchize_sharded(jnp.asarray(x), level0,
                                     _rmesh((4,), ("grid",)), "grid")
    got = tdist.hierarchize_sharded(torch.from_numpy(x), level0,
                                    _cpu_mesh((4,), ("grid",)), "grid")
    _close(got, want, dtype)
    with pytest.raises(ValueError, match="padded"):
        tdist.hierarchize_sharded(torch.from_numpy(x[:-1]), level0,
                                  _cpu_mesh((4,), ("grid",)), "grid")
