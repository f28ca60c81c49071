"""The plain PyTorch versions of the port's three batched kernels against
the reference's Pallas kernels (run in interpret mode, as the reference's
own tests run them on the CPU), bitwise in f64 and f32.

Rows of the TPU-kernel table (``PERF.md``): 5 = ``hier_tail_batched_pallas``
(forward), 7 = ``hier_axis0_batched_pallas`` (forward), 9 =
``hier_axis0_scatter_batched_pallas``.  Stacks include members below the
bucket target (zero-padded), and the scatter's accumulator includes the
dump slot."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.levels import grid_shape
from repro.kernels import hierarchize as rh
from repro_torch.kernels import hierarchize as th

DTYPES = [np.float64, np.float32]


def _stack(rng, levels, shape, dtype=np.float64):
    x = np.zeros((len(levels),) + tuple(shape), dtype)
    for g, lv in enumerate(levels):
        sl = tuple(slice(0, (1 << l) - 1) for l in lv)
        x[(g,) + sl] = rng.standard_normal(grid_shape(lv))
    return x


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


TAIL_STACKS = [
    ((7, 15), ((3, 4), (3, 4), (2, 3))),
    ((7, 7, 7), ((3, 3, 3), (3, 2, 1), (1, 3, 2))),
    ((15, 7, 3, 3), ((4, 3, 2, 2), (4, 1, 2, 1))),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,levels", TAIL_STACKS)
def test_tail_plain_equals_row5(dtype, shape, levels):
    x = _stack(np.random.default_rng(1), levels, shape, dtype)
    want = rh.hier_tail_batched_pallas(jnp.asarray(x), levels)
    _bitwise(th.hier_tail_batched(torch.from_numpy(x), levels), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,b,levels0", [
    (15, 9, (4, 3, 1)), (31, 1, (5, 5)), (7, 130, (3, 2, 3, 1))])
def test_axis0_plain_equals_row7(dtype, n, b, levels0):
    rng = np.random.default_rng(2)
    x = _stack(rng, [(l, 1) for l in levels0], (n, 1), dtype)
    x = np.array(np.broadcast_to(x, x.shape[:2] + (b,)))
    x *= rng.standard_normal(x.shape).astype(dtype)
    want = rh.hier_axis0_batched_pallas(jnp.asarray(x), levels0)
    _bitwise(th.hier_axis0_batched(torch.from_numpy(x), levels0), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,b,levels0,coeffs", [
    (15, 9, (4, 3, 4), (3.0, -3.0, 1.0)),
    (7, 3, (3, 1), (-1.0, 2.0)),
    (31, 5, (5, 4, 2, 5), (1.0, -3.0, 3.0, -1.0))])
def test_scatter_plain_equals_row9(dtype, n, b, levels0, coeffs):
    """Fused last pass + weighted scatter, members overlapping in the
    fine buffer (the member-order fold), pad rows on the dump slot."""
    rng = np.random.default_rng(3)
    g = len(levels0)
    x = rng.standard_normal((g, n, b)).astype(dtype)
    fine = 3 * n * b
    index = np.empty((g, n, b), np.int32)
    for m, l in enumerate(levels0):
        x[m, (1 << l) - 1:] = 0.0
        slots = rng.permutation(fine)[:n * b].reshape(n, b)
        index[m] = np.where(np.arange(n)[:, None] < (1 << l) - 1, slots,
                            fine)
    acc = rng.standard_normal(fine + 1).astype(dtype)
    cs = np.asarray(coeffs, dtype)
    want = rh.hier_axis0_scatter_batched_pallas(
        jnp.asarray(x), levels0, jnp.asarray(cs), jnp.asarray(index),
        jnp.asarray(acc))
    got = th.hier_axis0_scatter_batched(
        torch.from_numpy(x), levels0, torch.from_numpy(cs),
        torch.from_numpy(index), torch.from_numpy(acc.copy()))
    _bitwise(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,levels", [
    ((15, 15), ((4, 4), (3, 4), (4, 2))),      # reference: Pallas path
    ((7, 7, 7), ((3, 3, 3), (3, 2, 1))),       # reference: Pallas path
    ((31, 15, 7), ((5, 4, 3), (4, 4, 2))),     # reference: Pallas path
    ((3, 3, 3, 3), ((2, 2, 2, 2), (2, 1, 2, 1))),  # reference: jnp path
    ((4095,), ((12,), (11,))),                 # reference: jnp path, 1-D
    ((31,), ((5,), (3,))),                     # reference: Pallas path, 1-D
])
def test_hierarchize_batched_equals_reference_auto(dtype, shape, levels):
    """The port follows the reference's per-shape axis order, so it equals
    the reference's ``method="auto"`` bitwise."""
    x = _stack(np.random.default_rng(4), levels, shape, dtype)
    want = rh.hierarchize_batched(jnp.asarray(x), levels)
    _bitwise(th.hierarchize_batched(torch.from_numpy(x), levels), want)


@pytest.mark.parametrize("shape,levels", [
    ((15, 15), ((4, 4), (4, 4))),
    ((7, 7, 7), ((3, 3, 3), (3, 3, 3))),
])
def test_reference_methods_differ_by_axis_order(shape, levels):
    """Reference fault (ROADMAP Queue C): its docstrings call the Pallas
    and jnp paths bitwise equal, but they apply the axes in different
    orders and differ in the last bit.  The jnp path equals the port's
    passes in order 0..d-1; the Pallas path the order 1..d-1, 0."""
    rng = np.random.default_rng(0)
    x = np.zeros((2,) + shape)
    x[:] = rng.standard_normal((2,) + shape)
    pallas = np.asarray(rh.hierarchize_batched(jnp.asarray(x), levels,
                                               method="pallas"))
    jnp_ = np.asarray(rh.hierarchize_batched_jnp(jnp.asarray(x), levels))
    assert (pallas != jnp_).any()
    np.testing.assert_allclose(pallas, jnp_, rtol=0, atol=1e-14)
    xt = torch.from_numpy(x)
    d = len(shape)
    _bitwise(th.forward_passes(xt, levels, tuple(range(d))), jnp_)
    _bitwise(th.forward_passes(xt, levels, tuple(range(1, d)) + (0,)),
             pallas)


def test_cpu_path_launches_no_kernel():
    levels = ((3, 3, 3), (3, 2, 1))
    x = torch.from_numpy(_stack(np.random.default_rng(5), levels, (7, 7, 7)))
    with th.count_launches() as n:
        th.dehierarchize_batched(th.hierarchize_batched(x, levels), levels)
    assert n == {"hier_tail_batched": 0, "hier_axis0_batched": 0,
                 "hier_axis0_scatter_batched": 0, "dehier_tail_batched": 0,
                 "dehier_axis0_batched": 0, "hier_pole": 0,
                 "dehier_pole": 0, "apply_axis_matmul": 0,
                 "hier_fused_tail": 0, "hier_forward_grouped": 0,
                 "hier_scatter_grouped": 0, "assemble_grouped": 0,
                 "owner_fold": 0}


def test_non_cuda_accelerator_tensor_raises():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    any other device is refused, never computed by the plain version."""
    x = torch.zeros((1, 7, 7), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        th.hier_tail_batched(x, ((3, 3),))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        th.hier_axis0_batched(x, (3,))


def test_scatter_rejects_bad_operands():
    x = torch.zeros((1, 7, 1), dtype=torch.float64)
    idx = torch.zeros((1, 7, 1), dtype=torch.int32)
    cs = torch.ones(1, dtype=torch.float64)
    with pytest.raises(TypeError):
        th.hier_axis0_scatter_batched(x, (3,), cs, idx,
                                      torch.zeros(8, dtype=torch.float32))
    with pytest.raises(ValueError, match="int32"):
        th.hier_axis0_scatter_batched(x, (3,), cs, idx.long(),
                                      torch.zeros(8, dtype=torch.float64))
