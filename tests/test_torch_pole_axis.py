"""Rows 1 and 2 (the pole kernels) along every axis of a grid, in place, on
the CPU.

``kernels.ops.hierarchize(x, "pole")`` and ``dehierarchize`` hand each axis
of the grid to ``hier_pole`` / ``dehier_pole`` with ``axis=k`` (on the card
one launch over the grid's (outer, N, inner) view, no copy); on the CPU the
wrappers run their plain versions along the same axis.  Held bitwise
against the reference's ``repro.kernels.ops`` ``"pole"`` method, whose
Pallas kernels run in interpret mode and move each axis to the front: the
reference is called once per case, at levels up to 5, in f64 and f32, with
``reduced_op`` true and false, on every axis including the last, a level-1
axis and a strided input.  Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import hierarchize as th
from repro_torch.kernels import ops as tops

#: Levels up to 5 on every axis; (7, 1, 15) has a level-1 axis.


def _grid(shape, dtype, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


F64, F32 = np.float64, np.float32
#: (shape, dtype, reduced_op): every shape, both types, both spellings of
#: the update (``reduced_op=False`` is the paper's two-multiply ablation).
#: Each reference call costs about a second in interpret mode, so the
#: product is sampled.
FORWARD = [((15, 7, 31), F64, True), ((15, 7, 31), F32, True),
           ((15, 7, 31), F64, False), ((7, 3, 15), F32, False),
           ((7, 3, 15), F64, True), ((31,), F32, True), ((7, 1, 15), F64, True)]
INVERSE = [((15, 7, 31), F64), ((7, 3, 15), F32), ((31,), F64),
           ((7, 1, 15), F32)]


@pytest.mark.parametrize("shape,dtype,reduced_op", FORWARD, ids=str)
def test_pole_hierarchize_in_place_equals_reference(shape, dtype, reduced_op):
    x = _grid(shape, dtype, seed=len(shape) * 10 + shape[-1])
    want = rops.hierarchize(jnp.asarray(x), "pole", interpret=True,
                            reduced_op=reduced_op)
    _bitwise(tops.hierarchize(torch.from_numpy(x), "pole",
                              reduced_op=reduced_op), want)


@pytest.mark.parametrize("shape,dtype", INVERSE, ids=str)
def test_pole_dehierarchize_in_place_equals_reference(shape, dtype):
    a = _grid(shape, dtype, seed=len(shape) * 7 + shape[0])
    want = rops.dehierarchize(jnp.asarray(a), "pole", interpret=True)
    _bitwise(tops.dehierarchize(torch.from_numpy(a), "pole"), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_pole_takes_a_strided_grid(inverse):
    """A transposed (strided) grid gives the reference's bits on the same
    values; on the card the wrappers make it contiguous first."""
    x = _grid((31, 15, 7), np.float64, seed=3)
    strided = torch.from_numpy(x).permute(1, 2, 0)
    assert not strided.is_contiguous()
    values = jnp.asarray(np.ascontiguousarray(x.transpose(1, 2, 0)))
    if inverse:
        want = rops.dehierarchize(values, "pole", interpret=True)
        got = tops.dehierarchize(strided, "pole")
    else:
        want = rops.hierarchize(values, "pole", interpret=True)
        got = tops.hierarchize(strided, "pole")
    _bitwise(got.contiguous(), want)


def test_pole_passes_each_axis_in_place():
    """``ops`` hands every axis of the grid itself to the wrappers, in its
    own shape (no axis moved to the front, nothing flattened), one call an
    axis and direction, and each recorded call replays to the same bits."""
    x = torch.from_numpy(_grid((7, 3, 15), np.float32, seed=5))
    with th.record_calls() as calls:
        back = tops.dehierarchize(tops.hierarchize(x, "pole"), "pole")
    assert [(w, args["axis"]) for w, args in calls] == \
        [(th.hier_pole, k) for k in range(3)] + \
        [(th.dehier_pole, k) for k in range(3)]
    assert all(tuple((args.get("x", args.get("a"))).shape) == (7, 3, 15)
               for _, args in calls)
    for wrapper, args in calls:
        _bitwise(wrapper(**args).contiguous(),
                 wrapper.plain(**args).contiguous().numpy())
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=0, atol=1e-5)


def test_pole_axis_arguments():
    """A negative axis counts from the end; one past the rank raises; the
    (N, B) bundle call is axis 0."""
    x = torch.from_numpy(_grid((7, 15), np.float64, seed=6))
    assert torch.equal(th.hier_pole(x, axis=-1), th.hier_pole(x, axis=1))
    assert torch.equal(th.dehier_pole(x), th.dehier_pole(x, axis=0))
    for wrapper in (th.hier_pole, th.dehier_pole):
        with pytest.raises(ValueError, match="out of range"):
            wrapper(x, axis=2)
