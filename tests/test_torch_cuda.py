"""CUDA kernels of ``repro_torch`` against their plain PyTorch versions, on
the card.

Every test here needs a CUDA device: the ``cuda`` fixture skips (with a
reason) when there is none, which is decided at run time, never while the
module is collected.  The file imports no JAX, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX for the
reference's tests.)  Inputs are made with numpy from a seed.  The kernels
round every product and sum separately, so each comparison is bitwise.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.executor import build_plan, ct_transform_with_plan
from repro_torch.core.levels import (CombinationScheme, GeneralScheme,
                                     grid_shape)
from repro_torch.kernels import hierarchize as H
from repro_torch.launch.serve import CTSurrogate

pytestmark = pytest.mark.gpu

DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _stack(rng, levels, shape, dtype):
    """(G, *shape) stack, member g holding random data at its own level
    vector and zeros on the padding, as the executor assembles it."""
    x = np.zeros((len(levels),) + tuple(shape))
    for g, lv in enumerate(levels):
        sl = tuple(slice(0, (1 << l) - 1) for l in lv)
        x[(g,) + sl] = rng.standard_normal(grid_shape(lv))
    return torch.from_numpy(x).to(dtype)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (tells -0.0 from +0.0)."""
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    return a.dtype == b.dtype and torch.equal(a.view(bits[a.dtype]),
                                              b.view(bits[b.dtype]))


STACKS = [
    ((15, 15), ((4, 4), (3, 4), (4, 2))),
    ((7, 7, 7), ((3, 3, 3), (3, 2, 1), (2, 3, 3))),
    ((31, 7, 3), ((5, 3, 2), (4, 3, 1))),
    ((7, 3, 3, 1), ((3, 2, 2, 1), (3, 1, 2, 1))),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,levels", STACKS)
def test_tail_and_axis0_match_plain(cuda, dtype, shape, levels):
    x = _stack(np.random.default_rng(1), levels, shape, dtype)
    y = H.hier_tail_batched(x.to(cuda), levels)
    assert y.is_cuda and _same(y, H.hier_tail_batched(x, levels))
    l0 = [lv[0] for lv in levels]
    z = H.hier_axis0_batched(y, l0)
    assert _same(z, H.hier_axis0_batched(y.cpu(), l0))
    assert _same(H.hierarchize_batched(x.to(cuda), levels),
                 H.hierarchize_batched(x, levels))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,levels", STACKS)
def test_scatter_matches_plain_on_every_axis(cuda, dtype, shape, levels):
    rng = np.random.default_rng(2)
    x = _stack(rng, levels, shape, dtype)
    g, p = x.shape[0], x[0].numel()
    fine = 4 * p
    # injective per member, pad positions on the dump slot, members
    # overlapping so the member-order fold is exercised
    index = np.empty((g, p), np.int32)
    for m, lv in enumerate(levels):
        real = np.zeros(shape, bool)
        real[tuple(slice(0, (1 << l) - 1) for l in lv)] = True
        index[m] = np.where(real.ravel(), rng.permutation(fine)[:p], fine)
    index = torch.from_numpy(index)
    coeffs = torch.tensor([3.0, -3.0, 1.0][:g], dtype=dtype)
    acc = torch.from_numpy(rng.standard_normal(fine + 1)).to(dtype)
    for axis in range(len(shape)):
        lv = [l[axis] for l in levels]
        want = H.hier_axis0_scatter_batched(x, lv, coeffs, index, acc.clone(),
                                            axis=axis)
        got = H.hier_axis0_scatter_batched(x.to(cuda), lv, coeffs.to(cuda),
                                           index.to(cuda), acc.to(cuda),
                                           axis=axis)
        assert _same(got, want), axis


def test_masked_neighbours_do_not_leak(cuda):
    """An Inf/NaN in a pad slot is selected away, never multiplied in."""
    levels = ((2, 2), (3, 3))
    x = _stack(np.random.default_rng(3), levels, (7, 7), torch.float64)
    x[0, 3:, :] = float("nan")
    x[0, :, 3:] = float("inf")
    got = H.hierarchize_batched(x.to(cuda), levels)
    want = H.hierarchize_batched(x, levels)
    assert torch.isfinite(got[0, :3, :3]).all()
    # the pads themselves hold NaN/Inf, whose NaN payloads may differ
    assert _same(got[0, :3, :3], want[0, :3, :3]) and _same(got[1], want[1])


def test_wrappers_count_launches(cuda):
    levels = ((3, 3, 3), (3, 2, 1))
    x = _stack(np.random.default_rng(4), levels, (7, 7, 7),
               torch.float64).to(cuda)
    with H.count_launches() as n:
        H.hierarchize_batched(x, levels)
    assert n == {"hier_tail_batched": 2, "hier_axis0_batched": 1,
                 "hier_axis0_scatter_batched": 0}



def test_ptxas_report_survives_a_cached_build(cuda):
    """nvcc's ``-Xptxas -v`` report is kept beside each library, so a
    process that finds the libraries built still has it."""
    from repro_torch.kernels import _build
    _build.load_all()
    for name in _build.KERNELS:
        path = _build._library_path(name)
        assert path.is_file()
        assert "ptxas" in path.with_suffix(".ptxas.txt").read_text()
        assert _build.PTXAS_LOG[name] == \
            path.with_suffix(".ptxas.txt").read_text()

SCHEMES = [CombinationScheme(4, 3), CombinationScheme(3, 4),
           GeneralScheme.from_levels([(6, 5), (5, 6)], close=True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scheme", SCHEMES, ids=str)
def test_ct_transform_card_equals_cpu(cuda, dtype, scheme):
    rng = np.random.default_rng(5)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
             .to(dtype) for ell, _ in scheme.grids}
    plan = build_plan(scheme)
    want = ct_transform_with_plan(grids, plan, device="cpu")
    fused = ct_transform_with_plan(grids, plan, device=cuda)
    unfused = ct_transform_with_plan(grids, plan, fused=False, device=cuda)
    assert _same(fused, want) and _same(unfused, want)


def test_surrogate_card_matches_cpu(cuda):
    scheme = CombinationScheme(3, 4)
    rng = np.random.default_rng(6)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
             for ell, _ in scheme.grids}
    pts = rng.random((64, 3))
    card = CTSurrogate(scheme, grids, device=cuda)
    cpu = CTSurrogate(scheme, grids, device="cpu")
    assert _same(card.surplus, cpu.surplus)
    np.testing.assert_allclose(card.query(pts), cpu.query(pts), rtol=1e-12,
                               atol=1e-14)
