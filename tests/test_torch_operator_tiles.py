"""The slab table of rows 3 and 4 (``axis_operator.cu``, ``fused_tail.cu``),
on the CPU.

On the card ``apply_axis_matmul`` and ``hier_fused_tail`` multiply only
the operator tiles that hold a nonzero: ``_operator_slabs`` lists them for
each row tile and ``_operator_tiles`` packs them, both on the host.  For
every level 1-12, for H and H^-1 of the reference (``repro.kernels.ref``)
and for the kernels' tile (``OPERATOR_TILE``): the table covers every
nonzero and lists no zero tile, the packed tiles put back together are the
operator exactly, and the product restricted to the listed slabs equals
the full tensordot bitwise in f64 on seeded finite input.  Row 4's host
side: its passes (``_tail_passes``) cover each live tail axis once, and
the swapped form of its last-axis pass, walked over the same slab list,
is ``X @ H.T``.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import hierarchize as H

LEVELS = range(1, 13)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _drop_cached_operators():
    """Level 12's dense operators are 134 MB each: free them after."""
    yield
    for cached in (jref.operator_matrix, jref.dehier_operator_matrix,
                   H.ref.operator_matrix, H.ref.dehier_operator_matrix,
                   H._operator, H._operator_tiles):
        cached.cache_clear()


def _reference(level, inverse):
    return (jref.dehier_operator_matrix(level) if inverse
            else jref.operator_matrix(level))


def _listed(shape, offsets, slabs):
    """Boolean mask of the entries inside the listed slabs."""
    tm, tk = H.OPERATOR_TILE
    mask = np.zeros(shape, dtype=bool)
    for r in range(len(offsets) - 1):
        for s in slabs[offsets[r]:offsets[r + 1]]:
            mask[r * tm:(r + 1) * tm, s * tk:(s + 1) * tk] = True
    return mask


@pytest.mark.parametrize("inverse", [False, True], ids=["H", "H_inv"])
@pytest.mark.parametrize("level", LEVELS)
def test_slab_table_covers_the_operator(level, inverse):
    h = _reference(level, inverse)
    n = h.shape[0]
    tm, tk = H.OPERATOR_TILE
    offsets, slabs = H._operator_slabs(h)
    assert offsets.dtype == slabs.dtype == np.int32
    assert len(offsets) == -(-n // tm) + 1 and offsets[0] == 0
    assert offsets[-1] == len(slabs) and np.all(np.diff(offsets) >= 1)
    for r in range(len(offsets) - 1):          # ascending, in range
        row = slabs[offsets[r]:offsets[r + 1]]
        assert np.all(np.diff(row) > 0)
        assert 0 <= row[0] and row[-1] < -(-n // tk)
        for s in row:                          # no zero tile is listed
            assert np.any(h[r * tm:(r + 1) * tm, s * tk:(s + 1) * tk])
    mask = _listed(h.shape, offsets, slabs)
    assert np.all(mask[h != 0])                # every nonzero is covered

    x = torch.from_numpy(np.random.default_rng(level).standard_normal((n, 9)))
    full = torch.tensordot(torch.from_numpy(h), x, dims=([1], [0]))
    restricted = torch.tensordot(torch.from_numpy(np.where(mask, h, 0.0)), x,
                                 dims=([1], [0]))
    assert torch.equal(full.view(torch.int64), restricted.view(torch.int64))

    tiles, offs, sl = H._operator_tiles(level, inverse, torch.float64, CPU)
    assert np.array_equal(offs.numpy(), offsets)
    assert np.array_equal(sl.numpy(), slabs)
    assert tiles.shape == (len(slabs), tm, tk) and tiles.is_contiguous()
    rows = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    back = np.zeros((-(-n // tm) * tm, -(-n // tk) * tk))
    for t, (r, s) in enumerate(zip(rows, slabs)):
        back[r * tm:(r + 1) * tm, s * tk:(s + 1) * tk] = tiles[t].numpy()
    assert np.array_equal(back[:n, :n], h) and not back[n:].any()
    assert not back[:, n:].any()


def test_level9_walks_a_fifth_of_the_slabs():
    """At n = 511 a row tile walks 44 / 8 = 5.5 (H) or 49 / 8 = 6.1 (H^-1)
    of the 32 slabs: the flops the kernel's header counts."""
    counts = [H._operator_slabs(_reference(9, inv))[0][-1]
              for inv in (False, True)]
    assert counts == [44, 49]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_tiles_take_the_accumulator_type(dtype):
    """f32 and bf16 bundles take f32 tiles of the same slab list."""
    tiles, offsets, slabs = H._operator_tiles(7, True, H._op_dtype(dtype),
                                              CPU)
    want = H._operator_tiles(7, True, torch.float64, CPU)
    assert tiles.dtype == torch.float32
    assert torch.equal(tiles.double(), want[0])     # dyadic: exact in f32
    assert torch.equal(offsets, want[1]) and torch.equal(slabs, want[2])


# tests/test_torch_cuda.py's TAIL_SHAPES and LARGE_TAILS, the fused tail's
# card cases
TAIL_SHAPES = [(7, 7), (15, 3), (3, 7, 15), (7, 3, 3, 7), (3, 1, 7),
               (31, 63, 127), (3,) * 10, (31, 63, 511), (7, 511, 3)]


@pytest.mark.parametrize("shape", TAIL_SHAPES, ids=str)
def test_tail_passes_cover_each_live_axis_once(shape):
    """``hier_fused_tail`` launches one pass per tail axis of extent > 1,
    in order, each viewing the whole grid as (outer, n, inner); inner = 1
    (the swapped pass) only where every later axis has extent 1.  Applying
    the passes to those views is the plain version."""
    passes = H._tail_passes(shape)
    assert [a for a, *_ in passes] == [k for k in range(1, len(shape))
                                       if shape[k] > 1]
    for axis, outer, n, inner in passes:
        assert (outer, n, inner) == (int(np.prod(shape[:axis])), shape[axis],
                                     int(np.prod(shape[axis + 1:])))
        assert (inner == 1) == all(e == 1 for e in shape[axis + 1:])
    x = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(
        shape))
    y = x
    for axis, outer, n, inner in passes:
        h = torch.from_numpy(_reference(H.ref._level_of_length(n), False))
        y = torch.einsum("ij,ojk->oik", h, y.reshape(outer, n, inner))
    want = H.hier_fused_tail.plain(x)
    np.testing.assert_allclose(y.reshape(shape).numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("inverse", [False, True], ids=["H", "H_inv"])
@pytest.mark.parametrize("level", [2, 5, 9])
def test_swapped_walk_over_the_slab_list_is_x_times_h_transposed(level,
                                                                 inverse):
    """The last-axis pass, C = X . H^T with X (rows, n) row-major: C's
    column tile r is H's row tile r, summed over that tile's listed slabs
    of X's columns, each times the packed tile transposed."""
    h = _reference(level, inverse)
    n = h.shape[0]
    tm, tk = H.OPERATOR_TILE
    tiles, offsets, slabs = H._operator_tiles(level, inverse, torch.float64,
                                              CPU)
    rows = 70                                  # past one 64-row tile
    x = np.random.default_rng(level).standard_normal((rows, n))
    xp = np.zeros((rows, -(-n // tk) * tk))
    xp[:, :n] = x                              # zero past N, as loaded
    c = np.zeros((rows, -(-n // tm) * tm))
    for r in range(len(offsets) - 1):
        for t in range(offsets[r], offsets[r + 1]):
            s = slabs[t]
            c[:, r * tm:(r + 1) * tm] += (xp[:, s * tk:(s + 1) * tk]
                                          @ tiles[t].numpy().T)
    np.testing.assert_allclose(c[:, :n], x @ h.T, rtol=1e-12, atol=1e-12)
