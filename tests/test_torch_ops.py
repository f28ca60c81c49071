"""The port's per-grid (de)hierarchization against the reference, on the CPU.

Rows 1-4 of the TPU-kernel table (``PERF.md``): 1 = ``hier_pole_pallas``,
2 = ``dehier_pole_pallas``, 3 = ``apply_axis_matmul_pallas``, 4 =
``hier_fused_tail_pallas``.  On CPU tensors the port's wrappers run their
plain PyTorch versions; the reference's Pallas kernels run in interpret
mode, as its own tests run them.  Inputs are made with numpy from a seed.

Tolerances: the pole kernels (and the ``func``/``ref``/``gather`` methods
and the BFS helpers) are bitwise.  The dense-operator rows 3 and 4 sum in
another order than the reference's dot, so they are held to the
reference's own tolerances (``tests/test_kernels_pallas.py``): f64 rtol
1e-11 / atol 1e-12, f32 rtol 2e-5 / atol 2e-5, bf16 a max abs error below
0.15 against the f64 brute force.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hierarchize import hierarchize_1d_bfs as ref_bfs_hier
from repro.core.hierarchize import to_bfs as ref_to_bfs
from repro.kernels import hierarchize as rh
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import hierarchize as tcore
from repro_torch.kernels import hierarchize as th
from repro_torch.kernels import ops as tops

DTYPES = [np.float64, np.float32]
SHAPES_ND = [(3,), (7, 7), (15, 3), (3, 7, 15), (7, 3, 3, 7)]


def _tol(dtype):
    return dict(rtol=2e-5, atol=2e-5) if dtype == np.float32 else \
        dict(rtol=1e-11, atol=1e-12)


def _bundle(level, cols, dtype, seed=0):
    n = (1 << level) - 1
    return np.random.default_rng(seed).standard_normal(
        (n, cols)).astype(dtype)


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


def _close(got: torch.Tensor, want, dtype) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))


# ---------------------------------------------------------------------------
# Rows 1 and 2: the pole kernels (bitwise)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced_op", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", [2, 3, 5, 8])
@pytest.mark.parametrize("cols", [1, 3, 128, 200])
def test_pole_plain_equals_row1(level, cols, dtype, reduced_op):
    x = _bundle(level, cols, dtype, seed=level * 100 + cols)
    want = rh.hier_pole_pallas(jnp.asarray(x), reduced_op=reduced_op,
                               interpret=True)
    _bitwise(th.hier_pole(torch.from_numpy(x), reduced_op=reduced_op), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", [2, 3, 5, 8])
@pytest.mark.parametrize("cols", [1, 3, 128, 200])
def test_dehier_pole_plain_equals_row2(level, cols, dtype):
    a = _bundle(level, cols, dtype, seed=level * 13 + cols)
    want = rh.dehier_pole_pallas(jnp.asarray(a), interpret=True)
    _bitwise(th.dehier_pole(torch.from_numpy(a)), want)


# ---------------------------------------------------------------------------
# Rows 3 and 4: the dense-operator kernels (the reference's tolerances)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", [2, 4, 7])
@pytest.mark.parametrize("cols", [1, 64, 513])
def test_axis_matmul_plain_equals_row3(level, cols, dtype, inverse):
    x = _bundle(level, cols, dtype, seed=level * 7 + cols)
    want = rh.apply_axis_matmul_pallas(jnp.asarray(x), inverse=inverse,
                                       interpret=True)
    _close(th.apply_axis_matmul(torch.from_numpy(x), inverse=inverse), want,
           dtype)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [s for s in SHAPES_ND if len(s) > 1])
def test_fused_tail_plain_equals_row4(shape, dtype, inverse):
    x = np.random.default_rng(len(shape) * 31 + shape[-1]).standard_normal(
        shape).astype(dtype)
    want = rh.hier_fused_tail_pallas(jnp.asarray(x), inverse=inverse,
                                     interpret=True)
    _close(th.hier_fused_tail(torch.from_numpy(x), inverse=inverse), want,
           dtype)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES_ND)
def test_nd_fused_equals_reference(shape, dtype, inverse):
    x = np.random.default_rng(hash(shape) % 2 ** 31).standard_normal(
        shape).astype(dtype)
    fn = "dehierarchize_nd_fused" if inverse else "hierarchize_nd_fused"
    want = getattr(rh, fn)(jnp.asarray(x), interpret=True)
    _close(getattr(th, fn)(torch.from_numpy(x)), want, dtype)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("row", ["matmul", "fused_tail"])
def test_operator_rows_bf16_sum_in_f32(row, inverse):
    """bf16 input takes the f32 operator and sums in f32: against the f64
    brute force only the input's bf16 quantization shows (< 0.15), the
    reference's own bar.  Row 3 is also held to the reference's bf16 run
    at that bar; the reference's row 4 refuses bf16 (see below)."""
    x = np.random.default_rng(4).standard_normal((63, 31)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    brute = (rref.dehierarchize_1d_bruteforce if inverse
             else rref.hierarchize_1d_bruteforce)
    if row == "matmul":
        got = th.apply_axis_matmul(xb, inverse=inverse)
        want = brute(xb.double().numpy(), axis=0)
        ref_out = rh.apply_axis_matmul_pallas(
            jnp.asarray(x, jnp.bfloat16), inverse=inverse, interpret=True)
        assert np.max(np.abs(got.double().numpy() - np.asarray(
            ref_out.astype(jnp.float64)))) < 0.15
    else:
        got = th.hier_fused_tail(xb, inverse=inverse)
        want = brute(xb.double().numpy(), axis=1)
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(got.double().numpy() - want)) < 0.15


def test_reference_fused_tail_refuses_bf16():
    """Reference fault (ROADMAP Queue C): ``hier_fused_tail_pallas`` stores
    its f32 tensordot result into the bf16 output block, which Pallas
    refuses, so row 4 has no bf16 reference run to compare with."""
    x = jnp.ones((7, 7), jnp.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        rh.hier_fused_tail_pallas(x, interpret=True)


@pytest.mark.parametrize("wrapper,kw", [
    (th.hier_pole, {}), (th.dehier_pole, {}), (th.apply_axis_matmul, {}),
    (th.apply_axis_matmul, {"inverse": True})])
def test_level1_bundle_is_the_identity(wrapper, kw):
    x = torch.from_numpy(_bundle(1, 8, np.float64))
    assert wrapper(x, **kw) is x


def test_fused_tail_without_live_tail_axes_is_the_identity():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((7, 1, 1)))
    assert th.hier_fused_tail(x) is x
    with pytest.raises(ValueError, match=">= 2 dims"):
        th.hier_fused_tail(x[:, 0, 0])


@pytest.mark.parametrize("wrapper", [th.hier_pole, th.dehier_pole,
                                     th.apply_axis_matmul,
                                     th.hier_fused_tail])
def test_wrappers_refuse_other_devices(wrapper):
    """No silent fallback: a tensor neither on the CPU nor on CUDA raises."""
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(torch.empty((7, 3), dtype=torch.float64, device="meta"))


def test_wrappers_record_their_calls():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((7, 15)))
    with th.record_calls() as calls:
        th.hierarchize_nd_fused(x)
    assert [w.__name__ for w, _ in calls] == ["hier_fused_tail",
                                              "apply_axis_matmul"]
    wrapper, args = calls[0]
    assert torch.equal(wrapper.plain(**args), wrapper(**args))


# ---------------------------------------------------------------------------
# kernels.ops: every method against the same method of the reference
# ---------------------------------------------------------------------------

OPS_SHAPES = [(15, 7), (7, 3, 15)]
BITWISE_METHODS = {"func", "ref", "gather", "pole"}


@pytest.mark.parametrize("method", ["func", "ref", "gather", "pole",
                                    "matmul", "fused", "auto"])
@pytest.mark.parametrize("shape", OPS_SHAPES)
def test_ops_hierarchize_matches_reference(shape, method):
    x = np.random.default_rng(9).standard_normal(shape)
    want = rops.hierarchize(jnp.asarray(x), method, interpret=True)
    got = tops.hierarchize(torch.from_numpy(x), method)
    if method in BITWISE_METHODS:
        _bitwise(got.contiguous(), want)
    else:
        _close(got, want, np.float64)


@pytest.mark.parametrize("method", ["func", "ref", "pole", "matmul",
                                    "fused", "auto"])
@pytest.mark.parametrize("shape", OPS_SHAPES)
def test_ops_dehierarchize_matches_reference(shape, method):
    a = np.random.default_rng(10).standard_normal(shape)
    want = rops.dehierarchize(jnp.asarray(a), method, interpret=True)
    got = tops.dehierarchize(torch.from_numpy(a), method)
    if method in BITWISE_METHODS:
        _bitwise(got.contiguous(), want)
    else:
        _close(got, want, np.float64)
    np.testing.assert_allclose(
        tops.hierarchize(got, method).numpy(), a, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("reduced_op", [True, False])
@pytest.mark.parametrize("method", ["ref", "pole"])
def test_ops_reduced_op_spelling(method, reduced_op):
    x = np.random.default_rng(11).standard_normal((31, 7)).astype(np.float32)
    want = rops.hierarchize(jnp.asarray(x), method, reduced_op=reduced_op,
                            interpret=True)
    _bitwise(tops.hierarchize(torch.from_numpy(x), method,
                              reduced_op=reduced_op).contiguous(), want)


def test_auto_takes_the_reference_methods_threshold():
    """``auto`` is ``fused`` up to 2047 points per axis and the kernel-free
    ``ref`` above, as in the reference (same ``_MATMUL_MAX_N``)."""
    assert tops._MATMUL_MAX_N == rops._MATMUL_MAX_N
    x = np.random.default_rng(12).standard_normal((4095,))
    with th.count_launches() as n:
        got = tops.hierarchize(torch.from_numpy(x))
    _bitwise(got, rops.hierarchize(jnp.asarray(x), interpret=True))
    _bitwise(got, rops.hierarchize(jnp.asarray(x), "ref"))
    with th.record_calls() as calls:
        tops.hierarchize(torch.from_numpy(np.ones((2047, 3))))
    assert {w.__name__ for w, _ in calls} == {"hier_fused_tail",
                                              "apply_axis_matmul"}
    assert not any(n.values())       # CPU tensors launch no kernel


def test_unknown_methods_raise():
    x = torch.zeros((3, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown method"):
        tops.hierarchize(x, "nope")
    with pytest.raises(ValueError, match="unknown method"):
        tops.dehierarchize(x, "gather")   # the reference has no inverse one


# ---------------------------------------------------------------------------
# core.hierarchize: the BFS layout helpers (bitwise)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [1, 3, 6])
def test_bfs_permutation_and_layout_match_reference(level):
    from repro_torch.kernels import ref as tref
    np.testing.assert_array_equal(tref.bfs_permutation(level),
                                  rref.bfs_permutation(level))
    x = np.random.default_rng(level).standard_normal(((1 << level) - 1, 5))
    xb = tcore.to_bfs(torch.from_numpy(x), axis=0)
    _bitwise(xb, ref_to_bfs(jnp.asarray(x), axis=0))
    _bitwise(tcore.from_bfs(xb, axis=0), x)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, -1])
def test_hierarchize_1d_bfs_matches_reference(axis, reverse):
    x = np.random.default_rng(13).standard_normal((31, 15))
    xb = np.asarray(ref_to_bfs(jnp.asarray(x), axis=axis))
    want = ref_bfs_hier(jnp.asarray(xb), axis=axis,
                                    reverse=reverse)
    got = tcore.hierarchize_1d_bfs(torch.from_numpy(xb), axis=axis,
                                   reverse=reverse)
    _bitwise(got.contiguous(), want)
    nodal = tcore.from_bfs(got, axis=axis)
    np.testing.assert_allclose(
        nodal.numpy(), rref.hierarchize_1d_bruteforce(x, axis=axis),
        rtol=1e-12, atol=1e-14)


def test_core_reexports_the_dispatch():
    assert tcore.hierarchize is tops.hierarchize
    assert tcore.dehierarchize is tops.dehierarchize
