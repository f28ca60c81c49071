"""The port's gradient codecs (``repro_torch.optim.compression``) on the
CPU: the scenarios of the reference's ``tests/test_compression.py``, and
the codecs held to ``repro.optim.compression`` on the same numpy inputs.

``hier_encode``/``hier_decode`` run ``kernels.hierarchize.hier_pole``/
``dehier_pole`` (rows 1 and 2; their plain versions here, the level loop
of ``kernels.ref``), which round each product and sum as the reference's
level loop does: the surpluses and the decoded gradients are bitwise the
reference's, and so are ``int8`` and ``topk`` and the error-feedback
state of every codec.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from proptest import cases, integers, seeds

from repro.optim import compression as RC
from repro_torch.kernels import hierarchize as H
from repro_torch.optim.compression import (compress_with_feedback,
                                           hier_decode, hier_encode,
                                           init_error_feedback, int8_decode,
                                           int8_encode, topk_mask)


def _bitwise(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,level", cases(
    lambda r: (seeds(r), integers(r, 3, 8)), n=15))
def test_hier_codec_exactly_invertible(seed, level):
    g = np.random.default_rng(seed).standard_normal((37, 11)).astype(
        np.float32)
    alpha = hier_encode(torch.from_numpy(g), level)
    back = hier_decode(alpha, g.shape, torch.float32)
    np.testing.assert_allclose(back.numpy(), g, rtol=1e-4, atol=1e-5)
    ref_alpha = RC.hier_encode(jnp.asarray(g), level)
    _bitwise(alpha, ref_alpha)
    _bitwise(back, RC.hier_decode(ref_alpha, g.shape, jnp.float32))


def test_hier_codec_runs_rows_1_and_2():
    """Encode is one ``hier_pole`` call along the last axis of the
    contiguous (cols, 2**level - 1) buffer, the transpose of the (2**level
    - 1, cols) bundle (its axis passed in place), decode one
    ``dehier_pole`` call along the same axis."""
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        1000).astype(np.float32))
    with H.record_calls() as calls:
        alpha = hier_encode(g, 6)
        back = hier_decode(alpha, g.shape, torch.float32)
    assert [c[0] for c in calls] == [H.hier_pole, H.dehier_pole]
    assert tuple(alpha.shape) == (63, 16)
    for _, args in calls:
        x = args.get("x", args.get("a"))
        assert tuple(x.shape) == (16, 63) and x.is_contiguous()
        assert args["axis"] == 1
    np.testing.assert_allclose(back.numpy(), g.numpy(), rtol=1e-4, atol=1e-5)


def test_hier_codec_compresses_smooth_signals():
    n = 1023
    t = np.linspace(0, 1, n, dtype=np.float32)
    smooth = np.sin(2 * np.pi * t) + 0.3 * np.cos(6 * np.pi * t)
    noise = np.random.default_rng(0).standard_normal(n).astype(np.float32)

    def rel_err(sig):
        alpha = hier_encode(torch.from_numpy(sig), level=10)
        back = hier_decode(alpha * topk_mask(alpha, 0.1), sig.shape,
                           torch.float32).numpy()
        return np.linalg.norm(back - sig) / np.linalg.norm(sig)

    assert rel_err(smooth) < 0.01
    assert rel_err(noise) > 0.5


def test_int8_roundtrip_bounded():
    g = np.random.default_rng(1).standard_normal((64,)).astype(np.float32)
    q, s = int8_encode(torch.from_numpy(g))
    back = int8_decode(q, s, torch.float32).numpy()
    assert q.dtype == torch.int8
    assert np.max(np.abs(back - g)) <= float(s) * 0.5 + 1e-7
    rq, rs = RC.int8_encode(jnp.asarray(g))
    _bitwise(q, rq)
    _bitwise(s, rs)


def test_topk_mask_keeps_largest():
    x = np.asarray([0.1, -5.0, 0.2, 3.0], np.float32)
    m = topk_mask(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_array_equal(m, [0, 1, 0, 1])
    g = np.random.default_rng(9).standard_normal((13, 17)).astype(np.float32)
    _bitwise(topk_mask(torch.from_numpy(g), 0.2),
             RC.topk_mask(jnp.asarray(g), 0.2))


@pytest.mark.parametrize("codec", ["hier", "topk", "int8"])
def test_error_feedback_preserves_sum(codec):
    w = np.random.default_rng(2).standard_normal((31, 7)).astype(np.float32)
    g = {"w": torch.from_numpy(w)}
    approx, ef2 = compress_with_feedback(g, init_error_feedback(g),
                                         codec=codec, frac=0.25)
    total_out = approx["w"].numpy() + ef2.residual["w"].numpy()
    np.testing.assert_allclose(total_out, w, rtol=1e-4, atol=1e-5)
    rg = {"w": jnp.asarray(w)}
    rapprox, ref2 = RC.compress_with_feedback(
        rg, RC.init_error_feedback(rg), codec=codec, frac=0.25)
    _bitwise(approx["w"], rapprox["w"])
    _bitwise(ef2.residual["w"], ref2.residual["w"])


def test_error_feedback_unbiased_over_steps():
    w = np.random.default_rng(3).standard_normal((127,)).astype(np.float32)
    g = {"w": torch.from_numpy(w)}
    ef = init_error_feedback(g)
    acc = np.zeros(127, np.float32)
    steps = 30
    for _ in range(steps):
        approx, ef = compress_with_feedback(g, ef, codec="topk", frac=0.1)
        acc += approx["w"].numpy()
    mean_err = np.linalg.norm(acc / steps - w) / np.linalg.norm(w)
    assert mean_err < 0.2, mean_err


def test_hier_codec_linearity_for_allreduce():
    rng = np.random.default_rng(4)
    gs = [rng.standard_normal(255).astype(np.float32) for _ in range(4)]
    enc_sum = sum(hier_encode(torch.from_numpy(g), 8) for g in gs)
    back = hier_decode(enc_sum, (255,), torch.float32).numpy()
    np.testing.assert_allclose(back, sum(gs), rtol=1e-3, atol=1e-4)
