"""The port's attention (``repro_torch.kernels.flash_attention`` and
``repro_torch.models.attention``) against the reference's, on the CPU.

On CPU tensors the flash wrapper runs its plain version; the reference's
Pallas kernel runs in interpret mode.  Inputs are made with numpy from a
seed and handed to both.  Bars: the reference kernel's own, 2e-5 in f32
and 2e-2 in bf16 (``tests/test_flash_attention.py``); the plain attentions
in f32 at 2e-5 (``attention_chunked``: the reference scans keys in chunks,
the port takes one softmax, so the sums run in other orders) and 1e-5
(``attention_naive``, ``decode_attention``: the same formula).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import flash_attention as rflash
from repro.models import attention as rattn
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import hierarchize as H
from repro_torch.models import attention as tattn

# The cases of tests/test_flash_attention.py, plus head_dim 128 and 20 (the
# largest the kernel takes, and smollm's smoke width).
CASES = [
    # b, sq, skv, h, kv, hd, causal
    (2, 16, 16, 4, 2, 8, True),
    (1, 64, 64, 2, 2, 16, True),
    (2, 8, 24, 4, 4, 8, False),
    (1, 33, 33, 2, 1, 8, True),      # unaligned lengths (padding path)
    (1, 1, 40, 4, 2, 8, False),      # decode-like: one query row
    (1, 128, 128, 8, 8, 32, True),   # MHA, bigger blocks
    (1, 24, 24, 3, 1, 20, True),     # smollm smoke: 3 heads over 1, hd 20
    (1, 40, 40, 2, 1, 128, True),    # head_dim 128
]
TOL = {np.float32: 2e-5, "bf16": 2e-2}


def _inputs(case, seed=0):
    b, sq, skv, h, kv, hd, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32))


def _torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_flash_matches_reference_kernel(case, dtype):
    causal = case[-1]
    q, k, v = _inputs(case)
    want = rflash.flash_attention(_jax(q, dtype), _jax(k, dtype),
                                  _jax(v, dtype), causal=causal,
                                  interpret=True)
    got = tflash.flash_attention(_torch(q, dtype), _torch(k, dtype),
                                 _torch(v, dtype), causal=causal)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bhsd_matches_reference_kernel(causal):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((6, 21, 16)).astype(np.float32)
    k = rng.standard_normal((6, 29, 16)).astype(np.float32)
    v = rng.standard_normal((6, 29, 16)).astype(np.float32)
    want = rflash.flash_attention_bhsd(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       block_q=8, block_k=8, interpret=True)
    got = tflash.flash_attention_bhsd(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("block_q,block_k", [(8, 8), (16, 32), (64, 16)])
def test_block_shape_invariance(block_q, block_k):
    """The reference's blocks tile its grid; the port accepts them and its
    result does not depend on them."""
    case = (1, 48, 48, 4, 2, 8, True)
    q, k, v = _inputs(case, seed=2)
    want = rflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  block_q=block_q, block_k=block_k,
                                  interpret=True)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True,
                                 block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_padded_keys_contribute_nothing():
    """Non-causal with keys shorter than the reference's key block: the
    reference pads the keys to its block and masks them with -1e30."""
    case = (1, 5, 5, 2, 2, 8, False)
    q, k, v = _inputs(case, seed=3)
    want = rflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, block_q=8,
                                  block_k=8, interpret=True)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=False)
    naive = rattn.attention_naive(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False)
    for ref in (want, naive):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


def test_cpu_path_launches_nothing_and_is_recorded():
    q, k, v = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    before = tflash.flash_attention.launches
    with H.record_calls() as calls:
        out = tflash.flash_attention(q, k, v, causal=True)
    assert tflash.flash_attention.launches == before
    assert [c[0] for c in calls] == [tflash.flash_attention]
    wrapper, args = calls[0]
    assert torch.equal(wrapper.plain(**args), out)


@pytest.mark.parametrize("bad", ["offset", "heads", "dtype", "rank"])
def test_flash_refuses_what_it_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    kwargs = {}
    if bad == "offset":
        kwargs["q_offset"] = -1
        err = ValueError
    elif bad == "heads":
        k, v = k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(
            -1, -1, 3, -1)          # 4 query heads over 3 KV heads
        err = ValueError
    elif bad == "dtype":
        v = v.double()
        err = TypeError
    else:
        q = q[0]
        err = ValueError
    with pytest.raises(err):
        tflash.flash_attention(q, k, v, **kwargs)


# ---------------------------------------------------------------------------
# models.attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 16)])
def test_attention_naive_matches_reference(causal, q_offset):
    case = (2, 8, 24, 4, 2, 16, causal)
    q, k, v = _inputs(case, seed=4)
    want = rattn.attention_naive(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 q_offset=q_offset)
    got = tattn.attention_naive(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case,q_offset,kv_chunk", [
    ((2, 16, 16, 4, 2, 8, True), 0, 1024),
    ((1, 33, 33, 2, 1, 8, True), 0, 8),        # several chunks, padded
    ((2, 8, 24, 4, 4, 8, False), 0, 16),
    ((2, 8, 24, 4, 2, 16, True), 16, 8),       # a continued prefill
    ((1, 24, 24, 3, 1, 20, True), 0, 128),
])
def test_attention_chunked_matches_reference(case, q_offset, kv_chunk):
    q, k, v = _inputs(case, seed=5)
    causal = case[-1]
    want = rattn.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   q_offset=q_offset, kv_chunk=kv_chunk)
    got = tattn.attention_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  q_offset=q_offset, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_bf16_chunked_follows_the_flash_kernel():
    """The reference's ``attention_chunked`` rounds its scores and
    probabilities to bf16; its flash kernel, and the port, keep them in
    f32.  The port in bf16 is held to the reference's flash kernel at its
    bf16 bar, and both stand closer to the f32 result than the reference's
    bf16 ``attention_chunked`` does."""
    case = (2, 64, 64, 4, 2, 32, True)
    q, k, v = _inputs(case, seed=6)
    exact = rattn.attention_naive(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True)
    exact = np.asarray(exact)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref_flash = np.asarray(rflash.flash_attention(qb, kb, vb, causal=True,
                                                  interpret=True), np.float32)
    ref_chunked = np.asarray(rattn.attention_chunked(qb, kb, vb, causal=True),
                             np.float32)
    got = tattn.attention_chunked(*(torch.from_numpy(a).to(torch.bfloat16)
                                    for a in (q, k, v))).float().numpy()
    np.testing.assert_allclose(got, ref_flash, rtol=2e-2, atol=2e-2)
    err = lambda a: float(np.abs(a - exact).max())
    assert err(got) < err(ref_chunked) and err(ref_flash) < err(ref_chunked)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_reference(per_row):
    rng = np.random.default_rng(7)
    b, s_max, h, kv, hd = 3, 12, 4, 2, 8
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    ck = rng.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    cv = rng.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    lens = np.array([3, 12, 7], np.int32) if per_row else 9
    want = rattn.decode_attention(jnp.asarray(q), rattn.KVCache(
        jnp.asarray(ck), jnp.asarray(cv)), jnp.asarray(lens))
    got = tattn.decode_attention(torch.from_numpy(q), tattn.KVCache(
        torch.from_numpy(ck), torch.from_numpy(cv)),
        torch.as_tensor(lens) if per_row else lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cache_update_matches_reference_in_place():
    rng = np.random.default_rng(8)
    ck, cv = (rng.standard_normal((2, 6, 2, 4)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((2, 2, 2, 4)).astype(np.float32)
              for _ in range(2))
    want = rattn.cache_update(rattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
                              jnp.asarray(kn), jnp.asarray(vn), 3)
    cache = tattn.KVCache(torch.from_numpy(ck.copy()),
                          torch.from_numpy(cv.copy()))
    got = tattn.cache_update(cache, torch.from_numpy(kn),
                             torch.from_numpy(vn), 3)
    assert got.k is cache.k and got.v is cache.v
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    with pytest.raises(IndexError):
        tattn.cache_update(cache, torch.from_numpy(kn), torch.from_numpy(vn),
                           5)
