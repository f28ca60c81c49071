"""Row 10's gradient on the CPU: the plain versions of the port's
``flash_attention_lse`` (the forward with its log-sum-exp) and
``flash_attention_bwd`` (the backward), and the autograd Function
``FlashAttention`` that joins them, against the reference.

Inputs are made with numpy from a seed.  ``flash_attention_bwd_ref`` is
held to ``torch.autograd`` through ``flash_attention_ref`` and to
``jax.vjp`` of the reference's ``attention_chunked`` (chunked over 8 keys,
so its online softmax spans several chunks) in f32, at rtol 1e-5 / atol
1e-6: both sides compute in f32 and sum in other orders.  Cases: causal
and full, GQA groups 1 and 3, ragged lengths (not multiples of 8 or 64),
``q_offset`` > 0.  The log-sum-exp is held to ``torch.logsumexp`` of the
masked scaled scores in f64 (rtol 1e-6), and ``torch.autograd.gradcheck``
checks the Function in f64 (the plain versions compute in f64 for f64
inputs).  The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The bf16 kernels read their operands through TMA, which needs aligned
rows; ``_tma_operands``, the helper the wrapper runs before the launch,
is checked here on the CPU: its tensors are 16-byte aligned with row
strides of whole 16-byte units, the channels it pads (to a multiple of 8)
and the lse values past Sq are zero, and the plain backward on the
prepared operands, with the true head_dim's scale and sliced back, is the
plain backward on the originals in f32 (rtol 1e-6, atol 1e-7: the padded
channels change how einsum blocks its sums, a few f32 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_chunked as ref_attention
from repro_torch.kernels import flash_attention as F
from repro_torch.models import attention as A

TOL = dict(rtol=1e-5, atol=1e-6)

# b, sq, skv, h, kv, hd, causal, q_offset
CASES = [(2, 16, 16, 4, 4, 8, True, 0), (1, 37, 37, 6, 2, 16, True, 0),
         (2, 13, 29, 3, 1, 20, False, 0), (1, 21, 50, 6, 2, 8, True, 29),
         (2, 9, 71, 4, 4, 12, False, 5), (1, 70, 70, 3, 3, 64, True, 0)]


def _inputs(case, seed=0):
    b, sq, skv, h, kv, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd), (b, sq, h, hd))]


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp of the reference's attention_chunked, every case, once,
    jitted whole (one compile a case, not one dispatch an op)."""
    out = {}
    for case in CASES:
        causal, q_offset = case[6], case[7]

        def forward_and_vjp(q, k, v, do):
            o, vjp = jax.vjp(lambda q, k, v: ref_attention(
                q, k, v, causal=causal, q_offset=q_offset, kv_chunk=8),
                q, k, v)
            return (o, *vjp(do))
        out[case] = tuple(np.asarray(a) for a in jax.jit(forward_and_vjp)(
            *(jnp.asarray(a) for a in _inputs(case))))
    return out


def _port_grads(case):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    causal, q_offset = case[6], case[7]
    o, lse, _ = F.flash_attention_lse_ref(q, k, v, causal=causal,
                                          q_offset=q_offset)
    return o, F.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                        q_offset=q_offset)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_jax_grad_of_the_reference(case, jax_grads):
    o, grads = _port_grads(case)
    want_o, *want = jax_grads[case]
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    for got, w in zip(grads, want):
        assert got.dtype == torch.float32 and got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, **TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_autograd_through_the_plain_forward(case):
    q, k, v, do = (torch.from_numpy(a).requires_grad_() for a in
                   _inputs(case))
    out = F.flash_attention_ref(q, k, v, causal=case[6], q_offset=case[7])
    want = torch.autograd.grad(out, (q, k, v), do.detach())
    _, got = _port_grads(case)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_lse_is_the_masked_logsumexp(case):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(case))
    b, sq, skv, h, kv, hd, causal, q_offset = case
    o, lse, lo = F.flash_attention_lse_ref(q, k, v, causal=causal,
                                           q_offset=q_offset)
    assert lo is None                   # f32: the output is exact
    assert torch.equal(o, F.flash_attention_ref(q, k, v, causal=causal,
                                                q_offset=q_offset))
    kk = k.double().repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) * hd ** -0.5
    if causal:
        mask = (torch.arange(sq)[:, None] + q_offset
                < torch.arange(skv)[None, :])
        s = s.masked_fill(mask, float("-inf"))
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    np.testing.assert_allclose(lse.double().numpy(),
                               torch.logsumexp(s, -1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 3),
                                             (False, 2)])
def test_gradcheck_the_function_in_f64(causal, q_offset):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 4, 4, 3), (1, 6, 2, 3), (1, 6, 2, 3)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: F.FlashAttention.apply(q, k, v, causal, q_offset),
        (q, k, v))


def test_flash_attention_goes_through_the_function_only_for_grads():
    case = CASES[1]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    plain = F.flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        assert F.flash_attention(qg, kg, vg).grad_fn is None
    out = F.flash_attention(qg, kg, vg)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)          # the same bits
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    _, want = _port_grads((*case[:6], True, 0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_attention_chunked_is_differentiable():
    """The model's prefill attention takes row 10's gradient."""
    case = CASES[3]
    q, k, v, do = (torch.from_numpy(a).requires_grad_() for a in
                   _inputs(case))
    out = A.attention_chunked(q, k, v, causal=True, q_offset=case[7])
    got = torch.autograd.grad(out, (q, k, v), do.detach())
    _, want = _port_grads(case)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bwd_refuses_mismatched_shapes():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    o, lse, _ = F.flash_attention_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        F.flash_attention_bwd(q, k, v, o, lse[:, :, 1:], do)
    with pytest.raises(ValueError, match="lse"):
        F.flash_attention_bwd(q, k, v, o[:, 1:], lse, do)


# b, sq, skv, h, kv, hd, causal, q_offset: padded channels (hd 20, 12, 7),
# lse lines padded (sq 13, 9, 7), and hd 16 / sq 12 taken as they are.
PREP_CASES = [(1, 13, 29, 3, 3, 20, True, 5), (2, 9, 17, 4, 2, 12, False, 0),
              (1, 12, 12, 2, 1, 16, True, 0), (2, 7, 30, 6, 3, 7, False, 3)]


def _shifted(t):
    """``t`` as a contiguous view one element into a new buffer (not
    16-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", PREP_CASES, ids=str)
def test_tma_operands_are_aligned_and_zero_padded(case, dtype):
    b, sq, skv, h, kv, hd, causal, q_offset = case
    q, k, v, do = (_shifted(torch.from_numpy(a).to(dtype))
                   for a in _inputs(case))
    o, lse, _ = F.flash_attention_lse_ref(q, k, v, causal=causal,
                                          q_offset=q_offset)
    o, lse = _shifted(o), _shifted(lse)
    *rows, lse_p, pitch = F._tma_operands(q, k, v, o, do, lse)
    for t, orig in zip(rows, (q, k, v, o, do)):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1])
        assert t.shape[:-1] == orig.shape[:-1]
        assert t.shape[-1] % 8 == 0 and 0 <= t.shape[-1] - hd < 8
        assert torch.equal(t[..., :hd], orig)
        assert not t[..., hd:].any()
    assert pitch % 4 == 0 and 0 <= pitch - sq < 4
    assert lse_p.shape == (b, h, pitch) and lse_p.data_ptr() % 16 == 0
    assert torch.equal(lse_p[..., :sq], lse) and not lse_p[..., sq:].any()


@pytest.mark.parametrize("case", PREP_CASES, ids=str)
def test_bwd_ref_on_prepared_operands_is_the_plain_backward(case):
    b, sq, skv, h, kv, hd, causal, q_offset = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=3))
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse, _ = F.flash_attention_lse_ref(q, k, v, **kw)
    *rows, lse_p, _ = F._tma_operands(q, k, v, o, do, lse)
    qp, kp, vp, op, dop = rows
    got = F.flash_attention_bwd_ref(qp, kp, vp, op, lse_p[..., :sq], dop,
                                    scale=hd ** -0.5, **kw)
    want = F.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        g = g[..., :hd]
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# The bf16 output's residual: D from o + o_lo
# ---------------------------------------------------------------------------

def _common_part_inputs(seed=4):
    """bf16 q, k, v, do whose values share a large common part (v = 4 +
    noise): each output row is nearly the mean of v, as the whisper
    decoder's cross-attention over its frames gives."""
    rng = np.random.default_rng(seed)
    b, sq, skv, h, hd = 2, 24, 80, 3, 16
    q, k, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((b, sq, h, hd), (b, skv, h, hd), (b, sq, h, hd)))
    v = torch.from_numpy((4.0 + 0.3 * rng.standard_normal(
        (b, skv, h, hd))).astype(np.float32))
    return [t.to(torch.bfloat16) for t in (q, k, v, do)]


def test_residual_holds_the_f32_output():
    q, k, v, _ = _common_part_inputs()
    out, lse, lo = F.flash_attention_lse_ref(q, k, v, causal=False)
    assert torch.equal(out, F.flash_attention_ref(q, k, v, causal=False))
    assert lo.dtype == torch.bfloat16 and lo.shape == out.shape
    full = F.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=False)
    # the residual is the rounding: at most half an ulp of out (2^-9 of
    # it), and out + lo is the f32 output to bf16 rounding of lo itself
    assert bool((lo.float().abs() <= out.float().abs() * 2.0 ** -8).all())
    np.testing.assert_allclose((out.float() + lo.float()).numpy(),
                               full.numpy(), rtol=2.0 ** -15, atol=0)
    f32 = F.flash_attention_lse_ref(q.float(), k.float(), v.float(),
                                    causal=False)
    assert f32[2] is None


def test_bwd_with_the_residual_takes_d_from_the_f32_output():
    """With the residual the plain backward is within 2e-4 (relative L2)
    of the one given the f32 output (o + o_lo holds it to about 2^-17,
    and the common part amplifies that); from the bf16 output alone dq and
    dk are 3-5% off it on these inputs."""
    q, k, v, do = _common_part_inputs()
    out, lse, lo = F.flash_attention_lse_ref(q, k, v, causal=False)
    full = F.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=False)
    args = (q.float(), k.float(), v.float())
    want = F.flash_attention_bwd_ref(*args, full, lse, do.float(),
                                     causal=False)
    got = F.flash_attention_bwd_ref(*args, out, lse, do.float(),
                                    causal=False, o_lo=lo)
    plain = F.flash_attention_bwd_ref(*args, out, lse, do.float(),
                                      causal=False)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    for g, p, w in zip(got[:2], plain[:2], want[:2]):
        assert rel(g, w) <= 2e-4 and rel(p, w) > 2e-2
    assert torch.equal(got[2], want[2])          # dv takes no D
    # the wrapper takes the residual in bf16, and only there
    for args, o_lo in (((q, k, v, out), lo.float()), ((q, k, v, out), None),
                       (tuple(t.float() for t in (q, k, v, out)), lo)):
        with pytest.raises(ValueError, match="o_lo"):
            F.flash_attention_bwd(*args, lse, do.to(args[0].dtype),
                                  causal=False, o_lo=o_lo)


def test_flash_attention_function_passes_the_residual():
    """In bf16 the autograd Function saves the forward's residual and its
    backward hands it to flash_attention_bwd; in f32 there is none."""
    from repro_torch.kernels import hierarchize as H
    for dtype, has_lo in ((torch.bfloat16, True), (torch.float32, False)):
        q, k, v, do = (t.to(dtype) for t in _common_part_inputs())
        q.requires_grad_(True)
        with H.record_calls() as calls:
            F.flash_attention(q, k, v, causal=True).backward(do)
        bwd = [a for w, a in calls if w is F.flash_attention_bwd]
        assert len(bwd) == 1 and (bwd[0]["o_lo"] is not None) == has_lo


def test_tma_operands_pad_the_residual_as_o():
    q, k, v, do = _common_part_inputs()
    q, k, v, do = (t[..., :12].contiguous() for t in (q, k, v, do))
    out, lse, lo = F.flash_attention_lse_ref(q, k, v, causal=False)
    *rows, lse_p, pitch = F._tma_operands(q, k, v, out, do, lse, _shifted(lo))
    assert len(rows) == 6
    lo_p = rows[5]
    assert lo_p.data_ptr() % 16 == 0 and lo_p.shape[-1] == 16
    assert torch.equal(lo_p[..., :12], lo) and not lo_p[..., 12:].any()
