"""The port's SSM core (``repro_torch.models.ssm``) and the ssm family
(``xlstm_1_3b``: mLSTM and sLSTM layers) against the reference's, on the
CPU.

The chunked SSD core at several chunks and with a carried state, its
one-token step, the sLSTM scan and its continuation, on seeded f64 inputs
(both packages compute in f32): within 1e-5 (rtol and atol) of the
reference.  The mLSTM block, prefill then decode.  Then ``xlstm_1_3b`` at
its smoke config (f32): logits, ``serve_step`` and a train step
(``tests/torch_lm_families.py``), and its decode cache's specs.  Last, the
one place the port departs from the reference (ROADMAP C18): the SSD's
masked decay overflows in the reference's gradient and not in the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

from torch_lm_families import check_cache_specs, family

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "xlstm_1_3b"


def _ssd_inputs(b=2, l=24, h=3, p=4, s=5, seed=0, decay=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, p)),
            -np.abs(rng.standard_normal((b, l, h))) * decay,
            np.abs(rng.standard_normal((b, l, h))),
            rng.standard_normal((b, l, s)), rng.standard_normal((b, l, s)))


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("chunk", [4, 8, 24, 32])
def test_ssd_chunked_matches_the_reference(chunk):
    args = _ssd_inputs()
    want_y, want_s = RS.ssd_chunked(*_j(*args), chunk=chunk)
    got_y, got_s = TS.ssd_chunked(*_t(*args), chunk=chunk)
    assert got_y.dtype == torch.float64 and got_s.s.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.s.numpy(), np.asarray(want_s.s), **TOL)


def test_ssd_chunked_carries_an_initial_state():
    """Two halves with the state carried == the whole, on both sides."""
    args = _ssd_inputs(l=16)
    first = [a[:, :8] for a in args]
    second = [a[:, 8:] for a in args]
    _, rst1 = RS.ssd_chunked(*_j(*first), chunk=4)
    want, _ = RS.ssd_chunked(*_j(*second), chunk=4, initial=rst1)
    y1, st1 = TS.ssd_chunked(*_t(*first), chunk=4)
    np.testing.assert_allclose(st1.s.numpy(), np.asarray(rst1.s), **TOL)
    y2, st2 = TS.ssd_chunked(*_t(*second), chunk=4, initial=st1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(want), **TOL)
    full, st_full = TS.ssd_chunked(*_t(*args), chunk=4)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(),
                               **TOL)
    np.testing.assert_allclose(st2.s.numpy(), st_full.s.numpy(), **TOL)


def test_ssd_decode_step_matches_the_chunked_form():
    args = _ssd_inputs(l=6)
    full, _ = TS.ssd_chunked(*_t(*args), chunk=8)
    st = TS.SSDState(torch.zeros((2, 3, 5, 4)))
    rst = RS.SSDState(jnp.zeros((2, 3, 5, 4), jnp.float32))
    for t in range(6):
        step = [a[:, t:t + 1] for a in args]
        y, st = TS.ssd_decode_step(*_t(*step), st)
        ry, rst = RS.ssd_decode_step(*_j(*step), rst)
        np.testing.assert_allclose(y.numpy()[:, 0], full.numpy()[:, t], **TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(st.s.numpy(), np.asarray(rst.s), **TOL)


def test_causal_conv_with_history_matches_the_reference():
    rng = np.random.default_rng(1)
    x, w = rng.standard_normal((2, 7, 6)), rng.standard_normal((4, 6))
    hist = rng.standard_normal((2, 3, 6))
    for h in (None, hist):
        want, want_h = RS._causal_conv(*_j(x, w), None if h is None
                                       else jnp.asarray(h))
        got, got_h = TS._causal_conv(*_t(x, w), None if h is None
                                     else torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    # the history carries a split sequence: two calls == one
    one, _ = TS._causal_conv(*_t(x, w))
    a, ha = TS._causal_conv(*_t(x[:, :3], w))
    b, _ = TS._causal_conv(torch.from_numpy(x[:, 3:]), torch.from_numpy(w),
                           ha)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), one.numpy(),
                               rtol=1e-12)


def test_slstm_scan_matches_the_reference():
    rng = np.random.default_rng(2)
    xg = rng.standard_normal((2, 12, 2, 4, 4)) * 0.5
    r = rng.standard_normal((2, 4, 4, 4)) * 0.2
    want, wst = RS.slstm_scan(*_j(xg, r))
    got, st = TS.slstm_scan(*_t(xg, r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for a, b in zip(st, wst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_slstm_stateful_continuation():
    rng = np.random.default_rng(3)
    xg = rng.standard_normal((1, 8, 2, 4, 4)) * 0.5
    r = rng.standard_normal((2, 4, 4, 4)) * 0.2
    full, _ = TS.slstm_scan(*_t(xg, r))
    h1, st = TS.slstm_scan(*_t(xg[:, :4], r))
    h2, _ = TS.slstm_scan(torch.from_numpy(xg[:, 4:]), torch.from_numpy(r),
                          st)
    _, rst = RS.slstm_scan(*_j(xg[:, :4], r))
    want, _ = RS.slstm_scan(jnp.asarray(xg[:, 4:]), jnp.asarray(r), rst)
    np.testing.assert_allclose(h2.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), full.numpy(),
                               **TOL)


def test_mlstm_block_prefill_then_decode_matches_the_reference():
    """The first 6 tokens by prefill, the next 4 one by one from its state,
    on both sides; and the decode equals the whole prefill."""
    cfg = ref_smoke_config(ARCH)
    pn = family(ARCH).state_np[0]
    model = lm_params_from_numpy(pn, family(ARCH).cfg, device="cpu")
    lp_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), pn["segments"][0])
    lp = model.segments[0][0]
    x = np.random.default_rng(4).standard_normal((2, 10, cfg.d_model)) \
        .astype(np.float32)
    want_full, _ = RT._mlstm_block(jnp.asarray(x), lp_ref, cfg)
    with torch.no_grad():
        full, _ = TT._mlstm_block(torch.from_numpy(x), lp, family(ARCH).cfg)
        y, st = TT._mlstm_block(torch.from_numpy(x[:, :6]), lp,
                                family(ARCH).cfg)
        ry, rst = RT._mlstm_block(jnp.asarray(x[:, :6]), lp_ref, cfg)
        steps = [y]
        for t in range(6, 10):
            y, st = TT._mlstm_block(torch.from_numpy(x[:, t:t + 1]), lp,
                                    family(ARCH).cfg, st, decode=True)
            ry, rst = RT._mlstm_block(jnp.asarray(x[:, t:t + 1]), lp_ref,
                                      cfg, rst, decode=True)
            np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
            steps.append(y)
    np.testing.assert_allclose(full.numpy(), np.asarray(want_full), **TOL)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               **TOL)
    np.testing.assert_allclose(st.s.numpy(), np.asarray(rst.s), **TOL)


def test_logits_match_the_reference():
    family(ARCH).check_logits()


def test_serve_step_matches_the_reference():
    family(ARCH).check_serve_step()


def test_train_step_matches_the_reference():
    family(ARCH).check_train_step()


def test_decode_cache_specs_match_the_reference():
    check_cache_specs(ARCH)


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """ROADMAP C18: at a strong decay over a long chunk the reference's
    masked exp(cum_i - cum_j) (i < j) is inf, and its gradient NaN; the
    port masks the exponent first.  Forward values agree."""
    x, a, w, b, c = _ssd_inputs(l=16, decay=20.0)     # |cum| up to ~250
    assert float(np.max(-np.sum(a, axis=1))) > 100.0

    def ref_loss(a):
        return jnp.sum(RS.ssd_chunked(*_j(x), a, *_j(w, b, c),
                                      chunk=16)[0] ** 2)

    ref_grad = np.asarray(jax.grad(ref_loss)(jnp.asarray(a)))
    assert np.isnan(ref_grad).any()
    at = torch.from_numpy(a).requires_grad_()
    y, _ = TS.ssd_chunked(torch.from_numpy(x), at, *_t(w, b, c), chunk=16)
    (g,) = torch.autograd.grad((y ** 2).sum(), [at])
    assert bool(torch.isfinite(g).all())
    want, _ = RS.ssd_chunked(*_j(x, a, w, b, c), chunk=16)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
