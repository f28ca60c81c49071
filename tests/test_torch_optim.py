"""The port's optimizer (``repro_torch.optim.adamw``, ``.schedule``) on the
CPU: the scenarios of the reference's ``tests/test_optim.py``, each also
held to ``repro.optim`` on the same numpy inputs at rtol 1e-6 (both
compute in float32, one operation at a time), and the weight-decay rule
of the reference's stacked layers: a layer's norm scale, (d,) in the port
and (L, d) in the reference, is decayed, the final norm's (d,) is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.steps import init_train_state as ref_init_train_state
from repro.optim import adamw as RA
from repro.optim import schedule as RS
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_to_numpy, train_state_from_numpy
from repro_torch.launch.steps import decay_mask
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import constant, warmup_cosine

EXACT = dict(rtol=1e-6, atol=0)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _rank_mask(tree):
    """The reference's own rule on its own leaves: decay rank >= 2."""
    return {k: len(v.shape) >= 2 for k, v in tree.items()}


def _both_update(p, g, **kw):
    """One step from zero state in both packages: (port, reference)."""
    tp, tst = adamw_update(_t(g), adamw_init(_t(p)), _t(p),
                           decay=_rank_mask(p), **kw)
    rp, rst = RA.adamw_update(_j(g), RA.adamw_init(_j(p)), _j(p), **kw)
    return (tp, tst), (rp, rst)


def test_adamw_first_step_closed_form():
    p = {"w": np.asarray([[1.0, -2.0]], np.float32)}
    g = {"w": np.asarray([[0.5, -0.25]], np.float32)}
    lr, wd = 0.1, 0.1
    (tp, tst), (rp, _) = _both_update(p, g, lr=lr, weight_decay=wd)
    want = p["w"] - lr * (g["w"] / (np.abs(g["w"]) + 1e-8) + wd * p["w"])
    np.testing.assert_allclose(tp["w"].numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(rp["w"]), **EXACT)
    assert int(tst.step) == 1 and tst.step.dtype == torch.int32


def test_adamw_no_decay_on_vectors():
    p = {"b": np.asarray([1.0, 1.0], np.float32)}
    g = {"b": np.zeros(2, np.float32)}
    (tp, _), (rp, _) = _both_update(p, g, lr=0.1, weight_decay=0.5)
    np.testing.assert_allclose(tp["b"].numpy(), [1.0, 1.0])
    np.testing.assert_allclose(tp["b"].numpy(), np.asarray(rp["b"]), **EXACT)


def test_adamw_converges_quadratic():
    c = np.asarray([3.0, -1.0, 0.5], np.float32)
    tp, rp = {"x": torch.zeros(3)}, {"x": jnp.zeros(3, jnp.float32)}
    tst, rst = adamw_init(tp), RA.adamw_init(rp)
    for _ in range(300):
        tp, tst = adamw_update({"x": 2 * (tp["x"] - torch.from_numpy(c))},
                               tst, tp, lr=3e-2, weight_decay=0.0,
                               decay=_rank_mask(tp))
        rp, rst = RA.adamw_update({"x": 2 * (rp["x"] - c)}, rst, rp,
                                  lr=3e-2, weight_decay=0.0)
    np.testing.assert_allclose(tp["x"].numpy(), c, atol=1e-2)
    np.testing.assert_allclose(tp["x"].numpy(), np.asarray(rp["x"]),
                               rtol=1e-5)


def test_adamw_bf16_params_f32_state():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st.m["w"].dtype == torch.float32
    g = {"w": torch.full((4, 4), 0.1, dtype=torch.bfloat16)}
    new_p, new_st = adamw_update(g, st, p, lr=0.01, decay=_rank_mask(p))
    assert new_p["w"].dtype == torch.bfloat16
    assert new_st.v["w"].dtype == torch.float32
    rp, _ = RA.adamw_update({"w": jnp.full((4, 4), 0.1, jnp.bfloat16)},
                            RA.adamw_init({"w": jnp.ones((4, 4),
                                                         jnp.bfloat16)}),
                            {"w": jnp.ones((4, 4), jnp.bfloat16)}, lr=0.01)
    np.testing.assert_array_equal(new_p["w"].float().numpy(),
                                  np.asarray(rp["w"], np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_inplace_is_the_functional_update(dtype):
    """``inplace=True`` overwrites the parameters, and replaces the entries
    of the state's moment mappings, with the values the functional update
    returns, bit for bit, over three steps."""
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 4), "b": (4,)}
    p = {k: torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
         for k, s in shapes.items()}
    mine = {k: t.clone() for k, t in p.items()}
    st, st_mine = adamw_init(p), adamw_init(mine)
    m_map, v_map = st_mine.m, st_mine.v
    for _ in range(3):
        g = {k: torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
             for k, s in shapes.items()}
        p, st = adamw_update(g, st, p, lr=0.1, decay=_rank_mask(p))
        out, st_mine = adamw_update(g, st_mine, mine, lr=0.1,
                                    decay=_rank_mask(mine), inplace=True)
        assert all(out[k] is mine[k] for k in shapes)
        assert st_mine.m is m_map and st_mine.v is v_map
        for k in shapes:
            assert torch.equal(mine[k], p[k])
            assert torch.equal(st_mine.m[k], st.m[k])
            assert torch.equal(st_mine.v[k], st.v[k])
    assert int(st_mine.step) == 3


def test_clip_by_global_norm():
    g = {"a": np.asarray([3.0, 4.0], np.float32)}
    clipped, norm = clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(float(norm), 5.0, rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    rclipped, rnorm = RA.clip_by_global_norm(_j(g), 1.0)
    np.testing.assert_allclose(clipped["a"].numpy(),
                               np.asarray(rclipped["a"]), **EXACT)
    same, _ = clip_by_global_norm(_t(g), 10.0)
    np.testing.assert_allclose(same["a"].numpy(), g["a"], rtol=1e-6)


def test_warmup_cosine_shape():
    fn = warmup_cosine(1e-3, 10, 100, final_frac=0.1)
    ref = RS.warmup_cosine(1e-3, 10, 100, final_frac=0.1)
    lrs = [float(fn(s)) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    np.testing.assert_allclose(lrs[1], 1e-3, rtol=1e-6)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))
    np.testing.assert_allclose(lrs[-1], 1e-4, rtol=1e-4)
    for s in range(0, 101):
        np.testing.assert_allclose(
            float(fn(torch.tensor(s, dtype=torch.int32))),
            float(ref(jnp.asarray(s, jnp.int32))), **EXACT)


def test_constant_schedule():
    np.testing.assert_allclose(float(constant(5e-4)(7)), 5e-4, rtol=1e-6)
    assert float(constant(5e-4)(7)) == float(RS.constant(5e-4)(
        jnp.asarray(7)))


@pytest.fixture(scope="module")
def smoke_state():
    cfg = ref_smoke_config("smollm_360m")
    params, opt = ref_init_train_state(jax.random.PRNGKey(3), cfg)
    return cfg, jax.tree.map(np.asarray, (params, opt))


def test_decay_follows_the_reference_stacked_rank(smoke_state):
    """AdamW from the reference's smoke state: every parameter after one
    step with a constant gradient equals the reference's, which decays
    by the stacked leaf's rank."""
    cfg, (pn, on) = smoke_state
    tcfg = get_smoke_config("smollm_360m")
    model, opt = train_state_from_numpy(pn, on, tcfg, device="cpu")
    mask = decay_mask(model)
    assert mask["blocks.0.ln1.scale"] and mask["blocks.1.ln2.scale"]
    assert not mask["final_norm.scale"] and mask["embed"]
    named = {n: p.detach() for n, p in model.named_parameters()}
    grads = {n: torch.full_like(p, 0.01) for n, p in named.items()}
    new, _ = adamw_update(grads, opt, named, lr=0.1, weight_decay=0.5,
                          decay=mask)
    rgrads = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), pn)
    rnew, _ = RA.adamw_update(rgrads, jax.tree.map(jnp.asarray, on),
                              jax.tree.map(jnp.asarray, pn), lr=0.1,
                              weight_decay=0.5)
    got = lm_params_to_numpy(new, tcfg)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), **EXACT), got, jax.device_get(rnew))
    # the rule bites: without it a layer's norm scale would not decay
    plain, _ = adamw_update(grads, opt, named, lr=0.1, weight_decay=0.5,
                            decay=_rank_mask(named))
    assert not torch.equal(plain["blocks.0.ln1.scale"],
                           new["blocks.0.ln1.scale"])
    assert torch.equal(plain["final_norm.scale"], new["final_norm.scale"])
