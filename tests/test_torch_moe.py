"""The port's moe family (``repro_torch.models.moe``, the moe layers of
``models.transformer`` and ``models.model``) against the reference's, on
the CPU.

``router_topk``, ``moe_ffn`` (ragged and grouped, the latter at a capacity
that drops, so the same slots drop) and ``moe_ffn_ep`` (the port's mesh
``make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)`` against the
reference's shard_map under a JAX mesh of the same shape over the
conftest's fake devices) on seeded inputs, at the reference's own test
bars (2e-4); then ``olmoe_1b_7b`` and ``qwen3_moe_235b_a22b`` at their
smoke configs (f32): logits, ``serve_step`` and a train step at the dense
family's bars (``tests/torch_lm_families.py``).  The JAX side runs once
per architecture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import AxisType
from repro.compat import make_mesh as ref_make_mesh
from repro.compat import set_mesh
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as RMOE
from repro.models.transformer import forward as ref_forward
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.mesh import make_mesh, use_mesh
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import moe as TMOE
from repro_torch.models.transformer import forward

from torch_lm_families import family

MOE_TOL = dict(rtol=2e-4, atol=2e-4)      # the reference's test_moe.py bar
ARCHS = ["olmoe_1b_7b", "qwen3_moe_235b_a22b"]


def _params(e, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((d, e)).astype(np.float32) * 0.1,
            "wi_gate": (rng.standard_normal((e, d, f)) * d ** -0.5).astype(
                np.float32),
            "wi_up": (rng.standard_normal((e, d, f)) * d ** -0.5).astype(
                np.float32),
            "wo": (rng.standard_normal((e, f, d)) * f ** -0.5).astype(
                np.float32)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Routing and the single-device dispatches
# ---------------------------------------------------------------------------

def test_router_topk_matches_the_reference():
    x, w = _x((48, 16)), _x((16, 8), seed=2)
    rw, ri, raux = RMOE.router_topk(jnp.asarray(x), jnp.asarray(w), 8, 3)
    tw, ti, taux = TMOE.router_topk(torch.from_numpy(x), torch.from_numpy(w),
                                    8, 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)


def test_ragged_matches_the_reference_and_counts_host_reads():
    rp, tp = _both(_params(4, 8, 16))
    x = _x((24, 8))
    want, waux = RMOE.moe_ffn(jnp.asarray(x), rp, num_experts=4, k=2)
    reads = TMOE.moe_ffn.host_reads
    got, aux = TMOE.moe_ffn(torch.from_numpy(x), tp, num_experts=4, k=2)
    assert TMOE.moe_ffn.host_reads == reads + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


def test_ragged_matches_dense_loop():
    """Ragged dispatch == the per-token sum over its selected experts."""
    _, p = _both(_params(4, 8, 16))
    x = torch.from_numpy(_x((24, 8)))
    y, _ = TMOE.moe_ffn(x, p, num_experts=4, k=2, impl="ragged")
    weights, idx, _ = TMOE.router_topk(x, p["router"], 4, 2)
    want = torch.zeros(24, 8, dtype=torch.float64)
    for t in range(24):
        for j in range(2):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(x[t] @ p["wi_gate"][e]) * (
                x[t] @ p["wi_up"][e])
            want[t] += float(weights[t, j]) * (h @ p["wo"][e]).double()
    np.testing.assert_allclose(y.numpy(), want.numpy(), **MOE_TOL)


@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_grouped_matches_the_reference(cf):
    """At capacity t*k (cf = E) nothing drops; at cf 0.25 (8 slots an
    expert for 32 on average) the same slots drop as the reference's."""
    rp, tp = _both(_params(4, 8, 16))
    x = _x((64, 8))
    want, _ = RMOE.moe_ffn(jnp.asarray(x), rp, num_experts=4, k=2,
                           impl="grouped", capacity_factor=cf)
    got, _ = TMOE.moe_ffn(torch.from_numpy(x), tp, num_experts=4, k=2,
                          impl="grouped", capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    ragged, _ = TMOE.moe_ffn(torch.from_numpy(x), tp, num_experts=4, k=2)
    dropped = (got - ragged).abs().amax(-1) > 1e-5
    assert bool(dropped.any()) == (cf < 1)
    # "ep" on the (T, D) entry is the ragged path, as the reference's
    ep, _ = TMOE.moe_ffn(torch.from_numpy(x), tp, num_experts=4, k=2,
                         impl="ep")
    assert torch.equal(ep, ragged)


def test_grouped_drops_overflow():
    _, p = _both(_params(2, 8, 16))
    x = torch.from_numpy(_x((64, 8)))
    y, _ = TMOE.moe_ffn(x, p, num_experts=2, k=2, impl="grouped",
                        capacity_factor=0.25)
    full, _ = TMOE.moe_ffn(x, p, num_experts=2, k=2)
    norms, norms_full = y.norm(dim=-1), full.norm(dim=-1)
    assert bool((norms <= norms_full + 1e-5).all())
    assert int((norms < 1e-7).sum()) > 0


def test_moe_grads_finite_and_deterministic():
    _, p = _both(_params(4, 8, 8))
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = torch.from_numpy(_x((16, 8)))
    y, aux = TMOE.moe_ffn(x, p, num_experts=4, k=2)
    grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux, list(p.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    y2, _ = TMOE.moe_ffn(x, p, num_experts=4, k=2)
    assert torch.equal(y, y2)


# ---------------------------------------------------------------------------
# Expert parallelism on the mesh
# ---------------------------------------------------------------------------

def _ref_mesh(shape, names):
    return ref_make_mesh(shape, names, axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_ep_matches_the_reference(cf):
    """(2, 2) data x model: at cf 8 nothing drops, at cf 0.5 (8 slots an
    expert a row for 16 on average) the same slots drop."""
    e, d, f, b, s, k = 8, 16, 32, 4, 64, 2
    rp, tp = _both(_params(e, d, f, seed=3))
    x = _x((b, s, d), seed=4)
    with set_mesh(_ref_mesh((2, 2), ("data", "model"))):
        want, waux = jax.jit(lambda x, p: RMOE.moe_ffn_ep(
            x, p, num_experts=e, k=k, capacity_factor=cf))(jnp.asarray(x),
                                                           rp)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with use_mesh(mesh):
        got, aux = TMOE.moe_ffn_ep(torch.from_numpy(x), tp, num_experts=e,
                                   k=k, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    ragged, _ = TMOE.moe_ffn(torch.from_numpy(x).reshape(b * s, d), tp,
                             num_experts=e, k=k)
    err = float((got.reshape(b * s, d) - ragged).abs().max())
    assert (err <= 2e-4) == (cf >= 8.0)


def test_ep_gradients_flow_and_match_ragged():
    e, d, f, b, s, k = 8, 16, 32, 4, 12, 2
    _, tp = _both(_params(e, d, f, seed=5))
    p = {n: t.clone().requires_grad_() for n, t in tp.items()}
    x = torch.from_numpy(_x((b, s, d), seed=6))
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    y, _ = TMOE.moe_ffn_ep(x, p, num_experts=e, k=k, capacity_factor=8.0,
                           mesh=mesh)
    ragged, _ = TMOE.moe_ffn(x.reshape(b * s, d), p, num_experts=e, k=k)
    np.testing.assert_allclose(y.detach().numpy(),
                               ragged.detach().reshape(b, s, d).numpy(),
                               **MOE_TOL)
    ge = torch.autograd.grad((y ** 2).sum(), list(p.values()))
    gr = torch.autograd.grad((ragged ** 2).sum(), list(p.values()))
    for a, r in zip(ge, gr):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), r.numpy(), **MOE_TOL)


NONE_CASES = {  # where moe_ffn_ep returns None: mesh, experts, batch rows
    "no mesh": (None, 8, 4),
    "no model axis": (((4,), ("data",)), 8, 4),
    "one model shard": (((4, 1), ("data", "model")), 8, 4),
    "experts not divisible": (((1, 4), ("data", "model")), 6, 4),
    "rows not divisible": (((2, 2), ("data", "model")), 8, 3),
}


@pytest.mark.parametrize("case", list(NONE_CASES))
def test_ep_returns_none_where_the_reference_does(case):
    mesh, e, b = NONE_CASES[case]
    rp, tp = _both(_params(e, 8, 8))
    x = _x((b, 4, 8))
    kw = dict(num_experts=e, k=2)
    if mesh is None:
        assert RMOE.moe_ffn_ep(jnp.asarray(x), rp, **kw) is None
        assert TMOE.moe_ffn_ep(torch.from_numpy(x), tp, **kw) is None
        return
    shape, names = mesh
    n = int(np.prod(shape))
    ref_mesh = ref_make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape),
                             devices=jax.devices()[:n])
    with set_mesh(ref_mesh):
        assert RMOE.moe_ffn_ep(jnp.asarray(x), rp, **kw) is None
    with use_mesh(make_mesh(shape, names, devices=["cpu"] * n)):
        assert TMOE.moe_ffn_ep(torch.from_numpy(x), tp, **kw) is None


def test_ep_block_under_the_ambient_mesh_matches_the_reference():
    """``moe_impl="ep"``: the model's moe layers dispatch expert-parallel
    under the mesh context, on both sides; outside it, ragged."""
    cfg = ref_smoke_config("olmoe_1b_7b").replace(moe_impl="ep",
                                                  capacity_factor=8.0)
    tcfg = get_smoke_config("olmoe_1b_7b").replace(moe_impl="ep",
                                                   capacity_factor=8.0)
    pn = family("olmoe_1b_7b").state_np[0]
    model = lm_params_from_numpy(pn, tcfg, device="cpu")
    tokens = family("olmoe_1b_7b").tokens
    with set_mesh(_ref_mesh((2, 2), ("data", "model"))):
        want = jax.jit(lambda p, t: ref_forward(p, cfg, t))(
            jax.tree.map(jnp.asarray, pn), jnp.asarray(tokens))
    reads = TMOE.moe_ffn.host_reads
    with use_mesh(make_mesh((2, 2), ("data", "model"),
                            devices=["cpu"] * 4)), torch.no_grad():
        got = forward(model, tcfg, torch.from_numpy(tokens))
    assert TMOE.moe_ffn.host_reads == reads        # no ragged call
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    with torch.no_grad():
        plain = forward(model, tcfg, torch.from_numpy(tokens))
    assert TMOE.moe_ffn.host_reads == reads + tcfg.num_layers
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **MOE_TOL)


# ---------------------------------------------------------------------------
# The architectures at their smoke configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_the_reference(arch):
    family(arch).check_logits()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_the_reference(arch):
    family(arch).check_serve_step()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    family(arch).check_train_step()


def test_training_a_moe_config_moves_its_loss():
    res = train(TrainConfig(arch="olmoe_1b_7b", steps=8, seq_len=16,
                            global_batch=2, peak_lr=1e-2, warmup_steps=2,
                            device="cpu"))
    vals = [res.losses[s] for s in sorted(res.losses)]
    assert len(vals) == 8 and all(np.isfinite(v) for v in vals)
    assert vals[-1] < vals[0]
