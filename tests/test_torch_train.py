"""The port's dense-LM training (``repro_torch.launch.train``, ``.steps``,
``data.pipeline``, ``models.transformer.loss_fn``) against the reference's
on the CPU, at ``smollm_360m``'s smoke config (f32).

The reference's train state (its parameters from a JAX key, AdamW's zero
state) is carried across with ``convert.train_state_from_numpy``, so both
packages train from the same weights; results come back through
``convert.train_state_to_numpy`` in the reference's stacked layout.
Bars: the loss rtol 1e-5; gradients, updated parameters and AdamW's
moments rtol 1e-4 / atol 1e-6 (f32 sums in other orders: the products,
attention's analytic backward against JAX's autodiff of the chunked
softmax); per-step losses of eight ``train`` steps rtol 1e-4.  Batches of
``SyntheticLM`` are bitwise.  The JAX side runs once, in module fixtures.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import pipeline as RP
from repro.launch.steps import init_train_state as ref_init_train_state
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.launch.train import TrainConfig as RefTrainConfig
from repro.launch.train import train as ref_train
from repro.models import layers as RL
from repro.models.transformer import loss_fn as ref_loss_fn
from repro.optim import adamw as RA
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (lm_params_to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import pipeline as TP
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import hierarchize as H
from repro_torch.launch import steps as S
from repro_torch.launch.train import TrainConfig, main, train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.transformer import loss_fn
from repro_torch.optim.schedule import warmup_cosine

REPO = Path(__file__).resolve().parents[1]
ARCH = "smollm_360m"
SEQ, BATCH = 32, 4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _close(got, want, **tol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), **tol), got, want)


@pytest.fixture(scope="module")
def ref_state():
    """The reference's smoke train state as numpy, and its config."""
    cfg = ref_smoke_config(ARCH)
    state = ref_init_train_state(jax.random.PRNGKey(0), cfg)
    return cfg, jax.tree.map(np.asarray, state)


def _port_state(ref_state, dtype=None):
    _, (pn, on) = ref_state
    return train_state_from_numpy(pn, on, get_smoke_config(ARCH),
                                  device="cpu", dtype=dtype)


def _data(ref=False, **kw):
    cfg = dict(vocab_size=256, seq_len=SEQ, global_batch=BATCH, **kw)
    if ref:
        return RP.SyntheticLM(RP.DataConfig(**cfg))
    return TP.SyntheticLM(TP.DataConfig(**cfg), device="cpu")


# ---------------------------------------------------------------------------
# Data, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts,index", [(1, 0), (2, 1)])
def test_synthetic_batches_are_the_reference_bits(hosts, index):
    mine = _data(seed=3, num_hosts=hosts, host_index=index)
    ref = _data(ref=True, seed=3, num_hosts=hosts, host_index=index)
    for step in (0, 1, 17):
        got, want = mine.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert TP.host_shard_slice(8, 2, 1) == RP.host_shard_slice(8, 2, 1)


def test_cross_entropy_and_loss_fn(ref_state):
    cfg, (pn, _) = ref_state
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 264)).astype(np.float32)
    labels = rng.integers(0, 256, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(TL.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), 256)),
        float(RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               256)), rtol=1e-5)
    model, _ = _port_state(ref_state)
    batch = _data().batch(0)
    np.testing.assert_allclose(
        float(loss_fn(model, get_smoke_config(ARCH), batch).detach()),
        float(ref_loss_fn(jax.tree.map(jnp.asarray, pn), cfg,
                          _data(ref=True).batch(0))), rtol=1e-5)


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_step(ref_state):
    """The reference's gradients and one step of its train step (warmup 0,
    so a constant schedule of 1e-3 stands in), from its smoke state."""
    cfg, (pn, on) = ref_state
    batch = _data(ref=True).batch(0)
    params = jax.tree.map(jnp.asarray, pn)
    loss, grads = jax.value_and_grad(ref_loss_fn)(params, cfg, batch)
    step = ref_make_train_step(cfg, lambda s: jnp.asarray(1e-3, jnp.float32))
    new_p, new_o, metrics = step(params, jax.tree.map(jnp.asarray, on),
                                 batch)
    return float(loss), jax.tree.map(np.asarray, (grads, new_p, new_o,
                                                  metrics))


def test_train_step_matches_the_reference(ref_state, ref_step):
    ref_loss, (rgrads, rparams, ropt, rmetrics) = ref_step
    tcfg = get_smoke_config(ARCH)
    model, opt = _port_state(ref_state)
    batch = _data().batch(0)
    loss, grads = S.loss_and_grads(model, tcfg, batch)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    _close(lm_params_to_numpy(grads, tcfg), rgrads, **GRAD_TOL)
    step = S.make_train_step(tcfg, lambda s: torch.tensor(1e-3))
    model, opt, metrics = step(model, opt, batch)
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               rmetrics["grad_norm"], rtol=1e-5)
    pn, on = train_state_to_numpy(model, opt, tcfg)
    _close(on.m, ropt.m, **GRAD_TOL)
    _close(on.v, ropt.v, **GRAD_TOL)
    assert int(on.step) == int(ropt.step) == 1
    # The parameters: the reference's AdamW on the port's own gradients
    # gives the port's values everywhere, to f32 rounding (rtol 1e-6; atol
    # 1e-9, an ulp of the weights where p - lr * delta cancels) ...
    _, (_, start_o) = ref_state
    clipped, _ = RA.clip_by_global_norm(
        jax.tree.map(jnp.asarray, lm_params_to_numpy(grads, tcfg)), 1.0)
    want, _ = RA.adamw_update(clipped, jax.tree.map(jnp.asarray, start_o),
                              jax.tree.map(jnp.asarray, ref_state[1][0]),
                              lr=1e-3)
    _close(pn, jax.tree.map(np.asarray, want), rtol=1e-6, atol=1e-9)
    # ... and the reference's whole step at rtol 1e-4 / atol 1e-6 wherever
    # the step is conditioned: Adam's first step moves each weight by
    # lr * g / (|g| + eps), which turns a gradient difference into
    # lr * eps / (|g| + eps)^2 times as much, 2.5e4 times near |g| = eps
    # (1e-8).  Left out: the entries with |g| < 2 eps where the two
    # gradients differ, and there may be at most 10 of them.
    mine = lm_params_to_numpy(grads, tcfg)

    def conditioned(got, ref, g, g_mine):
        skip = (np.abs(g) < 2e-8) & (g_mine != g)
        np.testing.assert_allclose(got[~skip], ref[~skip], **GRAD_TOL)
        return int(skip.sum())

    skipped = jax.tree.leaves(jax.tree.map(conditioned, pn, rparams, rgrads,
                                           mine))
    assert sum(skipped) <= 10


def test_first_warmup_step_has_lr_zero(ref_state):
    tcfg = get_smoke_config(ARCH)
    model, opt = _port_state(ref_state)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = S.make_train_step(tcfg, warmup_cosine(1e-3, 2, 10))
    model, opt, metrics = step(model, opt, _data().batch(0))
    assert float(metrics["lr"]) == 0.0 and int(opt.step) == 1
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n])


def _one_step(ref_state, cfg):
    model, opt = _port_state(ref_state)
    step = S.make_train_step(cfg, lambda s: torch.tensor(1e-3))
    model, opt, m = step(model, opt, _data().batch(0))
    return float(m["loss"]), dict(model.named_parameters()), opt


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bitwise_the_plain_step(ref_state, policy):
    base = get_smoke_config(ARCH)
    plain = _one_step(ref_state, base)
    remat = _one_step(ref_state, base.replace(remat=True,
                                              remat_policy=policy))
    assert plain[0] == remat[0]
    for n, p in plain[1].items():
        assert torch.equal(p, remat[1][n]), n
    for a, b in zip(plain[2].m.values(), remat[2].m.values()):
        assert torch.equal(a, b)


def test_remat_full_recomputes_row_10_once(ref_state):
    """With remat "full" a step calls row 10's forward twice a layer (the
    forward and the recompute) and its backward once."""
    cfg = get_smoke_config(ARCH).replace(remat=True, remat_policy="full")
    model, opt = _port_state(ref_state)
    with H.record_calls() as calls:
        S.make_train_step(cfg, lambda s: torch.tensor(1e-3))(
            model, opt, _data().batch(0))
    names = [c[0] for c in calls]
    assert names.count(F.flash_attention_lse) == 2 * cfg.num_layers
    assert names.count(F.flash_attention_bwd) == cfg.num_layers


def test_grad_accum_matches_single_batch(ref_state, ref_step):
    """grad_accum=2 against 1 on one global batch of 8 (the reference's
    system test), and the port's accumulated step against the
    reference's."""
    cfg, (pn, on) = ref_state
    tcfg = get_smoke_config(ARCH)
    data = TP.SyntheticLM(TP.DataConfig(256, SEQ, 8), device="cpu")
    batch = data.batch(0)
    l1, g1 = S.loss_and_grads(_port_state(ref_state)[0], tcfg, batch)
    l2, g2 = S.loss_and_grads(_port_state(ref_state)[0], tcfg, batch, 2)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-3)
    assert all(g.dtype == torch.float32 for g in g2.values())
    _close(lm_params_to_numpy(g2, tcfg), lm_params_to_numpy(g1, tcfg),
           rtol=1e-3, atol=1e-6)
    rbatch = RP.SyntheticLM(RP.DataConfig(256, SEQ, 8)).batch(0)
    rstep = ref_make_train_step(cfg, lambda s: jnp.asarray(1e-3, jnp.float32),
                                grad_accum=2)
    _, ro, rm = rstep(jax.tree.map(jnp.asarray, pn),
                      jax.tree.map(jnp.asarray, on), rbatch)
    model, opt = _port_state(ref_state)
    model, opt, m = S.make_train_step(tcfg, lambda s: torch.tensor(1e-3),
                                      grad_accum=2)(model, opt, batch)
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    # the first moment is 0.1 times the accumulated, clipped gradient
    _close(lm_params_to_numpy(opt.m, tcfg), jax.tree.map(np.asarray, ro.m),
           **GRAD_TOL)


def test_bf16_step_near_the_reference(ref_state):
    """One bf16 smoke step: the loss within 3e-2 of the reference's."""
    cfg, (pn, on) = ref_state
    bcfg = cfg.replace(dtype="bfloat16")
    rparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pn)
    rstep = ref_make_train_step(bcfg, lambda s: jnp.asarray(1e-3,
                                                            jnp.float32))
    _, _, rm = rstep(rparams, jax.tree.map(jnp.asarray, on),
                     _data(ref=True).batch(0))
    model, opt = _port_state(ref_state, dtype=torch.bfloat16)
    tcfg = get_smoke_config(ARCH).replace(dtype="bfloat16")
    model, opt, m = S.make_train_step(tcfg, lambda s: torch.tensor(1e-3))(
        model, opt, _data().batch(0))
    assert model.embed.dtype == torch.bfloat16
    assert opt.m["embed"].dtype == torch.float32
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=3e-2)


# ---------------------------------------------------------------------------
# The train loop
# ---------------------------------------------------------------------------

STEPS8 = dict(arch=ARCH, steps=8, seq_len=SEQ, global_batch=BATCH,
              warmup_steps=3)


@pytest.fixture(scope="module")
def ref_train8():
    return ref_train(RefTrainConfig(**STEPS8))


def test_train_matches_the_reference_per_step(ref_state, ref_train8):
    res = train(TrainConfig(**STEPS8, device="cpu"),
                state=_port_state(ref_state))
    assert sorted(res.losses) == sorted(ref_train8.losses) == list(range(8))
    for s in range(8):
        np.testing.assert_allclose(res.losses[s], ref_train8.losses[s],
                                   rtol=1e-4)
    assert res.final_step == ref_train8.final_step == 8
    assert res.rollbacks == 0
    _close(lm_params_to_numpy(res.params, get_smoke_config(ARCH)),
           jax.tree.map(np.asarray, ref_train8.params), rtol=1e-3,
           atol=1e-5)


def test_nan_injection_rolls_back_and_recovers(tmp_path):
    """The reference's system test at 12 steps (a checkpoint every 4, the
    NaN at step 6): one rollback to step 4, training on past the poisoned
    step."""
    res = train(TrainConfig(arch=ARCH, steps=12, seq_len=32, global_batch=4,
                            checkpoint_dir=str(tmp_path / "ckpt"),
                            checkpoint_every=4, loss_poison_step=6,
                            device="cpu"))
    assert res.rollbacks == 1
    assert res.final_step == 12
    assert any("non-finite" in e for e in res.events)
    assert max(res.losses) == 11
    assert 6 not in res.losses and all(
        np.isfinite(v) for v in res.losses.values())


def test_nan_without_checkpoint_raises():
    with pytest.raises(RuntimeError, match="unrecoverable"):
        train(TrainConfig(arch=ARCH, steps=6, seq_len=32, global_batch=4,
                          loss_poison_step=3, device="cpu"))


def test_rollback_restores_the_saved_state_bitwise(tmp_path):
    """The state restored at a rollback is bitwise the checkpoint of the
    last good step, and training continues from it."""
    import repro_torch.launch.train as T
    saved, restored = {}, {}
    save, restore = T.save_checkpoint, T.restore_checkpoint

    def spy_save(directory, step, tree, **kw):
        saved[step] = {k: v.detach().clone() for k, v in tree[0].items()}
        return save(directory, step, tree, **kw)

    def spy_restore(directory, step, template, **kw):
        out = restore(directory, step, template, **kw)
        restored[step] = out[0][0]
        return out

    T.save_checkpoint, T.restore_checkpoint = spy_save, spy_restore
    try:
        res = train(TrainConfig(arch=ARCH, steps=6, seq_len=32,
                                global_batch=4, warmup_steps=2,
                                checkpoint_dir=str(tmp_path),
                                checkpoint_every=2, loss_poison_step=3,
                                device="cpu"))
    finally:
        T.save_checkpoint, T.restore_checkpoint = save, restore
    assert res.rollbacks == 1 and sorted(res.losses) == [0, 1, 2, 4, 5]
    assert list(restored) == [2] and sorted(saved) == [2, 6]
    for k, t in saved[2].items():
        assert torch.equal(t, restored[2][k]), k


def test_resume_is_deterministic(tmp_path):
    """Stop at 8, resume to 12 == one uninterrupted 12-step run."""
    ck = str(tmp_path / "ckpt")
    kw = dict(arch=ARCH, seq_len=32, global_batch=4, device="cpu")
    train(TrainConfig(steps=8, checkpoint_dir=ck, checkpoint_every=8,
                      **kw))
    resumed = train(TrainConfig(steps=12, checkpoint_dir=ck,
                                checkpoint_every=8, **kw))
    uninterrupted = train(TrainConfig(steps=12, **kw))
    assert sorted(resumed.losses) == list(range(8, 12))
    for s in range(8, 12):
        np.testing.assert_allclose(resumed.losses[s],
                                   uninterrupted.losses[s],
                                   rtol=1e-5, atol=1e-6)


def test_serving_after_training_records_no_graph(ref_state):
    cfg = get_smoke_config(ARCH)
    res = train(TrainConfig(arch=ARCH, steps=2, seq_len=8, global_batch=2,
                            device="cpu"), state=_port_state(ref_state))
    model = res.params
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(np.arange(10).reshape(2, 5))
    logits = S.make_prefill_step(cfg)(model, {"tokens": tokens})
    assert logits.grad_fn is None and not logits.requires_grad
    cache = TM.init_decode_cache(cfg, 2, 8, device="cpu")
    out, cache = S.make_serve_step(cfg)(model, cache, {"token":
                                                       tokens[:, :1],
                                                       "pos": 0})
    assert out.grad_fn is None and not out.requires_grad
    assert cache["segments"][0]["k"].grad_fn is None
    want = TM.prefill_step(model, cfg, {"tokens": tokens[:, :1]})
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_train_takes_a_step_of_a_moe_config():
    res = train(TrainConfig(arch="olmoe_1b_7b", steps=1, seq_len=8,
                            global_batch=2, device="cpu"))
    assert res.final_step == 1 and np.isfinite(res.losses[0])
    assert int(res.opt_state.step) == 1
    assert "blocks.0.moe.router" in dict(res.params.named_parameters())


def test_cli_trains_on_the_cpu(capsys, tmp_path):
    main(["--steps", "3", "--seq-len", "8", "--global-batch", "2",
          "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("steps=3 first_loss=") and "rollbacks=0" in out


def test_example_trains_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" / "train_lm.py"),
         "--preset", "smoke", "--steps", "12", "--seq-len", "32",
         "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.rstrip().endswith("OK")


def test_importing_the_training_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.train, repro_torch.launch.steps, "
            "repro_torch.optim.adamw, repro_torch.optim.schedule, "
            "repro_torch.optim.compression, repro_torch.data.pipeline, "
            "repro_torch.convert, repro_torch.kernels.flash_attention, "
            "repro_torch.checkpoint.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "assert not bad")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
