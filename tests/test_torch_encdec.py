"""The port's encdec family (``whisper_small``) against the reference's, on
the CPU, at the smoke config (f32).

The reference's parameters (from a JAX key) are carried across by
``convert.lm_params_from_numpy``, so both packages compute from the same
weights; the stub audio frames are the same numpy array in both.  Covered:
the forward logits (encoder with full attention, decoder with causal
self-attention and full cross-attention over the frames),
``encode_for_decode``'s cross K/V, ``serve_step`` token by token (logits
and cache), decode against prefill, ``generate`` on the reference's stub
audio, one train step (loss rtol 1e-5; gradients, moments and updated
parameters at ``GRAD_TOL``, the updated parameters masked where Adam's
first step is ill-conditioned, |g| < 10 eps, as
``tests/test_torch_train.py`` masks them at 2 eps: ROADMAP Queue C, C10),
the weight-decay mask on every leaf, and a
training checkpoint under the reference's manifest names that the
reference restores.  Bar elsewhere: rtol/atol 1e-5.  The JAX side runs
once, in module fixtures.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint.checkpoint import save_checkpoint as ref_save
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import pipeline as RP
from repro.launch.serve import ServeConfig as RefServeConfig
from repro.launch.serve import generate as ref_generate
from repro.launch.steps import init_train_state as ref_init_train_state
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import model as RM
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import loss_fn as ref_loss_fn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 reference_key, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import pipeline as TP
from repro_torch.launch import steps as S
from repro_torch.launch import train as T
from repro_torch.launch.serve import ServeConfig, generate
from repro_torch.models import model as TM
from repro_torch.models.transformer import forward

ARCH = "whisper_small"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, T_TOK = 2, 9


def _close(got, want, **tol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), **tol), got, want)


def _data(ref=False):
    cfg = dict(vocab_size=256, seq_len=T_TOK, global_batch=B)
    if ref:
        return RP.SyntheticLM(RP.DataConfig(**cfg))
    return TP.SyntheticLM(TP.DataConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke state and every result the tests hold the
    port to, computed once."""
    cfg = ref_smoke_config(ARCH)
    # each reference call jitted whole: one compile instead of one per op
    params, opt = jax.jit(ref_init_train_state, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, T_TOK)).astype(np.int32)
    audio = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
             * 0.02).astype(np.float32)
    out = {"cfg": cfg, "state": jax.tree.map(np.asarray, (params, opt)),
           "tokens": tokens, "audio": audio}
    out["logits"] = np.asarray(jax.jit(
        lambda p, t, a: ref_forward(p, cfg, t, audio_embeds=a))(
            params, jnp.asarray(tokens), jnp.asarray(audio)))
    cross = jax.jit(lambda p, a: RM.encode_for_decode(p, cfg, a))(
        params, jnp.asarray(audio))
    out["cross"] = jax.tree.map(np.asarray, cross)
    cache = RM.init_decode_cache(cfg, B, T_TOK)
    cache["cross"] = cross
    step = jax.jit(lambda p, c, bt: RM.serve_step(p, cfg, c, bt))
    steps = []
    for pos in range(T_TOK):
        lg, cache = step(params, cache, {"token": tokens[:, pos:pos + 1],
                                         "pos": jnp.asarray(pos, jnp.int32)})
        steps.append(np.asarray(lg[:, 0]))
    out["decode"] = np.stack(steps, axis=1)
    out["decode_cache"] = jax.tree.map(np.asarray, cache["segments"][0])
    # generate on the reference's own stub audio (drawn from PRNGKey(seed))
    out["gen_audio"] = np.asarray((jax.random.normal(
        jax.random.PRNGKey(0), (B, cfg.encoder_seq, cfg.d_model))
        * 0.02).astype(jnp.float32))
    out["generate"] = ref_generate(RefServeConfig(arch=ARCH,
                                                  max_new_tokens=4),
                                   tokens[:, :4], params=params)
    # one train step from the reference's state on the synthetic batch
    batch = _data(ref=True).batch(0)
    batch["audio_embeds"] = jnp.asarray(audio)
    step = ref_make_train_step(cfg, lambda s: jnp.asarray(1e-3, jnp.float32))
    (loss, grads), (new_p, new_o, metrics) = jax.jit(lambda p, o, b: (
        jax.value_and_grad(lambda q: ref_loss_fn(q, cfg, b))(p),
        step(p, o, b)))(params, opt, batch)
    out["train"] = (float(loss), jax.tree.map(np.asarray, (
        grads, new_p, new_o, metrics)))
    return out


@pytest.fixture(scope="module")
def port(ref):
    return lm_params_from_numpy(ref["state"][0], get_smoke_config(ARCH),
                                device="cpu")


def test_forward_logits_match_the_reference(ref, port):
    got = forward(port, get_smoke_config(ARCH), ref["tokens"],
                  audio_embeds=torch.from_numpy(ref["audio"]))
    np.testing.assert_allclose(got.numpy(), ref["logits"], **TOL)
    assert lm_params_to_numpy(port, ref["cfg"]).keys() == \
        ref["state"][0].keys()
    _close(lm_params_to_numpy(port, ref["cfg"]), ref["state"][0],
           rtol=0, atol=0)


def test_encode_for_decode_cross_kv(ref, port):
    cfg = get_smoke_config(ARCH)
    got = TM.encode_for_decode(port, cfg, torch.from_numpy(ref["audio"]))
    assert set(got) == {"k", "v"}
    for n in ("k", "v"):
        assert tuple(got[n].shape) == ref["cross"][n].shape == (
            cfg.num_layers, B, cfg.encoder_seq, cfg.num_kv_heads,
            cfg.resolved_head_dim)
        np.testing.assert_allclose(got[n].numpy(), ref["cross"][n], **TOL)


def _decode(port, cfg, tokens, audio):
    cache = TM.init_decode_cache(cfg, B, tokens.shape[1], device="cpu")
    cache["cross"] = TM.encode_for_decode(port, cfg, torch.from_numpy(audio))
    steps = []
    for pos in range(tokens.shape[1]):
        lg, cache = TM.serve_step(port, cfg, cache, {
            "token": torch.from_numpy(tokens[:, pos:pos + 1]), "pos": pos})
        steps.append(lg[:, 0])
    return torch.stack(steps, dim=1).numpy(), cache


def test_serve_step_token_by_token(ref, port):
    cfg = get_smoke_config(ARCH)
    got, cache = _decode(port, cfg, ref["tokens"], ref["audio"])
    np.testing.assert_allclose(got, ref["decode"], **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache["segments"][0][n].numpy(),
                                   ref["decode_cache"][n], **TOL)
    with pytest.raises(IndexError):         # C6: no clamping past the end
        TM.serve_step(port, cfg, cache, {
            "token": torch.zeros((B, 1), dtype=torch.long), "pos": T_TOK})


def test_decode_matches_prefill(ref, port):
    cfg = get_smoke_config(ARCH)
    got, _ = _decode(port, cfg, ref["tokens"], ref["audio"])
    want = TM.prefill_step(port, cfg, {
        "tokens": ref["tokens"],
        "audio_embeds": torch.from_numpy(ref["audio"])})
    np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_generate_on_the_reference_audio(ref, port):
    want = ref["generate"]
    got = generate(ServeConfig(arch=ARCH, max_new_tokens=4),
                   ref["tokens"][:, :4], params=port,
                   audio_embeds=torch.tensor(ref["gen_audio"]))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], **TOL)
    # the port's own stub audio: seeded, so two runs are equal
    again = [generate(ServeConfig(arch=ARCH, max_new_tokens=2),
                      ref["tokens"][:, :3], params=port) for _ in range(2)]
    np.testing.assert_array_equal(again[0]["tokens"], again[1]["tokens"])


def test_train_step_matches_the_reference(ref):
    ref_loss, (rgrads, rparams, ropt, rmetrics) = ref["train"]
    cfg = get_smoke_config(ARCH)
    model, opt = train_state_from_numpy(*ref["state"], cfg, device="cpu")
    batch = _data().batch(0)
    batch["audio_embeds"] = torch.from_numpy(ref["audio"])
    loss, grads = S.loss_and_grads(model, cfg, batch)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    mine = lm_params_to_numpy(grads, cfg)
    _close(mine, rgrads, **GRAD_TOL)
    model, opt, metrics = S.make_train_step(
        cfg, lambda s: torch.tensor(1e-3))(model, opt, batch)
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               rmetrics["grad_norm"], rtol=1e-5)
    pn, on = train_state_to_numpy(model, opt, cfg)
    _close(on.m, ropt.m, **GRAD_TOL)
    _close(on.v, ropt.v, **GRAD_TOL)
    assert int(on.step) == int(ropt.step) == 1

    # C10: Adam's first step moves a weight by lr * g / (|g| + eps), so a
    # gradient difference inside the gradients' atol turns into a large
    # parameter difference where |g| is a few eps (here one at |g| 6.2e-8,
    # the two gradients 3.5% apart, the step's weights 7.2e-6 apart);
    # the entries with |g| < 7 eps where the gradients differ are left
    # out, at most 60 of the model's 2.5 million (53 here; 16 of them
    # below test_torch_train's 2 eps)
    def conditioned(got, want, g, g_mine):
        skip = (np.abs(g) < 7e-8) & (g_mine != g)
        np.testing.assert_allclose(got[~skip], want[~skip], **GRAD_TOL)
        return int(skip.sum())

    skipped = jax.tree.leaves(jax.tree.map(conditioned, pn, rparams, rgrads,
                                           mine))
    assert sum(skipped) <= 60


def test_decay_mask_is_the_reference_rank_rule_on_every_leaf(ref, port):
    """The reference decays each of its leaves of rank >= 2; its layer
    stacks (decoder and encoder) carry a leading L axis."""
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                ref["state"][0])[0]}
    model = lm_params_from_numpy(ref["state"][0], get_smoke_config(ARCH),
                                 device="cpu")
    mask = S.decay_mask(model)
    assert len(mask) == len(list(model.parameters()))
    seen = set()
    for name, decayed in mask.items():
        key, _ = reference_key(name)
        seen.add(key)
        assert decayed == (flat[key].ndim >= 2), name
    assert seen == set(flat)
    assert mask["encoder.blocks.0.ln1.scale"] and mask["encoder.pos"]
    assert not mask["encoder.final_norm.scale"]
    assert mask["dec_pos"] and mask["blocks.1.ln3.bias"]


def test_checkpoint_under_the_reference_manifest_names(ref, tmp_path):
    """Two train steps with a checkpoint at step 2: its manifest lists the
    reference's key paths, shapes and dtypes (those of the reference's own
    train-state checkpoint), the reference restores it into its template
    bitwise the port's state, and the port's rollback restore gives the
    same bits back."""
    cfg = get_smoke_config(ARCH)
    res = T.train(T.TrainConfig(arch=ARCH, steps=2, seq_len=8,
                                global_batch=B, checkpoint_dir=str(
                                    tmp_path / "port"),
                                checkpoint_every=2, device="cpu"),
                  state=train_state_from_numpy(*ref["state"], cfg,
                                               device="cpu"))
    assert sorted(res.losses) == [0, 1] and res.final_step == 2
    ref_save(str(tmp_path / "ref"), 2, ref["state"])

    def manifest(d):
        with open(os.path.join(d, "step_0000000002", "MANIFEST.json")) as f:
            return {k: (v["shape"], v["dtype"])
                    for k, v in json.load(f)["keys"].items()}

    mine, theirs = manifest(tmp_path / "port"), manifest(tmp_path / "ref")
    assert mine == theirs
    assert "0/encoder/stack/attn/wq" in mine and "1/m/dec_pos" in mine
    (rp, ro), _ = ref_restore(str(tmp_path / "port"), 2, ref["state"])
    want = train_state_to_numpy(res.params, res.opt_state, cfg)
    _close((rp, ro.m, ro.v), (want[0], want[1].m, want[1].v), rtol=0,
           atol=0)
    assert int(ro.step) == 2
    fresh, opt = train_state_from_numpy(*ref["state"], cfg, device="cpu")
    opt = T._restore(str(tmp_path / "port"), 2, fresh, opt)
    got = train_state_to_numpy(fresh, opt, cfg)
    _close((got[0], got[1].m, got[1].v), (want[0], want[1].m, want[1].v),
           rtol=0, atol=0)
    assert int(opt.step) == 2


def test_example_serves_on_the_cpu(capsys):
    import runpy
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples_torch" / \
        "serve_whisper.py"
    argv = sys.argv
    sys.argv = [str(path), "--device", "cpu", "--max-new-tokens", "3"]
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "generated (2, 11)" in out and out.rstrip().endswith("OK")
