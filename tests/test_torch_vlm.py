"""The port's vlm family (``llava_next_34b``) against the reference's, on
the CPU, at the smoke config (f32; 4 query heads over 2 KV heads).

The reference's parameters are carried across by
``convert.lm_params_from_numpy`` and the stub patch embeddings are the
same numpy array in both packages.  Covered: the prefill with its patches
prepended (attention causal over patches and text, logits of the text
positions only), a decode step (the reference's ``test_vlm_decode_runs``,
and the port's steps against the reference's), and one train step's loss
(rtol 1e-5) and gradients (``GRAD_TOL``: rtol 1e-4 as the dense and
encdec files, atol 3e-6 where they have 1e-6, because on this batch the
reference's own f32 gradients of ``embed`` lie up to 3.0e-6 from its run
with f64 weights and inputs (the cross-entropy f32 in both), and the two
packages' f32 gradients 1.2e-6 apart in one entry).  Bar elsewhere: rtol/atol 1e-5.
The JAX side runs once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import pipeline as RP
from repro.launch.steps import init_train_state as ref_init_train_state
from repro.models import model as RM
from repro.models.transformer import loss_fn as ref_loss_fn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_to_numpy, train_state_from_numpy
from repro_torch.data import pipeline as TP
from repro_torch.launch import steps as S
from repro_torch.models import model as TM

ARCH = "llava_next_34b"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=3e-6)
B, T_TOK = 2, 7


@pytest.fixture(scope="module")
def ref():
    cfg = ref_smoke_config(ARCH)
    # each reference call jitted whole: one compile instead of one per op
    params, opt = jax.jit(ref_init_train_state, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, T_TOK)).astype(np.int32)
    patches = (rng.standard_normal((B, cfg.vision_patches, cfg.d_model))
               * 0.02).astype(np.float32)
    out = {"cfg": cfg, "state": jax.tree.map(np.asarray, (params, opt)),
           "tokens": tokens, "patches": patches}
    out["prefill"] = np.asarray(jax.jit(
        lambda p, b: RM.prefill_step(p, cfg, b))(params, {
            "tokens": jnp.asarray(tokens),
            "patch_embeds": jnp.asarray(patches)}))
    cache = RM.init_decode_cache(cfg, B, 8)
    serve = jax.jit(lambda p, c, b: RM.serve_step(p, cfg, c, b))
    steps = []
    for pos in range(3):
        lg, cache = serve(params, cache, {
            "token": jnp.asarray(tokens[:, pos:pos + 1]),
            "pos": jnp.asarray(pos, jnp.int32)})
        steps.append(np.asarray(lg))
    out["decode"] = steps
    batch = RP.SyntheticLM(RP.DataConfig(256, T_TOK, B)).batch(0)
    batch["patch_embeds"] = jnp.asarray(patches)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss_fn(p, cfg, b)))(params, batch)
    out["train"] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def model(ref):
    return train_state_from_numpy(*ref["state"], get_smoke_config(ARCH),
                                  device="cpu")[0]


def test_prefill_with_patches_keeps_the_text_logits(ref, model):
    cfg = get_smoke_config(ARCH)
    assert cfg.num_heads // cfg.num_kv_heads == 2
    got = TM.prefill_step(model, cfg, {
        "tokens": torch.from_numpy(ref["tokens"]),
        "patch_embeds": torch.from_numpy(ref["patches"])})
    assert tuple(got.shape) == (B, T_TOK, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), ref["prefill"], **TOL)
    with pytest.raises(ValueError, match="patch_embeds"):
        TM.prefill_step(model, cfg, {"tokens": ref["tokens"]})


def test_vlm_decode_runs(ref, model):
    """The reference's ``test_vlm_decode_runs``, and three steps against
    the reference's (text only: the patches are not in the cache)."""
    cfg = get_smoke_config(ARCH)
    cache = TM.init_decode_cache(cfg, B, 8, device="cpu")
    logits, _ = TM.serve_step(model, cfg, cache, {
        "token": torch.zeros((B, 1), dtype=torch.int32), "pos": 0})
    assert tuple(logits.shape) == (B, 1, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
    cache = TM.init_decode_cache(cfg, B, 8, device="cpu")
    for pos, want in enumerate(ref["decode"]):
        got, cache = TM.serve_step(model, cfg, cache, {
            "token": torch.from_numpy(ref["tokens"][:, pos:pos + 1]),
            "pos": pos})
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_train_step_matches_the_reference(ref, model):
    ref_loss, rgrads = ref["train"]
    cfg = get_smoke_config(ARCH)
    batch = TP.SyntheticLM(TP.DataConfig(256, T_TOK, B),
                           device="cpu").batch(0)
    batch["patch_embeds"] = torch.from_numpy(ref["patches"])
    loss, grads = S.loss_and_grads(model, cfg, batch)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **GRAD_TOL),
                 lm_params_to_numpy(grads, cfg), rgrads)
