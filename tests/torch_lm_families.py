"""Shared checks of the port's LM families against the reference, for the
``tests/test_torch_*.py`` files of the moe, ssm and hybrid families.

``Family(arch)`` runs the reference once per architecture (its smoke
config, f32, the parameters from ``jax.random.PRNGKey(0)``; every call
jitted whole) and carries its parameters and train state across with
``convert``, so the port computes from the same weights.  Bars, as the
dense family's (``tests/test_torch_lm.py``, ``tests/test_torch_train.py``):
logits and ``serve_step`` rtol/atol 1e-5, a train step's loss rtol 1e-5,
its gradients and AdamW's moments rtol 1e-4 / atol 1e-6.  In the ssm and
hybrid families the SSD's and sLSTM's f32 exponentials put a few entries
past those bars (ROADMAP C19): at most 0.1% of a leaf, each within 1e-5 of
the leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import pipeline as RP
from repro.launch.steps import init_train_state as ref_init_train_state
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import model as RM
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import loss_fn as ref_loss_fn
from repro.optim import adamw as RA
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (lm_params_to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import pipeline as TP
from repro_torch.launch import steps as S
from repro_torch.models import model as TM
from repro_torch.models.transformer import forward

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PROMPT = (2, 12)                 # prefill and decode: batch x tokens
SEQ, BATCH = 16, 2               # the train step's batch


#: ROADMAP C19: in the ssm and hybrid families a few entries of a result
#: (at most this share of a leaf) may lie past the bar, each within
#: C19_SCALE of the leaf's largest magnitude.
C19_SHARE, C19_SCALE = 1e-3, 1e-5


def _close_c19(a, b, rtol, atol):
    out = np.abs(a - b) > atol + rtol * np.abs(b)
    assert out.sum() <= C19_SHARE * out.size, (
        f"{out.sum()} of {out.size} entries past rtol {rtol} / atol {atol}")
    if out.any():
        worst = float(np.abs(a - b)[out].max())
        assert worst <= C19_SCALE * float(np.abs(b).max()), (
            f"{worst} past {C19_SCALE} of the leaf's scale "
            f"{float(np.abs(b).max())}")


def close(got, want, c19: bool = False, **tol):
    """Every leaf within ``tol``; with ``c19`` (the ssm and hybrid
    families) up to ``C19_SHARE`` of a leaf's entries past it, within
    ``C19_SCALE`` of the leaf's largest magnitude."""
    def one(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if c19:
            _close_c19(a, b, tol["rtol"], tol["atol"])
        else:
            np.testing.assert_allclose(a, b, **tol)
    jax.tree.map(one, got, want)


def data(ref: bool = False):
    cfg = dict(vocab_size=256, seq_len=SEQ, global_batch=BATCH)
    if ref:
        return RP.SyntheticLM(RP.DataConfig(**cfg))
    return TP.SyntheticLM(TP.DataConfig(**cfg), device="cpu")


class Family:
    """The reference's results for one architecture's smoke config, computed
    once: forward logits, token-by-token ``serve_step`` logits and the
    cache after them, and one train step (loss, gradients, AdamW's new
    state and metrics)."""

    def __init__(self, arch: str):
        self.arch = arch
        self.ref_cfg = ref_smoke_config(arch)
        self.cfg = get_smoke_config(arch)
        self.c19 = self.cfg.family in ("ssm", "hybrid")
        cfg = self.ref_cfg
        state = ref_init_train_state(jax.random.PRNGKey(0), cfg)
        self.state_np = jax.tree.map(np.asarray, state)
        params = state[0]
        self.tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, PROMPT).astype(np.int32)
        self.logits = np.asarray(jax.jit(
            lambda p, t: ref_forward(p, cfg, t))(params,
                                                 jnp.asarray(self.tokens)))
        step = jax.jit(lambda p, c, b: RM.serve_step(p, cfg, c, b))
        cache = RM.init_decode_cache(cfg, PROMPT[0], PROMPT[1])
        steps = []
        for pos in range(PROMPT[1]):
            lg, cache = step(params, cache, {
                "token": jnp.asarray(self.tokens[:, pos:pos + 1]),
                "pos": jnp.asarray(pos, jnp.int32)})
            steps.append(np.asarray(lg[:, 0]))
        self.decode_logits = np.stack(steps, axis=1)
        self.cache = jax.tree.map(np.asarray, cache)
        batch = data(ref=True).batch(0)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_loss_fn(p, cfg, b)))(params, batch)
        _, new_o, metrics = jax.jit(ref_make_train_step(
            cfg, lambda s: jnp.asarray(1e-3, jnp.float32)))(
            params, state[1], batch)
        self.loss = float(loss)
        self.grads, self.new_opt, self.metrics = jax.tree.map(
            np.asarray, (grads, new_o, metrics))

    def port_state(self):
        pn, on = self.state_np
        return train_state_from_numpy(pn, on, self.cfg, device="cpu")

    # -- the checks ---------------------------------------------------------

    def check_logits(self):
        model, _ = self.port_state()
        with torch.no_grad():
            got = forward(model, self.cfg, torch.from_numpy(self.tokens))
        assert got.shape == self.logits.shape
        close(got.numpy(), self.logits, self.c19, **TOL)

    def check_serve_step(self):
        """Token by token from a zero cache: each step's logits and the
        final cache (every segment's state or K/V) as the reference's."""
        model, _ = self.port_state()
        cache = TM.init_decode_cache(self.cfg, *PROMPT, device="cpu")
        steps = []
        for pos in range(PROMPT[1]):
            lg, cache = TM.serve_step(model, self.cfg, cache, {
                "token": torch.from_numpy(self.tokens[:, pos:pos + 1]),
                "pos": pos})
            steps.append(lg[:, 0].numpy())
        close(np.stack(steps, axis=1), self.decode_logits, self.c19, **TOL)
        got = jax.tree.map(lambda t: t.numpy(), cache,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert jax.tree.structure(got) == jax.tree.structure(self.cache)
        close(got, self.cache, self.c19, **TOL)

    def check_train_step(self):
        """Loss, gradients, the clipped norm and AdamW's moments of one
        step, as the reference's; the updated parameters as the
        reference's AdamW makes them from the port's gradients."""
        cfg = self.cfg
        model, opt = self.port_state()
        batch = data().batch(0)
        loss, grads = S.loss_and_grads(model, cfg, batch)
        np.testing.assert_allclose(float(loss), self.loss, rtol=1e-5)
        mine = lm_params_to_numpy(grads, cfg)
        close(mine, self.grads, self.c19, **GRAD_TOL)
        step = S.make_train_step(cfg, lambda s: torch.tensor(1e-3))
        model, opt, metrics = step(model, opt, batch)
        np.testing.assert_allclose(float(metrics["loss"]), self.loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   self.metrics["grad_norm"], rtol=1e-5)
        pn, on = train_state_to_numpy(model, opt, cfg)
        close(on.m, self.new_opt.m, self.c19, **GRAD_TOL)
        close(on.v, self.new_opt.v, self.c19, **GRAD_TOL)
        assert int(on.step) == int(self.new_opt.step) == 1

        # The parameters: the reference's AdamW on the port's own gradients
        # gives the port's values, to f32 rounding.  (Against the
        # reference's whole step they are not conditioned: Adam's first
        # step moves a weight by lr * g / (|g| + eps), which turns a
        # gradient difference at small |g| into a large one; ROADMAP C10.)
        pn0, on0 = self.state_np
        want, _ = jax.jit(lambda g, o, p: RA.adamw_update(
            RA.clip_by_global_norm(g, 1.0)[0], o, p, lr=1e-3))(
            mine, on0, pn0)
        close(pn, jax.tree.map(np.asarray, want), rtol=1e-6, atol=1e-9)


_FAMILIES = {}


def family(arch: str) -> Family:
    """The reference's results for ``arch``, once per process."""
    if arch not in _FAMILIES:
        _FAMILIES[arch] = Family(arch)
    return _FAMILIES[arch]


def spec_pairs(mine, ref):
    """[(key path, port meta tensor, reference ShapeDtypeStruct)], with the
    same key paths on both sides."""
    flat_ref = {jax.tree_util.keystr(p): s for p, s in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_mine = {jax.tree_util.keystr(p): t for p, t in
                 jax.tree_util.tree_flatten_with_path(
                     mine, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    assert flat_mine.keys() == flat_ref.keys()
    return [(k, flat_mine[k], flat_ref[k]) for k in flat_ref]


def check_cache_specs(arch: str):
    """``decode_cache_specs`` and ``init_decode_cache`` at the smoke and
    the published configs: the reference's names, shapes and dtypes, and
    the sLSTM's starting values."""
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    for mine_cfg, ref_cfg, b, s in (
            (get_smoke_config(arch), ref_smoke_config(arch), 2, 16),
            (get_config(arch), ref_get_config(arch), 3, 4096)):
        for key, t, sds in spec_pairs(TM.decode_cache_specs(mine_cfg, b, s),
                                      RM.decode_cache_specs(ref_cfg, b, s)):
            assert t.device.type == "meta", key
            assert tuple(t.shape) == tuple(sds.shape), key
            assert str(t.dtype).removeprefix("torch.") == str(sds.dtype), key
    got = TM.init_decode_cache(get_smoke_config(arch), 2, 16, device="cpu")
    want = RM.init_decode_cache(ref_smoke_config(arch), 2, 16)
    for key, t, a in spec_pairs(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=key)
