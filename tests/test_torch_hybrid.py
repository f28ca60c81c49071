"""The port's hybrid family (``zamba2_1_2b``: Mamba2 layers with one shared
attention+MLP block every ``shared_attn_every`` of them) and the segment
plans of the ssm and hybrid families, against the reference's, on the CPU.

The Mamba2 block (prefill, then decode from its state), the segment plans
at several depths, then ``zamba2_1_2b`` at its smoke config (f32):
logits, ``serve_step`` (a K/V cache per shared-attention site) and a train
step (``tests/torch_lm_families.py``), its decode cache's specs, and
``train`` of both families moving their loss, as the reference's
``test_training_other_families``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

from torch_lm_families import check_cache_specs, family

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "zamba2_1_2b"


def test_mamba2_block_prefill_then_decode_matches_the_reference():
    """Prefill of 6 tokens, then 4 decode steps from its state (the SSD
    state and the conv history), on both sides; the decode equals the
    whole prefill (the reference's own bar, 2e-4, for that)."""
    cfg = ref_smoke_config(ARCH)
    tcfg = get_smoke_config(ARCH)
    pn = family(ARCH).state_np[0]
    lp_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), pn["segments"][0])
    lp = {k: (torch.from_numpy(np.array(v[0])) if not isinstance(v, dict)
              else {kk: torch.from_numpy(np.array(vv[0]))
                    for kk, vv in v.items()})
          for k, v in pn["segments"][0].items()}
    x = np.random.default_rng(5).standard_normal((2, 10, cfg.d_model)) \
        .astype(np.float32)
    want_full, _ = RS.mamba2_block(jnp.asarray(x), lp_ref, cfg)
    full, _ = TS.mamba2_block(torch.from_numpy(x), lp, tcfg)
    np.testing.assert_allclose(full.numpy(), np.asarray(want_full), **TOL)
    y, st = TS.mamba2_block(torch.from_numpy(x[:, :6]), lp, tcfg)
    _, rst = RS.mamba2_block(jnp.asarray(x[:, :6]), lp_ref, cfg)
    steps = [y]
    for t in range(6, 10):
        y, st = TS.mamba2_block(torch.from_numpy(x[:, t:t + 1]), lp, tcfg,
                                st, decode=True)
        ry, rst = RS.mamba2_block(jnp.asarray(x[:, t:t + 1]), lp_ref, cfg,
                                  rst, decode=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
        steps.append(y)
    np.testing.assert_allclose(st.ssd.s.numpy(), np.asarray(rst.ssd.s), **TOL)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(rst.conv), **TOL)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("family_name", ["ssm", "hybrid"])
def test_segment_plans_match_the_reference(family_name):
    """Every depth 1-20 and every period 0-5 (0: none), and the published
    configs; ``init_params`` builds one stack per layer segment and none
    at a shared-attention site."""
    arch = "xlstm_1_3b" if family_name == "ssm" else ARCH
    field = "slstm_every" if family_name == "ssm" else "shared_attn_every"
    for layers in range(1, 21):
        for every in range(6):
            kw = {"num_layers": layers, field: every}
            assert TT.segment_plan(get_smoke_config(arch).replace(**kw)) == \
                RT.segment_plan(ref_smoke_config(arch).replace(**kw))
    assert TT.segment_plan(get_config(arch)) == \
        RT.segment_plan(ref_get_config(arch))
    cfg = get_smoke_config(arch).replace(num_layers=7)
    model = TT.init_params(cfg, device="cpu")
    plan = TT.segment_plan(cfg)
    assert [len(s) for s in model.segments] == [
        0 if kind == "shared_attn" else n for kind, n in plan]
    assert (model.shared_attn is not None) == (family_name == "hybrid")


def test_configs_and_param_counts_match_the_reference():
    for arch in ("xlstm_1_3b", ARCH):
        for mine, ref in ((get_config(arch), ref_get_config(arch)),
                          (get_smoke_config(arch), ref_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        # the smoke model's leaves: the reference's key paths and shapes
        cfg = get_smoke_config(arch)
        model = TT.init_params(cfg, device="cpu")
        ref = jax.eval_shape(lambda k: RT.init_params(k, ref_smoke_config(
            arch)), jax.random.PRNGKey(0))
        from repro_torch.convert import lm_params_to_numpy
        mine = lm_params_to_numpy(model, cfg)
        assert jax.tree.structure(mine) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            assert a.shape == b.shape


def test_logits_match_the_reference():
    family(ARCH).check_logits()


def test_serve_step_matches_the_reference():
    family(ARCH).check_serve_step()


def test_train_step_matches_the_reference():
    family(ARCH).check_train_step()


def test_decode_cache_specs_match_the_reference():
    check_cache_specs(ARCH)


@pytest.mark.parametrize("arch", ["xlstm_1_3b", ARCH])
def test_training_other_families_moves_the_loss(arch):
    res = train(TrainConfig(arch=arch, steps=8, seq_len=32, global_batch=4,
                            peak_lr=1e-2, warmup_steps=2, device="cpu"))
    vals = [res.losses[s] for s in sorted(res.losses)]
    assert len(vals) == 8 and all(np.isfinite(v) for v in vals), arch
    assert vals[-1] < vals[0], arch
