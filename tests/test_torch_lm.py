"""The port's dense LM (``repro_torch.models``, ``launch.serve.generate``)
against the reference's, on the CPU.

The four dense architectures run at their smoke configs (f32).  The
reference draws its parameters from a JAX key; they are carried across
as numpy arrays by ``lm_params_from_numpy``, so both packages compute
from the same weights.  Bar: rtol/atol 1e-5 (both compute in f32; the
products, the chunked against the one-pass softmax and the rotary tables,
which the port builds in f64 and rounds, sum or round in other places, a
few float32 ulps apart).  Greedy tokens must be equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch.serve import ServeConfig as RefServeConfig
from repro.launch.serve import generate as ref_generate
from repro.models import layers as rlayers
from repro.models import model as RM
from repro.models.config import model_flops as ref_model_flops
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_params as ref_init_params
from repro_torch.configs import (ARCH_IDS, DENSE_ARCH_IDS, get_config,
                                 get_smoke_config)
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig, SHAPES, model_flops
from repro_torch.models.transformer import forward, init_params

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)

_PARAMS = {}


def _params(arch, dtype="float32"):
    """(reference params, port DenseLM, cfg) of an arch's smoke config,
    built once per module."""
    if (arch, dtype) not in _PARAMS:
        cfg = ref_get_smoke_config(arch).replace(dtype=dtype)
        ref = ref_init_params(jax.random.PRNGKey(0), cfg)
        port = lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                    get_smoke_config(arch).replace(
                                        dtype=dtype), device="cpu")
        _PARAMS[arch, dtype] = (ref, port, cfg)
    return _PARAMS[arch, dtype]


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCH_IDS)
def test_configs_equal_the_reference(arch):
    for mine, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke_config(arch), ref_get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        for shape in SHAPES:
            assert model_flops(mine, shape) == ref_model_flops(ref, shape)


def test_smollm_width():
    cfg = get_config("smollm_360m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == (
        32, 960, 15, 5, 64, 2560, 49152)
    assert cfg.tie_embeddings and cfg.dtype == "bfloat16"
    assert 3.5e8 < cfg.param_count() < 3.7e8


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a not in DENSE_ARCH_IDS])
def test_other_families_raise(arch):
    for get in (get_config, get_smoke_config):
        with pytest.raises(NotImplementedError, match="Queue A 11"):
            get(arch)


def test_non_dense_config_is_refused_by_the_model():
    cfg = ModelConfig(name="moe", family="moe", num_layers=1, d_model=8,
                      num_heads=2, num_kv_heads=1, d_ff=16, vocab_size=32,
                      num_experts=2, experts_per_token=1, dtype="float32")
    for call in (lambda: init_params(cfg, device="cpu"),
                 lambda: forward(None, cfg, np.zeros((1, 2), np.int32)),
                 lambda: TM.serve_step(None, cfg, {}, {"token": None,
                                                       "pos": 0}),
                 lambda: TM.init_decode_cache(cfg, 1, 2, device="cpu")):
        with pytest.raises(NotImplementedError, match="Queue A 11"):
            call()
    with pytest.raises(KeyError):
        get_config("no_such_arch")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta,partial", [(10000.0, 1.0), (10000.0, 0.5),
                                           (1e6, 1.0)])
def test_rope_matches_reference(theta, partial):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1000, 1040), (2, 40))
    want = rlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                        partial=partial)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       theta=theta, partial=partial)
    # f32 rotation of f32-rounded tables against the x64 reference's f64
    # rotation: a few float32 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_norms_and_mlps_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    s, b = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    w1, w2 = (rng.standard_normal((12, 20)).astype(np.float32)
              for _ in range(2))
    w3 = rng.standard_normal((20, 12)).astype(np.float32)
    b1 = rng.standard_normal(20).astype(np.float32)
    j, t = (lambda *a: [jnp.asarray(v) for v in a],
            lambda *a: [torch.from_numpy(v) for v in a])
    for ref, mine in [
            (rlayers.rmsnorm(*j(x, s)), tlayers.rmsnorm(*t(x, s))),
            (rlayers.layernorm(*j(x, s, b)), tlayers.layernorm(*t(x, s, b))),
            (rlayers.mlp_swiglu(*j(x, w1, w2, w3)),
             tlayers.mlp_swiglu(*t(x, w1, w2, w3))),
            (rlayers.mlp_gelu(*j(x, w1, b1, w3, s)),
             tlayers.mlp_gelu(*t(x, w1, b1, w3, s)))]:
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)


def test_init_dense_scale_and_seed():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.init_dense(gen, (400, 300), dtype=torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (400, 300)
    assert abs(float(w.float().std()) - 400 ** -0.5) < 0.002
    again = tlayers.init_dense(torch.Generator().manual_seed(0), (400, 300),
                               dtype=torch.bfloat16)
    assert torch.equal(w, again)


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCH_IDS)
def test_lm_params_from_numpy_is_exact(arch):
    ref, port, cfg = _params(arch)
    assert len(port.blocks) == cfg.num_layers
    np.testing.assert_array_equal(port.embed.numpy(), np.asarray(ref["embed"]))
    stack = ref["segments"][0]
    for i, block in enumerate(port.blocks):
        for part, group in stack.items():
            for name, a in group.items():
                np.testing.assert_array_equal(block[part][name].numpy(),
                                              np.asarray(a[i]))
    assert (port.lm_head is None) == cfg.tie_embeddings
    assert not any(p.requires_grad for p in port.parameters())
    narrowed = lm_params_from_numpy(jax.tree.map(np.asarray, ref), cfg,
                                    device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in narrowed.parameters())
    assert torch.equal(narrowed.blocks[0]["attn"]["wq"],
                       port.blocks[0]["attn"]["wq"].to(torch.bfloat16))


@pytest.mark.parametrize("arch", DENSE_ARCH_IDS)
def test_forward_matches_reference(arch):
    ref, port, cfg = _params(arch)
    tokens = _tokens(cfg, (2, 16))
    want = ref_forward(ref, cfg, jnp.asarray(tokens))
    got = forward(port, cfg, tokens)
    assert tuple(got.shape) == (2, 16, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    prefill = TM.prefill_step(port, cfg, {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(prefill, got) and torch.equal(port(tokens), got)


@pytest.mark.parametrize("arch", DENSE_ARCH_IDS)
def test_serve_step_matches_reference(arch):
    """One decode step at position 5 against a cache already holding
    random K/V at positions 0..4: logits and the whole cache."""
    ref, port, cfg = _params(arch)
    rng = np.random.default_rng(3)
    shape = (cfg.num_layers, 2, 8, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck, cv = (np.zeros(shape, np.float32) for _ in range(2))
    ck[:, :, :5], cv[:, :, :5] = (rng.standard_normal(
        shape[:2] + (5,) + shape[3:]).astype(np.float32) for _ in range(2))
    token = _tokens(cfg, (2, 1), seed=4)
    want_logits, want_cache = RM.serve_step(
        ref, cfg, {"segments": [{"k": jnp.asarray(ck), "v": jnp.asarray(cv)}]},
        {"token": jnp.asarray(token), "pos": jnp.asarray(5, jnp.int32)})
    cache = TM.init_decode_cache(cfg, 2, 8, device="cpu")
    cache["segments"][0]["k"][:] = torch.from_numpy(ck)
    cache["segments"][0]["v"][:] = torch.from_numpy(cv)
    got_logits, got_cache = TM.serve_step(port, cfg, cache,
                                          {"token": token, "pos": 5})
    assert got_cache is cache
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            got_cache["segments"][0][name].numpy(),
            np.asarray(want_cache["segments"][0][name]), **TOL)


@pytest.mark.parametrize("pos", [8, 9])
def test_serve_step_past_the_cache_raises(pos):
    """A ``serve_step`` at ``pos >= max_seq`` raises ``IndexError`` and
    leaves the cache as it was; the reference's ``dynamic_update_slice``
    clamps the write instead and returns logits without a word (ROADMAP
    Queue C)."""
    ref, port, cfg = _params(DENSE_ARCH_IDS[0])
    rng = np.random.default_rng(7)
    shape = (cfg.num_layers, 2, 8, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    token = _tokens(cfg, (2, 1), seed=8)
    cache = TM.init_decode_cache(cfg, 2, 8, device="cpu")
    cache["segments"][0]["k"][:] = torch.from_numpy(ck)
    cache["segments"][0]["v"][:] = torch.from_numpy(cv)
    with pytest.raises(IndexError, match="do not fit"):
        TM.serve_step(port, cfg, cache, {"token": token, "pos": pos})
    assert np.array_equal(cache["segments"][0]["k"].numpy(), ck)
    assert np.array_equal(cache["segments"][0]["v"].numpy(), cv)
    logits, _ = RM.serve_step(
        ref, cfg, {"segments": [{"k": jnp.asarray(ck), "v": jnp.asarray(cv)}]},
        {"token": jnp.asarray(token), "pos": jnp.asarray(pos, jnp.int32)})
    assert np.all(np.isfinite(np.asarray(logits)))


@pytest.mark.parametrize("arch", DENSE_ARCH_IDS)
def test_generate_matches_reference(arch):
    ref, port, cfg = _params(arch)
    prompts = _tokens(cfg, (2, 5), seed=5)
    want = ref_generate(RefServeConfig(arch=arch, max_new_tokens=6), prompts,
                        params=ref)
    got = tserve.generate(tserve.ServeConfig(arch=arch, max_new_tokens=6),
                          prompts, params=port)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["logprobs"], np.asarray(want["logprobs"]),
                               **TOL)


@pytest.mark.parametrize("arch", DENSE_ARCH_IDS)
def test_decode_matches_prefill(arch):
    """Token-by-token ``serve_step`` logits equal ``prefill_step``'s (cache
    parity), the port alone: f32, the flash attention's one-pass softmax
    against ``decode_attention``'s, so the reference's 1e-5 bar holds."""
    _, port, cfg = _params(arch)
    tokens = _tokens(cfg, (2, 8), seed=6)
    want = TM.prefill_step(port, cfg, {"tokens": tokens})
    cache = TM.init_decode_cache(cfg, 2, 8, device="cpu")
    got = []
    for pos in range(8):
        logits, cache = TM.serve_step(port, cfg, cache,
                                      {"token": tokens[:, pos:pos + 1],
                                       "pos": pos})
        got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               **TOL)


def test_bf16_forward_near_the_reference():
    """smollm's smoke config in bf16, the same weights as the reference.
    The reference's attention rounds its scores and probabilities to bf16
    and the port's (the flash kernel's function) does not; every other op
    rounds to bf16 in both.  Bar: 2e-2 absolute, the reference flash
    kernel's own bf16 bar, on logits of magnitude below 1 (where a bf16
    ulp is at most 2**-8): the two differ by 0.008-0.011, two to three
    ulps, on three seeds."""
    ref, port, cfg = _params("smollm_360m", "bfloat16")
    assert port.embed.dtype == torch.bfloat16
    tokens = _tokens(cfg, (2, 16), seed=7)
    want = np.asarray(ref_forward(ref, cfg, jnp.asarray(tokens)), np.float32)
    got = forward(port, cfg, tokens)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_generate_with_temperature_is_seeded():
    _, port, cfg = _params("smollm_360m")
    prompts = _tokens(cfg, (2, 3), seed=8)
    sc = tserve.ServeConfig(max_new_tokens=5, temperature=0.8, seed=3)
    a = tserve.generate(sc, prompts, params=port)
    b = tserve.generate(sc, prompts, params=port)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 8) and np.all(a["logprobs"] <= 0)


def test_generate_inits_its_own_weights_on_the_device():
    prompts = np.zeros((1, 2), np.int32)
    out = tserve.generate(tserve.ServeConfig(max_new_tokens=2), prompts,
                          device="cpu")
    assert out["tokens"].shape == (1, 4)
    _, port, _ = _params("smollm_360m")
    with pytest.raises(ValueError):
        tserve.generate(tserve.ServeConfig(), prompts, params=port,
                        device="meta")


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--batch", "1", "--prompt-len", "2", "--max-new-tokens",
                 "2", "--device", "cpu"])
    assert "generated: (1, 4)" in capsys.readouterr().out


def test_prefill_makes_one_attention_call_per_layer():
    from repro_torch.kernels import hierarchize as H
    _, port, cfg = _params("chatglm3_6b")
    with H.record_calls() as calls:
        TM.prefill_step(port, cfg, {"tokens": _tokens(cfg, (1, 4))})
    assert [c[0] for c in calls] == [tflash.flash_attention] * cfg.num_layers


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm_360m")
    prompts = np.zeros((1, 2), np.int32)
    for call in (lambda: init_params(cfg),
                 lambda: TM.init_decode_cache(cfg, 1, 4),
                 lambda: tserve.generate(tserve.ServeConfig(), prompts),
                 lambda: lm_params_from_numpy({}, cfg, device=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_importing_the_lm_port_loads_no_jax():
    code = ("import sys, repro_torch.models.model, repro_torch.convert, "
            "repro_torch.launch.serve, repro_torch.kernels.flash_attention, "
            "repro_torch.configs.smollm_360m; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
