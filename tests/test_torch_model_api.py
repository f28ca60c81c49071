"""The port's model API (``repro_torch.models.model``: ``input_specs``,
``make_batch``, ``decode_cache_specs``, ``init_decode_cache``) against the
reference's, on the CPU.

For a dense (``smollm_360m``), an encdec (``whisper_small``) and a vlm
(``llava_next_34b``) architecture, at the smoke and the published
configs, and for a train, a prefill and a decode shape: every input spec
and every decode-cache entry has the reference's name, shape and dtype
(the port's are ``meta`` tensors where the reference's are
``ShapeDtypeStruct``s).  ``make_batch`` draws real tensors of those specs
from a ``torch.Generator``: equal for equal seeds, other draws for
another seed.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as RM
from repro.models.config import ShapeConfig as RefShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.config import ShapeConfig

ARCHS = ["smollm_360m", "whisper_small", "llava_next_34b"]
SHAPES = [("smoke_train", 16, 2, "train"), ("smoke_prefill", 12, 3,
                                            "prefill"),
          ("smoke_decode", 32, 2, "decode")]


def _spec_pairs(mine, ref):
    """[(key path, port meta tensor, reference ShapeDtypeStruct)]."""
    flat_ref = {jax.tree_util.keystr(p): s for p, s in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_mine = {jax.tree_util.keystr(p): t for p, t in
                 jax.tree_util.tree_flatten_with_path(
                     mine, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    assert flat_mine.keys() == flat_ref.keys()
    return [(k, flat_mine[k], flat_ref[k]) for k in flat_ref]


def _same(t, s, key):
    assert t.device.type == "meta", key
    assert tuple(t.shape) == tuple(s.shape), key
    assert str(t.dtype).removeprefix("torch.") == str(s.dtype), key


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, smoke):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    rcfg = (ref_smoke_config if smoke else ref_get_config)(arch)
    for shape in SHAPES:
        for key, t, s in _spec_pairs(
                TM.input_specs(cfg, ShapeConfig(*shape)),
                RM.input_specs(rcfg, RefShapeConfig(*shape))):
            _same(t, s, (arch, shape, key))
    for key, t, s in _spec_pairs(TM.decode_cache_specs(cfg, 2, 24),
                                 RM.decode_cache_specs(rcfg, 2, 24)):
        _same(t, s, (arch, key))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_cache_is_zeros_of_the_specs(arch):
    cfg = get_smoke_config(arch)
    cache = TM.init_decode_cache(cfg, 2, 24, device="cpu")
    specs = TM.decode_cache_specs(cfg, 2, 24)
    assert set(cache) == set(specs) == (
        {"segments", "cross"} if arch == "whisper_small" else {"segments"})
    for got, spec in zip(jax.tree.leaves(cache), jax.tree.leaves(specs)):
        assert got.shape == spec.shape and got.dtype == spec.dtype
        assert not got.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_is_seeded(arch):
    cfg = get_smoke_config(arch)

    def batch(kind, seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return TM.make_batch(cfg, ShapeConfig("s", 16, 2, kind), gen)

    for kind in ("train", "prefill", "decode"):
        a, b, c = batch(kind, 0), batch(kind, 0), batch(kind, 1)
        specs = TM.input_specs(cfg, ShapeConfig("s", 16, 2, kind))
        assert a.keys() == specs.keys()
        for name, spec in specs.items():
            assert a[name].shape == spec.shape, name
            assert a[name].dtype == spec.dtype, name
            assert torch.equal(a[name], b[name]), name
        if kind == "decode":
            assert int(a["pos"]) == 0
            continue
        assert 0 <= int(a["tokens"].min()) and \
            int(a["tokens"].max()) < min(cfg.vocab_size, 1000)
        assert not torch.equal(a["tokens"], c["tokens"])
        for name in ("audio_embeds", "patch_embeds"):
            if name in a:
                std = float(a[name].float().std())
                assert 0.015 < std < 0.025, (name, std)
                assert not torch.equal(a[name], c[name])
