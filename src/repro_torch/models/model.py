"""The LM's model API: input specs, seeded batches, decode caches, and the
serving steps (prefill, and one decode step against a cache).

Port of ``repro.models.model``, every family.  ``input_specs`` and
``decode_cache_specs`` return, where the reference returns
``jax.ShapeDtypeStruct``s, tensors on the ``meta`` device (a shape and a
dtype, no storage), name by name the reference's; ``make_batch`` draws
small real batches of those specs from a ``torch.Generator`` (the
reference's distributions, not its numbers).

The decode cache keeps the reference's layout, ``{"segments": [...]}``
with one entry per ``segment_plan`` segment: ``{"k", "v"}`` of shape
``(L, B, S_max, KV, hd)`` for a dense-kind segment and for each of the
hybrid's shared-attention sites (L = 1: the weights are shared, the cache
is per site), ``{"ssd", "conv"}`` for a Mamba2 segment (``(L, B, H, S,
P)`` float32 and ``(L, B, K-1, C)``), ``{"ssd"}`` for an mLSTM segment
(``(L, B*H, 1, hd, hd+1)`` float32) and ``{"c", "n", "m", "h"}`` for an
sLSTM (``(B, H, hd)`` float32, ``m`` starting at -1e9 and ``n`` at 1e-6);
for encdec a ``"cross"`` entry over the encoder's frames, filled once by
``encode_for_decode``.  Where the reference returns a new cache,
``serve_step`` writes the token's K/V and each recurrent layer's new state
into the given one in place and returns it: PyTorch tensors are mutable,
and a copy of the cache per token would double its memory traffic.  A
step past the cache's end raises (``attention.cache_update``; the
reference clamps, ROADMAP Queue C, C6).  The steps run under
``torch.inference_mode()``: they record no autograd graph, also on a
model whose parameters take gradients (one that trains).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models.attention import (KVCache, cache_update,
                                          decode_attention)
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.transformer import (LM, _cross_project, _dtype,
                                            _ffn, _logits, _mamba_block,
                                            _mlp, _mlstm_block,
                                            _norm_apply, _project_qkv,
                                            _run_encoder, _slstm_block,
                                            check_family, forward,
                                            segment_plan)

__all__ = ["input_specs", "make_batch", "decode_cache_specs",
           "init_decode_cache", "encode_for_decode", "prefill_step",
           "serve_step"]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, batch: int) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.family == "encdec":
        out["audio_embeds"] = _spec((batch, cfg.encoder_seq, cfg.d_model),
                                    torch.bfloat16)
    if cfg.family == "vlm":
        out["patch_embeds"] = _spec((batch, cfg.vision_patches, cfg.d_model),
                                    torch.bfloat16)
    return out


def input_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Every model input of ``shape``'s kind as a ``meta`` tensor: tokens
    (and labels) int32, the stub frontends' embeddings bf16; decode takes
    only the token and its position (the modality prefix already lies in
    the cache)."""
    check_family(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _spec((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _spec((b, s), torch.int32)
        specs.update(_frontend_specs(cfg, b))
        return specs
    if shape.kind == "decode":
        return {"token": _spec((b, 1), torch.int32),
                "pos": _spec((), torch.int32)}
    raise ValueError(shape.kind)


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Real tensors of ``input_specs`` on the generator's device: tokens
    uniform in [0, min(vocab, 1000)), the position 0, embeddings normal
    times 0.02."""
    device = generator.device
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype == torch.int32 and spec.dim():
            out[name] = torch.randint(0, min(cfg.vocab_size, 1000),
                                      tuple(spec.shape), generator=generator,
                                      device=device, dtype=torch.int32)
        elif spec.dtype == torch.int32:
            out[name] = torch.zeros((), dtype=torch.int32, device=device)
        else:
            out[name] = (torch.randn(tuple(spec.shape), generator=generator,
                                     device=device) * 0.02).to(spec.dtype)
    return out


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def _kv_specs(cfg: ModelConfig, n_layers: int, batch: int, seq: int):
    shape = (n_layers, batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": _spec(shape, _dtype(cfg)), "v": _spec(shape, _dtype(cfg))}


def _segment_specs(cfg: ModelConfig, kind: str, n: int, batch: int,
                   max_seq: int) -> Dict[str, torch.Tensor]:
    f32 = torch.float32
    if kind == "mamba":
        di, s, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        return {"ssd": _spec((n, batch, nh, s, di // nh), f32),
                "conv": _spec((n, batch, cfg.ssm_conv - 1, di + 2 * s),
                              _dtype(cfg))}
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if kind == "mlstm":
        return {"ssd": _spec((n, batch * h, 1, hd, hd + 1), f32)}
    if kind == "slstm":
        return {name: _spec((batch, h, hd), f32) for name in "cnmh"}
    # dense, or a shared-attention site: its own K/V (L = 1)
    return _kv_specs(cfg, n, batch, max_seq)


def decode_cache_specs(cfg: ModelConfig, batch: int,
                       max_seq: int) -> Dict[str, Any]:
    """The decode cache as ``meta`` tensors (mirrors ``init_decode_cache``):
    one entry per segment (the module docstring) and, for encdec,
    ``"cross"`` over the encoder's ``encoder_seq`` frames."""
    cache: Dict[str, Any] = {"segments": [
        _segment_specs(cfg, kind, n, batch, max_seq)
        for kind, n in segment_plan(cfg)]}
    if cfg.family == "encdec":
        cache["cross"] = _kv_specs(cfg, cfg.num_layers, batch,
                                   cfg.encoder_seq)
    return cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device=None) -> Dict[str, Any]:
    """Zero-initialized decode cache on ``device`` (default CUDA); an
    sLSTM's stabilizer ``m`` starts at -1e9 and its normalizer ``n`` at
    1e-6, as the reference's."""
    device = resolve_device(device)

    def zeros(node):
        if isinstance(node, torch.Tensor):
            return torch.zeros(node.shape, dtype=node.dtype, device=device)
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        return [zeros(v) for v in node]

    cache = zeros(decode_cache_specs(cfg, batch, max_seq))
    for (kind, _n), seg in zip(segment_plan(cfg), cache["segments"]):
        if kind == "slstm":
            seg["m"] -= 1e9
            seg["n"] += 1e-6
    return cache


@torch.inference_mode()
def encode_for_decode(params: LM, cfg: ModelConfig,
                      audio_embeds) -> Dict[str, torch.Tensor]:
    """Encdec only: run the encoder once and precompute every decoder
    layer's cross K/V, ``{"k", "v"}`` of shape (L, B, encoder_seq, KV, hd)
    in the model's type (the fixed part of the decode cache)."""
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name} is not an encdec model")
    enc_out = _run_encoder(params, cfg, audio_embeds)
    dt = _dtype(cfg)
    kvs = [_cross_project(enc_out, block["cross"], cfg)
           for block in params.blocks]
    return {"k": torch.stack([k.to(dt) for k, _ in kvs]),
            "v": torch.stack([v.to(dt) for _, v in kvs])}


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill_step(params: LM, cfg: ModelConfig, batch) -> torch.Tensor:
    """Inference prefill: forward logits for the full prompt
    ``batch["tokens"]`` (B, S), with the stub frontends' ``audio_embeds``
    or ``patch_embeds``; its attention is the flash kernel."""
    return forward(params, cfg, batch["tokens"],
                   audio_embeds=batch.get("audio_embeds"),
                   patch_embeds=batch.get("patch_embeds"))


def _self_attn_step(x, lp, kc, vc, cfg: ModelConfig, pos: int, positions):
    """One token's self-attention sublayer against one layer's cache, the
    token's K/V written in place at ``pos``."""
    xin = _norm_apply(x, lp["ln1"], cfg)
    q, k, v = _project_qkv(xin, lp["attn"], cfg, positions)
    cache = cache_update(KVCache(kc, vc), k, v, pos)
    attn = decode_attention(q, cache, pos + 1)
    return x + attn.reshape(*x.shape[:2], -1) @ lp["attn"]["wo"]


def _decode_dense_segment(x, blocks, kc, vc, cfg: ModelConfig, pos: int):
    """Decode over the dense layers; kc/vc (L, B, S, KV, hd), written in
    place at ``pos``."""
    positions = torch.full((1, 1), pos, device=x.device)
    for layer, lp in enumerate(blocks):
        x = _self_attn_step(x, lp, kc[layer], vc[layer], cfg, pos, positions)
        x = x + _ffn(_norm_apply(x, lp["ln2"], cfg), lp, cfg)
    return x


def _decode_mamba_segment(x, layers, st, cfg: ModelConfig):
    """Decode over a Mamba2 segment; st["ssd"], st["conv"] (L, ...) take
    each layer's new state in place."""
    for layer, lp in enumerate(layers):
        x, new = _mamba_block(x, lp, cfg, ssm.Mamba2State(
            ssm.SSDState(st["ssd"][layer]), st["conv"][layer]), decode=True)
        st["ssd"][layer].copy_(new.ssd.s)
        st["conv"][layer].copy_(new.conv)
    return x


def _decode_mlstm_segment(x, layers, st, cfg: ModelConfig):
    """Decode over an mLSTM segment; st["ssd"] (L, B*H, 1, hd, hd+1)
    takes each layer's new state in place."""
    for layer, lp in enumerate(layers):
        x, new = _mlstm_block(x, lp, cfg, ssm.SSDState(st["ssd"][layer]),
                              decode=True)
        st["ssd"][layer].copy_(new.s)
    return x


def _decode_slstm(x, lp, st, cfg: ModelConfig):
    """One token through an sLSTM; st's c, n, m, h take the new state."""
    x, new = _slstm_block(x, lp, cfg, ssm.SLSTMState(
        st["c"], st["n"], st["m"], st["h"]))
    for name, t in zip("cnmh", new):
        st[name].copy_(t)
    return x


def _decode_shared_attn(x, p, st, cfg: ModelConfig, pos: int):
    """One token through the hybrid's shared block against this site's
    K/V (1, B, S, KV, hd), written in place at ``pos``."""
    positions = torch.full((1, 1), pos, device=x.device)
    x = _self_attn_step(x, p, st["k"][0], st["v"][0], cfg, pos, positions)
    return x + _mlp(_norm_apply(x, p["ln2"], cfg), p["mlp"], cfg)


def _decode_cross_segment(x, blocks, kc, vc, cross_k, cross_v,
                          cfg: ModelConfig, pos: int):
    """Decode over the encdec decoder's layers: self-attention against
    kc/vc (written in place at ``pos``), cross-attention over every frame
    of the fixed cross_k/cross_v (L, B, S_enc, KV, hd), the MLP."""
    positions = torch.full((1, 1), pos, device=x.device)
    b, hd, hh = x.shape[0], cfg.resolved_head_dim, cfg.num_heads
    for layer, lp in enumerate(blocks):
        x = _self_attn_step(x, lp, kc[layer], vc[layer], cfg, pos, positions)
        hin = _norm_apply(x, lp["ln3"], cfg)
        qx = (hin @ lp["cross"]["wq"]).reshape(b, 1, hh, hd)
        ck, cv = cross_k[layer], cross_v[layer]
        attn = decode_attention(qx, KVCache(ck, cv), ck.shape[1])
        x = x + attn.reshape(b, 1, -1) @ lp["cross"]["wo"]
        x = x + _mlp(_norm_apply(x, lp["ln2"], cfg), lp["mlp"], cfg)
    return x


@torch.inference_mode()
def serve_step(params: LM, cfg: ModelConfig, cache, batch
               ) -> Tuple[torch.Tensor, Any]:
    """One decode step: new token ``batch["token"]`` (B, 1) at position
    ``batch["pos"]``; returns (logits (B, 1, Vp), cache), the cache
    updated in place.  An encdec cache must hold ``"cross"``
    (``encode_for_decode``)."""
    plan = segment_plan(cfg)
    pos = int(batch["pos"])
    token = torch.as_tensor(batch["token"], device=params.device).long()
    x = params.embed[token]                                # (B, 1, D)
    seg = cache["segments"][0]
    if cfg.family == "encdec":
        x = x + params.dec_pos[pos][None, None]
        x = _decode_cross_segment(x, params.blocks, seg["k"], seg["v"],
                                  cache["cross"]["k"], cache["cross"]["v"],
                                  cfg, pos)
    elif params.segments is None:
        x = _decode_dense_segment(x, params.blocks, seg["k"], seg["v"], cfg,
                                  pos)
    else:
        for (kind, _n), layers, st in zip(plan, params.segments,
                                          cache["segments"]):
            if kind == "mamba":
                x = _decode_mamba_segment(x, layers, st, cfg)
            elif kind == "mlstm":
                x = _decode_mlstm_segment(x, layers, st, cfg)
            elif kind == "slstm":
                x = _decode_slstm(x, layers[0], st, cfg)
            else:                                       # shared_attn
                x = _decode_shared_attn(x, params.shared_attn, st, cfg, pos)
    return _logits(x, params, cfg), cache
