"""The LM's serving steps: prefill, and one decode step against a cache.

Port of the dense parts of ``repro.models.model``.  The decode cache keeps
the reference's layout, ``{"segments": [{"k", "v"}]}`` with tensors of
shape ``(L, B, S_max, KV, hd)``.  Where the reference returns a new cache,
``serve_step`` writes the token's K/V into the given one in place and
returns it: PyTorch tensors are mutable, and a copy of the cache per
token would double its memory traffic.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models.attention import (KVCache, cache_update,
                                          decode_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (DenseLM, _dtype, _logits, _mlp,
                                            _norm_apply, _project_qkv,
                                            check_dense, forward,
                                            segment_plan)

__all__ = ["init_decode_cache", "prefill_step", "serve_step"]


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device=None) -> Dict[str, Any]:
    """Zero-initialized decode cache on ``device`` (default CUDA)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"segments": [
        {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
         "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}
        for _kind, _n in segment_plan(cfg)]}


def prefill_step(params: DenseLM, cfg: ModelConfig, batch) -> torch.Tensor:
    """Inference prefill: forward logits for the full prompt
    ``batch["tokens"]`` (B, S); its attention is the flash kernel."""
    return forward(params, cfg, batch["tokens"])


def _decode_dense_segment(x, blocks, kc, vc, cfg: ModelConfig, pos: int):
    """Decode over the dense layers; kc/vc (L, B, S, KV, hd), written in
    place at ``pos``."""
    positions = torch.full((1, 1), pos, device=x.device)
    for layer, lp in enumerate(blocks):
        xin = _norm_apply(x, lp["ln1"], cfg)
        q, k, v = _project_qkv(xin, lp["attn"], cfg, positions)
        cache = cache_update(KVCache(kc[layer], vc[layer]), k, v, pos)
        attn = decode_attention(q, cache, pos + 1)
        x = x + attn.reshape(*x.shape[:2], -1) @ lp["attn"]["wo"]
        x = x + _mlp(_norm_apply(x, lp["ln2"], cfg), lp["mlp"], cfg)
    return x


def serve_step(params: DenseLM, cfg: ModelConfig, cache, batch
               ) -> Tuple[torch.Tensor, Any]:
    """One decode step: new token ``batch["token"]`` (B, 1) at position
    ``batch["pos"]``; returns (logits (B, 1, Vp), cache), the cache
    updated in place."""
    check_dense(cfg)
    pos = int(batch["pos"])
    token = torch.as_tensor(batch["token"], device=params.device).long()
    x = params.embed[token]                                # (B, 1, D)
    seg = cache["segments"][0]
    x = _decode_dense_segment(x, params.blocks, seg["k"], seg["v"], cfg, pos)
    return _logits(x, params, cfg), cache
