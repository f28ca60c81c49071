"""Attention: GQA prefill on the flash-attention kernel and a cached
single-token path for decode.

Port of ``repro.models.attention``.  ``attention_chunked`` is the
prefill's attention; the reference scans the keys in chunks with an
online softmax, and the port runs the same function as one call of
``kernels.flash_attention`` (the CUDA kernel of row 10 on the card, its
plain version on the CPU), so ``kv_chunk`` is accepted and has no effect.
One difference in bf16 follows: the reference rounds its scores, and the
probabilities before the value product, to bf16, where the flash kernel
(the reference's own and the port's) keeps both in f32.  In f32 the two
agree to rounding.

``decode_attention`` stays plain PyTorch, as the reference computes it
outside any kernel.  The port's cache is mutable: ``cache_update`` writes
the new token's K/V in place and returns the cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["attention_naive", "attention_chunked", "decode_attention",
           "cache_update", "KVCache"]


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, S_max, KV, hd)
    v: torch.Tensor         # (B, S_max, KV, hd)


def _expand_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*groups, hd) by repeat (GQA)."""
    return torch.repeat_interleave(x, groups, dim=2)


def attention_naive(q, k, v, *, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference attention. q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd)."""
    sq, h, hd = q.shape[1], q.shape[2], q.shape[3]
    k = _expand_kv(k, h // k.shape[2])
    v = _expand_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (hd ** 0.5)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(qi < ki, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention_chunked(q, k, v, *, causal: bool = True, q_offset: int = 0,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention: q (B, Sq, H, hd); k/v (B, Skv, KV, hd);
    H = KV * groups.  One ``flash_attention`` call; never forms the
    (Sq x Skv) scores on the card."""
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q, cache: KVCache, cache_len) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, hd); cache.k/v: (B, S_max, KV, hd); ``cache_len``: (B,) or
    scalar count of valid cache entries (the new token must already be
    written at position cache_len - 1)."""
    b, _, h, hd = q.shape
    kvh = cache.k.shape[2]
    qf = (q * hd ** -0.5).reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, cache.k).float()
    if not isinstance(cache_len, int):    # (B,) lengths; an int needs no copy
        cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(cache.k.shape[1], device=q.device)[None, :] < cache_len
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(cache.v.dtype), cache.v)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def cache_update(cache: KVCache, k_new, v_new, position: int) -> KVCache:
    """Write T tokens' K/V (B, T, KV, hd) at ``position``, in place."""
    t = k_new.shape[1]
    if not 0 <= position <= cache.k.shape[1] - t:
        raise IndexError(f"{t} tokens at position {position} do not fit the "
                         f"cache's {cache.k.shape[1]} slots")
    cache.k[:, position:position + t] = k_new.to(cache.k.dtype)
    cache.v[:, position:position + t] = v_new.to(cache.v.dtype)
    return cache
