"""The dense decoder: parameters as ``nn.Module``s and the forward pass.

Port of the dense parts of ``repro.models.transformer``.  ``DenseLM``
holds the embedding, the final norm, the LM head (unless tied) and an
``nn.ModuleList`` of ``DenseBlock``s; a block is an ``nn.ModuleDict`` of
``nn.ParameterDict``s with the reference's names (``attn``, ``ln1``,
``ln2``, ``mlp``), so ``p["attn"]["wq"]`` reads as in the reference.
Weights keep the reference's ``(d_in, d_out)`` layout, so every product
stays ``x @ w``, and ``lax.scan`` over the layer stack becomes a Python
loop.  The parameters take no gradient: this slice serves, and training
is a later one.

Only the dense family runs.  ``segment_plan``, ``forward`` and the
serving steps raise ``NotImplementedError`` for any other family (moe,
ssm, hybrid, encdec, vlm; ROADMAP.md, Queue A 11).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.attention import attention_chunked
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense, layernorm, rmsnorm, rope

__all__ = ["DenseBlock", "DenseLM", "segment_plan", "init_params", "forward",
           "check_dense"]


def check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name} is of the {cfg.family} family; the port runs only "
            f"the dense family yet (ROADMAP.md, Queue A 11)")


def segment_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(kind, n_layers) segments of the decoder stack."""
    check_dense(cfg)
    return [("dense", cfg.num_layers)]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_dict(tensors: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class DenseBlock(nn.ModuleDict):
    """One decoder layer's weights: ``attn`` (wq, wk, wv, wo, and bq, bk,
    bv with ``qkv_bias``, q_norm and k_norm with ``qk_norm``), ``ln1``,
    ``ln2`` and ``mlp`` (wi_gate, wi_up, wo; or wi, bi, wo, bo for gelu)."""

    def __init__(self, layer: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__({part: _param_dict(layer[part])
                          for part in ("attn", "ln1", "ln2", "mlp")})


class DenseLM(nn.Module):
    """The dense decoder's weights, in the reference's pytree layout with
    the layer stack split into ``blocks``.  Build one with ``init_params``
    (random, seeded) or ``repro_torch.convert.lm_params_from_numpy`` (the
    reference's values); it runs on the device its tensors lie on."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: Mapping[str, torch.Tensor],
                 layers: List[Mapping[str, Mapping[str, torch.Tensor]]],
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        check_dense(cfg)
        if len(layers) != cfg.num_layers:
            raise ValueError(f"{cfg.name} has {cfg.num_layers} layers, got "
                             f"{len(layers)}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: an LM head is needed exactly when "
                             f"the embeddings are not tied")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = _param_dict(final_norm)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        self.blocks = nn.ModuleList(DenseBlock(layer) for layer in layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, vocab_padded)."""
        return forward(self, self.cfg, tokens)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _attn_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, dt = cfg.num_heads, cfg.num_kv_heads, _dtype(cfg)
    p = {"wq": init_dense(gen, (d, h * hd), dtype=dt),
         "wk": init_dense(gen, (d, kv * hd), dtype=dt),
         "wv": init_dense(gen, (d, kv * hd), dtype=dt),
         "wo": init_dense(gen, (h * hd, d), dtype=dt)}
    zeros = lambda n: torch.zeros(n, dtype=dt, device=gen.device)
    if cfg.qkv_bias:
        p.update(bq=zeros(h * hd), bk=zeros(kv * hd), bv=zeros(kv * hd))
    if cfg.qk_norm:
        p.update(q_norm=torch.ones(hd, dtype=dt, device=gen.device),
                 k_norm=torch.ones(hd, dtype=dt, device=gen.device))
    return p


def _mlp_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, _dtype(cfg)
    if cfg.act == "silu":
        return {"wi_gate": init_dense(gen, (d, f), dtype=dt),
                "wi_up": init_dense(gen, (d, f), dtype=dt),
                "wo": init_dense(gen, (f, d), dtype=dt)}
    return {"wi": init_dense(gen, (d, f), dtype=dt),
            "bi": torch.zeros(f, dtype=dt, device=gen.device),
            "wo": init_dense(gen, (f, d), dtype=dt),
            "bo": torch.zeros(d, dtype=dt, device=gen.device)}


def _norm_params(cfg: ModelConfig, device) -> dict:
    d, dt = cfg.d_model, _dtype(cfg)
    p = {"scale": torch.ones(d, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dt, device=device)
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device=None) -> DenseLM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    on ``device`` (default CUDA): the reference's shapes, scales and types,
    not its numbers."""
    check_dense(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = _dtype(cfg)
    embed = init_dense(gen, (cfg.vocab_padded, cfg.d_model), scale=0.02,
                       dtype=dt)
    lm_head = None if cfg.tie_embeddings else init_dense(
        gen, (cfg.d_model, cfg.vocab_padded), dtype=dt)
    layers = [{"attn": _attn_params(gen, cfg), "ln1": _norm_params(cfg, device),
               "ln2": _norm_params(cfg, device), "mlp": _mlp_params(gen, cfg)}
              for _ in range(cfg.num_layers)]
    return DenseLM(cfg, embed, _norm_params(cfg, device), layers, lm_head)


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------

def _norm_apply(x, p, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def _project_qkv(x, p, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope:
        q = rope(q, positions, theta=cfg.rope_theta, partial=cfg.partial_rotary)
        k = rope(k, positions, theta=cfg.rope_theta, partial=cfg.partial_rotary)
    return q, k, v


def _self_attn(x, p, cfg: ModelConfig, positions, causal: bool = True):
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = attention_chunked(q, k, v, causal=causal,
                            kv_chunk=min(cfg.attn_chunk, max(128, s)))
    return out.reshape(b, s, -1) @ p["wo"]


def _mlp(x, p, cfg: ModelConfig):
    if cfg.act == "silu":
        return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]
    h = F.gelu(x @ p["wi"] + p["bi"], approximate="tanh")
    return h @ p["wo"] + p["bo"]


def _dense_block(x, p, cfg: ModelConfig, positions, causal: bool = True):
    x = x + _self_attn(_norm_apply(x, p["ln1"], cfg), p["attn"], cfg,
                       positions, causal)
    return x + _mlp(_norm_apply(x, p["ln2"], cfg), p["mlp"], cfg)


def _logits(x, params: DenseLM, cfg: ModelConfig):
    x = _norm_apply(x, params.final_norm, cfg)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


def forward(params: DenseLM, cfg: ModelConfig, tokens) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vp), on the device of ``params``."""
    check_dense(cfg)
    tokens = torch.as_tensor(tokens, device=params.device).long()
    x = params.embed[tokens]
    positions = torch.arange(tokens.shape[1], device=params.device)[None]
    for block in params.blocks:
        x = _dense_block(x, block, cfg, positions)
    return _logits(x, params, cfg)
