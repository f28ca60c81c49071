"""The decoder LM and its encoder: parameters as ``nn.Module``s and the
forward pass.

Port of ``repro.models.transformer``, every family: dense, moe, encdec,
vlm, ssm and hybrid.  ``LM`` holds the embedding, the final norm, the LM
head (unless tied) and the decoder's layers.  The single-segment
families (dense, moe, encdec, vlm) keep them in ``blocks``, an
``nn.ModuleList`` of ``DenseBlock``s: ``nn.ModuleDict``s of
``nn.ParameterDict``s with the reference's names (``attn``, ``ln1``,
``ln2``, and ``mlp`` or, for moe, ``moe``: the router (D, E) in f32 and
the experts' ``wi_gate``/``wi_up`` (E, D, F) and ``wo`` (E, F, D)), so
``p["attn"]["wq"]`` reads as in the reference.  The encdec family
(``whisper_small``) decodes with ``CrossBlock``s (a ``DenseBlock`` plus
``cross``, its cross-attention projections, and ``ln3``) over an
``Encoder`` (``pos``, a positional table over the stub audio frames,
``blocks`` of ``DenseBlock``s run with full attention, ``final_norm``),
and adds ``dec_pos`` (32768 x d) to the token embeddings; the vlm family
(``llava_next_34b``) prepends the stub patch embeddings to the text and
keeps the text positions' logits.  The ssm (``xlstm_1_3b``: mLSTM
layers with an sLSTM every ``slstm_every``-th) and hybrid
(``zamba2_1_2b``: Mamba2 layers with one shared attention+MLP block every
``shared_attn_every`` of them, its weights shared and its cache per site)
families keep ``segments``, one ``nn.ModuleList`` of ``LayerParams`` per
segment of ``segment_plan`` (empty for a shared-attention site), and the
hybrid's ``shared_attn`` (a ``DenseBlock``).  Weights keep the
reference's ``(d_in, d_out)`` layout, so every product stays ``x @ w``,
and ``lax.scan`` over a layer stack becomes a Python loop.  The
parameters are made with ``requires_grad=False``: serving needs no graph.
Training (``repro_torch.launch.steps.init_train_state``) turns gradients
on for its own state; ``forward`` then runs each layer of a stack, of the
encoder as of the decoder, under the reference's rematerialisation
(``cfg.remat``, ``cfg.remat_policy``): ``"full"`` is
``torch.utils.checkpoint`` (non-reentrant), ``"dots"`` selective
checkpointing that saves the 2-D matrix products (the projections:
``checkpoint_dots_with_no_batch_dims``; attention's batched products are
recomputed), ``"none"`` the plain forward; the sLSTM and shared-attention
blocks run plain, as the reference's do.  ``loss_fn`` is the mean token
cross-entropy of the logits (the moe's aux loss is dropped there, as in
the reference).  A moe layer's FFN is ``models.moe``: expert-parallel
(``moe_ffn_ep``) under an ambient mesh with a ``"model"`` axis
(``core.mesh.use_mesh``) when ``cfg.moe_impl == "ep"``, else, or where
that returns None, ``moe_ffn`` with the config's ``moe_impl``.

A family the reference does not know is refused (``ValueError``, as the
reference's ``segment_plan`` raises).
"""

from __future__ import annotations

import functools
from typing import List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch import resolve_device
from repro_torch.models import ssm
from repro_torch.models.attention import attention_chunked
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cross_entropy, init_dense, layernorm,
                                      rmsnorm, rope)
from repro_torch.models.moe import moe_ffn, moe_ffn_ep

__all__ = ["DenseBlock", "CrossBlock", "Encoder", "LayerParams", "LM",
           "FAMILIES", "segment_plan", "init_params", "forward",
           "runs_family", "check_family", "loss_fn", "reference_rank"]

#: The families the port runs (``configs`` admits an architecture by its
#: config's family): all of the reference's.
FAMILIES = ("dense", "encdec", "vlm", "moe", "ssm", "hybrid")

#: The families whose decoder is a list of segments of several kinds.
SEGMENTED = ("ssm", "hybrid")

#: Rows of the decoder's positional table (the reference's).
DEC_POS_ROWS = 32768


def runs_family(cfg: ModelConfig) -> bool:
    return cfg.family in FAMILIES


def check_family(cfg: ModelConfig) -> None:
    """Refuse a family the reference does not know (its ``segment_plan``
    raises ``ValueError(cfg.family)``)."""
    if not runs_family(cfg):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"families are {', '.join(FAMILIES)}")


def segment_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(kind, n_layers) segments of the decoder stack."""
    check_family(cfg)
    if cfg.family not in SEGMENTED:
        return [("dense", cfg.num_layers)]
    plan, i = [], 0
    if cfg.family == "ssm":                      # xLSTM: sLSTM every k-th
        k = cfg.slstm_every or (cfg.num_layers + 1)
        while i < cfg.num_layers:
            n_m = min(k - 1, cfg.num_layers - i)
            if n_m:
                plan.append(("mlstm", n_m))
                i += n_m
            if i < cfg.num_layers:
                plan.append(("slstm", 1))
                i += 1
        return plan
    k = cfg.shared_attn_every or (cfg.num_layers + 1)   # zamba2: shared
    while i < cfg.num_layers:                            # attn every k
        n_m = min(k, cfg.num_layers - i)
        plan.append(("mamba", n_m))
        i += n_m
        if i < cfg.num_layers:
            plan.append(("shared_attn", 1))
    return plan


def has_shared_attn(cfg: ModelConfig) -> bool:
    """Whether the model holds ``shared_attn`` (the reference builds it for
    every hybrid config with ``shared_attn_every``, used or not)."""
    return cfg.family == "hybrid" and bool(cfg.shared_attn_every)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_dict(tensors: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class DenseBlock(nn.ModuleDict):
    """One decoder layer's weights: ``attn`` (wq, wk, wv, wo, and bq, bk,
    bv with ``qkv_bias``, q_norm and k_norm with ``qk_norm``), ``ln1``,
    ``ln2`` and ``mlp`` (wi_gate, wi_up, wo; or wi, bi, wo, bo for gelu)
    or, in a moe layer, ``moe`` (router, wi_gate, wi_up, wo)."""

    PARTS = ("attn", "ln1", "ln2", "mlp")

    def __init__(self, layer: Mapping[str, Mapping[str, torch.Tensor]]):
        parts = ["moe" if part == "mlp" and "moe" in layer else part
                 for part in self.PARTS]
        super().__init__({part: _param_dict(layer[part]) for part in parts})


class CrossBlock(DenseBlock):
    """An encdec decoder layer: a ``DenseBlock`` plus ``cross`` (the
    cross-attention's projections, shaped as ``attn``) and ``ln3``."""

    PARTS = DenseBlock.PARTS + ("cross", "ln3")


class Encoder(nn.Module):
    """The encdec encoder: ``pos`` (encoder_seq, d), ``blocks`` (one
    ``DenseBlock`` a layer, run with full attention) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, pos: torch.Tensor,
                 layers: List[Mapping[str, Mapping[str, torch.Tensor]]],
                 final_norm: Mapping[str, torch.Tensor]):
        super().__init__()
        if len(layers) != cfg.encoder_layers:
            raise ValueError(f"{cfg.name} has {cfg.encoder_layers} encoder "
                             f"layers, got {len(layers)}")
        self.pos = nn.Parameter(pos, requires_grad=False)
        self.blocks = nn.ModuleList(DenseBlock(layer) for layer in layers)
        self.final_norm = _param_dict(final_norm)


class LayerParams(nn.Module):
    """One mamba, mLSTM or sLSTM layer's weights in the reference's
    layout: a tensor leaf a parameter (``in_proj``, ``A_log``, ``r``, ...),
    a mapping leaf a ``ParameterDict`` (``ln``); ``p["in_proj"]`` and
    ``p["ln"]["scale"]`` read as in the reference."""

    def __init__(self, layer: Mapping[str, object]):
        super().__init__()
        for name, leaf in layer.items():
            if isinstance(leaf, Mapping):
                setattr(self, name, _param_dict(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


class LM(nn.Module):
    """The LM's weights, in the reference's pytree layout with each layer
    stack split per layer: the decoder's ``blocks`` (``CrossBlock``s for
    the encdec family) or, for ssm and hybrid, ``segments`` (one
    ``nn.ModuleList`` of ``LayerParams`` per ``segment_plan`` segment,
    empty for a shared-attention site) and the hybrid's ``shared_attn``;
    for encdec, ``encoder`` and ``dec_pos``.  ``layers`` lists every
    decoder layer in order (a shared-attention site takes none).  Build
    one with ``init_params`` (random, seeded) or
    ``repro_torch.convert.lm_params_from_numpy`` (the reference's values);
    it runs on the device its tensors lie on."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: Mapping[str, torch.Tensor],
                 layers: List[Mapping[str, object]],
                 lm_head: Optional[torch.Tensor] = None, *,
                 encoder: Optional[Encoder] = None,
                 dec_pos: Optional[torch.Tensor] = None,
                 shared_attn: Optional[Mapping[str, Mapping[
                     str, torch.Tensor]]] = None):
        super().__init__()
        plan = segment_plan(cfg)
        if len(layers) != cfg.num_layers:
            raise ValueError(f"{cfg.name} has {cfg.num_layers} layers, got "
                             f"{len(layers)}")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: an LM head is needed exactly when "
                             f"the embeddings are not tied")
        encdec = cfg.family == "encdec"
        if (encoder is not None, dec_pos is not None) != (encdec, encdec):
            raise ValueError(f"{cfg.name}: an encoder and dec_pos are needed "
                             f"exactly for the encdec family")
        if (shared_attn is not None) != has_shared_attn(cfg):
            raise ValueError(f"{cfg.name}: shared_attn is needed exactly for "
                             f"a hybrid config with shared_attn_every")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = _param_dict(final_norm)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        self.blocks = self.segments = None
        if cfg.family in SEGMENTED:
            segments, i = [], 0
            for kind, n in plan:
                n = 0 if kind == "shared_attn" else n
                segments.append(nn.ModuleList(
                    LayerParams(layer) for layer in layers[i:i + n]))
                i += n
            self.segments = nn.ModuleList(segments)
        else:
            block = CrossBlock if encdec else DenseBlock
            self.blocks = nn.ModuleList(block(layer) for layer in layers)
        self.shared_attn = (None if shared_attn is None
                            else DenseBlock(shared_attn))
        self.encoder = encoder
        self.dec_pos = (None if dec_pos is None
                        else nn.Parameter(dec_pos, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, *, audio_embeds=None,
                patch_embeds=None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, vocab_padded)."""
        return forward(self, self.cfg, tokens, audio_embeds=audio_embeds,
                       patch_embeds=patch_embeds)


def reference_rank(name: str, p: torch.Tensor) -> int:
    """The rank of the reference's leaf that holds ``LM`` parameter
    ``name``: the reference stacks each layer stack's leaves along a
    leading L axis, so a per-layer tensor (``blocks.<i>.*``,
    ``segments.<s>.<i>.*``, ``encoder.blocks.<i>.*``) is one rank short
    of its reference leaf (a norm scale of shape (d,) is the reference's
    (L, d); an sLSTM segment is a stack of one).  The hybrid's
    ``shared_attn`` is not stacked."""
    stacked = name.startswith(("blocks.", "segments.", "encoder.blocks."))
    return p.ndim + 1 if stacked else p.ndim


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


def _moe_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    e, d, f, dt = cfg.num_experts, cfg.d_model, cfg.d_ff, _dtype(cfg)
    return {"router": init_dense(gen, (d, e), dtype=torch.float32),
            "wi_gate": init_dense(gen, (e, d, f), scale=d ** -0.5, dtype=dt),
            "wi_up": init_dense(gen, (e, d, f), scale=d ** -0.5, dtype=dt),
            "wo": init_dense(gen, (e, f, d), scale=f ** -0.5, dtype=dt)}


def _layer_params(gen: torch.Generator, cfg: ModelConfig, device,
                  cross: bool = False) -> dict:
    p = {"attn": _attn_params(gen, cfg), "ln1": _norm_params(cfg, device),
         "ln2": _norm_params(cfg, device)}
    if cfg.is_moe:
        p["moe"] = _moe_params(gen, cfg)
    else:
        p["mlp"] = _mlp_params(gen, cfg)
    if cross:
        p.update(cross=_attn_params(gen, cfg), ln3=_norm_params(cfg, device))
    return p


def _mamba_layer_params(gen: torch.Generator, cfg: ModelConfig,
                        device) -> dict:
    d, di, s, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    dt, f32 = _dtype(cfg), torch.float32
    return {"in_proj": init_dense(gen, (d, 2 * di + 2 * s + nh), dtype=dt),
            "conv_w": init_dense(gen, (cfg.ssm_conv, di + 2 * s), scale=0.5,
                                 dtype=dt),
            "A_log": torch.zeros(nh, dtype=f32, device=device),
            "D": torch.ones(nh, dtype=f32, device=device),
            "dt_bias": torch.zeros(nh, dtype=f32, device=device),
            "norm": torch.ones(di, dtype=dt, device=device),
            "out_proj": init_dense(gen, (di, d), dtype=dt),
            "ln": _norm_params(cfg, device)}


def _mlstm_layer_params(gen: torch.Generator, cfg: ModelConfig,
                        device) -> dict:
    d, h, hd, dt = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, \
        _dtype(cfg)
    return {"wq": init_dense(gen, (d, h * hd), dtype=dt),
            "wk": init_dense(gen, (d, h * hd), dtype=dt),
            "wv": init_dense(gen, (d, h * hd), dtype=dt),
            "w_gates": init_dense(gen, (d, 2 * h), dtype=dt),
            "w_ogate": init_dense(gen, (d, h * hd), dtype=dt),
            "wo": init_dense(gen, (h * hd, d), dtype=dt),
            "ln": _norm_params(cfg, device)}


def _slstm_layer_params(gen: torch.Generator, cfg: ModelConfig,
                        device) -> dict:
    d, h, hd, dt = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, \
        _dtype(cfg)
    return {"w_in": init_dense(gen, (d, h * 4 * hd), dtype=dt),
            "r": init_dense(gen, (h, hd, 4, hd), scale=hd ** -0.5, dtype=dt),
            "wo": init_dense(gen, (h * hd, d), dtype=dt),
            "ln": _norm_params(cfg, device)}


def _shared_attn_params(gen: torch.Generator, cfg: ModelConfig,
                        device) -> dict:
    return {"attn": _attn_params(gen, cfg), "mlp": _mlp_params(gen, cfg),
            "ln1": _norm_params(cfg, device),
            "ln2": _norm_params(cfg, device)}


_LAYER_BUILDERS = {"mamba": _mamba_layer_params,
                   "mlstm": _mlstm_layer_params,
                   "slstm": _slstm_layer_params}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device=None) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    on ``device`` (default CUDA): the reference's shapes, scales and types,
    not its numbers."""
    plan = segment_plan(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = _dtype(cfg)
    encdec = cfg.family == "encdec"
    embed = init_dense(gen, (cfg.vocab_padded, cfg.d_model), scale=0.02,
                       dtype=dt)
    lm_head = None if cfg.tie_embeddings else init_dense(
        gen, (cfg.d_model, cfg.vocab_padded), dtype=dt)
    if cfg.family in SEGMENTED:
        layers = [_LAYER_BUILDERS[kind](gen, cfg, device)
                  for kind, n in plan if kind != "shared_attn"
                  for _ in range(n)]
    else:
        layers = [_layer_params(gen, cfg, device, cross=encdec)
                  for _ in range(cfg.num_layers)]
    shared = (_shared_attn_params(gen, cfg, device)
              if has_shared_attn(cfg) else None)
    encoder = dec_pos = None
    if encdec:
        encoder = Encoder(
            cfg, init_dense(gen, (cfg.encoder_seq, cfg.d_model), scale=0.02,
                            dtype=dt),
            [_layer_params(gen, cfg, device)
             for _ in range(cfg.encoder_layers)],
            _norm_params(cfg, device))
        dec_pos = init_dense(gen, (DEC_POS_ROWS, cfg.d_model), scale=0.02,
                             dtype=dt)
    return LM(cfg, embed, _norm_params(cfg, device), layers, lm_head,
              encoder=encoder, dec_pos=dec_pos, shared_attn=shared)


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


def _moe(h, p, cfg: ModelConfig):
    """A moe layer's FFN on (B, S, D): expert-parallel under the ambient
    mesh when the config asks for it and the mesh allows it, else
    ``moe_ffn`` with the config's ``moe_impl`` (the aux loss dropped)."""
    b, s, d = h.shape
    if cfg.moe_impl == "ep":
        out = moe_ffn_ep(h, p, num_experts=cfg.num_experts,
                         k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor)
        if out is not None:
            return out[0]
    y, _aux = moe_ffn(h.reshape(b * s, d), p, num_experts=cfg.num_experts,
                      k=cfg.experts_per_token, impl=cfg.moe_impl,
                      capacity_factor=cfg.capacity_factor)
    return y.reshape(b, s, d)


def _ffn(h, p, cfg: ModelConfig):
    """A dense-kind layer's FFN sublayer: the experts or the MLP."""
    return _moe(h, p["moe"], cfg) if cfg.is_moe else _mlp(h, p["mlp"], cfg)


def _dense_block(x, p, cfg: ModelConfig, positions, causal: bool = True):
    x = x + _self_attn(_norm_apply(x, p["ln1"], cfg), p["attn"], cfg,
                       positions, causal)
    return x + _ffn(_norm_apply(x, p["ln2"], cfg), p, cfg)


def _shared_attn_block(x, p, cfg: ModelConfig, positions):
    """The hybrid's shared attention+MLP block (causal)."""
    x = x + _self_attn(_norm_apply(x, p["ln1"], cfg), p["attn"], cfg,
                       positions, causal=True)
    return x + _mlp(_norm_apply(x, p["ln2"], cfg), p["mlp"], cfg)


def _mlstm_block(x, p, cfg: ModelConfig,
                 state: Optional[ssm.SSDState] = None, decode: bool = False):
    """mLSTM: linear attention with exp gates on the SSD core.

    The value vector is augmented with a constant 1-channel carrying the
    normalizer n_t; output h = (S q) / max(|n q|, 1).  Heads fold into the
    batch (one head a row: B_t = k_t, C_t = q_t).  ``state``: (B*H, 1, hd,
    hd + 1) f32."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    xin = _norm_apply(x, p["ln"], cfg)
    q = (xin @ p["wq"]).reshape(b, s, h, hd)
    k = (xin @ p["wk"]).reshape(b, s, h, hd) * (hd ** -0.5)
    v = (xin @ p["wv"]).reshape(b, s, h, hd)
    gates = (xin @ p["w_gates"]).reshape(b, s, 2, h).float()
    i_gate = torch.exp(torch.clamp(gates[:, :, 0], -10.0, 4.0))
    log_f = F.logsigmoid(gates[:, :, 1])
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)

    def fold(t, chan):       # (B, S, H, ...) -> (B*H, S, ...)
        return t.movedim(2, 1).reshape(b * h, s, *chan)

    args = (fold(v_aug, (1, hd + 1)), fold(log_f[..., None], (1,)),
            fold(i_gate[..., None], (1,)), fold(k, (hd,)), fold(q, (hd,)))
    st = state if state is not None else ssm.SSDState(torch.zeros(
        (b * h, 1, hd, hd + 1), dtype=torch.float32, device=x.device))
    y, new_st = (ssm.ssd_decode_step(*args, st) if decode else
                 ssm.ssd_chunked(*args, chunk=cfg.ssm_chunk, initial=st))
    y = y.reshape(b, h, s, hd + 1)
    num, den = y[..., :hd], y[..., hd]
    out = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    out = out.movedim(1, 2).reshape(b, s, h * hd).to(x.dtype)
    o_gate = torch.sigmoid(xin @ p["w_ogate"])
    return x + (out * o_gate) @ p["wo"], new_st


def _slstm_block(x, p, cfg: ModelConfig,
                 state: Optional[ssm.SLSTMState] = None):
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    gates = (_norm_apply(x, p["ln"], cfg) @ p["w_in"]).reshape(b, s, h, 4, hd)
    hseq, new_state = ssm.slstm_scan(gates, p["r"], state)
    return x + hseq.reshape(b, s, h * hd) @ p["wo"], new_state


def _mamba_block(x, p, cfg: ModelConfig,
                 state: Optional[ssm.Mamba2State] = None,
                 decode: bool = False):
    y, new_state = ssm.mamba2_block(_norm_apply(x, p["ln"], cfg), p, cfg,
                                    state, decode)
    return x + y, new_state


def _mamba_layer(x, p, cfg: ModelConfig, positions):
    return _mamba_block(x, p, cfg)[0]


def _mlstm_layer(x, p, cfg: ModelConfig, positions):
    return _mlstm_block(x, p, cfg)[0]


def _encoder_block(x, p, cfg: ModelConfig, positions):
    return _dense_block(x, p, cfg, positions, causal=False)


def _cross_project(enc_out, p, cfg: ModelConfig):
    """The cross-attention's K and V (B, S_enc, KV, hd) of the encoder's
    output, one layer's ``cross`` weights."""
    b, kv, hd = enc_out.shape[0], cfg.num_kv_heads, cfg.resolved_head_dim
    return ((enc_out @ p["wk"]).reshape(b, -1, kv, hd),
            (enc_out @ p["wv"]).reshape(b, -1, kv, hd))


def _cross_block(x, p, cfg: ModelConfig, positions, enc_out):
    """Self-attention (causal), cross-attention (full) over the encoder's
    output, then the MLP."""
    x = x + _self_attn(_norm_apply(x, p["ln1"], cfg), p["attn"], cfg,
                       positions, causal=True)
    h = _norm_apply(x, p["ln3"], cfg)
    b, s, _ = x.shape
    q = (h @ p["cross"]["wq"]).reshape(b, s, cfg.num_heads,
                                       cfg.resolved_head_dim)
    kk, vv = _cross_project(enc_out, p["cross"], cfg)
    out = attention_chunked(q, kk, vv, causal=False, kv_chunk=cfg.attn_chunk)
    x = x + out.reshape(b, s, -1) @ p["cross"]["wo"]
    return x + _mlp(_norm_apply(x, p["ln2"], cfg), p["mlp"], cfg)


def _logits(x, params: LM, cfg: ModelConfig):
    x = _norm_apply(x, params.final_norm, cfg)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


#: The 2-D matrix products that ``remat_policy="dots"`` saves.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _layer_fn(cfg: ModelConfig, block_fn=_dense_block):
    """How ``forward`` runs one layer of ``block_fn``: plain, or under the
    config's rematerialisation when autograd records a graph."""
    if not (cfg.remat and cfg.remat_policy != "none"
            and torch.is_grad_enabled()):
        return block_fn
    if cfg.remat_policy == "full":
        context = _ckpt.noop_context_fn
    elif cfg.remat_policy == "dots":
        context = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return functools.partial(_ckpt.checkpoint, block_fn,
                             use_reentrant=False, context_fn=context)


def _frontend(embeds, params: LM, name: str) -> torch.Tensor:
    if embeds is None:
        raise ValueError(f"{params.cfg.name} ({params.cfg.family}) needs "
                         f"{name}")
    return torch.as_tensor(embeds, device=params.device)


def _run_encoder(params: LM, cfg: ModelConfig, audio_embeds) -> torch.Tensor:
    """The encoder over the stub audio frames (B, encoder_seq, d): the
    positional table added, full attention, the final norm."""
    enc = params.encoder
    x = _frontend(audio_embeds, params, "audio_embeds") + enc.pos[None]
    positions = torch.arange(x.shape[1], device=params.device)[None]
    layer = _layer_fn(cfg, _encoder_block)
    for block in enc.blocks:
        x = layer(x, block, cfg, positions)
    return _norm_apply(x, enc.final_norm, cfg)


def forward(params: LM, cfg: ModelConfig, tokens, *, audio_embeds=None,
            patch_embeds=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vp), on the device of ``params``.
    The stub frontends feed ``audio_embeds`` (encdec: (B, encoder_seq, d))
    or ``patch_embeds`` (vlm: (B, vision_patches, d), prepended to the
    text; attention is causal over the whole sequence and the logits are
    the text positions')."""
    check_family(cfg)
    tokens = torch.as_tensor(tokens, device=params.device).long()
    s_text = tokens.shape[1]
    x = params.embed[tokens]
    n_prefix = 0
    if cfg.family == "vlm":
        patches = _frontend(patch_embeds, params, "patch_embeds")
        n_prefix = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=params.device)[None]
    if cfg.family == "encdec":
        x = x + params.dec_pos[:s_text][None]
        enc_out = _run_encoder(params, cfg, audio_embeds)
        layer = _layer_fn(cfg, _cross_block)
        for block in params.blocks:
            x = layer(x, block, cfg, positions, enc_out)
    elif cfg.family in SEGMENTED:
        layers = {"mamba": _layer_fn(cfg, _mamba_layer),
                  "mlstm": _layer_fn(cfg, _mlstm_layer)}
        for (kind, _n), seg in zip(segment_plan(cfg), params.segments):
            if kind in layers:
                for lp in seg:
                    x = layers[kind](x, lp, cfg, positions)
            elif kind == "slstm":
                x, _ = _slstm_block(x, seg[0], cfg)
            else:                                   # shared_attn
                x = _shared_attn_block(x, params.shared_attn, cfg, positions)
    else:
        layer = _layer_fn(cfg)
        for block in params.blocks:
            x = layer(x, block, cfg, positions)
    if n_prefix:
        x = x[:, n_prefix:]
    return _logits(x, params, cfg)


def loss_fn(params: LM, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean token cross-entropy (f32) of ``batch["tokens"]`` against
    ``batch["labels"]`` (B, S); the stub frontends ride in the batch as
    ``audio_embeds`` / ``patch_embeds``."""
    logits = forward(params, cfg, batch["tokens"],
                     audio_embeds=batch.get("audio_embeds"),
                     patch_embeds=batch.get("patch_embeds"))
    labels = torch.as_tensor(batch["labels"], device=params.device)
    return cross_entropy(logits, labels, cfg.vocab_size)
