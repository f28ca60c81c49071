"""Model configuration for all assigned architectures.

The port's copy of ``repro.models.config`` (it imports nothing of the
reference); ``ModelConfig``, ``ShapeConfig``, ``SHAPES`` and
``model_flops`` are unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # defaults to d_model // num_heads
    # --- attention details ---
    rope: bool = True
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0      # fraction of head_dim that rotates (GLM: 0.5)
    qkv_bias: bool = False           # qwen1.5
    qk_norm: bool = False            # qwen3
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_impl: str = "ragged"         # ragged | grouped (padded grouped GEMM)
    capacity_factor: float = 2.0     # for the grouped (dropping) impl
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    slstm_every: int = 0             # xLSTM: every k-th block is sLSTM
    shared_attn_every: int = 0       # zamba2: shared attn block every k layers
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # stub audio frontend output length
    # --- VLM ---
    vision_patches: int = 0          # stub anyres frontend output length
    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"       # full | dots (checkpoint_dots) | none
    attn_chunk: int = 1024           # KV chunk of the online-softmax attention
    # --- activation sharding constraints (§Perf lever; "none" lets GSPMD
    # propagation decide, "tp" pins Megatron-style specs, "sp" additionally
    # shards the residual sequence dim over the model axis) ---
    act_shard: str = "none"          # none | tp | sp
    batch_axes: Tuple[str, ...] = ("data",)   # mesh axes the batch shards over
    model_axis_size: int = 16        # TP degree (divisibility guard)

    # ----------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the logits axis shards over 16-way TP x 128 lanes."""
        return _round_up(self.vocab_size, 2048)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        # mamba2 convention: head dim 64
        return max(1, self.ssm_d_inner // 64)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        h, kv, f, v = self.num_heads, self.num_kv_heads, self.d_ff, self.vocab_padded
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.act == "silu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = attn + (0 if self.is_moe else mlp) + 2 * d
        if self.is_moe:
            per_layer += self.num_experts * (3 * d * f) + d * self.num_experts
        total = self.num_layers * per_layer
        if self.family in ("ssm", "hybrid"):
            di, s, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            mamba = d * (2 * di + 2 * s + nh) + self.ssm_conv * (di + 2 * s) + di * d + 2 * nh + di
            if self.family == "ssm":
                # xLSTM: attention-free; "mamba" slot approximates the mLSTM block
                mamba = 3 * d * self.num_heads * hd + self.num_heads * hd * d
            total = self.num_layers * (mamba + 2 * d)
            if self.shared_attn_every:
                total += attn + mlp + 2 * d
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp + 2 * d) + self.encoder_seq * d
        emb = v * d
        total += emb if self.tie_embeddings else 2 * emb
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        expert_params = self.num_layers * self.num_experts * 3 * self.d_model * self.d_ff
        active = self.num_layers * self.experts_per_token * 3 * self.d_model * self.d_ff
        return full - expert_params + active

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


def model_flops(cfg: ModelConfig, shape: "ShapeConfig") -> float:
    """Analytic MODEL_FLOPS of one step: 6*N_active*tokens for training
    (fwd+bwd), 2*N_active*tokens for prefill, 2*N_active*batch for one decode
    step (EXPERIMENTS.md §Roofline convention; embedding lookup excluded,
    lm_head included via active params)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}
