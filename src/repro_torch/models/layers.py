"""Shared neural-net building blocks, plain PyTorch.

Port of ``repro.models.layers`` for the LM families.  ``shard_act`` is
left out: it pins an activation's sharding on a device mesh, and on one
device it is the identity.  ``init_dense`` takes a ``torch.Generator``
where the reference takes a JAX key; the two draw different numbers, so
the tests carry the reference's parameters across as numpy arrays
(``repro_torch.convert.lm_params_from_numpy``).

``rope`` computes its angles and their cosine and sine in float64 and
rounds the tables to float32; the rotation itself runs in float32 and is
rounded to the input's type.  The reference builds its frequencies in
numpy float64: under ``jax_enable_x64`` (the tests) the angles and the
rotation run in float64 and only the result is rounded; in production
(x64 off) everything runs in float32.  So the port's tables are the x64
reference's to float32 rounding, its rotated values within a few float32
ulps of it (about 1e-7 relative; the tests' bar is 1e-5), and its angles
stay exact at long positions where a float32 angle would not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "layernorm", "rope", "mlp_swiglu", "mlp_gelu",
           "init_dense", "cross_entropy"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0,
         partial: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the last axis of (..., S, H, hd).

    ``partial`` < 1 rotates only the first ``partial * hd`` channels
    (GLM-style 2d/partial rotary).  ``positions``: (..., S) integers."""
    hd = x.shape[-1]
    rot = int(hd * partial)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    # built on the device: a host copy per call would stall the stream
    freqs = torch.pow(theta, torch.arange(0, half, dtype=torch.float64,
                                          device=x.device) * (-2.0 / rot))
    ang = positions[..., :, None].double() * freqs          # (..., S, half)
    cos = torch.cos(ang).float()[..., :, None, :]           # over heads
    sin = torch.sin(ang).float()[..., :, None, :]
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def mlp_swiglu(x, wi_gate, wi_up, wo):
    return (F.silu(x @ wi_gate) * (x @ wi_up)) @ wo


def mlp_gelu(x, wi, bi, wo, bo):
    return F.gelu(x @ wi + bi, approximate="tanh") @ wo + bo


def init_dense(generator: torch.Generator, shape, scale: float | None = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal weights of standard deviation ``scale`` (default
    ``fan_in ** -0.5``), drawn in float32 on the generator's device and
    rounded to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy; logits may be vocab-padded (padded ids never
    appear in labels).  Computed in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
