"""Gradient compression for the data-parallel all-reduce.

Port of ``repro.optim.compression``: three codecs, composable with error
feedback.

* ``hier`` — the paper's transform as a codec: a gradient is flattened
  into a ``(2**level - 1, cols)`` pole bundle and hierarchized along its
  poles (``kernels.hierarchize.hier_pole``, row 1 on the card), small
  surpluses are dropped, and ``dehier_pole`` (row 2) decodes.  Exactly
  invertible at truncation 0.
* ``int8`` — per-tensor symmetric quantization.
* ``topk`` — magnitude top-k (``torch.topk``) with error feedback.

Gradients and residuals are flat mappings ``{name: tensor}``.  As in the
reference, the train step does not call the codecs: they are the wire
format a data-parallel step would use.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.hierarchize import dehier_pole, hier_pole

__all__ = ["hier_encode", "hier_decode", "int8_encode", "int8_decode",
           "topk_mask", "ErrorFeedback", "init_error_feedback",
           "compress_with_feedback"]


def _pole_shape(n: int, level: int) -> Tuple[int, int]:
    pole = (1 << level) - 1
    cols = -(-n // pole)
    return pole, cols


def hier_encode(g: torch.Tensor, level: int = 8) -> torch.Tensor:
    """Flatten -> (2**level - 1, cols) pole bundle -> hierarchize axis 0.

    The bundle is the transpose of the padded (cols, 2**level - 1) buffer,
    which is hierarchized along its last axis in place; the result is its
    transposed view."""
    flat = g.reshape(-1).float()
    pole, cols = _pole_shape(flat.numel(), level)
    buf = F.pad(flat, (0, pole * cols - flat.numel())).reshape(cols, pole)
    return hier_pole(buf, axis=1).T


def hier_decode(alpha: torch.Tensor, shape, dtype) -> torch.Tensor:
    """The inverse of ``hier_encode`` on a (2**level - 1, cols) bundle,
    dehierarchized along the last axis of its (cols, 2**level - 1)
    transpose (in place where that is contiguous, as ``hier_encode``'s
    result and elementwise products of it are)."""
    buf = dehier_pole(alpha.T, axis=1)
    n = 1
    for d in shape:
        n *= int(d)
    return buf.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def int8_encode(g: torch.Tensor):
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Magnitude top-``frac`` mask (1.0/0.0), computed per tensor."""
    flat = torch.abs(x.reshape(-1).float())
    k = max(1, int(frac * flat.numel()))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x.float()) >= thresh).float()


class ErrorFeedback(NamedTuple):
    residual: Dict[str, torch.Tensor]


def init_error_feedback(params: Mapping[str, torch.Tensor]) -> ErrorFeedback:
    return ErrorFeedback({k: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                          for k, p in params.items()})


def compress_with_feedback(grads: Mapping[str, torch.Tensor],
                           ef: ErrorFeedback, *, codec: str = "hier",
                           level: int = 8, frac: float = 0.1
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      ErrorFeedback]:
    """Per tensor: add the residual, encode and truncate, keep what was
    dropped.  Returns (the decoded approximate gradients, what the
    all-reduce would carry, and the new error-feedback state)."""
    def one(g, r):
        g32 = g.float() + r
        if codec == "hier":
            alpha = hier_encode(g32, level)
            approx = hier_decode(alpha * topk_mask(alpha, frac), g32.shape,
                                 torch.float32)
        elif codec == "topk":
            approx = g32 * topk_mask(g32, frac)
        elif codec == "int8":
            q, s = int8_encode(g32)
            approx = int8_decode(q, s, torch.float32)
        else:
            raise ValueError(codec)
        return approx.to(g.dtype), g32 - approx

    out = {k: one(g, ef.residual[k]) for k, g in grads.items()}
    return ({k: a for k, (a, _) in out.items()},
            ErrorFeedback({k: r for k, (_, r) in out.items()}))
