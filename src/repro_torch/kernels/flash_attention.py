"""Flash attention (forward, causal or full, GQA): the kernel of row 10.

Port of ``repro.kernels.flash_attention``.  ``flash_attention`` takes the
model's layout, ``q (B, Sq, H, hd)`` and ``k/v (B, Skv, KV, hd)`` with
``H`` a multiple of ``KV``; ``flash_attention_bhsd`` takes the TPU
kernel's, ``(BH, Sq, hd)`` with the heads already expanded, as the case
``H = KV = 1`` of the same kernel.  Given CUDA tensors, the wrapper
launches ``csrc/flash_attention.cu`` (f32 or bf16, ``head_dim`` up to 128)
once, reading each query head's KV head in place, or raises; given CPU
tensors it runs ``flash_attention_ref``, its plain version.
``flash_attention.launches`` counts the kernel's launches, and every call
is recorded by ``hierarchize.record_calls``.

The function is the TPU kernel's: f32 scores of ``q * hd**-0.5`` against
``k``, filled with ``-1e30`` where a key lies past the keys' length or, with
``causal``, past the query's position (``q_pos + q_offset < k_pos``), an
f32 softmax and ``p @ v`` divided by ``max(l, 1e-30)``, rounded to ``q``'s
type.  ``block_q``/``block_k`` are tiling choices of the TPU's grid and do
not change the function (the reference's own block-invariance test): they
are accepted and the card tiles as it wants.  ``q_offset`` exists for
``attention_chunked``; a negative one, which would leave rows with no
visible key, is refused.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hierarchize import _raise_on, _record, _stream

__all__ = ["flash_attention", "flash_attention_bhsd", "flash_attention_ref"]

_NEG_INF = -1e30
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_HEAD_DIM = 128


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, hd) and k, v (B, Skv, KV, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: batch and head_dim must agree "
                         f"and H must be a multiple of KV")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0
                        ) -> torch.Tensor:
    """The plain version, eager PyTorch on any device: the whole score
    matrix at once, in f32.  q (B, Sq, H, hd), k/v (B, Skv, KV, hd)."""
    _check(q, k, v, q_offset)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = (q.float() * hd ** -0.5).reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]       # (B, Sq, KV, g, 1)
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _operand(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Drop-in for ``attention_chunked``: q (B, Sq, H, hd), k/v (B, Skv,
    KV, hd) -> (B, Sq, H, hd) in q's type.  On CUDA: one launch of
    ``flash_attention.cu``; q, k and v are read through their strides
    (only the last dimension must be contiguous)."""
    _record(flash_attention, q=q, k=k, v=v, causal=causal, block_q=block_q,
            block_k=block_k, q_offset=q_offset)
    _check(q, k, v, q_offset)
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k and v must lie on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_TAG:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, sq, h, hd = q.shape
    if hd > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim up to {_MAX_HEAD_DIM}, "
                         f"got {hd}")
    q, k, v = _operand(q), _operand(k), _operand(v)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    _raise_on(_build.kernel("flash_attention", _DTYPE_TAG[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
        k.shape[2], sq, k.shape[1], hd, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), q_offset, _stream(q)),
        "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = 512,
                         block_k: int = 512, q_offset: int = 0
                         ) -> torch.Tensor:
    """q: (BH, Sq, hd); k/v: (BH, Skv, hd), heads already expanded (the TPU
    kernel's layout).  One ``flash_attention`` call on views."""
    out = flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                          causal=causal, block_q=block_q, block_k=block_k,
                          q_offset=q_offset)
    return out[:, :, 0]


def _plain(q, k, v, *, causal=True, block_q=512, block_k=512, q_offset=0):
    return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)


flash_attention.launches = 0
flash_attention.plain = _plain
