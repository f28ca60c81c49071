"""Flash attention (causal or full, GQA): the kernel of row 10, and its
gradient.

Port of ``repro.kernels.flash_attention``.  ``flash_attention`` takes the
model's layout, ``q (B, Sq, H, hd)`` and ``k/v (B, Skv, KV, hd)`` with
``H`` a multiple of ``KV``; ``flash_attention_bhsd`` takes the TPU
kernel's, ``(BH, Sq, hd)`` with the heads already expanded, as the case
``H = KV = 1`` of the same kernel.  Given CUDA tensors, the wrapper
launches ``csrc/flash_attention.cu`` (``head_dim`` up to 128) once, reading
each query head's KV head in place, or raises; given CPU tensors it runs
``flash_attention_ref``, its plain version.  bf16 runs on the warpgroup
tensor-core products (wgmma) with q, k and v brought in by TMA from maps
on their own strides (``_tma_rows``: an operand TMA cannot describe is
read from an aligned copy); f32 runs on the CUDA cores.
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

Training differentiates it.  ``flash_attention`` called with an input that
requires a gradient (in grad mode) goes through ``FlashAttention``, an
autograd Function: its forward is ``flash_attention_lse``, the same
kernel with its log-sum-exp output on (a template flag of
``flash_attention.cu``; ``out`` is the same bits), and its backward is
``flash_attention_bwd``, two hand-written launches of
``csrc/flash_attention_bwd.cu`` (dq, then dk and dv, FlashAttention-2
style, no atomics; bf16 on the warpgroup tensor-core products (wgmma) fed
by TMA, f32 on the CUDA cores).
In bf16 ``flash_attention_lse`` also returns the output's rounding
residual (``o_lo = bf16(o_f32 - o)``, written by the same launch) and the
backward takes ``D = rowsum(do * (o + o_lo))`` from it (``o_lo=``,
required in bf16): from the bf16 ``o`` alone,
D is off by about 2^-9 |o| |do|, which ``dS = P (dP - D)`` does not cancel
where the rows of ``o`` share a large common part (whisper's decoder after
its cross-attention over 1500 frames), and the gradients below drift
3-4% (relative L2) from the f32 ones.
Each wrapper has its plain version (``flash_attention_lse_ref``,
``flash_attention_bwd_ref``: the same math on the whole score matrix,
which the CPU runs) and its own ``.launches`` count;
``flash_attention.launches`` counts only the launches without the
log-sum-exp, the serving path's.  The plain versions compute in f32, or
in f64 for f64 inputs (``torch.autograd.gradcheck``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hierarchize import _raise_on, _record, _stream

__all__ = ["flash_attention", "flash_attention_bhsd", "flash_attention_ref",
           "flash_attention_lse", "flash_attention_lse_ref",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "FlashAttention"]

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


def _plain_forward(q, k, v, causal: bool, q_offset: int):
    """(out, lse, out_lo) of the plain version: the whole score matrix at
    once, in f32 (f64 for f64 inputs); lse (B, H, Sq) the rows' natural
    log-sum-exp of the masked scaled scores; out_lo the f32 output less
    ``out``, in bf16 for bf16 inputs and None otherwise."""
    _check(q, k, v, q_offset)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    acc = _acc_dtype(q.dtype)
    qf = (q.to(acc) * hd ** -0.5).reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(acc))
    if causal:
        s = s.masked_fill(_causal_mask(sq, skv, q_offset, q.device), _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(acc))
    l = p.sum(dim=-1)                                      # (B, KV, g, Sq)
    out = out / torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-30)
    lse = (m[..., 0] + torch.log(l)).reshape(b, h, sq)
    full = out.reshape(b, sq, h, hd)
    out = full.to(q.dtype)
    lo = (full - out.to(acc)).to(q.dtype) if q.dtype == torch.bfloat16 \
        else None
    return out, lse, lo


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _causal_mask(sq: int, skv: int, q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv), True where key k lies past query row r: r + q_offset < k."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    return q_pos < torch.arange(skv, device=device)[None, :]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0
                        ) -> torch.Tensor:
    """The plain version, eager PyTorch on any device: the whole score
    matrix at once, in f32 (f64 for f64 inputs).  q (B, Sq, H, hd), k/v
    (B, Skv, KV, hd)."""
    return _plain_forward(q, k, v, causal, q_offset)[0]


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            q_offset: int = 0):
    """``flash_attention_lse``'s plain version: ``flash_attention_ref``'s
    output (the same bits), the rows' log-sum-exp and the output's
    rounding residual (None outside bf16)."""
    return _plain_forward(q, k, v, causal, q_offset)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            q_offset: int = 0, scale: float | None = None,
                            o_lo=None):
    """The backward's plain version, eager PyTorch on any device, in f32
    (f64 for f64 inputs): ``P = exp(S * scale - lse)`` recomputed whole,
    ``D = rowsum(do * o)`` (``o + o_lo`` with the forward's residual),
    ``dv = P^T do``, ``dS = P * (do v^T - D)``, ``dq = dS k * scale``,
    ``dk = dS^T q * scale``; ``scale`` defaults to ``hd**-0.5``.  Returns
    ``(dq, dk, dv)`` in the inputs' types."""
    _check(q, k, v, q_offset)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g, acc = h // kvh, _acc_dtype(q.dtype)
    scale = hd ** -0.5 if scale is None else scale
    qf = q.to(acc).reshape(b, sq, kvh, g, hd)
    dof = do.to(acc).reshape(b, sq, kvh, g, hd)
    kf, vf = k.to(acc), v.to(acc)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf * scale, kf)
    if causal:
        s = s.masked_fill(_causal_mask(sq, skv, q_offset, q.device), _NEG_INF)
    p = torch.exp(s - lse.to(acc).reshape(b, kvh, g, sq)[..., None])
    of = o.to(acc) if o_lo is None else o.to(acc) + o_lo.to(acc)
    d = (dof * of.reshape(b, sq, kvh, g, hd)).sum(-1)          # (B,Sq,KV,g)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _tma_operands(q, k, v, o, do, lse, o_lo=None):
    """The bf16 backward kernels' operands as TMA describes them: ``(q, k,
    v, o, do, lse, pitch)``, or ``(q, k, v, o, do, o_lo, lse, pitch)`` with
    the forward's residual ``o_lo``.

    TMA reads q, k, v, o and do as boxes of contiguous (B, S, heads, hd)
    arrays, which needs a 16-byte aligned base and strides that are
    multiples of 16 bytes, so hd a multiple of 8; and lse (and the kernels'
    D scratch) as lines of 64 values at a pitch of a multiple of 16 bytes.
    An operand that is not so already becomes an aligned contiguous copy:
    its channels zero-padded to the next multiple of 8 when hd is not one
    (the kernels then run at the padded hd with the true hd's scale, and
    the wrapper slices the gradients back), lse's lines zero-padded to a
    ``pitch`` that is a multiple of 4 values.  Pure torch on any device."""
    hd, sq = q.shape[-1], q.shape[1]
    pad = -hd % 8

    def rows(t):
        t = t.contiguous()
        if pad:
            return torch.nn.functional.pad(t, (0, pad))
        return t if t.data_ptr() % 16 == 0 else t.clone()

    pitch = sq + -sq % 4
    lse = lse.contiguous()
    if pitch != sq:
        lse = torch.nn.functional.pad(lse, (0, pitch - sq))
    elif lse.data_ptr() % 16:
        lse = lse.clone()
    ts = (q, k, v, o, do) if o_lo is None else (q, k, v, o, do, o_lo)
    return (*(rows(t) for t in ts), lse, pitch)


def _operand(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """A bf16 forward operand (B, S, heads, hd) as the kernel's TMA maps
    read it: ``t`` itself where hd is a multiple of 8, its base 16-byte
    aligned, its channels contiguous and every other stride a positive
    multiple of 8 values (whole 16 bytes), as the model's contiguous
    (B, S, heads, hd) projections are; otherwise an aligned contiguous
    copy with its channels zero-padded to a multiple of 8, returned as the
    view of its first hd channels (the maps read the zero padding; the
    kernel keeps the true hd for its scale and output).  The same kernel
    runs on either.  Pure torch on any device."""
    hd = t.shape[-1]
    if (hd % 8 == 0 and t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 for s in t.stride()[:-1])):
        return t
    buf = t.new_zeros((*t.shape[:-1], hd + -hd % 8))
    buf[..., :hd] = t
    return buf[..., :hd]


def _device_checks(q, k, v) -> None:
    """Raise unless q, k, v are CUDA tensors the kernels take (the CPU
    takes the plain versions before this)."""
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k and v must lie on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_TAG:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim up to {_MAX_HEAD_DIM}, "
                         f"got {q.shape[-1]}")


def _launch_forward(q, k, v, causal: bool, q_offset: int, with_lse: bool):
    """One ``flash_attention.cu`` launch: (out, lse or None, out_lo or
    None); out_lo is written in bf16 with the lse."""
    _device_checks(q, k, v)
    b, sq, h, hd = q.shape
    prepare = _tma_rows if q.dtype == torch.bfloat16 else _operand
    q, k, v = prepare(q), prepare(k), prepare(v)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    lo = torch.empty_like(out) if with_lse and q.dtype == torch.bfloat16 \
        else None
    _raise_on(_build.kernel("flash_attention", _DTYPE_TAG[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if lo is None else lo.data_ptr(), b, h, k.shape[2], sq,
        k.shape[1], hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), q_offset, _stream(q)), "flash_attention")
    return out, lse, lo


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Drop-in for ``attention_chunked``: q (B, Sq, H, hd), k/v (B, Skv,
    KV, hd) -> (B, Sq, H, hd) in q's type.  On CUDA: one launch of
    ``flash_attention.cu``; q, k and v are read through their strides (f32:
    only the last dimension must be contiguous; bf16: ``_tma_rows`` copies
    an operand whose strides or base TMA cannot take).  When an input requires
    a gradient (and grad mode is on), the call goes through
    ``FlashAttention``: the forward with its log-sum-exp
    (``flash_attention_lse``) and the backward kernels."""
    _record(flash_attention, q=q, k=k, v=v, causal=causal, block_q=block_q,
            block_k=block_k, q_offset=q_offset)
    _check(q, k, v, q_offset)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, q_offset)
    if q.device.type == "cpu" and k.device == v.device == q.device:
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    out, _, _ = _launch_forward(q, k, v, causal, q_offset, with_lse=False)
    flash_attention.launches += 1
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0):
    """Row 10's forward with the state its backward needs: ``(out, lse,
    out_lo)``, ``lse`` f32 (B, H, Sq), ``out_lo`` the output's bf16
    rounding residual (None for f32 inputs, whose output is exact).  On
    CUDA: one launch of
    ``flash_attention.cu`` with its LSE output on (``out`` the same bits as
    ``flash_attention``'s); on the CPU the plain version."""
    _record(flash_attention_lse, q=q, k=k, v=v, causal=causal,
            q_offset=q_offset)
    _check(q, k, v, q_offset)
    if q.device.type == "cpu" and k.device == v.device == q.device:
        return flash_attention_lse_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    out, lse, lo = _launch_forward(q, k, v, causal, q_offset, with_lse=True)
    flash_attention_lse.launches += 1
    return out, lse, lo


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        q_offset: int = 0, o_lo=None):
    """``(dq, dk, dv)`` of row 10's attention from the forward's inputs, its
    output ``o``, its ``lse`` and the output's gradient ``do``.  On CUDA:
    ``flash_attention_bwd.cu``'s two launches (dq, writing D = rowsum(do *
    o) to a scratch tensor, then dk and dv; each counted in
    ``flash_attention_bwd.launches``); on the CPU the plain version.  f32
    operands are read as contiguous copies.  bf16 operands go through
    ``_tma_operands`` first: an operand whose base is not 16-byte aligned,
    or whose rows TMA cannot describe (hd not a multiple of 8), becomes an
    aligned contiguous copy, its channels zero-padded to a multiple of 8
    (the gradients then come back as slices of the padded ones), and lse's
    lines are padded to a multiple of 4 values.  ``o_lo``: the forward's
    output residual, required in bf16 (D is taken from ``o + o_lo``) and
    refused otherwise."""
    _record(flash_attention_bwd, q=q, k=k, v=v, o=o, lse=lse, do=do,
            causal=causal, q_offset=q_offset, o_lo=o_lo)
    _check(q, k, v, q_offset)
    if not (o.shape == do.shape == q.shape and tuple(lse.shape) == (
            q.shape[0], q.shape[2], q.shape[1])):
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)} and "
                         f"lse (B, H, Sq), got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    bf16 = q.dtype == torch.bfloat16
    if (o_lo is not None) != bf16 or bf16 and (
            o_lo.shape != o.shape or o_lo.dtype != o.dtype):
        got = None if o_lo is None else f"{o_lo.dtype}{tuple(o_lo.shape)}"
        raise ValueError(f"o_lo, the forward's output residual, must be "
                         f"bf16 of o's shape {tuple(o.shape)} for bf16 "
                         f"inputs and None otherwise, got {got} for "
                         f"{q.dtype}")
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       q_offset=q_offset, o_lo=o_lo)
    _device_checks(q, k, v)
    if not (o.device == do.device == lse.device == q.device
            and o.dtype == do.dtype == q.dtype
            and lse.dtype == torch.float32):
        raise TypeError(f"o and do must be {q.dtype} and lse float32 on "
                        f"{q.device}")
    b, sq, h, hd = q.shape
    if bf16 and o_lo.device != q.device:
        raise TypeError(f"o_lo must lie on {q.device}")
    if bf16:
        q, k, v, o, do, o_lo, lse, pitch = _tma_operands(q, k, v, o, do, lse,
                                                         o_lo)
    else:
        q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
        pitch = sq
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((b, h, pitch), dtype=torch.float32, device=q.device)
    _raise_on(_build.kernel("flash_attention_bwd", _DTYPE_TAG[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if o_lo is None else o_lo.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, k.shape[2], sq, k.shape[1],
        q.shape[-1], int(causal), q_offset, hd, pitch, _stream(q)),
        "flash_attention_bwd")
    flash_attention_bwd.launches += 2
    if q.shape[-1] != hd:
        dq, dk, dv = (t[..., :hd] for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Row 10 as a differentiable function: ``forward`` launches the kernel
    with its log-sum-exp and, in bf16, the output's residual
    (``flash_attention_lse``) and saves q, k, v, the output, the lse and
    the residual; ``backward`` runs
    ``flash_attention_bwd`` with it (the two backward kernels on CUDA, the
    plain version on the CPU).  Nothing falls back: a kernel that fails to
    build or launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        out, lse, lo = flash_attention_lse(q, k, v, causal=causal,
                                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse, lo)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lo = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal,
                                         q_offset=ctx.q_offset, o_lo=lo)
        return dq, dk, dv, None, None


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
flash_attention_lse.launches = 0
flash_attention_lse.plain = flash_attention_lse_ref
flash_attention_bwd.launches = 0
flash_attention_bwd.plain = flash_attention_bwd_ref
