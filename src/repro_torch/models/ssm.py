"""State-space and recurrent blocks: Mamba2 (SSD), mLSTM, sLSTM.

Port of ``repro.models.ssm``.  One chunked "state-space duality" core
(``ssd_chunked``) serves both the Mamba2 blocks of zamba2 and the mLSTM
blocks of xLSTM (the recurrence ``S_t = exp(a_t) S_{t-1} + w_t B_t
x_t^T``); its state is float32 and carried across chunks, so memory is
O(chunk^2), not O(L^2).  The reference's ``lax.scan`` over chunks (and
over time for the exact sLSTM) is a Python loop here, the same products
as einsums in the same types, and the reference's clips kept.

One difference, in gradients only: within a chunk the reference forms
the decay ``exp(cum_i - cum_j)`` for every pair and masks the upper
triangle (i < j) after the exponential.  There ``cum_i - cum_j`` is the
negated log-decay of the steps between, which at a strong decay over a
long chunk overflows to inf; the masked forward value is still 0, but its
gradient is 0 * inf = NaN (ROADMAP Queue C, C18).  The port masks the
exponent (to -inf) before the exponential: the same forward values, and
finite gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm

__all__ = ["ssd_chunked", "ssd_decode_step", "SSDState", "mamba2_block",
           "Mamba2State", "slstm_scan", "SLSTMState"]


class SSDState(NamedTuple):
    s: torch.Tensor          # (B, H, S, P) running state, float32


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, a, w, bmat, cmat, *, chunk: int = 128,
                initial: Optional[SSDState] = None):
    """y_t = C_t . S_t with S_t = exp(a_t) S_{t-1} + w_t B_t x_t^T.

    x: (B, L, H, P) values;  a: (B, L, H) log-decay (<= 0);
    w: (B, L, H) input weights; bmat/cmat: (B, L, S) (one group over H).
    Returns (y (B, L, H, P) in x's type, final SSDState)."""
    b, l, h, p = x.shape
    s = bmat.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a, w = (F.pad(t, (0, 0, 0, pad)) for t in (a, w))
        bmat, cmat = (F.pad(t, (0, 0, 0, pad)) for t in (bmat, cmat))
    nc = (l + pad) // chunk
    state = initial.s if initial is not None else torch.zeros(
        (b, h, s, p), dtype=torch.float32, device=x.device)
    qi = torch.arange(chunk, device=x.device)
    mask = (qi[:, None] >= qi[None, :])[None, :, :, None]     # (1, Qi, Qj, 1)
    ys = []
    for c in range(nc):
        part = slice(c * chunk, (c + 1) * chunk)
        xc, bc, cc = (t[:, part].float() for t in (x, bmat, cmat))
        wc = w[:, part].float()
        cum = torch.cumsum(a[:, part].float(), dim=1)         # (B, Q, H)
        total = cum[:, -1]                                    # (B, H)
        # --- intra-chunk (causal) ---
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # (B, Qi, Qj, H)
        dec = torch.exp(diff.masked_fill(~mask, float("-inf")))
        cb = torch.einsum("bis,bjs->bij", cc, bc)             # (B, Qi, Qj)
        m = cb[:, :, :, None] * dec * wc[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xc)
        # --- inter-chunk: contribution of the carried state ---
        y_inter = torch.einsum("bis,bhsp->bihp", cc, state) \
            * torch.exp(cum)[..., None]
        # --- state update ---
        decay_out = torch.exp(total[:, None, :] - cum)        # (B, Q, H)
        contrib = torch.einsum("bqh,bqs,bqhp->bhsp", wc * decay_out, bc, xc)
        state = state * torch.exp(total)[:, :, None, None] + contrib
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1)[:, :l], SSDState(state)


def ssd_decode_step(x, a, w, bmat, cmat, state: SSDState):
    """One-token recurrence.  x: (B,1,H,P), a/w: (B,1,H), b/c: (B,1,S)."""
    decay = torch.exp(a.float())[:, 0, :, None, None]         # (B,H,1,1)
    contrib = torch.einsum("bh,bs,bhp->bhsp", w.float()[:, 0],
                           bmat.float()[:, 0], x.float()[:, 0])
    s = state.s * decay + contrib
    y = torch.einsum("bs,bhsp->bhp", cmat.float()[:, 0], s)
    return y[:, None].to(x.dtype), SSDState(s)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

class Mamba2State(NamedTuple):
    ssd: SSDState            # (B, H, S, P)
    conv: torch.Tensor       # (B, K-1, C) causal-conv history


def _causal_conv(x, w, history=None):
    """Depthwise causal conv.  x: (B, L, C), w: (K, C).  Returns (out,
    the last K-1 inputs as the next call's history)."""
    k = w.shape[0]
    if history is None:
        history = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([history, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i][None, None, :]
    new_hist = xp[:, -(k - 1):] if k > 1 else history
    return out, new_hist


def mamba2_block(x, params, cfg, state: Optional[Mamba2State] = None,
                 decode: bool = False):
    """x: (B, L, D) -> ((B, L, D), Mamba2State).  params:
    in_proj (D, 2*Di + 2*S + H), conv_w (K, Di + 2*S), A_log (H,), D (H,),
    dt_bias (H,), norm (Di,), out_proj (Di, D)."""
    b, l, _ = x.shape
    di, s_sz, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    p = di // nh
    z, xz, bc, dt_raw = torch.split(x @ params["in_proj"],
                                    [di, di, 2 * s_sz, nh], dim=-1)
    conv_out, new_hist = _causal_conv(torch.cat([xz, bc], dim=-1),
                                      params["conv_w"],
                                      state.conv if state is not None
                                      else None)
    xz, bmat, cmat = torch.split(F.silu(conv_out), [di, s_sz, s_sz], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (B,L,H)
    a_neg = -torch.exp(params["A_log"].float())                  # (H,)
    xh = xz.reshape(b, l, nh, p)
    if decode:
        y, new_ssd = ssd_decode_step(xh, dt * a_neg, dt, bmat, cmat,
                                     state.ssd)
    else:
        y, new_ssd = ssd_chunked(xh, dt * a_neg, dt, bmat, cmat,
                                 chunk=cfg.ssm_chunk,
                                 initial=state.ssd if state is not None
                                 else None)
    y = y + xh * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, l, di) * F.silu(z)
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], Mamba2State(new_ssd, new_hist)


# ---------------------------------------------------------------------------
# sLSTM (exact, sequential)
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor          # (B, H, hd), float32
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def slstm_scan(x_gates, r_weights, state: Optional[SLSTMState] = None):
    """Exact sLSTM over time.

    x_gates: (B, L, H, 4, hd) input pre-activations (order i, f, z, o);
    r_weights: (H, hd, 4, hd) per-head recurrent block matrices.
    Returns (h_seq (B, L, H, hd) in x_gates' type, final state)."""
    b, l, h, _, hd = x_gates.shape
    if state is None:
        zeros = torch.zeros((b, h, hd), dtype=torch.float32,
                            device=x_gates.device)
        state = SLSTMState(zeros, zeros + 1e-6, zeros - 1e9, zeros)
    r = r_weights.float()
    st, hs = state, []
    for t in range(l):
        rec = torch.einsum("bhd,hdgf->bhgf", st.h, r)
        it, ft, zt, ot = (x_gates[:, t].float() + rec).unbind(dim=2)
        m_new = torch.maximum(ft + st.m, it)
        i = torch.exp(it - m_new)
        f = torch.exp(ft + st.m - m_new)
        c = f * st.c + i * torch.tanh(zt)
        n = f * st.n + i
        hh = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        st = SLSTMState(c, n, m_new, hh)
        hs.append(hh)
    return torch.stack(hs, dim=1).to(x_gates.dtype), st
