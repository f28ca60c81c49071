"""Mixture-of-Experts FFN: token-choice top-k routing.

Port of ``repro.models.moe``.  Three execution strategies
(``config.moe_impl``), as in the reference:

* ``ragged``: sort every (token, choice) slot by expert and run each
  expert's FFN on its contiguous segment of the sorted tokens.  Exact, no
  drops.  The reference's ``jax.lax.ragged_dot`` becomes one
  ``torch.matmul`` per non-empty expert and product (three an expert), so
  the group sizes are read to the host once per call
  (``moe_ffn.host_reads`` counts those reads, ``moe_ffn.expert_products``
  the products issued).
* ``grouped``: fixed-capacity (E, C, D) buffers and batched products;
  slots past an expert's capacity go to a dump row and are dropped.
* ``ep``: expert-parallel dispatch on the port's single-controller mesh
  (``moe_ffn_ep``).  Experts split over the ``"model"`` axis and batch
  rows over the others; each shard selects its tokens with a per-row
  local argsort (capacity-bounded), runs its experts and the shards'
  outputs are summed in shard order (the reference's psum).  The mesh is
  the ambient one of ``repro_torch.core.mesh.use_mesh`` (the reference
  reads its mesh context the same way) unless ``mesh=`` hands one in.
  Without a usable mesh it returns None and the caller takes the ragged
  path, as the reference's ``_dense_block`` does.  On the ``(T, D)`` entry
  (``moe_ffn``) ``impl="ep"`` is ragged, as in the reference.

Where the reference scatter-adds each slot's weighted output into its
token (``.at[tok].add``), the port writes the slots back into their
(token, choice) positions, a permutation, and sums each token's k choices:
the same values without an atomic add, so the result on the card has the
same bits run to run.  The k additions are done in choice order where the
reference adds them in expert order: float sums a few ulps apart.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.mesh import current_mesh, mesh_axes

__all__ = ["moe_ffn", "moe_ffn_ep", "router_topk"]


def router_topk(x, w_router, num_experts: int, k: int):
    """Returns (weights (T,k) f32 normalized, expert_idx (T,k), aux_loss)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, k, dim=-1)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    # Switch-style load-balance aux loss
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(idx[:, 0], num_experts).float(), dim=0)
    aux = num_experts * torch.sum(me * ce)
    return weights, idx, aux


def _sort_by_expert(idx_flat, num_experts: int):
    """Stable sort of token-expert assignments; returns (perm, group_sizes)."""
    perm = torch.argsort(idx_flat, stable=True)
    group_sizes = torch.bincount(idx_flat, minlength=num_experts)
    return perm, group_sizes


def _ffn_ragged(xs, wi_gate, wi_up, wo, group_sizes):
    """Each expert's SwiGLU FFN on its contiguous rows of ``xs``."""
    sizes = group_sizes.tolist()            # the one host read of a call
    moe_ffn.host_reads += 1
    out, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            xe = xs[start:start + n]
            h = F.silu(xe @ wi_gate[e]) * (xe @ wi_up[e])
            out.append(h @ wo[e])
            moe_ffn.expert_products += 3
        start += n
    if not out:
        return xs.new_zeros((0, wo.shape[-1]))
    return torch.cat(out)


def _combine(ys, perm, t: int, k: int):
    """Slot outputs ``ys`` (sorted by ``perm``) summed into their tokens:
    written back to (token, choice) order, then each token's k summed."""
    full = torch.empty_like(ys)
    full[perm] = ys
    return full.reshape(t, k, -1).sum(dim=1)


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _shard_device(mesh, data_axes, axis_name: str, i: int, m: int):
    """The mesh device of data block ``i`` (row-major over ``data_axes``)
    and model shard ``m``."""
    coords = {axis_name: m}
    for a in reversed(data_axes):
        coords[a] = i % mesh.shape[a]
        i //= mesh.shape[a]
    return mesh.devices[tuple(coords[a] for a in mesh.axis_names)]


def _ep_local(xl, wf, idxf, tokf, wi_gate, wi_up, wo, *, m: int,
              e_local: int, c_e: int, cap: int, num_experts: int, k: int):
    """One (data block, model shard)'s share: its experts' outputs for its
    rows, (bl, s, d) f32 (the reference's ``local`` before the psum)."""
    wi_gate, wi_up, wo = wi_gate.float(), wi_up.float(), wo.float()
    bl, s, d = xl.shape
    lo = m * e_local
    mine = (idxf >= lo) & (idxf < lo + e_local)              # (B, S*k)
    key = torch.where(mine, idxf, num_experts)               # foreign last
    order = torch.argsort(key, dim=-1, stable=True)[:, :cap]  # per-row sort
    sel_e = (torch.gather(idxf, 1, order) - lo).clamp(0, e_local - 1)
    valid = torch.gather(mine, 1, order)
    toks = torch.gather(tokf, 1, order)                      # (B, cap)
    gates = torch.gather(wf, 1, order) * valid.to(xl.dtype)
    # position of each slot within its expert group (slots are sorted by
    # expert, so groups are contiguous per row)
    eid = torch.where(valid, sel_e, e_local)
    counts = F.one_hot(eid, e_local + 1).sum(dim=1)
    starts = torch.cumsum(counts, dim=-1) - counts           # exclusive
    pos = torch.arange(cap, device=xl.device)[None] - torch.gather(
        starts, 1, eid)
    keep = valid & (pos < c_e)
    slot = torch.where(keep, sel_e * c_e + pos, e_local * c_e)
    rows = torch.arange(bl, device=xl.device)[:, None].expand_as(slot)
    xs = torch.gather(xl, 1, toks[..., None].expand(-1, -1, d)) \
        * keep[..., None].to(xl.dtype)                       # (B, cap, D)
    buf = xl.new_zeros((bl, e_local * c_e + 1, d)).index_put(
        (rows, slot), xs, accumulate=True)
    xe = buf[:, :-1].reshape(bl, e_local, c_e, d)
    h = F.silu(torch.einsum("becd,edf->becf", xe, wi_gate)) * \
        torch.einsum("becd,edf->becf", xe, wi_up)
    ye = torch.einsum("becf,efd->becd", h, wo)
    ys = ye.reshape(bl, e_local * c_e, d)[
        rows, torch.clamp(slot, max=e_local * c_e - 1)]
    ys = ys * (gates * keep.to(xl.dtype))[..., None]
    # each selected slot back at its (token, choice) position, then each
    # token's k choices summed (the reference's .at[toks].add)
    full = xl.new_zeros((bl, s * k, d)).index_put((rows, order), ys)
    return full.reshape(bl, s, k, d).sum(dim=2)


def moe_ffn_ep(x, params, *, num_experts: int, k: int,
               capacity_factor: float = 2.0, axis_name: str = "model",
               mesh=None):
    """Expert-parallel dispatch (see the module docstring).  x: (B, S, D).

    The mesh is ``mesh`` or the ambient one (``core.mesh.use_mesh``).
    Experts split over ``axis_name``, batch rows over the remaining axes
    (row-major); every sort and scatter is per row.  Each shard runs on its
    mesh device in f32 (the reference's boundary type), and the model
    shards' outputs are summed in shard order on the first shard's device.

    Returns ``(y (B, S, D) in x's type on x's device, aux)``, or None
    where the reference does: no mesh, no ``axis_name`` axis, one model
    shard, experts not divisible by the shards, or rows not divisible by
    the data shards."""
    mesh = current_mesh() if mesh is None else mesh
    axes = mesh_axes(mesh)
    if not axes or axis_name not in axes:
        return None
    tp = axes[axis_name]
    if tp <= 1 or num_experts % tp:
        return None
    b, s, d = x.shape
    data_axes = tuple(a for a in mesh.axis_names if a != axis_name)
    n_data = math.prod(axes[a] for a in data_axes)
    if b % n_data:
        return None
    e_local = num_experts // tp
    # per-expert capacity per row; >=8 keeps decode (S=1) drop-free
    c_e = max(8, _ceil8(int(capacity_factor * s * k / num_experts)))
    cap = min(e_local * c_e, s * k)      # selected slots per row per shard

    weights, idx, aux = router_topk(x.reshape(b * s, d), params["router"],
                                    num_experts, k)
    idx_r = idx.reshape(b, s * k)
    tok_r = torch.arange(s, device=x.device).repeat_interleave(k)[
        None].expand(b, -1)
    xf = x.float()
    w_r = weights.reshape(b, s * k).float()
    bl = b // n_data
    outs = []
    for i in range(n_data):
        rows = slice(i * bl, (i + 1) * bl)
        total = None
        for m in range(tp):                   # the psum, in shard order
            dev = _shard_device(mesh, data_axes, axis_name, i, m)
            experts = slice(m * e_local, (m + 1) * e_local)
            part = _ep_local(
                xf[rows].to(dev), w_r[rows].to(dev), idx_r[rows].to(dev),
                tok_r[rows].to(dev),
                *(params[n][experts].to(dev) for n in (
                    "wi_gate", "wi_up", "wo")),
                m=m, e_local=e_local, c_e=c_e, cap=cap,
                num_experts=num_experts, k=k)
            total = part if total is None else total + part.to(total.device)
        outs.append(total.to(x.device))
    return torch.cat(outs).to(x.dtype), aux


def moe_ffn(x, params, *, num_experts: int, k: int, impl: str = "ragged",
            capacity_factor: float = 2.0):
    """x: (T, D) tokens; params: router (D,E), wi_gate/wi_up (E,D,F), wo (E,F,D).

    Returns (y (T, D), aux_loss)."""
    t, d = x.shape
    if impl == "ep":     # (T,D) entry point: EP needs the (B,S,D) caller
        impl = "ragged"  # (moe_ffn_ep); exact, as the reference's
    weights, idx, aux = router_topk(x, params["router"], num_experts, k)
    idx_flat = idx.reshape(-1)                       # (T*k,)
    tok_flat = torch.arange(t, device=x.device).repeat_interleave(k)
    w_flat = weights.reshape(-1).to(x.dtype)

    if impl == "ragged":
        perm, group_sizes = _sort_by_expert(idx_flat, num_experts)
        ys = _ffn_ragged(x[tok_flat[perm]], params["wi_gate"],
                         params["wi_up"], params["wo"], group_sizes)
        ys = ys * w_flat[perm][:, None]
        return _combine(ys, perm, t, k), aux

    if impl == "grouped":
        capacity = int(capacity_factor * t * k / num_experts)
        capacity = max(8, _ceil8(capacity))
        perm, group_sizes = _sort_by_expert(idx_flat, num_experts)
        idx_sorted = idx_flat[perm]
        # position of each sorted slot within its expert group
        starts = torch.cumsum(group_sizes, 0) - group_sizes
        pos = torch.arange(t * k, device=x.device) - starts[idx_sorted]
        keep = pos < capacity
        slot = torch.where(keep, idx_sorted * capacity + pos,
                           num_experts * capacity)
        buf = x.new_zeros((num_experts * capacity + 1, d)).index_put(
            (slot,), x[tok_flat[perm]] * keep[:, None].to(x.dtype))
        xe = buf[:-1].reshape(num_experts, capacity, d)
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, params["wi_gate"])) * \
            torch.einsum("ecd,edf->ecf", xe, params["wi_up"])
        ye = torch.einsum("ecf,efd->ecd", h, params["wo"])
        ys = ye.reshape(num_experts * capacity, d)[torch.clamp(
            slot, max=num_experts * capacity - 1)]
        ys = ys * (w_flat[perm] * keep.to(x.dtype))[:, None]
        return _combine(ys, perm, t, k), aux

    raise ValueError(f"unknown moe impl {impl!r}")


moe_ffn.host_reads = 0          # group sizes read to the host (ragged)
moe_ffn.expert_products = 0     # per-expert products issued (ragged)
