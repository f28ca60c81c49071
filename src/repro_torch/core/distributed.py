"""Distributed combination technique on a device mesh, single-controller.

Port of ``repro.core.distributed``.  The reference drives every device of
a mesh from one process through ``shard_map``; so does the port, with the
mesh a grid of ``torch.device``s (``repro_torch.core.mesh``) and every
collective an explicit, ordered copy or fold between per-device tensors.
A mesh may name one device more than once: its shards then share the
device and the collectives are copies within it, which is how these paths
run on the CPU and on one card.  The result of a gather is one tensor on
``device`` (by default the mesh's first device): the single controller
needs one copy, where the reference leaves a replica on every device.

Parallelism layers, as the reference's:

* across combination grids — ``plan_grid_groups`` places grids on device
  groups, longest processing time first;
* within a grid — ``hierarchize_sharded``: axis 0 sharded, the tail axes
  transformed locally, axis 0 as (local operator rows) @ (all-gathered
  poles), a dense product left to ``torch.tensordot``;
* the communication phase, whose gather step is one weighted reduction of
  surpluses embedded in the common fine grid:

  - grid-replicated (``gather_full_psum`` / ``ct_transform_psum``): the
    grid axis sharded, every shard's weighted sum, then the psum, folded
    in rank order (so the sums are reassociated against the single-device
    gather, as in the reference);
  - slab-sharded (``gather_slab_scatter`` / ``gather_slab_scatter_fused``
    / ``ct_transform_sharded``): the fine grid split into ``n_slabs``
    leading-axis slabs (``repro_torch.core.executor.ShardedPlan``), each
    slab device scatter-adding into only its ``slab_size + 1`` buffer
    through its slab-local index map, then the ordered all-gather of the
    slabs (or, ``gather=False``, a ``SlabSharded`` of them).  The fused
    path runs row 9's grouped scatter once per slab on a slot-owner table
    of that slab (``slab_scatter_tables``), so each slab is bitwise the
    matching slice of the single-device surplus;
  - 2-D (member x slab) mesh (``gather_slab_scatter_2d``): the
    hierarchization itself sharded over ``members * slabs`` compute
    groups (member-major), each group hierarchizing its contiguous member
    shard (``hierarchize_batched_data``, rows 5 and 7) and shipping the
    coefficient-weighted payload it owes every slab
    (``SlabBucket.ship_src``); each slab owner receives the payloads in
    global group order and folds them with ONE ordered ``owner_fold``
    launch on a slot-owner table built from ``ship_idx`` once per plan
    (``two_d_tables``): the per-slot left fold of the dense gather, so the
    result is bitwise the single-device surplus.  (Summing per-group
    partial slabs would reassociate; ``index_add_`` and atomics on the
    card add in no fixed order.)  The reference issues bucket b+1's
    transform and collectives before bucket b's scatter so that they
    overlap; here every bucket's payload is shipped first and each slab
    folds all of them in one launch, bucket by bucket in the same order.

On one device nothing of this is interconnect traffic: the slabs' copies
are copies within the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import lockdep as _lockdep
from repro_torch.core.levels import (LevelVector, SchemeLike, fine_levels,
                                     num_points)
from repro_torch.core.mesh import Mesh, SlabSharded
from repro_torch.kernels import ref
from repro_torch.kernels.hierarchize import (OwnerTable,
                                             hier_forward_grouped,
                                             hier_scatter_grouped,
                                             hierarchize_batched_data,
                                             member_pred_arrays, owner_fold,
                                             owner_table, scatter_table)

__all__ = ["plan_grid_groups", "hierarchize_sharded", "gather_full_psum",
           "gather_slab_scatter", "gather_slab_scatter_fused",
           "gather_slab_scatter_2d", "comm_phase_sharded",
           "ct_transform_psum", "ct_transform_sharded",
           "slab_scatter_tables", "two_d_tables"]


def plan_grid_groups(scheme: SchemeLike, num_groups: int
                     ) -> Tuple[Tuple[LevelVector, ...], ...]:
    """Longest-processing-time placement of combination grids onto groups:
    a tuple of per-group tuples of level vectors, cost = grid points."""
    grids = sorted((ell for ell, _ in scheme.grids), key=num_points,
                   reverse=True)
    loads = [0] * num_groups
    buckets: list = [[] for _ in range(num_groups)]
    for ell in grids:
        g = int(np.argmin(loads))
        buckets[g].append(ell)
        loads[g] += num_points(ell)
    return tuple(tuple(b) for b in buckets)


def _check_mesh(mesh, *axes: str) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"the sharded paths run on a repro_torch.core.mesh."
                        f"Mesh (make_mesh), got {type(mesh).__name__}")
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"{a!r} is not an axis of the mesh (axes: "
                             f"{tuple(mesh.shape)})")
    return mesh


def _group_devices(mesh: Mesh, member_axis: str,
                   axis_name: str) -> Tuple[torch.device, ...]:
    """Compute group ``m * n_slabs + s``'s device (member-major)."""
    am = mesh.axis_names.index(member_axis)
    asl = mesh.axis_names.index(axis_name)
    out = []
    for m in range(mesh.shape[member_axis]):
        for s in range(mesh.shape[axis_name]):
            index = [0] * mesh.devices.ndim
            index[am], index[asl] = m, s
            out.append(mesh.devices[tuple(index)])
    return tuple(out)


# ---------------------------------------------------------------------------
# Pole-parallel hierarchization
# ---------------------------------------------------------------------------

def _padded_operator(level: int, dtype, npad: int) -> np.ndarray:
    """(npad, npad) hierarchization operator, identity on the padding (a
    copy of the reference's constant builder)."""
    n = (1 << level) - 1
    out = np.eye(npad)
    out[:n, :n] = ref.operator_matrix(level)
    return out.astype(dtype)


def hierarchize_sharded(x_padded: torch.Tensor, level0: int, mesh: Mesh,
                        axis_name: str) -> torch.Tensor:
    """Hierarchize a d-dim grid whose axis 0 is padded to ``2**level0``
    and sharded over ``axis_name``; the other axes are unpadded and local.

    Each shard transforms its tail axes locally (``ref.hierarchize_1d_ref``,
    no communication), the shards are all-gathered along axis 0, and each
    shard's rows come out as (its operator rows) @ (the gathered poles) — a
    dense product (``torch.tensordot``; the reference leaves it to XLA).
    The operator is built in float32 and cast, as the reference's (its
    entries 1 and -1/2 are exact).  The sums of that product are ordered
    otherwise than the level loop's: agreement is to rounding.  Returns
    the transformed grid on the mesh's first device."""
    _check_mesh(mesh, axis_name)
    n0p = x_padded.shape[0]
    if n0p != 1 << level0:
        raise ValueError(f"axis 0 must be padded to 2**{level0}, got {n0p}")
    devices = mesh.axis_devices(axis_name)
    nshards = len(devices)
    if n0p % nshards:
        raise ValueError(f"{nshards} shards do not divide axis 0 ({n0p})")
    shard = n0p // nshards
    hmat = torch.from_numpy(_padded_operator(level0, np.float32, n0p))
    locs = []
    for i, dev in enumerate(devices):
        x = x_padded[i * shard:(i + 1) * shard].to(dev)
        for ax in range(1, x.ndim):        # tail axes: no communication
            x = ref.hierarchize_1d_ref(x, axis=ax)
        locs.append(x)
    out = []
    for i, dev in enumerate(devices):
        xg = torch.cat([x.to(dev) for x in locs])       # all-gather, ordered
        rows = hmat[i * shard:(i + 1) * shard].to(device=dev, dtype=xg.dtype)
        out.append(torch.tensordot(rows, xg, dims=([1], [0])))
    first = mesh.first_device()
    return torch.cat([o.to(first) for o in out])


# ---------------------------------------------------------------------------
# The grid-replicated gather
# ---------------------------------------------------------------------------

def _psum(parts, device: torch.device) -> torch.Tensor:
    """The sum of ``parts`` on ``device``, folded in rank order:
    ``((p0 + p1) + p2) + ...``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def gather_full_psum(embedded: torch.Tensor, coeff: torch.Tensor,
                     mesh: Mesh, axis_name: str) -> torch.Tensor:
    """Gather over grid groups: ``sum_g coeff_g * embedded_g``.

    ``embedded`` (G, *fine_shape) is sharded along G over ``axis_name``
    (G a multiple of its extent; the callers pad); each shard's weighted
    sum (``torch.tensordot``) is computed on its device, then the psum
    folds the shards' sums in rank order on the mesh's first device.
    Reassociated against a single sum over G, as the reference's."""
    _check_mesh(mesh, axis_name)
    devices = mesh.axis_devices(axis_name)
    g = embedded.shape[0]
    if g % len(devices):
        raise ValueError(f"{g} grids do not shard over {len(devices)} "
                         f"devices; pad them")
    loc = g // len(devices)
    dtype = torch.promote_types(embedded.dtype, torch.as_tensor(coeff).dtype)
    coeff = torch.as_tensor(coeff)
    parts = []
    for k, dev in enumerate(devices):
        e = embedded[k * loc:(k + 1) * loc].to(device=dev, dtype=dtype)
        c = coeff[k * loc:(k + 1) * loc].to(device=dev, dtype=dtype)
        parts.append(torch.tensordot(c, e, dims=([0], [0])))
    return _psum(parts, mesh.first_device())


# ---------------------------------------------------------------------------
# Per-plan tables of the slab-sharded gathers
# ---------------------------------------------------------------------------

def slab_scatter_tables(splan) -> tuple:
    """Row 9's slot-owner table of every slab: ``scatter_table`` of the
    plan's last passes over the slab-local maps ``[sb.index[s] ...]``,
    dump ``slab_size``.  Built once per sharded plan."""
    from repro_torch.core.executor import _pass_specs, _plan_table

    def build():
        _, last = _pass_specs(splan.plan)
        return tuple(scatter_table(last, [sb.index[s]
                                          for sb in splan.slab_buckets],
                                   splan.slab_size)
                     for s in range(splan.n_slabs))
    return _plan_table("slab", [sb.index for sb in splan.slab_buckets],
                       build)


@dataclasses.dataclass
class TwoDTables:
    """What the 2-D ingest of one sharded plan needs besides the data: per
    slab the owner table of its fold (``folds``: every bucket's
    ``ship_idx[s]``, bucket by bucket, group by group), per bucket the
    predecessor data of the member stack padded to ``n_groups *
    group_size`` rows (pad members all-False), and per (bucket, group,
    device) the group's shard of both on the device, made at first use."""

    folds: Tuple[OwnerTable, ...]
    preds: tuple
    _on: dict = dataclasses.field(default_factory=dict)
    _lock: Any = dataclasses.field(
        default_factory=lambda: _lockdep.make_lock("two-d-tables"))

    def group(self, splan, b: int, i: int, device: torch.device) -> tuple:
        """``(ship_src[i], predecessor data)`` of bucket b's group i on
        ``device``."""
        key = (b, i, device)
        with self._lock:
            t = self._on.get(key)
        if t is None:
            sb = splan.slab_buckets[b]
            gs = sb.group_size
            t = (torch.from_numpy(np.ascontiguousarray(
                sb.ship_src[i])).to(device).long(),
                tuple(torch.from_numpy(np.ascontiguousarray(
                    a[i * gs:(i + 1) * gs])).to(device)
                    for a in self.preds[b]))
            with self._lock:
                t = self._on.setdefault(key, t)
        return t


def two_d_tables(splan) -> TwoDTables:
    """The 2-D ingest's tables of ``splan`` (``TwoDTables``), built once
    per sharded plan."""
    from repro_torch.core.executor import _plan_table
    if splan.n_groups < 2:
        raise ValueError("two_d_tables: the plan is not compute-sharded "
                         "(n_groups < 2)")

    def build():
        folds = tuple(owner_table([sb.ship_idx[s]
                                   for sb in splan.slab_buckets],
                                  splan.slab_size)
                      for s in range(splan.n_slabs))
        preds = []
        for b, sb in zip(splan.plan.buckets, splan.slab_buckets):
            pad = splan.n_groups * sb.group_size - len(b.ells)
            preds.append(tuple(np.pad(a, ((0, pad), (0, 0)))
                               for a in member_pred_arrays(b.levels,
                                                           b.shape)))
        return TwoDTables(folds=folds, preds=tuple(preds))
    return _plan_table("2d", [sb.ship_idx for sb in splan.slab_buckets],
                       build)


# ---------------------------------------------------------------------------
# The slab-sharded gathers
# ---------------------------------------------------------------------------

def _check_slab_gather_args(splan, mesh: Mesh, axis_name: str,
                            n_inputs: int, what: str) -> None:
    _check_mesh(mesh, axis_name)
    nshards = mesh.shape[axis_name]
    if nshards != splan.n_slabs:
        raise ValueError(
            f"plan is sharded for {splan.n_slabs} slab(s) but mesh axis "
            f"{axis_name!r} has {nshards} device(s); rebuild with "
            f"shard_plan(plan, {nshards})")
    if n_inputs != len(splan.plan.buckets):
        raise ValueError(f"got {n_inputs} {what} array(s) for "
                         f"{len(splan.plan.buckets)} bucket(s)")


def _finish_slab_gather(bufs, splan, gather: bool, device):
    """The gathered fine grid on ``device`` (the slabs copied in order into
    one buffer: the all-gather), or, ``gather=False``, a ``SlabSharded``
    of the slabs where they lie."""
    fine_shape = splan.plan.fine_shape
    size = splan.slab_size
    if not gather:
        return SlabSharded(tuple(
            b[:size].view((splan.slab_rows,) + tuple(fine_shape[1:]))
            for b in bufs), tuple(fine_shape))
    out = torch.empty(splan.plan.fine_size, dtype=bufs[0].dtype,
                      device=device)
    for s, buf in enumerate(bufs):
        a = s * size
        n = min(size, splan.plan.fine_size - a)
        if n > 0:
            out[a:a + n].copy_(buf[:n])
    return out.view(fine_shape)


def _split(coeffs: torch.Tensor, splan) -> list:
    return list(torch.split(coeffs, [len(b.ells) for b in splan.plan.buckets]))


def _coeff_list(coeff_arrays, splan, dtype) -> list:
    if coeff_arrays is None:
        coeff_arrays = [b.coeffs for b in splan.plan.buckets]
    return [torch.as_tensor(c).to(dtype) for c in coeff_arrays]


def gather_slab_scatter(alphas, sharded_plan, mesh: Mesh, axis_name: str, *,
                        gather: bool = True, idx_arrays=None,
                        coeff_arrays=None, device=None):
    """Slab-sharded gather of per-bucket COMPACT surpluses ``alphas``
    (``bucket_surpluses``, one (G_b, P_b) tensor per bucket, replicated):
    each slab device weights them by the coefficients and adds them into
    its ``slab_size + 1`` buffer through its slab-local maps, one ordered
    ``index_add_`` per member (each member's map is injective off the
    dump slot, so the per-slot order is member order: the bits of the
    single-device unfused ingest).

    ``gather=True`` returns the fine grid on ``device`` (default: the mesh's
    first device); ``gather=False`` a ``SlabSharded`` (rows past
    ``fine_shape[0]`` zero).  ``idx_arrays`` (per bucket, (S, G, P)) and
    ``coeff_arrays`` (per bucket, (G,)) override the plan's."""
    splan = sharded_plan
    _check_slab_gather_args(splan, mesh, axis_name, len(alphas), "surplus")
    dtype = alphas[0].dtype
    for a in alphas[1:]:
        dtype = torch.promote_types(dtype, a.dtype)
    if idx_arrays is None:
        idx_arrays = [sb.index for sb in splan.slab_buckets]
    coeffs = _coeff_list(coeff_arrays, splan, dtype)
    device = mesh.first_device() if device is None else torch.device(device)
    bufs = []
    for s, dev in enumerate(mesh.axis_devices(axis_name)):
        buf = torch.zeros(splan.slab_size + 1, dtype=dtype, device=dev)
        for a, idx, c in zip(alphas, idx_arrays, coeffs):
            a, c = a.to(device=dev, dtype=dtype), c.to(dev)
            idx = torch.as_tensor(idx[s]).to(dev)
            for m in range(a.shape[0]):
                # ctlint: ok(bit-identity-reassoc): idx[m] is injective off the dump slot and the calls run in member order, so each slot's adds are the left fold (tests/test_torch_distributed.py::test_ct_transform_sharded_bitwise_single_device, unfused_1d)
                buf.index_add_(0, idx[m], c[m] * a[m])
        bufs.append(buf)
    return _finish_slab_gather(bufs, splan, gather, device)


def gather_slab_scatter_fused(tails, sharded_plan, mesh: Mesh,
                              axis_name: str, *, gather: bool = True,
                              tables=None, coeff_arrays=None, device=None):
    """Slab-sharded gather with the fused epilogue (row 9): ``tails`` is
    the flat concatenation of the bucket stacks with every pass before
    each bucket's last applied (``hier_forward_grouped`` on the plan's
    ``_pass_specs``), replicated.  Each slab device
    runs ``hier_scatter_grouped`` on its slab's table
    (``slab_scatter_tables``) into its ``slab_size + 1`` buffer: the last
    pass, the coefficient weighting and the ordered scatter-add, two
    launches a slab on CUDA.  The reference's tails are the tail-axis
    transforms with axis 0 last; the port's last pass follows the
    reference's axis order per bucket (axis 0 on its Pallas path), so
    that every bucket fuses with the single-device bits.  Per fine slot
    the adds run in global member order from a zero buffer: each slab is
    bitwise the matching slice of the single-device surplus.  Same
    ``gather`` semantics as ``gather_slab_scatter``."""
    splan = sharded_plan
    _check_slab_gather_args(splan, mesh, axis_name, len(splan.plan.buckets),
                            "bucket")
    tables = slab_scatter_tables(splan) if tables is None else tables
    if coeff_arrays is None:
        coeffs = torch.from_numpy(np.concatenate(
            [b.coeffs for b in splan.plan.buckets]))
    else:
        coeffs = torch.cat([torch.as_tensor(c).reshape(-1)
                            for c in coeff_arrays]) \
            if isinstance(coeff_arrays, (list, tuple)) else coeff_arrays
    device = mesh.first_device() if device is None else torch.device(device)
    bufs = []
    for s, dev in enumerate(mesh.axis_devices(axis_name)):
        buf = torch.zeros(splan.slab_size + 1, dtype=tails.dtype, device=dev)
        hier_scatter_grouped(tails.to(dev), tables[s],
                             coeffs.to(device=dev, dtype=tails.dtype), buf)
        bufs.append(buf)
    return _finish_slab_gather(bufs, splan, gather, device)


def gather_slab_scatter_2d(stacks, sharded_plan, mesh: Mesh,
                           member_axis: str, axis_name: str, *,
                           gather: bool = True, tables=None,
                           coeff_arrays=None, dtype=None, device=None):
    """2-D (member x slab) gather: the hierarchization itself sharded.
    ``stacks`` are the per-bucket NODAL compact stacks
    (``bucket_nodal_stacks``, (G_b, P_b) each).  Compute group ``i = m *
    n_slabs + s`` (on mesh device (m, s)):

    1. hierarchizes its contiguous member shard of every bucket
       (``hierarchize_batched_data``, the padded member rows zero with
       all-False predecessor masks) and weights it by its coefficients;
    2. ships the payload it owes every slab (``ship_src``): the slab
       owner (mesh device (0, s)) receives them in global group order —
       the all-to-all over the slab axis and the all-gather over the
       member axis, as ordered copies;
    3. each slab owner folds every payload of every bucket into its
       ``slab_size + 1`` buffer with one ``owner_fold`` launch on its
       table (``two_d_tables``): per slot the left fold in global member
       order, so the result is bitwise the single-device surplus.

    ``tables`` (``two_d_tables(splan)``) and ``coeff_arrays`` (per bucket)
    override the plan's; ``dtype`` the accumulation dtype.  Same
    ``gather`` semantics as the 1-D gathers."""
    splan = sharded_plan
    nb = len(stacks)
    _check_slab_gather_args(splan, mesh, axis_name, nb, "nodal-stack")
    if member_axis not in mesh.shape:
        raise ValueError(f"member_axis {member_axis!r} is not an axis of the "
                         f"mesh (axes: {tuple(mesh.shape)})")
    if member_axis == axis_name:
        raise ValueError(f"member_axis and axis_name must differ, both "
                         f"{axis_name!r}")
    n_slabs = splan.n_slabs
    n_groups = int(mesh.shape[member_axis]) * n_slabs
    if splan.n_groups != n_groups:
        raise ValueError(
            f"plan is compute-sharded for {splan.n_groups} group(s) but "
            f"the (member x slab) mesh has {n_groups}; rebuild with "
            f"shard_plan(plan, {n_slabs}, n_groups={n_groups})")
    if dtype is None:
        dtype = stacks[0].dtype
        for a in stacks[1:]:
            dtype = torch.promote_types(dtype, a.dtype)
    tables = two_d_tables(splan) if tables is None else tables
    coeffs = _coeff_list(coeff_arrays, splan, dtype)
    groups = _group_devices(mesh, member_axis, axis_name)
    owners = groups[:n_slabs]                # member row 0 owns the slabs
    received = [[] for _ in range(n_slabs)]
    for b, (bucket, sb, x, c) in enumerate(zip(
            splan.plan.buckets, splan.slab_buckets, stacks, coeffs)):
        gs, g = sb.group_size, len(bucket.ells)
        for i, dev in enumerate(groups):
            lo, hi = min(i * gs, g), min((i + 1) * gs, g)
            xi = torch.zeros((gs,) + bucket.shape, dtype=dtype, device=dev)
            xi[:hi - lo] = x[lo:hi].to(device=dev, dtype=dtype).view(
                (hi - lo,) + bucket.shape)
            ci = torch.zeros(gs, dtype=dtype, device=dev)
            ci[:hi - lo] = c[lo:hi].to(dev)
            src, pred = tables.group(splan, b, i, dev)
            alpha = hierarchize_batched_data(xi, pred).reshape(gs, -1)
            w = torch.cat([(ci[:, None] * alpha).reshape(-1),
                           torch.zeros(1, dtype=dtype, device=dev)])
            payload = w[src]                               # (S, L)
            for s, owner in enumerate(owners):
                received[s].append(payload[s].to(owner))
    bufs = []
    for s, owner in enumerate(owners):
        buf = torch.zeros(splan.slab_size + 1, dtype=dtype, device=owner)
        owner_fold(torch.cat(received[s]), tables.folds[s], buf)
        bufs.append(buf)
    device = mesh.first_device() if device is None else torch.device(device)
    return _finish_slab_gather(bufs, splan, gather, device)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _sharded_ingest(grids, splan, mesh: Mesh, axis_name: str, *,
                    member_axis: Optional[str], fused: Optional[bool],
                    coeffs: torch.Tensor, dtype: torch.dtype,
                    device: torch.device, gather: bool = True,
                    tables=None, idxs=None):
    """The sharded ingest of ``grids`` (on ``device``, the plan's member
    grids) under ``splan``: the 2-D path when ``member_axis`` is meshed
    and the plan compute-sharded, else the 1-D fused (default) or unfused
    path.  ``coeffs`` are the plan's coefficients concatenated, in
    ``dtype`` on ``device``; ``tables`` / ``idxs`` the per-plan tables or
    per-slab index maps a caller bound (built from the plan when None)."""
    from repro_torch.core.executor import (_assemble, _bucket_views,
                                           _pass_specs)
    from repro_torch.kernels.hierarchize import hierarchize_batched
    x = _assemble(grids, splan.plan.buckets, dtype)
    if member_axis is not None and splan.n_groups > 1:
        stacks = [v.reshape(len(b.ells), -1) for b, v in zip(
            splan.plan.buckets, _bucket_views(x, splan.plan.buckets))]
        return gather_slab_scatter_2d(
            stacks, splan, mesh, member_axis, axis_name, gather=gather,
            tables=tables, coeff_arrays=_split(coeffs, splan), dtype=dtype,
            device=device)
    if fused is not False:
        y = hier_forward_grouped(x, _pass_specs(splan.plan)[0])
        return gather_slab_scatter_fused(
            y, splan, mesh, axis_name, gather=gather, tables=tables,
            coeff_arrays=coeffs, device=device)
    alphas = [hierarchize_batched(v, b.levels).reshape(len(b.ells), -1)
              for b, v in zip(splan.plan.buckets,
                              _bucket_views(x, splan.plan.buckets))]
    return gather_slab_scatter(alphas, splan, mesh, axis_name, gather=gather,
                               idx_arrays=idxs,
                               coeff_arrays=_split(coeffs, splan),
                               device=device)


def ct_transform_sharded(nodal_grids, scheme: Optional[SchemeLike],
                         mesh: Mesh, axis_name: str, *,
                         full_levels: Optional[Sequence[int]] = None,
                         plan=None, gather: bool = True,
                         fused: Optional[bool] = None,
                         interpret: Optional[bool] = None,
                         spec=None, member_axis: Optional[str] = None,
                         device=None):
    """Memory-scaling distributed gather: the slab-sharded
    ``ct_transform`` whose per-device scatter target is one slab.

    ``plan`` (a ``shard_plan`` result) reuses a live plan; otherwise one is
    built for ``mesh.shape[axis_name]`` slabs.  ``member_axis`` (or
    ``spec.member_axis``) names the second axis of a 2-D mesh: the
    hierarchization is then sharded too (``gather_slab_scatter_2d``).
    Otherwise the fused epilogue runs (``gather_slab_scatter_fused``, the
    port's default on every bucket) unless ``fused=False``
    (``gather_slab_scatter``).  All paths give the single-device
    ``ct_transform``'s bits.  The grids are assembled on ``device``
    (default the mesh's first), where the gathered result lands;
    ``gather=False`` returns a ``SlabSharded`` instead.  ``spec``
    consolidates ``fused``/``interpret``/``merge``; the bare keywords are
    deprecated."""
    from repro_torch.core.executor import (_grids_on, build_plan,
                                           resolve_spec, shard_plan)
    spec = resolve_spec("ct_transform_sharded", spec, fused=fused,
                        interpret=interpret)
    _check_mesh(mesh, axis_name)
    device = mesh.first_device() if device is None else torch.device(device)
    for dev in {device.type, mesh.device_type}:
        spec.resolve_interpret(torch.device(dev))
    if device.type != mesh.device_type:
        raise ValueError(f"the gather's device {device} is not of the "
                         f"mesh's type ({mesh.device_type}): no path mixes "
                         f"the CPU with a card")
    if member_axis is None:
        member_axis = spec.member_axis
    n_groups = 1
    if member_axis is not None:
        _check_mesh(mesh, member_axis)
        n_groups = int(mesh.shape[member_axis]) * int(mesh.shape[axis_name])
    if plan is None:
        plan = shard_plan(build_plan(scheme, full_levels, merge=spec.merge),
                          mesh.shape[axis_name], n_groups=n_groups)
    elif full_levels is not None and plan.full_levels != \
            tuple(int(l) for l in full_levels):
        raise ValueError(
            f"plan embeds into {plan.full_levels}, caller asked for "
            f"{tuple(int(l) for l in full_levels)}")
    if member_axis is not None and n_groups == 1:
        member_axis = None           # a 1 x 1 mesh: the classic slab path
    grids, dtype = _grids_on(nodal_grids, plan.plan, device)
    coeffs = torch.from_numpy(np.concatenate(
        [b.coeffs for b in plan.plan.buckets])).to(device=device, dtype=dtype)
    if member_axis is None:
        _check_slab_gather_args(plan, mesh, axis_name,
                                len(plan.plan.buckets), "bucket")
    return _sharded_ingest(grids, plan, mesh, axis_name,
                           member_axis=member_axis, fused=spec.fused,
                           coeffs=coeffs, dtype=dtype, device=device,
                           gather=gather)


def comm_phase_sharded(hier_grids, scheme: SchemeLike, mesh: Mesh,
                       axis_name: str,
                       full_levels: Optional[Sequence[int]] = None, *,
                       plan=None, spec=None):
    """Full communication phase of already-hierarchized grids: the gather,
    then each grid's extract.  Default: the grid-replicated psum (every
    grid embedded, the stack's psum over ``axis_name``).  With a
    slab-sharded ``plan``, or a sharded ``spec`` from which one is built,
    the gather runs slab-sharded (``gather_slab_scatter``) on the grids
    packed into compact bucket rows."""
    from repro_torch.core.combination import embed_to_full, extract_from_full
    from repro_torch.core.executor import (_assemble, _bucket_views,
                                           _grids_on, build_plan,
                                           ensure_spec)
    ensure_spec("comm_phase_sharded", spec)
    _check_mesh(mesh, axis_name)
    if plan is None and spec is not None and spec.slabs > 1:
        plan = build_plan(scheme, full_levels, spec=spec)
    if full_levels is None:
        full_levels = fine_levels(scheme)
    full_levels = tuple(int(l) for l in full_levels)
    ells = [ell for ell, _ in scheme.grids]
    first = mesh.first_device()
    if plan is not None:
        if plan.full_levels != full_levels:
            raise ValueError(
                f"plan embeds into {plan.full_levels}, comm phase asked "
                f"for {full_levels}")
        base = plan.plan
        grids, dtype = _grids_on(hier_grids, base, first)
        x = _assemble(grids, base.buckets, dtype)
        alphas = [v.reshape(len(b.ells), -1) for b, v in
                  zip(base.buckets, _bucket_views(x, base.buckets))]
        combined = gather_slab_scatter(alphas, plan, mesh, axis_name)
        return {ell: extract_from_full(combined, ell, full_levels)
                for ell in ells}
    # the coefficients stay float64, so an f32 phase sums in f64, as the
    # reference's tensordot promotes
    coeffs = torch.tensor([float(c) for _, c in scheme.grids],
                          dtype=torch.float64)
    emb = torch.stack([embed_to_full(torch.as_tensor(hier_grids[ell]).to(
        first), ell, full_levels) for ell in ells])
    combined = gather_full_psum(*_pad_grids(emb, coeffs, mesh, axis_name),
                                mesh, axis_name)
    return {ell: extract_from_full(combined, ell, full_levels)
            for ell in ells}


def _pad_grids(embedded, coeffs, mesh: Mesh, axis_name: str):
    """``embedded`` and ``coeffs`` zero-padded along the grid axis to a
    multiple of the mesh axis's extent."""
    pad = (-embedded.shape[0]) % int(mesh.shape[axis_name])
    if pad:
        embedded = torch.cat([embedded, embedded.new_zeros(
            (pad,) + tuple(embedded.shape[1:]))])
        coeffs = torch.cat([coeffs, coeffs.new_zeros(pad)])
    return embedded, coeffs


def ct_transform_psum(nodal_grids, scheme: SchemeLike, mesh: Mesh,
                      axis_name: str,
                      full_levels: Optional[Sequence[int]] = None, *,
                      plan=None, spec=None):
    """Distributed batched gather: the executor's per-grid embedded
    surpluses (``ct_embedded``, on the mesh's first device), then one
    weighted psum over grid groups.  With a slab-sharded ``plan`` (or a
    spec with ``n_slabs``) it runs ``ct_transform_sharded`` instead (same
    result, no (G, *fine_shape) stack)."""
    from repro_torch.core.executor import (build_plan, ct_embedded,
                                           resolve_spec)
    spec = resolve_spec("ct_transform_psum", spec)
    _check_mesh(mesh, axis_name)
    if plan is None and spec.slabs > 1:
        plan = build_plan(scheme, full_levels, spec=spec)
    if plan is not None:
        return ct_transform_sharded(
            nodal_grids, scheme, mesh, axis_name, full_levels=full_levels,
            plan=plan, spec=dataclasses.replace(spec, mesh=None,
                                                n_slabs=None))
    embedded, coeffs, _ = ct_embedded(nodal_grids, scheme,
                                      full_levels=full_levels, spec=spec,
                                      device=mesh.first_device())
    embedded, coeffs = _pad_grids(embedded, coeffs, mesh, axis_name)
    return gather_full_psum(embedded, coeffs.to(embedded.dtype), mesh,
                            axis_name)
