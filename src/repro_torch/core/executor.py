"""Batched combination-technique executor (CT ingest and scatter).

Port of ``repro.core.executor`` on plain (unsharded) plans:

  1. **Bucketing** — component grids are grouped by canonical
     (descending-level) shape; every axis permutation of one level
     multiset shares a bucket.
  2. **Cost-model bucket merging** (opt-in, ``merge=MergeConfig(...)``) —
     near-shape buckets merge into padded super-buckets by the optimal
     contiguous partition of the descending-sorted shape sequence, priced
     with the reference's TPU model so that plans are array-equal to the
     reference's.
  3. **Batched hierarchization** — one batched forward transform per
     bucket (``repro_torch.kernels.hierarchize``), axes in the reference's
     per-shape order.
  4. **Static index plan + scatter-add** — a per-bucket (G, P) int32 map
     into the flat common fine grid (+1 dump slot for pad positions).
  5. **Scatter phase** (``ct_scatter``) — the same map read in reverse:
     each bucket's surpluses are read off the fine grid and dehierarchized
     batched (``dehierarchize_batched``), back onto every component grid.
  6. **Incremental rebuilds** (``extend_plan``,
     ``update_plan_coefficients``) — the adaptive and fault-recovery
     paths: unchanged buckets are returned by object identity, buckets
     whose coefficients alone moved keep their ``index`` by identity, and
     the result is array-equal to a from-scratch ``build_plan``.

Sharded plans (``shard_plan``, or ``build_plan`` under a sharded spec)
are the reference's: a ``ShardedPlan`` wraps the base plan with per-slab
index maps (the fine grid split into ``n_slabs`` leading-axis slabs) and,
for the 2-D (member x slab) ingest, the per-group shipping maps; the
incremental rebuilds re-shard incrementally, and the entry points that
read a plan take either (a ``ShardedPlan`` runs through its base plan
unless a meshed spec routes it to ``repro_torch.core.distributed``).

Execution policy comes as one ``spec=repro_torch.core.engine.ExecSpec``
on every entry point, under the reference's precedence rules
(``resolve_spec``): an explicit spec wins and a conflicting legacy keyword
raises; the legacy keywords (``merge=``, ``fused=``) fold into a spec and
warn once per call-site family.  ``device=`` stays a plain keyword.

Execution rule of the port: every bucket, on every device, takes the
FUSED epilogue by default — each bucket's last forward pass writes the
coefficient-weighted surpluses straight into the fine grid, so the
compact (G, P) surplus stack is never stored.  The reference gates its
fused path on a TPU VMEM budget and on its Pallas path; on Hopper the
fine grid stays in device memory and the pass axis is a kernel
parameter, so no gate is needed.  The fused ingest runs every bucket at
once: the stacks are assembled into one flat buffer (one
``assemble_grouped`` launch), one ``hier_forward_grouped`` launch
applies every bucket's passes before its last, and
``hier_scatter_grouped`` (two launches) applies the last passes and adds
into the fine grid through the plan's slot-owner table
(``scatter_table``, built once per plan and kept while the plan's index
maps live): four launches however many grids the scheme has.
``fused=False`` runs the full transform bucket by bucket on the same
assembled buffer and then one ordered ``index_add_`` per member.  Both
accumulate each fine slot as a left fold in global member order, so they
give the same bits.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import lockdep as _lockdep
from repro_torch.core.levels import (LevelVector, SchemeLike,
                                     canonical_levels, fine_levels,
                                     grid_shape)
from repro_torch.kernels.hierarchize import (ScatterTable, assemble_grouped,
                                             axis_order, batched_method,
                                             dehierarchize_batched,
                                             hier_flops,
                                             hier_forward_grouped,
                                             hier_scatter_grouped,
                                             hier_tail_batched,
                                             hierarchize_batched,
                                             scatter_table,
                                             storage_released, tile_volume)

__all__ = ["ExecutorPlan", "Bucket", "ShardedPlan", "SlabBucket",
           "MergeConfig", "build_plan", "shard_plan",
           "extend_plan", "update_plan_coefficients", "ct_transform",
           "ct_transform_with_plan", "ct_scatter", "ct_scatter_with_plan",
           "ct_embedded", "ct_embedded_with_plan", "bucket_surpluses",
           "bucket_tail_surpluses", "bucket_nodal_stacks", "plan_fused_ok",
           "plan_launch_stats", "plan_ingest_stats", "clear_plan_cache",
           "resolve_spec", "ensure_spec"]


# ---------------------------------------------------------------------------
# ExecSpec resolution and the legacy-keyword warnings
# ---------------------------------------------------------------------------

#: (function, sorted legacy keywords) families already warned about: each
#: warns once per process (``reset_legacy_warnings`` rearms them).
_WARNED_LEGACY: set = set()
_WARNED_LEGACY_LOCK = _lockdep.make_lock("warn-once")


def reset_legacy_warnings() -> None:
    """Re-arm every once-per-call-site legacy-keyword warning (tests)."""
    with _WARNED_LEGACY_LOCK:
        _WARNED_LEGACY.clear()


def warn_legacy_kwargs(fn_name: str, kwarg_names: Sequence[str]) -> None:
    """One ``DeprecationWarning`` per (function, keywords) family: the
    execution keywords keep working but should become one ``spec=``.  The
    first thread to claim a family warns; concurrent callers stay
    silent."""
    key = (fn_name, tuple(sorted(kwarg_names)))
    with _WARNED_LEGACY_LOCK:
        if key in _WARNED_LEGACY:
            return
        _WARNED_LEGACY.add(key)
    shown = ", ".join(f"{k}=" for k in sorted(kwarg_names))
    warnings.warn(
        f"{fn_name}: keyword(s) {shown} are deprecated; pass "
        f"spec=repro_torch.core.engine.ExecSpec(...) instead (the legacy "
        f"keywords are folded into an ExecSpec and keep working)",
        DeprecationWarning, stacklevel=3)


def ensure_spec(fn_name: str, spec) -> None:
    """Named ``TypeError`` when ``spec=`` receives something else than an
    ``ExecSpec`` (an old positional caller's option landing in ``spec``)."""
    from repro_torch.core.engine import ExecSpec
    if spec is not None and not isinstance(spec, ExecSpec):
        raise TypeError(
            f"{fn_name}: spec must be a repro_torch.core.engine.ExecSpec, "
            f"got {type(spec).__name__}; legacy options go in their "
            f"(deprecated) keywords, e.g. merge=..., not positionally")


def resolve_spec(fn_name: str, spec, **legacy):
    """Fold legacy execution keywords into an ``ExecSpec``: an explicit
    ``spec=`` wins and a non-``None`` legacy keyword beside it raises;
    legacy keywords alone build the equivalent spec and warn once per
    call-site family."""
    from repro_torch.core.engine import ExecSpec
    ensure_spec(fn_name, spec)
    given = {k: v for k, v in legacy.items() if v is not None}
    if spec is None:
        spec = ExecSpec()
    elif given:
        shown = ", ".join(f"{k}=" for k in sorted(given))
        raise ValueError(
            f"{fn_name}: pass either spec= or the legacy keyword(s) "
            f"{shown}, not both (fold them into the ExecSpec)")
    if given:
        warn_legacy_kwargs(fn_name, tuple(given))
        spec = dataclasses.replace(spec, **given)
    return spec


@dataclass(frozen=True)
class Bucket:
    """One batch of component grids sharing a canonical (padded) shape."""

    ells: Tuple[LevelVector, ...]        # original level vectors
    perms: Tuple[Tuple[int, ...], ...]   # canon axis k <- original axis perm[k]
    levels: Tuple[LevelVector, ...]      # canonicalized member level vectors
    target: LevelVector                  # componentwise max over members
    coeffs: np.ndarray                   # (G,) combination coefficients
    index: np.ndarray                    # (G, P) int32 flat fine indices

    @property
    def shape(self) -> Tuple[int, ...]:
        return grid_shape(self.target)


@dataclass(frozen=True)
class ExecutorPlan:
    """Precomputed static execution plan for one scheme's gather phase;
    ``merge`` is the bucket-merging cost model it was built with."""

    dim: int
    full_levels: LevelVector
    fine_shape: Tuple[int, ...]
    buckets: Tuple[Bucket, ...]
    merge: Optional["MergeConfig"] = None

    @property
    def fine_size(self) -> int:
        return int(np.prod(self.fine_shape))

    @property
    def num_grids(self) -> int:
        return sum(len(b.ells) for b in self.buckets)


@dataclass(frozen=True)
class SlabBucket:
    """Per-slab split of one bucket's embed index map, as the reference's.

    The fine grid is split into ``n_slabs`` contiguous slabs along its
    leading axis (``slab_rows`` rows each, the last one ragged when
    ``fine_shape[0] % n_slabs != 0``).  For slab ``s``:

    * ``index[s]`` — the bucket's (G, P) map in slab-LOCAL flat
      coordinates; every entry outside slab ``s`` (and every pad position)
      points at the slab dump slot ``slab_size``, so each global index
      lands in exactly one slab and the per-slot addition order of the
      dense gather is kept;
    * ``row_ranges[s, g]`` — the range ``[start, stop)`` of member g's
      nodes along its ORIGINAL leading axis whose embedded rows fall in
      slab ``s``.

    Compute-sharded over ``n_groups`` member groups (the 2-D ingest), the
    bucket also carries the shipping maps: ``group_size`` members per
    group (``ceil(G / n_groups)``, the stack zero-padded at the tail);
    ``ship_src[i, s]`` gathers, from group i's flattened weighted stack
    plus one trailing zero slot, the payload it owes slab ``s`` in
    (member, position) order (pads read the zero slot); ``ship_idx[s, i]``
    holds the matching slab-local targets (pads on the dump slot).  The
    payloads of all groups, in group order, replay the base map's global
    (g, p) order restricted to slab ``s``."""

    index: np.ndarray        # (S, G, P) int32 slab-local indices
    row_ranges: np.ndarray   # (S, G, 2) int32 node ranges [start, stop)
    ship_src: Optional[np.ndarray] = None   # (n_groups, S, L) int32
    ship_idx: Optional[np.ndarray] = None   # (S, n_groups, L) int32
    group_size: int = 0                     # members per group (padded)


@dataclass(frozen=True)
class ShardedPlan:
    """Slab-sharded view of an ``ExecutorPlan``: the same buckets and
    coefficients (``plan``, shared by identity), plus per-slab maps so each
    of ``n_slabs`` devices scatter-adds only into its own
    ``ceil(fine_shape[0] / n_slabs)``-row slab
    (``repro_torch.core.distributed``).  ``n_groups > 1``: the 2-D ingest,
    each of ``n_groups`` devices hierarchizing only its member shard."""

    plan: ExecutorPlan
    n_slabs: int
    slab_rows: int                        # ceil(fine_shape[0] / n_slabs)
    slab_buckets: Tuple[SlabBucket, ...]
    n_groups: int = 1

    @property
    def row_size(self) -> int:
        return int(np.prod(self.plan.fine_shape[1:], dtype=np.int64))

    @property
    def slab_size(self) -> int:
        return self.slab_rows * self.row_size

    # -- the ExecutorPlan surface the fault / adaptive callers read --
    @property
    def dim(self) -> int:
        return self.plan.dim

    @property
    def full_levels(self) -> LevelVector:
        return self.plan.full_levels

    @property
    def fine_shape(self) -> Tuple[int, ...]:
        return self.plan.fine_shape

    @property
    def fine_size(self) -> int:
        return self.plan.fine_size

    @property
    def buckets(self) -> Tuple[Bucket, ...]:
        return self.plan.buckets

    @property
    def merge(self) -> Optional["MergeConfig"]:
        return self.plan.merge

    @property
    def num_grids(self) -> int:
        return self.plan.num_grids


def _group_ship_maps(index: np.ndarray, n_groups: int,
                     slab_size: int) -> tuple:
    """Shipping maps of one bucket for the 2-D ingest (see
    ``SlabBucket``): group i owns member rows ``[i*gs, (i+1)*gs)``;
    per (slab s, group i) the payload positions in (member, position)
    order and their slab-local targets, padded to the longest payload."""
    n_slabs, g_total, p = index.shape
    gs = -(-g_total // n_groups)
    srcs, dsts = {}, {}
    pay_len = 1
    for s in range(n_slabs):
        for i in range(n_groups):
            loc = index[s, i * gs:(i + 1) * gs]        # (<=gs, P)
            gg, pp = np.nonzero(loc != slab_size)      # (member, pos) order
            srcs[s, i] = gg.astype(np.int64) * p + pp
            dsts[s, i] = loc[gg, pp]
            pay_len = max(pay_len, gg.size)
    zero_slot = gs * p
    ship_src = np.full((n_groups, n_slabs, pay_len), zero_slot, np.int32)
    ship_idx = np.full((n_slabs, n_groups, pay_len), slab_size, np.int32)
    for (s, i), src in srcs.items():
        ship_src[i, s, :src.size] = src
        ship_idx[s, i, :src.size] = dsts[s, i]
    return ship_src, ship_idx, gs


def _shard_bucket(bucket: Bucket, full_levels: LevelVector, n_slabs: int,
                  slab_rows: int, row_size: int,
                  n_groups: int = 1) -> SlabBucket:
    """Split one bucket's index map into per-slab local maps and row
    ranges (and the shipping maps when compute-sharded)."""
    n0 = (1 << full_levels[0]) - 1
    slab_size = slab_rows * row_size
    g = bucket.index.astype(np.int64)             # (G, P); dump == fine_size
    row = g // row_size                           # dump maps to row n0
    index = np.empty((n_slabs,) + g.shape, np.int32)
    ranges = np.zeros((n_slabs, g.shape[0], 2), np.int32)
    for s in range(n_slabs):
        lo, hi = s * slab_rows, min((s + 1) * slab_rows, n0)
        in_slab = (row >= lo) & (row < hi)
        index[s] = np.where(in_slab, g - lo * row_size, slab_size)
    for gi, ell in enumerate(bucket.ells):
        step = 1 << (full_levels[0] - ell[0])
        rows = (np.arange((1 << ell[0]) - 1) + 1) * step - 1
        for s in range(n_slabs):
            lo, hi = s * slab_rows, min((s + 1) * slab_rows, n0)
            hit = np.nonzero((rows >= lo) & (rows < hi))[0]
            if hit.size:
                ranges[s, gi] = (hit[0], hit[-1] + 1)
    if n_groups == 1:
        return SlabBucket(index=index, row_ranges=ranges)
    ship_src, ship_idx, gs = _group_ship_maps(index, n_groups, slab_size)
    return SlabBucket(index=index, row_ranges=ranges, ship_src=ship_src,
                      ship_idx=ship_idx, group_size=gs)


def shard_plan(plan: ExecutorPlan, n_slabs: Optional[int] = None,
               old: Optional[ShardedPlan] = None, *,
               spec=None, n_groups: Optional[int] = None) -> ShardedPlan:
    """Slab-shard a plan for ``n_slabs`` devices (and compute-shard it over
    ``n_groups`` member groups for the 2-D ingest).  ``old``, a prior
    sharding of the same geometry, lends its slab split to every bucket
    whose base ``index`` survived by identity.  ``spec`` supplies
    ``n_slabs`` (``spec.slabs``) and ``n_groups`` (``spec.groups``)."""
    if spec is not None:
        ensure_spec("shard_plan", spec)
        if n_slabs is not None:
            raise ValueError("shard_plan: pass n_slabs or spec, not both")
        n_slabs = spec.slabs
        if n_groups is None:
            n_groups = spec.groups
    if n_slabs is None:
        raise ValueError("shard_plan: n_slabs (or a sharded spec) required")
    if isinstance(plan, ShardedPlan):
        raise TypeError("shard_plan expects the unsharded base plan")
    if n_slabs < 1:
        raise ValueError(f"n_slabs must be >= 1, got {n_slabs}")
    n_groups = 1 if n_groups is None else int(n_groups)
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    n0 = plan.fine_shape[0]
    row_size = int(np.prod(plan.fine_shape[1:], dtype=np.int64))
    slab_rows = -(-n0 // n_slabs)
    reuse = {}
    # a surviving base index proves the embed map unchanged; the slab maps
    # also bake in the slab geometry and the group count
    if old is not None and (old.n_slabs, old.n_groups, old.slab_rows,
                            old.row_size, old.plan.full_levels) == (
            n_slabs, n_groups, slab_rows, row_size, plan.full_levels):
        reuse = {id(b.index): sb
                 for b, sb in zip(old.plan.buckets, old.slab_buckets)}
    slab_buckets = tuple(
        reuse.get(id(b.index)) or _shard_bucket(b, plan.full_levels, n_slabs,
                                                slab_rows, row_size, n_groups)
        for b in plan.buckets)
    return ShardedPlan(plan=plan, n_slabs=n_slabs, slab_rows=slab_rows,
                       slab_buckets=slab_buckets, n_groups=n_groups)


@dataclass(frozen=True)
class MergeConfig:
    """Static cost model for merging near-shape buckets into padded
    super-buckets, in bytes: ``launch_cost_bytes`` per kernel launch
    against ``round_trips`` copies of each member's padded volume.  Kept
    exactly as the reference prices it (TPU tile volumes and its fused
    VMEM gate), so merged plans equal the reference's.  ``max_members``
    caps a super-bucket.  Hashable: it is part of the plan cache key."""

    launch_cost_bytes: int = 1 << 20
    round_trips: int = 4
    dtype_bytes: int = 8
    max_members: Optional[int] = None


#: The reference's fused-epilogue budget (a TPU VMEM figure).  Read ONLY
#: by the merge cost model, so merge partitions match the reference; the
#: port's execution rule fuses every bucket.
_REFERENCE_FUSED_OUT_BUDGET_BYTES = 8 * 1024 * 1024


def _bucket_cost(target: LevelVector, n_members: int, merge: MergeConfig,
                 out_elems: int) -> float:
    """Modelled cost of one bucket, as the reference prices it: launch
    overhead plus member traffic, plus the standalone scatter and the
    compact-stack round trip for buckets it would not fuse."""
    shape = grid_shape(target)
    p = int(np.prod(shape, dtype=np.int64))
    fused = False
    if batched_method(shape) == "pallas":
        launches, vol = (1 if len(shape) == 1 else 2), tile_volume(shape)
        fused = (out_elems * merge.dtype_bytes
                 <= _REFERENCE_FUSED_OUT_BUDGET_BYTES)
    else:
        launches, vol = len(shape), p
    cost = (launches * merge.launch_cost_bytes
            + merge.round_trips * n_members * vol * merge.dtype_bytes)
    if not fused:
        cost += (merge.launch_cost_bytes
                 + 2 * n_members * p * merge.dtype_bytes)
    return cost


def _merge_partition(keys: Sequence[LevelVector], sizes: Sequence[int],
                     merge: MergeConfig,
                     out_elems: int) -> Tuple[Tuple[int, int], ...]:
    """Optimal contiguous partition of the descending-sorted canonical
    keys into super-buckets, as half-open segments ``(i, j)`` (interval
    DP, exact under the cost model).  Contiguity keeps the global member
    order, and with it the bits of the per-slot left fold."""
    n = len(keys)
    d = len(keys[0]) if n else 0
    best = [0.0] * (n + 1)
    cut = [0] * (n + 1)
    for j in range(1, n + 1):
        best[j] = float("inf")
        target = list(keys[j - 1])
        members = 0
        for i in range(j - 1, -1, -1):
            for k in range(d):
                if keys[i][k] > target[k]:
                    target[k] = keys[i][k]
            members += sizes[i]
            if merge.max_members is not None and members > merge.max_members \
                    and j - i > 1:
                break
            c = best[i] + _bucket_cost(tuple(target), members, merge,
                                       out_elems)
            if c < best[j]:
                best[j], cut[j] = c, i
    segments = []
    j = n
    while j > 0:
        segments.append((cut[j], j))
        j = cut[j]
    return tuple(reversed(segments))


def _member_index_map(ell: LevelVector, perm: Tuple[int, ...],
                      target: LevelVector, full_levels: LevelVector,
                      fine_strides: np.ndarray, dump: int) -> np.ndarray:
    """Flat fine-grid index of every position of the padded canonical
    member array; pad positions map to the dump slot.  Node j (0-based)
    of a level-l axis embeds at fine index ``(j + 1) * 2**(L - l) - 1``."""
    d = len(target)
    shape = grid_shape(target)
    idx = np.zeros(shape, np.int64)
    bad = np.zeros(shape, bool)
    for k in range(d):
        a = perm[k]
        l, big = ell[a], full_levels[a]
        n = (1 << l) - 1
        j = np.arange(shape[k])
        v = np.where(j < n, (j + 1) * (1 << (big - l)) - 1, 0)
        bc = [1] * d
        bc[k] = shape[k]
        idx += (v * fine_strides[a]).reshape(bc)
        bad |= (j >= n).reshape(bc)
    return np.where(bad, dump, idx).astype(np.int32).ravel()


def _fine_strides(fine_shape: Tuple[int, ...]) -> np.ndarray:
    strides = np.ones(len(fine_shape), np.int64)
    for a in range(len(fine_shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * fine_shape[a + 1]
    return strides


def _group_members(scheme: SchemeLike) -> Dict[LevelVector, list]:
    """Group (ell, perm, canon, coeff) member records by canonical key."""
    groups: Dict[LevelVector, list] = {}
    for ell, c in scheme.grids:
        canon, perm = canonical_levels(ell)
        groups.setdefault(canon, []).append((ell, perm, canon, c))
    return groups


def _segment_member_lists(groups: Dict[LevelVector, list],
                          merge: Optional[MergeConfig],
                          fine_size: int) -> list:
    """Bucket member lists: canonical groups in descending key order,
    merged into contiguous super-bucket segments under ``merge``.  The
    one construction site of ``build_plan`` and ``extend_plan``, so the
    same groups, ``merge`` and fine grid give the same partition."""
    keys = sorted(groups, reverse=True)
    if merge is None:
        return [list(groups[k]) for k in keys]
    segments = _merge_partition(keys, [len(groups[k]) for k in keys],
                                merge, fine_size + 1)
    return [[m for k in keys[i:j] for m in groups[k]] for i, j in segments]


def _make_bucket(members: list, full_levels: LevelVector,
                 fine_strides: np.ndarray, fine_size: int,
                 old_rows: Optional[Dict[LevelVector, np.ndarray]] = None
                 ) -> Bucket:
    """Build one bucket from its member records; ``old_rows`` maps level
    vectors to index-map rows built for THIS bucket's target, which an
    incremental rebuild reuses instead of recomputing."""
    target = tuple(max(lv[k] for _, _, lv, _ in members)
                   for k in range(len(full_levels)))
    old_rows = old_rows or {}
    index = np.stack([
        old_rows[ell] if ell in old_rows else
        _member_index_map(ell, perm, target, full_levels, fine_strides,
                          dump=fine_size)
        for ell, perm, _, _ in members])
    return Bucket(
        ells=tuple(m[0] for m in members),
        perms=tuple(m[1] for m in members),
        levels=tuple(m[2] for m in members),
        target=target,
        coeffs=np.asarray([float(m[3]) for m in members]),
        index=index)


def build_plan(scheme: SchemeLike,
               full_levels: Optional[Sequence[int]] = None, *,
               merge: Optional[MergeConfig] = None,
               spec=None) -> ExecutorPlan:
    """Bucket (and optionally merge-plan) the scheme's grids and
    precompute the embed index plan.  Cached per ``(scheme, full_levels,
    merge)``, with ``full_levels`` normalized first.  ``spec`` supplies
    ``merge`` instead (both at once raise); a sharded spec makes this
    return the ``ShardedPlan`` (the cached base plan, sharded per call:
    no mesh ever enters the cache)."""
    if spec is not None:
        ensure_spec("build_plan", spec)
        if merge is not None:
            raise ValueError("build_plan: pass merge or spec, not both")
        merge = spec.merge
    if full_levels is None:
        full_levels = fine_levels(scheme)
    key = (scheme, tuple(int(l) for l in full_levels), merge)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = _PLAN_CACHE.put(key, _build_plan_uncached(*key))
    if spec is not None and (spec.slabs > 1 or spec.groups > 1):
        plan = shard_plan(plan, spec.slabs, n_groups=spec.groups)
    return plan


class _PlanCache:
    """Thread-safe LRU cache of host-side plans (numpy index maps only).
    Concurrent misses on one key may both build; the first insert wins,
    so callers always get one object per key."""

    def __init__(self, maxsize: int):
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = _lockdep.make_lock("plan-cache")
        self._maxsize = maxsize

    def get(self, key):
        with self._lock:
            val = self._data.get(key)
            if val is not None:
                self._data.move_to_end(key)
            return val

    def put(self, key, value):
        """Insert-if-absent; returns the winning (cached) value."""
        with self._lock:
            have = self._data.get(key)
            if have is not None:
                self._data.move_to_end(key)
                return have
            self._data[key] = value
            while len(self._data) > self._maxsize:
                self._data.popitem(last=False)
            return value

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


_PLAN_CACHE = _PlanCache(maxsize=64)


def clear_plan_cache() -> None:
    """Drop every cached executor plan (tests / benchmarks)."""
    _PLAN_CACHE.clear()


def _build_plan_uncached(scheme: SchemeLike, full_levels: LevelVector,
                         merge: Optional[MergeConfig]) -> ExecutorPlan:
    fine_shape = grid_shape(full_levels)
    fine_size = int(np.prod(fine_shape))
    fine_strides = _fine_strides(fine_shape)
    buckets = tuple(_make_bucket(members, full_levels, fine_strides,
                                 fine_size)
                    for members in _segment_member_lists(
                        _group_members(scheme), merge, fine_size))
    return ExecutorPlan(dim=scheme.dim, full_levels=full_levels,
                        fine_shape=fine_shape, buckets=buckets, merge=merge)


def _check_plan(plan, fn: str) -> None:
    if not isinstance(plan, (ExecutorPlan, ShardedPlan)):
        raise TypeError(f"{fn} takes an ExecutorPlan or a ShardedPlan, got "
                        f"{type(plan).__name__}")


def _base(plan, fn: str) -> ExecutorPlan:
    """The unsharded plan of ``plan`` (itself, or a ``ShardedPlan``'s)."""
    _check_plan(plan, fn)
    return plan.plan if isinstance(plan, ShardedPlan) else plan


def extend_plan(plan: ExecutorPlan, scheme: SchemeLike,
                full_levels: Optional[Sequence[int]] = None, *,
                spec=None) -> ExecutorPlan:
    """Incremental plan rebuild after the scheme's index set changed.

    Gives exactly ``build_plan(scheme, full_levels, merge=plan.merge)``,
    reusing the old plan: a bucket with unchanged members and coefficients
    is returned by object identity; one whose coefficients alone moved
    keeps its ``index`` array by identity; a bucket that gained or lost
    members recomputes index-map rows only for members no old bucket of
    its target held.  A changed fine grid makes every embed index stale,
    so it falls back to a full (cached) ``build_plan``.  A ``spec`` whose
    ``merge`` differs from the plan's re-partitions under the spec's.  A
    ``ShardedPlan`` is extended through its base plan and re-sharded
    incrementally (``shard_plan(..., old=)``); a spec asking for another
    slab count raises."""
    _check_plan(plan, "extend_plan")
    if spec is not None:
        ensure_spec("extend_plan", spec)
        plan_slabs = plan.n_slabs if isinstance(plan, ShardedPlan) else 1
        if (spec.n_slabs is not None or spec.mesh is not None) \
                and spec.slabs != plan_slabs:
            raise ValueError(
                f"extend_plan: spec requests {spec.slabs} slab(s) but the "
                f"plan is sharded for {plan_slabs}; re-shard explicitly "
                f"(shard_plan) instead of extending across layouts")
        if spec.merge != plan.merge:
            if isinstance(plan, ShardedPlan):
                plan = dataclasses.replace(plan, plan=dataclasses.replace(
                    plan.plan, merge=spec.merge))
            else:
                plan = dataclasses.replace(plan, merge=spec.merge)
    if isinstance(plan, ShardedPlan):
        return shard_plan(extend_plan(plan.plan, scheme, full_levels),
                          plan.n_slabs, old=plan, n_groups=plan.n_groups)
    if full_levels is None:
        full_levels = fine_levels(scheme)
    full_levels = tuple(int(l) for l in full_levels)
    if full_levels != plan.full_levels:
        return build_plan(scheme, full_levels, merge=plan.merge)
    fine_strides = _fine_strides(plan.fine_shape)
    # keyed by the member tuple: a merged plan may hold two buckets with
    # the same target, never two with the same members
    old_by_ells = {b.ells: b for b in plan.buckets}
    buckets = []
    for members in _segment_member_lists(_group_members(scheme), plan.merge,
                                         plan.fine_size):
        target = tuple(max(lv[k] for _, _, lv, _ in members)
                       for k in range(len(full_levels)))
        coeffs = np.asarray([float(m[3]) for m in members])
        ob = old_by_ells.get(tuple(m[0] for m in members))
        if ob is not None and ob.target == target:
            buckets.append(ob if np.array_equal(ob.coeffs, coeffs)
                           else dataclasses.replace(ob, coeffs=coeffs))
            continue
        old_rows = {ell: row for b in plan.buckets if b.target == target
                    for ell, row in zip(b.ells, b.index)}
        buckets.append(_make_bucket(members, full_levels, fine_strides,
                                    plan.fine_size, old_rows=old_rows))
    return ExecutorPlan(dim=scheme.dim, full_levels=full_levels,
                        fine_shape=plan.fine_shape, buckets=tuple(buckets),
                        merge=plan.merge)


def update_plan_coefficients(plan: ExecutorPlan,
                             scheme: SchemeLike) -> ExecutorPlan:
    """Coefficient-ONLY plan update: every bucket keeps its members and
    index map (by identity); coefficients are re-read from ``scheme`` and
    members no longer in it get coefficient 0 (their stale data must
    merely be finite).  Raises ``ValueError`` when ``scheme`` activates a
    grid the plan does not hold: ``extend_plan`` is then needed.  A
    ``ShardedPlan`` keeps every slab split (by identity)."""
    _check_plan(plan, "update_plan_coefficients")
    if isinstance(plan, ShardedPlan):
        return shard_plan(update_plan_coefficients(plan.plan, scheme),
                          plan.n_slabs, old=plan, n_groups=plan.n_groups)
    coeff = {ell: float(c) for ell, c in scheme.grids}
    held = {ell for b in plan.buckets for ell in b.ells}
    missing = sorted(set(coeff) - held)
    if missing:
        raise ValueError(
            f"coefficient-only update impossible: scheme activates grid(s) "
            f"{missing} not present in the plan; use extend_plan")
    buckets = []
    for b in plan.buckets:
        nc = np.asarray([coeff.get(ell, 0.0) for ell in b.ells])
        buckets.append(b if np.array_equal(b.coeffs, nc)
                       else dataclasses.replace(b, coeffs=nc))
    return dataclasses.replace(plan, buckets=tuple(buckets))


# ---------------------------------------------------------------------------
# Gather phase
# ---------------------------------------------------------------------------

def _check_nodal_grids(nodal_grids: Mapping[LevelVector, torch.Tensor],
                       plan: ExecutorPlan) -> None:
    """Name the missing level vector(s) instead of failing deep inside."""
    if not nodal_grids:
        raise ValueError(
            f"nodal_grids is empty: the scheme has {plan.num_grids} "
            f"combination grids (one nodal array per level vector required)")
    missing = [ell for b in plan.buckets for ell in b.ells
               if ell not in nodal_grids]
    if missing:
        shown = ", ".join(map(str, missing[:5]))
        more = f" (+{len(missing) - 5} more)" if len(missing) > 5 else ""
        raise ValueError(
            f"nodal_grids is missing {len(missing)} scheme grid(s): "
            f"level vector(s) {shown}{more}")


def _grids_on(nodal_grids, plan: ExecutorPlan, device: torch.device
              ) -> Tuple[Dict[LevelVector, torch.Tensor], torch.dtype]:
    """The plan's grids as tensors on ``device`` and their common dtype."""
    _check_nodal_grids(nodal_grids, plan)
    grids = {ell: torch.as_tensor(_readable(nodal_grids[ell], ell, device),
                                  device=device)
             for b in plan.buckets for ell in b.ells}
    dtype = None
    for g in grids.values():
        dtype = g.dtype if dtype is None else torch.promote_types(dtype,
                                                                  g.dtype)
    return grids, dtype


def _readable(v, ell: LevelVector, device=None):
    """``v``, unless it is a tensor whose storage was released (a donated
    grid) and the caller is about to copy it (to ``device``, or to another
    dtype when ``device`` is None): that raises ``ValueError`` before the
    copy reads freed memory.  The assembly checks the grids it reads in
    place (``assemble_grouped``)."""
    if isinstance(v, torch.Tensor) and (device is None or v.device != device) \
            and storage_released(v):
        raise ValueError(f"the grid of level vector {ell} has a released "
                         f"storage (a donated grid) and cannot be read")
    return v


def _parts(grids: Mapping[LevelVector, torch.Tensor], buckets,
           dtype: torch.dtype) -> list:
    """The buckets' member grids in plan order, in ``dtype``."""
    return [grids[ell] if grids[ell].dtype == dtype
            else _readable(grids[ell], ell).to(dtype)
            for b in buckets for ell in b.ells]


def _assemble(grids: Mapping[LevelVector, torch.Tensor], buckets,
              dtype: torch.dtype) -> torch.Tensor:
    """The flat concatenation of the buckets' stacks: each member grid
    transposed to canonical axis order and zero-padded to its bucket's
    target shape (pad values never reach the fine buffer — the index plan
    routes them to the dump slot).  One ``assemble_grouped`` call."""
    return assemble_grouped(_parts(grids, buckets, dtype),
                            tuple((b.shape, b.perms) for b in buckets))


def _bucket_views(x: torch.Tensor, buckets):
    """The ``(G, *shape)`` stacks of the flat concatenation ``x``."""
    a = 0
    for b in buckets:
        n = len(b.ells) * int(np.prod(b.shape, dtype=np.int64))
        yield x[a:a + n].view((len(b.ells),) + b.shape)
        a += n


@dataclass(frozen=True)
class _IngestTable:
    """What a fused ingest of a plan needs besides the data: the passes
    before each bucket's last (``hier_forward_grouped``'s ``stacks``) and
    the slot-owner table of the last passes (whose ``spans`` place each
    bucket in the flat concatenation of the stacks)."""

    stacks: tuple
    scatter: ScatterTable


_PLAN_TABLES: Dict[tuple, Any] = {}
_PLAN_TABLES_LOCK = _lockdep.make_lock("plan-tables")


def _plan_table(kind: str, arrays, build):
    """``build()``, cached under ``kind`` and the identity of ``arrays``
    (a plan's numpy maps), and dropped when one of them dies: a per-plan
    table is built once and kept while its plan lives.  A holder of the
    table (an engine tenant) keeps it usable after that."""
    key = (kind,) + tuple(id(a) for a in arrays)
    with _PLAN_TABLES_LOCK:
        table = _PLAN_TABLES.get(key)
    if table is not None:
        return table
    table = build()
    with _PLAN_TABLES_LOCK:
        if key in _PLAN_TABLES:
            return _PLAN_TABLES[key]
        _PLAN_TABLES[key] = table
    for a in arrays:
        weakref.finalize(a, _PLAN_TABLES.pop, key, None)
    return table


def _pass_specs(plan: ExecutorPlan) -> Tuple[tuple, tuple]:
    """The fused ingest's passes, in the reference's axis order per bucket:
    ``hier_forward_grouped``'s ``stacks`` (every pass before a bucket's
    last) and the last passes ``(shape, levels along the axis, axis)`` of
    the scatter tables."""
    stacks, last = [], []
    for b in plan.buckets:
        order = axis_order(b.shape)
        stacks.append((b.shape, b.levels, order[:-1]))
        last.append((b.shape, tuple(lv[order[-1]] for lv in b.levels),
                     order[-1]))
    return tuple(stacks), tuple(last)


def _ingest_table(plan: ExecutorPlan) -> _IngestTable:
    """The plan's ingest table, built once and cached under the identity of
    the plan's index arrays (``_plan_table``): ``update_plan_coefficients``
    and the coefficient-only path of ``extend_plan`` keep them, so their
    plans reuse it."""
    def build():
        stacks, last = _pass_specs(plan)
        return _IngestTable(stacks=stacks, scatter=scatter_table(
            last, [b.index for b in plan.buckets], plan.fine_size))
    return _plan_table("ingest", [b.index for b in plan.buckets], build)


def _gather_unfused(full: torch.Tensor, x: torch.Tensor,
                    member_levels: Tuple[LevelVector, ...],
                    idx: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """Accumulate one assembled bucket stack ``x`` (G members, canonical
    padded shape) into the flat fine buffer ``full`` (+1 dump slot), IN
    PLACE: the full transform, then one ordered ``index_add_`` per member
    through the (G, P) embed map ``idx`` with the (G,) coefficients
    ``cs``."""
    g = len(member_levels)
    alpha = hierarchize_batched(x, member_levels).reshape(g, -1)
    for m in range(g):
        # ctlint: ok(bit-identity-reassoc): idx[m] is injective off the dump slot and the calls run in member order, so each slot's adds are the left fold (tests/test_torch_executor.py::test_ct_transform_bitwise_equals_reference, fused=False)
        full.index_add_(0, idx[m], cs[m] * alpha[m])
    return full


def _ingest_fused(grids, plan: ExecutorPlan, table: _IngestTable,
                  coeffs: torch.Tensor, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """The fused ingest: assembly, the grouped forward passes and the
    grouped ordered scatter (four launches on CUDA) into a fresh fine
    buffer; ``coeffs`` are the plan's coefficients, concatenated, in
    ``dtype`` on ``device``."""
    full = torch.zeros(plan.fine_size + 1, dtype=dtype, device=device)
    x = _assemble(grids, plan.buckets, dtype)
    hier_scatter_grouped(hier_forward_grouped(x, table.stacks),
                         table.scatter, coeffs, full)
    return full[:-1].reshape(plan.fine_shape)


def _ingest_unfused(grids, plan: ExecutorPlan, idxs, coeffs,
                    dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The unfused ingest (same bits): the assembly, then per bucket the
    full transform and one ``index_add_`` per member; ``idxs`` and
    ``coeffs`` are per bucket, on ``device`` (``coeffs`` in ``dtype``)."""
    full = torch.zeros(plan.fine_size + 1, dtype=dtype, device=device)
    x = _assemble(grids, plan.buckets, dtype)
    for b, stack, idx, cs in zip(plan.buckets, _bucket_views(x, plan.buckets),
                                 idxs, coeffs):
        _gather_unfused(full, stack, b.levels, idx, cs)
    return full[:-1].reshape(plan.fine_shape)


def _check_spec_device(fn: str, spec, device: torch.device) -> None:
    if spec is not None:
        ensure_spec(fn, spec)
        spec.resolve_interpret(device)


def ct_transform_with_plan(nodal_grids: Mapping[LevelVector, torch.Tensor],
                           plan: ExecutorPlan, *,
                           fused: Optional[bool] = None,
                           spec=None, device=None) -> torch.Tensor:
    """``ct_transform`` against an explicit plan: nodal component grids
    -> sparse-grid surplus on the common fine grid, on ``device``.

    ``fused=None`` takes the port's default, the fused epilogue on every
    bucket (four kernel launches in all on CUDA); ``fused=False`` the
    unfused scatter (same bits).  ``spec`` supplies ``fused`` instead
    (both at once raise).  A ``ShardedPlan`` runs through its base plan on
    ``device``, unless ``spec`` has a mesh: then it runs slab-sharded over
    the mesh (``repro_torch.core.distributed.ct_transform_sharded``,
    gathered onto ``device``, by default the mesh's first device).  A
    meshed spec with an unsharded plan raises: it never degrades to the
    single-device path."""
    _check_plan(plan, "ct_transform_with_plan")
    if spec is not None and spec.mesh is not None:
        ensure_spec("ct_transform_with_plan", spec)
        if fused is not None:
            raise ValueError("ct_transform_with_plan: pass spec or the bare "
                             "fused keyword, not both")
        if not isinstance(plan, ShardedPlan):
            raise ValueError(
                "ct_transform_with_plan: spec has a mesh but the plan is "
                "not slab-sharded — build it with build_plan(scheme, "
                "spec=spec) (or shard_plan) so the multi-device gather can "
                "run; a meshed spec never silently degrades to the "
                "single-device path")
        from repro_torch.core.distributed import ct_transform_sharded
        return ct_transform_sharded(
            nodal_grids, None, spec.mesh, spec.axis_name, plan=plan,
            spec=dataclasses.replace(spec, mesh=None), device=device)
    plan = _base(plan, "ct_transform_with_plan")
    device = resolve_device(device)
    if spec is not None:
        _check_spec_device("ct_transform_with_plan", spec, device)
        if fused is not None:
            raise ValueError("ct_transform_with_plan: pass spec or the bare "
                             "fused keyword, not both")
        fused = spec.fused
    grids, dtype = _grids_on(nodal_grids, plan, device)
    if fused is False:
        return _ingest_unfused(
            grids, plan,
            [torch.from_numpy(b.index).to(device) for b in plan.buckets],
            [torch.as_tensor(b.coeffs, dtype=dtype, device=device)
             for b in plan.buckets], dtype, device)
    coeffs = torch.from_numpy(np.concatenate(
        [b.coeffs for b in plan.buckets])).to(device=device, dtype=dtype)
    return _ingest_fused(grids, plan, _ingest_table(plan), coeffs, dtype,
                         device)


def ct_transform(nodal_grids: Mapping[LevelVector, torch.Tensor],
                 scheme: SchemeLike, *,
                 full_levels: Optional[Sequence[int]] = None,
                 merge: Optional[MergeConfig] = None,
                 fused: Optional[bool] = None,
                 spec=None, device=None) -> torch.Tensor:
    """Gather phase, batched: nodal component grids -> sparse-grid surplus
    on the common fine grid (hierarchize-per-grid + ``combine_full``, in
    one pass over the plan).  ``spec.merge`` opts into bucket merging (same
    bits, fewer buckets); a meshed spec runs the slab-sharded gather
    (``repro_torch.core.distributed.ct_transform_sharded``, same bits);
    ``merge=`` / ``fused=`` are deprecated spellings of the spec's
    fields."""
    spec = resolve_spec("ct_transform", spec, merge=merge, fused=fused)
    if spec.mesh is not None:
        from repro_torch.core.distributed import ct_transform_sharded
        return ct_transform_sharded(
            nodal_grids, scheme, spec.mesh, spec.axis_name,
            full_levels=full_levels,
            spec=dataclasses.replace(spec, mesh=None), device=device)
    return ct_transform_with_plan(
        nodal_grids, build_plan(scheme, full_levels, merge=spec.merge),
        spec=spec, device=device)


def bucket_surpluses(nodal_grids: Mapping[LevelVector, torch.Tensor],
                     plan: ExecutorPlan, *,
                     device=None) -> Tuple[torch.Tensor, ...]:
    """Per-bucket COMPACT hierarchical surpluses ``[(G_b, P_b), ...]`` —
    the batched hierarchization without the embed (a ``ShardedPlan``: its
    base plan's)."""
    plan = _base(plan, "bucket_surpluses")
    device = resolve_device(device)
    grids, dtype = _grids_on(nodal_grids, plan, device)
    x = _assemble(grids, plan.buckets, dtype)
    return tuple(hierarchize_batched(stack, b.levels).reshape(len(b.ells), -1)
                 for b, stack in zip(plan.buckets,
                                     _bucket_views(x, plan.buckets)))


def bucket_tail_surpluses(nodal_grids: Mapping[LevelVector, torch.Tensor],
                          plan: ExecutorPlan, *,
                          device=None) -> Tuple[torch.Tensor, ...]:
    """Per-bucket TAIL-transformed stacks ``[(G_b, N0, B_b), ...]``: axes
    1..d-1 transformed, axis 0 still nodal."""
    plan = _base(plan, "bucket_tail_surpluses")
    device = resolve_device(device)
    grids, dtype = _grids_on(nodal_grids, plan, device)
    x = _assemble(grids, plan.buckets, dtype)
    out = []
    for b, stack in zip(plan.buckets, _bucket_views(x, plan.buckets)):
        y = hier_tail_batched(stack, b.levels)
        out.append(y.reshape(len(b.ells), y.shape[1], -1))
    return tuple(out)


def bucket_nodal_stacks(nodal_grids: Mapping[LevelVector, torch.Tensor],
                        plan: ExecutorPlan, *,
                        device=None) -> Tuple[torch.Tensor, ...]:
    """Per-bucket assembled NODAL stacks ``[(G_b, P_b), ...]``: assembly
    only, no transform."""
    plan = _base(plan, "bucket_nodal_stacks")
    device = resolve_device(device)
    grids, dtype = _grids_on(nodal_grids, plan, device)
    x = _assemble(grids, plan.buckets, dtype)
    return tuple(stack.reshape(len(b.ells), -1) for b, stack in
                 zip(plan.buckets, _bucket_views(x, plan.buckets)))


def plan_fused_ok(plan) -> bool:
    """Whether every bucket of the plan takes the fused epilogue under the
    port's rule: always, on every device and for every scatter target (a
    ``ShardedPlan``'s slab buffer too).  The reference gates this on a TPU
    VMEM budget (its ``dtype`` and ``out_elems``) and its Pallas path; here
    the fine grid or slab stays in device memory and the pass axis is a
    kernel parameter, so nothing gates it (module docstring)."""
    _check_plan(plan, "plan_fused_ok")
    return True


# ---------------------------------------------------------------------------
# Plan accounting
# ---------------------------------------------------------------------------

def plan_launch_stats(plan: ExecutorPlan, *, dtype_bytes: int = 8,
                      fused: Optional[bool] = None) -> Dict[str, int]:
    """Plan-derived launch and byte accounting of one ingest
    (``ct_transform_with_plan``) on CUDA, under the reference's keys:

    * ``pallas_launches`` — the port's hand-written kernel launches (the
      reference's Pallas launches): fused, one ``assemble_grouped``, one
      ``hier_forward_grouped`` and two ``hier_scatter_grouped`` launches,
      four however many buckets; unfused, the assembly plus per bucket
      one axis-0 launch (axis 0 of extent > 1) and one tail launch (a
      tail axis of extent > 1);
    * ``einsum_dispatches`` — always 0: the port has no dense-operator
      dispatch in the ingest;
    * ``scatter_dispatches`` — the unfused path's library scatter-adds,
      one ``index_add_`` per member; 0 fused;
    * ``launches`` — the sum;
    * ``transform_bytes`` — the stacks' traffic in the transform kernels:
      fused, the forward launch reads and writes every stack and the
      scatter reads it (3 touches); unfused, 2 touches per launch;
    * ``stack_bytes`` — the compact-surplus round trip of the unfused path
      (written by the transform, read by the scatter-adds); 0 fused.

    ``dtype_bytes`` prices one value (8 = f64).  A ``ShardedPlan`` counts
    the sharded ingest's launches (``repro_torch.core.distributed``): the
    1-D fused ingest has the assembly, the grouped forward launch and two
    scatter launches per slab; the 1-D unfused one per slab one
    ``index_add_`` per member; the 2-D ingest the assembly, per member
    group and bucket its forward launches, and one ``owner_fold`` launch
    per slab."""
    _check_plan(plan, "plan_launch_stats")
    if isinstance(plan, ShardedPlan):
        return _sharded_launch_stats(plan, dtype_bytes, fused)
    stats = {"buckets": len(plan.buckets), "members": plan.num_grids,
             "pallas_launches": 0, "einsum_dispatches": 0,
             "scatter_dispatches": 0, "launches": 0,
             "transform_bytes": 0, "stack_bytes": 0}
    stack = sum(len(b.ells) * int(np.prod(b.shape, dtype=np.int64))
                for b in plan.buckets) * dtype_bytes
    if fused is not False:
        stats["pallas_launches"] = 4
        stats["transform_bytes"] = 3 * stack
    else:
        stats["pallas_launches"] = 1
        for b in plan.buckets:
            g = len(b.ells)
            nb = g * int(np.prod(b.shape, dtype=np.int64)) * dtype_bytes
            n = (b.shape[0] > 1) + any(n > 1 for n in b.shape[1:])
            stats["pallas_launches"] += n
            stats["transform_bytes"] += 2 * n * nb
            stats["scatter_dispatches"] += g
        stats["stack_bytes"] = 2 * stack
    stats["launches"] = (stats["pallas_launches"]
                         + stats["einsum_dispatches"]
                         + stats["scatter_dispatches"])
    return stats


def _sharded_launch_stats(plan: ShardedPlan, dtype_bytes: int,
                          fused: Optional[bool]) -> Dict[str, int]:
    base = plan.plan
    stats = {"buckets": len(base.buckets), "members": base.num_grids,
             "pallas_launches": 1, "einsum_dispatches": 0,
             "scatter_dispatches": 0, "launches": 0,
             "transform_bytes": 0, "stack_bytes": 0}
    stack = sum(len(b.ells) * int(np.prod(b.shape, dtype=np.int64))
                for b in base.buckets) * dtype_bytes
    if plan.n_groups > 1:
        for b, sb in zip(base.buckets, plan.slab_buckets):
            gs = sb.group_size
            n = (b.shape[0] > 1) + any(n > 1 for n in b.shape[1:])
            nb = gs * int(np.prod(b.shape, dtype=np.int64)) * dtype_bytes
            stats["pallas_launches"] += plan.n_groups * n
            stats["transform_bytes"] += 2 * n * nb * plan.n_groups
        stats["pallas_launches"] += plan.n_slabs
        stats["stack_bytes"] = 2 * stack
    elif fused is not False:
        stats["pallas_launches"] += 1 + 2 * plan.n_slabs
        stats["transform_bytes"] = (2 + plan.n_slabs) * stack
    else:
        for b in base.buckets:
            g = len(b.ells)
            nb = g * int(np.prod(b.shape, dtype=np.int64)) * dtype_bytes
            n = (b.shape[0] > 1) + any(n > 1 for n in b.shape[1:])
            stats["pallas_launches"] += n
            stats["transform_bytes"] += 2 * n * nb
            stats["scatter_dispatches"] += g * plan.n_slabs
        stats["stack_bytes"] = (1 + plan.n_slabs) * stack
    stats["launches"] = (stats["pallas_launches"]
                         + stats["einsum_dispatches"]
                         + stats["scatter_dispatches"])
    return stats


def plan_ingest_stats(plan, *, dtype_bytes: int = 8) -> Dict[str, int]:
    """PER-DEVICE ingest compute and memory of the plan's execution mode,
    counted as the reference counts them:

    * ``ingest_flops`` — the hierarchization flops one device performs
      (``hier_flops``): the whole compact stack on an unsharded or 1-D
      plan, its ``ceil(G_b / n_groups)`` member shard on a 2-D plan; plus
      one add per stack entry (1-D), or per real payload entry the busiest
      slab receives (2-D; pads are shipped but add nothing);
    * ``ingest_bytes`` — the device's stack (shard), the payload sent and
      received with its int32 target map (2-D), and its scatter target
      (the slab buffer, or the whole fine grid unsharded), +1 dump slot.

    ``dtype_bytes`` prices a value, 4 bytes an index."""
    _check_plan(plan, "plan_ingest_stats")
    splan = plan if isinstance(plan, ShardedPlan) else None
    base = _base(plan, "plan_ingest_stats")
    n_groups = splan.n_groups if splan is not None else 1
    flops = stack_bytes = ship_bytes = scatter_elems = 0
    for i, b in enumerate(base.buckets):
        g = len(b.ells)
        p = int(np.prod(b.shape, dtype=np.int64))
        gloc = -(-g // n_groups)
        flops += hier_flops(b.shape, gloc)
        stack_bytes += gloc * p * dtype_bytes
        if n_groups > 1:
            sb = splan.slab_buckets[i]
            pay = int(sb.ship_src.shape[-1])
            ship_bytes += (splan.n_slabs + n_groups) * pay * dtype_bytes
            ship_bytes += n_groups * pay * 4
            real = np.asarray(sb.ship_idx) != splan.slab_size
            scatter_elems += int(real.sum(axis=(1, 2)).max())
        else:
            scatter_elems += g * p
    out_elems = (splan.slab_size if splan is not None
                 else base.fine_size) + 1
    return {"n_groups": n_groups,
            "n_slabs": splan.n_slabs if splan is not None else 1,
            "ingest_flops": flops + scatter_elems,
            "ingest_bytes": stack_bytes + ship_bytes
            + out_elems * dtype_bytes,
            "stack_bytes": stack_bytes, "ship_bytes": ship_bytes,
            "out_bytes": out_elems * dtype_bytes}


# ---------------------------------------------------------------------------
# Scatter phase and the per-grid embedding
# ---------------------------------------------------------------------------

def ct_scatter_with_plan(full: torch.Tensor, plan: ExecutorPlan, *,
                         spec=None,
                         device=None) -> Dict[LevelVector, torch.Tensor]:
    """Scatter phase, batched: sparse-grid surplus on the common fine grid
    -> nodal values of the combined solution on every component grid of
    the plan, on ``device``.

    Each bucket's surpluses are read off the fine grid through its index
    map (pad positions, which point at the dump slot, read +0.0) and
    dehierarchized batched.  The reference appends a zero dump slot to a
    copy of the fine grid; here the dump index is masked instead, so the
    fine grid is never copied.  A ``ShardedPlan`` reads through its base
    plan (the scatter is a local strided read of the gathered grid)."""
    plan = _base(plan, "ct_scatter_with_plan")
    device = resolve_device(device)
    _check_spec_device("ct_scatter_with_plan", spec, device)
    flat = torch.as_tensor(full, device=device).reshape(-1)
    if flat.numel() != plan.fine_size:
        raise ValueError(f"the surplus has {flat.numel()} values, the plan's "
                         f"fine grid {plan.fine_shape} {plan.fine_size}")
    dump = plan.fine_size
    out: Dict[LevelVector, torch.Tensor] = {}
    for bucket in plan.buckets:
        idx = torch.from_numpy(bucket.index).to(device).reshape(-1)
        pad = idx == dump
        alpha = torch.where(pad, 0.0, flat.index_select(0, idx.masked_fill(
            pad, 0))).reshape((len(bucket.ells),) + bucket.shape)
        nodal = dehierarchize_batched(alpha, bucket.levels)
        for i, (ell, perm) in enumerate(zip(bucket.ells, bucket.perms)):
            sl = tuple(slice(0, s) for s in grid_shape(bucket.levels[i]))
            inv = tuple(int(a) for a in np.argsort(np.asarray(perm)))
            out[ell] = nodal[i][sl].permute(inv).contiguous()
    return out


def ct_scatter(full: torch.Tensor, scheme: SchemeLike, *,
               full_levels: Optional[Sequence[int]] = None,
               merge: Optional[MergeConfig] = None,
               spec=None, device=None) -> Dict[LevelVector, torch.Tensor]:
    """Scatter phase, batched (``ct_scatter_with_plan`` on the scheme's
    cached plan): the truncating projection of the surplus onto every
    component grid, dehierarchized.  ``merge=`` is a deprecated spelling
    of ``spec.merge``."""
    spec = resolve_spec("ct_scatter", spec, merge=merge)
    return ct_scatter_with_plan(
        full, build_plan(scheme, full_levels, merge=spec.merge), spec=spec,
        device=device)


def ct_embedded_with_plan(nodal_grids: Mapping[LevelVector, torch.Tensor],
                          plan: ExecutorPlan, *, spec=None, device=None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Tuple[LevelVector, ...]]:
    """Per-grid UNWEIGHTED embedded surpluses, batched: ``(embedded (G,
    *fine_shape), coeffs (G,) float64, grid order)``, in plan order.

    Every member's surpluses are written into its own row of one flat
    buffer through its index map offset by the row; pad positions all go
    to one slot past the last row, which the result leaves out.  The
    result holds G fine grids: it is meant for small fine grids.  A
    ``ShardedPlan`` embeds through its base plan."""
    plan = _base(plan, "ct_embedded_with_plan")
    device = resolve_device(device)
    _check_spec_device("ct_embedded_with_plan", spec, device)
    grids, dtype = _grids_on(nodal_grids, plan, device)
    fine = plan.fine_size
    total = plan.num_grids
    buf = torch.zeros(total * fine + 1, dtype=dtype, device=device)
    coeffs, order = [], []
    x = _assemble(grids, plan.buckets, dtype)
    for bucket, stack in zip(plan.buckets, _bucket_views(x, plan.buckets)):
        g = len(bucket.ells)
        alpha = hierarchize_batched(stack, bucket.levels)
        rows = np.arange(len(order), len(order) + g, dtype=np.int64)[:, None]
        flat = np.where(bucket.index == fine, total * fine,
                        rows * fine + bucket.index)
        buf[torch.from_numpy(flat.ravel()).to(device)] = alpha.reshape(-1)
        coeffs.append(bucket.coeffs)
        order.extend(bucket.ells)
    return (buf[:-1].view((total,) + plan.fine_shape),
            torch.from_numpy(np.concatenate(coeffs)).to(device),
            tuple(order))


def ct_embedded(nodal_grids: Mapping[LevelVector, torch.Tensor],
                scheme: SchemeLike, *,
                full_levels: Optional[Sequence[int]] = None,
                merge: Optional[MergeConfig] = None,
                spec=None, device=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                 Tuple[LevelVector, ...]]:
    """``ct_embedded_with_plan`` on the scheme's cached plan (``merge=`` a
    deprecated spelling of ``spec.merge``)."""
    spec = resolve_spec("ct_embedded", spec, merge=merge)
    return ct_embedded_with_plan(
        nodal_grids, build_plan(scheme, full_levels, merge=spec.merge),
        spec=spec, device=device)
