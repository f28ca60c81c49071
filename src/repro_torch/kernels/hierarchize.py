"""(De)hierarchization kernels: the per-grid transforms of the paper and the
batched transforms of CT bucket stacks, each kernel wrapper with
its plain PyTorch version beside it.

Port of ``repro.kernels.hierarchize``.

Per-grid wrappers (``kernels.ops`` dispatches to them), each transforming
axis 0 of an ``(N, B)`` pole bundle, any one axis of a d-dim grid in place
(the pole wrappers' ``axis``) or the tail axes of a d-dim grid:

* ``hier_pole``        — ``hier_pole_pallas``: the paper's fine-to-coarse
  level loop, one ``pole_fwd`` launch (bitwise the reference);
* ``dehier_pole``      — ``dehier_pole_pallas``: the coarse-to-fine
  inverse, one ``pole_inv`` launch (bitwise the reference);
* ``apply_axis_matmul`` — ``apply_axis_matmul_pallas``: the operator
  ``H`` (or ``H^-1``) along axis 0, one ``axis_operator`` launch over its
  nonzero tiles;
* ``hier_fused_tail``  — ``hier_fused_tail_pallas``: the operators along
  every tail axis 1..d-1 in one ``fused_tail`` call, one launch per axis
  over its nonzero tiles.

``hier_axis0`` and ``hierarchize_nd_fused`` / ``dehierarchize_nd_fused``
compose the last two, as the reference does.  A level-1 axis (extent 1) is
the identity and launches nothing.  The two operator kernels sum in
another order than the reference's dot, so they are held to its
tolerances (f64 rtol 1e-11, f32 2e-5); bf16 input takes an f32 operator,
sums in f32 and is rounded to bf16 once.

The batched half transforms CT bucket stacks.  A bucket stack is a
``(G, *shape)`` tensor of G component grids zero-padded to one canonical
shape; member g carries its own level vector, so members below the
bucket target transform exactly as their unpadded selves.

Forward hierarchization along one axis is the 3-term update ``_hier3``,
``x - 0.5*x[lp] - 0.5*x[rp]`` with masked (boundary / pad) ancestors
selected to zero.  Its evaluation order is fixed, so every path of this
module gives the same bits per axis ORDER.  The reference applies the
axes in an order fixed by ``batched_method(shape)``: tail axes 1..d-1 and
then axis 0 on its Pallas path, axes 0..d-1 on its jnp path, and the two
orders differ by an ulp.  ``axis_order`` keeps that rule, so this port
matches the reference bitwise on every bucket.

Dehierarchization along one axis is the coarse-to-fine level loop of
``ref.dehierarchize_1d_ref`` on each member's own head of ``2**l - 1``
nodes, the padding copied unchanged (the reference's padded operator
``H^-1 (+) I``).  The reference applies that operator as a dense matmul;
the port runs the stencil, so it agrees with the reference to rounding
(f64 rtol 1e-12), and its kernel and plain version agree bitwise.

Batched wrappers (each the port of one TPU kernel of the reference):

* ``hier_tail_batched``  — ``hier_tail_batched_pallas`` (forward): passes
  along tail axes, one ``axis_pass_fwd`` launch for all of them;
* ``dehier_tail_batched`` — ``hier_tail_batched_pallas(inverse=True)``:
  one ``axis_pass_inv`` launch per tail axis;
* ``hier_axis0_batched`` — ``hier_axis0_batched_pallas`` (forward): one
  ``axis_pass_fwd`` launch along axis 0;
* ``dehier_axis0_batched`` — ``hier_axis0_batched_pallas(inverse=True)``:
  one ``axis_pass_inv`` launch along axis 0;
* ``hier_axis0_scatter_batched`` — ``hier_axis0_scatter_batched_pallas``:
  the last pass fused with the coefficient-weighted scatter-add into the
  flat fine grid, two ``axis_pass_scatter_fwd`` launches.

The CT ingest runs the same two kernels over every bucket at once:
``hier_forward_grouped`` (rows 5 and 7: the passes before each bucket's
last, one ``axis_pass_fwd`` launch) and ``hier_scatter_grouped`` (row 9:
the last passes and the ordered scatter-add, two ``axis_pass_scatter_fwd``
launches, on a slot-owner table, ``scatter_table``, built once per plan).
Their input, the flat concatenation of the bucket stacks, is assembled
from the member grids by ``assemble_grouped`` (one ``assemble_members``
launch; the reference leaves this transpose-and-pad to XLA, so it
replaces no TPU kernel).  The slab-sharded ingest runs
``hier_scatter_grouped`` once per slab, on that slab's table (its local
index maps, dump ``slab_size``); the 2-D ingest's slab owner adds the
shipped payloads with ``owner_fold`` (one ``owner_fold`` launch on an
``owner_table``: the ordered fold alone, which XLA's in-order scatter-add
gives the reference, port-only).

``hier_tail_batched`` and ``hier_axis0_batched`` keep the reference's
signatures: ``inverse=True`` hands the call to the inverse wrapper, which
counts and records it under its own name (so their ``.plain`` is the
forward one only), and ``pred=`` (forward only) takes the predecessor
data as runtime tensors (``member_pred_arrays``).

A wrapper given a CPU tensor runs its plain PyTorch version (the oracle
the tests compare with the reference); given a CUDA tensor it launches
its kernel or raises.  ``<wrapper>.plain`` is that plain version, with the
wrapper's signature, on any device; ``<wrapper>.launches`` counts kernel
launches; ``record_calls`` records every wrapper call with its arguments.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import lockdep as _lockdep
from repro_torch.kernels import _build, ref

__all__ = [
    "hier_pole",
    "dehier_pole",
    "apply_axis_matmul",
    "hier_fused_tail",
    "hier_axis0",
    "hierarchize_nd_fused",
    "dehierarchize_nd_fused",
    "hier_tail_batched",
    "dehier_tail_batched",
    "hier_axis0_batched",
    "dehier_axis0_batched",
    "hier_axis0_scatter_batched",
    "hier_forward_grouped",
    "hier_scatter_grouped",
    "assemble_grouped",
    "storage_released",
    "ScatterTable",
    "scatter_table",
    "OwnerTable",
    "owner_table",
    "owner_fold",
    "hierarchize_batched",
    "dehierarchize_batched",
    "hierarchize_batched_data",
    "axis_order",
    "forward_passes",
    "member_pred_arrays",
    "count_launches",
    "record_calls",
    "pad_blowup",
    "tile_volume",
    "batched_method",
    "hier_flops",
]

# The reference's TPU tiling, kept ONLY so that ``tile_volume`` /
# ``batched_method`` price buckets exactly as the reference does: the
# executor's merge cost model then builds the same plans, and
# ``axis_order`` picks the same axis order per bucket (and so the same
# bits).  The CUDA kernels themselves work at the true extents.
_LANE = 128
_SUBLANE = 8
_PALLAS_MAX_BLOWUP = 8.0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_volume(shape: Sequence[int]) -> int:
    """Padded-tile element count of one grid under the reference's TPU
    sublane/lane tiling (the merge cost model prices buckets with it)."""
    pads = [_round_up(s, _SUBLANE if i < len(shape) - 1 else _LANE)
            for i, s in enumerate(shape)]
    return int(np.prod(pads, dtype=np.int64))


def pad_blowup(shape: Sequence[int]) -> float:
    """Padded-tile volume over true volume under the TPU tiling."""
    return float(tile_volume(shape)) / max(1.0, float(np.prod(shape)))


def batched_method(shape: Sequence[int]) -> str:
    """The reference's ``method="auto"`` rule: ``"pallas"`` unless TPU
    tile padding would inflate the block more than 8x or an axis exceeds
    2047.  Here it only decides the axis order (``axis_order``)."""
    return ("jnp" if pad_blowup(shape) > _PALLAS_MAX_BLOWUP
            or max(shape) > 2047 else "pallas")


def axis_order(shape: Sequence[int], method: str = "auto") -> Tuple[int, ...]:
    """Order of the passes over a bucket of ``shape``: axes 1..d-1 then 0
    on the reference's ``"pallas"`` path, 0..d-1 on its ``"jnp"`` path;
    ``"auto"`` takes the reference's rule (``batched_method``)."""
    if method == "auto":
        method = batched_method(shape)
    d = len(shape)
    if method == "pallas":
        return tuple(range(1, d)) + (0,)
    if method == "jnp":
        return tuple(range(d))
    raise ValueError(f"unknown method {method!r}")


def hier_flops(shape: Sequence[int], g: int = 1) -> int:
    """Forward-hierarchization flop count of a ``(g, *shape)`` stack: 4
    flops per point per axis (two halvings, two subtracts)."""
    return 4 * g * len(shape) * int(np.prod(shape, dtype=np.int64))


# ---------------------------------------------------------------------------
# Per-member predecessor data
# ---------------------------------------------------------------------------

def _pred_index_1d(level: int, npad: int) -> tuple:
    """Left/right hierarchical-predecessor 0-based index vectors (npad,)
    plus validity masks, for a level-``level`` pole at the head of an axis
    of extent ``npad >= 2**level - 1``.  Boundary ancestors and pad
    positions get a False mask and a self index."""
    n = (1 << level) - 1
    if n > npad:
        raise ValueError(f"level {level} pole ({n}) exceeds extent {npad}")
    j = np.arange(1, npad + 1)
    s = j & -j
    real = j <= n
    lm = real & (j - s >= 1)
    rm = real & (j + s <= n)
    lp = np.where(lm, j - s, j) - 1
    rp = np.where(rm, j + s, j) - 1
    return (lp.astype(np.int32), rp.astype(np.int32), lm, rm)


def _pred_stack(member_levels: Sequence[int], npad: int) -> tuple:
    """Per-member predecessor stacks: ``(idx (2, G, npad) int32,
    mask (2, G, npad) bool)`` — left then right."""
    parts = [_pred_index_1d(l, npad) for l in member_levels]
    idx = np.stack([np.stack([p[0] for p in parts]),
                    np.stack([p[1] for p in parts])])
    mask = np.stack([np.stack([p[2] for p in parts]),
                     np.stack([p[3] for p in parts])])
    return idx, mask


def member_pred_arrays(member_levels: Sequence[Sequence[int]],
                       shape: Sequence[int]) -> tuple:
    """Per-member forward-transform data of a bucket stack: for each axis
    ``k`` in order, ``lp, rp`` int32 and ``lm, rm`` bool of shape
    ``(G, shape[k])`` — ``4 * d`` numpy arrays."""
    member_levels = [tuple(ml) for ml in member_levels]
    out = []
    for k, n in enumerate(shape):
        idx, mask = _pred_stack([ml[k] for ml in member_levels], n)
        out += [idx[0], idx[1], mask[0], mask[1]]
    return tuple(out)


@functools.lru_cache(maxsize=1024)
def _pred_tensors(levels: Tuple[int, ...], n: int,
                  device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``(lp, rp, lm, rm)`` of one axis on ``device``: int32 indices and
    bool masks of shape (G, n).  Cached: the data depends on the member
    levels alone and is reused by every ingest of a plan."""
    idx, mask = _pred_stack(levels, n)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (idx[0], idx[1], mask[0], mask[1]))


def _axis_pred(levels: Sequence[int], axis: int, x: torch.Tensor):
    """Predecessor tensors of bucket axis ``axis`` of the stack ``x``;
    ``levels[g]`` is member g's level along that axis."""
    return _pred_tensors(tuple(int(l) for l in levels), x.shape[axis + 1],
                         x.device)


def _runtime_pred(pred, axis: int, x: torch.Tensor):
    """Caller-supplied predecessor data ``(lp, rp, lm, rm)`` of bucket axis
    ``axis`` (numpy arrays or tensors of shape (G, n)) as the kernels'
    tensors on the stack's device: int32 indices, bool masks."""
    shape = (x.shape[0], x.shape[axis + 1])
    out = []
    for a, dtype in zip(pred, (torch.int32, torch.int32, torch.bool,
                               torch.bool)):
        t = torch.as_tensor(a, device=x.device).to(dtype).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"predecessor data of axis {axis} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        out.append(t)
    return tuple(out)


def _forward_pred(levels, pred, axis: int, x: torch.Tensor):
    """Predecessor tensors of bucket axis ``axis``: built from the member
    ``levels`` along it, or taken from ``pred``, that axis's runtime
    ``(lp, rp, lm, rm)``."""
    if pred is None:
        return _axis_pred(levels, axis, x)
    return _runtime_pred(pred, axis, x)


def _check_levels(levels: Sequence[int], n: int) -> None:
    for l in levels:
        if l < 1 or (1 << l) - 1 > n:
            raise ValueError(f"level {l} pole does not fit extent {n}")


@functools.lru_cache(maxsize=1024)
def _level_tensor(levels: Tuple[int, ...], n: int,
                  device: torch.device) -> torch.Tensor:
    """Member levels along one axis of extent ``n`` as an int32 (G,)
    tensor on ``device`` (the inverse kernel's operand).  Cached."""
    _check_levels(levels, n)
    return torch.tensor(levels, dtype=torch.int32, device=device)


def _axis_levels(member_levels, axis: int):
    """Each member's level along bucket ``axis`` (None without levels,
    when the forward transform takes runtime predecessor data)."""
    if member_levels is None:
        return None
    return tuple(int(ml[axis]) for ml in member_levels)


def _tail_pred(pred, axis: int):
    """Tail axis ``axis``'s slice of the tail predecessor data."""
    return None if pred is None else pred[4 * (axis - 1):4 * axis]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _hier3(x: torch.Tensor, xl: torch.Tensor, xr: torch.Tensor,
           lm: torch.Tensor, rm: torch.Tensor) -> torch.Tensor:
    """THE forward update, in the reference's evaluation order: masked
    ancestors contribute an exact ``+0.0`` whatever the gathered value."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return x - 0.5 * torch.where(lm, xl, zero) - 0.5 * torch.where(rm, xr, zero)


def _axis_pass_plain(x: torch.Tensor, axis: int, pred) -> torch.Tensor:
    """One forward pass along bucket axis ``axis`` of a (G, *shape) stack."""
    lp, rp, lm, rm = pred
    bshape = [1] * x.ndim
    bshape[0], bshape[axis + 1] = x.shape[0], x.shape[axis + 1]
    take = lambda i: torch.take_along_dim(x, i.long().reshape(bshape),
                                          axis + 1)
    return _hier3(x, take(lp), take(rp), lm.reshape(bshape),
                  rm.reshape(bshape))


def _axis_scatter_plain(x: torch.Tensor, axis: int, pred,
                        coeffs: torch.Tensor, index: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
    """Last pass + weighted scatter-add, member by member in member order;
    pad positions (index == dump slot) are skipped, as in the kernel."""
    g = x.shape[0]
    alpha = _axis_pass_plain(x, axis, pred).reshape(g, -1)
    idx = index.reshape(g, -1).long()
    dump = acc.shape[0] - 1
    for m in range(g):
        keep = idx[m] != dump
        # ctlint: ok(bit-identity-reassoc): idx[m][keep] is injective (the dump slot dropped) and the calls run in member order, so each slot's adds are the left fold (tests/test_torch_hierarchize.py::test_scatter_plain_equals_row9)
        acc.index_add_(0, idx[m][keep], (coeffs[m] * alpha[m])[keep])
    return acc


def _inverse_pass_plain(x: torch.Tensor, axis: int,
                        levels: Sequence[int]) -> torch.Tensor:
    """One dehierarchization pass along bucket axis ``axis``: for each
    group of members at one level, the level loop of
    ``ref.dehierarchize_1d_ref`` on their head slice; the padding copied."""
    _check_levels(levels, x.shape[axis + 1])
    out = x.clone()
    for level in sorted(set(levels)):
        members = torch.tensor([g for g, l in enumerate(levels)
                                if l == level], device=x.device)
        head = x.index_select(0, members).narrow(axis + 1, 0,
                                                 (1 << level) - 1)
        out.narrow(axis + 1, 0, (1 << level) - 1)[members] = \
            ref.dehierarchize_1d_ref(head, axis + 1)
    return out


def _tail_plain(x: torch.Tensor, member_levels, *, pred=None,
                axes: Sequence[int] | None = None) -> torch.Tensor:
    for k in _live_axes(x, axes):
        x = _axis_pass_plain(x, k, _forward_pred(
            _axis_levels(member_levels, k), _tail_pred(pred, k), k, x))
    return x


def _dehier_tail_plain(x: torch.Tensor,
                       member_levels: Sequence[Sequence[int]], *,
                       axes: Sequence[int] | None = None) -> torch.Tensor:
    for k in _live_axes(x, axes):
        x = _inverse_pass_plain(x, k, _axis_levels(member_levels, k))
    return x


def _axis0_plain(x: torch.Tensor, levels0, *, pred=None) -> torch.Tensor:
    if x.shape[1] == 1:
        return x
    return _axis_pass_plain(x, 0, _forward_pred(levels0, pred, 0, x))


def _dehier_axis0_plain(x: torch.Tensor,
                        levels0: Sequence[int]) -> torch.Tensor:
    if x.shape[1] == 1:
        return x
    return _inverse_pass_plain(x, 0, tuple(int(l) for l in levels0))


def _axis0_scatter_plain(x: torch.Tensor, levels: Sequence[int],
                         coeffs: torch.Tensor, index: torch.Tensor,
                         acc: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
    return _axis_scatter_plain(x, axis, _axis_pred(levels, axis, x), coeffs,
                               index, acc)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}


def _cuda_operand(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must lie on the CUDA device with the "
                         f"stack, got {t.device}")
    return t.contiguous()


def _check_stack(x: torch.Tensor, tags=_DTYPE_TAG) -> torch.Tensor:
    """``x`` made contiguous, or raise unless it is a CUDA tensor of one of
    the types in ``tags`` (the kernels' dtype tags)."""
    if x.device.type != "cuda":
        raise ValueError(f"the kernels take CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in tags:
        names = " or ".join(str(t).removeprefix("torch.") for t in tags)
        raise TypeError(f"the kernels take {names}, got {x.dtype}")
    return x.contiguous()


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    """``x``, or raise if it is not contiguous: the inverse wrappers refuse
    a strided stack rather than copy it."""
    if not x.is_contiguous():
        raise ValueError("the inverse kernels take a contiguous stack")
    return x


def _view(shape: Sequence[int], axis: int) -> Tuple[int, int, int]:
    """(outer, n, inner) extents of a pass along ``axis`` of ``shape``."""
    return (int(np.prod(shape[:axis], dtype=np.int64)), int(shape[axis]),
            int(np.prod(shape[axis + 1:], dtype=np.int64)))


def _live_axes(x: torch.Tensor, axes: Sequence[int] | None) -> list:
    """The tail ``axes`` (default 1..d-1) of the stack ``x`` with extent
    > 1: a level-1 axis is the identity."""
    axes = range(1, x.ndim - 1) if axes is None else axes
    return [k for k in axes if x.shape[k + 1] > 1]


_RECORDING: list | None = None


def _record(wrapper, **arguments) -> None:
    if _RECORDING is not None:
        _RECORDING.append((wrapper, arguments))


@contextlib.contextmanager
def record_calls():
    """Record every wrapper call inside the block (this module's and
    ``flash_attention``'s).

    Yields a list, filled as the calls happen, of ``(wrapper, arguments)``
    pairs, ``arguments`` the call's keyword arguments: replaying
    ``wrapper(**arguments)`` (or ``wrapper.plain(**arguments)``) repeats
    the call.  Not thread-safe: record from one thread."""
    global _RECORDING
    saved, _RECORDING = _RECORDING, []
    try:
        yield _RECORDING
    finally:
        _RECORDING = saved


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


#: ``axis_pass_fwd.cu``'s ``kMaxPasses``: passes a stack of the forward
#: kernel (grids of up to 10 dimensions).
_MAX_PASSES = 10
#: A member the forward kernel keeps in shared memory: two buffers of it
#: fill a block's 227 KB.  Larger members walk device memory.
_SMEM_MEMBER_BYTES = 116224


class _FwdItem(ctypes.Structure):
    """``axis_pass_fwd.cu``'s ``FwdItem``: one stack of a forward launch,
    pointers as int64 device addresses."""
    _fields_ = [(f, ctypes.c_int64) for f in ("src", "dst", "scratch",
                                                "member", "g", "passes")] + [
        (f, ctypes.c_int64 * _MAX_PASSES)
        for f in ("n", "inner", "lp", "rp", "lm", "rm")]


@dataclasses.dataclass(frozen=True)
class _ForwardTable:
    """A grouped forward launch's work table on the device: the packed
    ``FwdItem`` structs, the block list ``(item, member)`` heaviest first,
    the member sizes of the stacks with passes (shared-memory sizing), the
    scratch elements of members too large for shared memory, and the
    tensors the table points at (kept alive with it)."""

    items: torch.Tensor
    blocks: torch.Tensor
    nblocks: int
    members: Tuple[int, ...]
    scratch: int
    keep: tuple


def _forward_table(specs, device: torch.device) -> _ForwardTable:
    """The work table of the stacks ``specs``: ``(offset, g, shape,
    passes)`` each, ``offset`` the stack's element offset in the flat
    source and output, ``passes`` a list of ``(axis, (lp, rp, lm, rm))``
    in order, the predecessor tensors on ``device``."""
    items = (_FwdItem * max(1, len(specs)))()
    keep, members, order, scratch = [], [], [], 0
    for i, (offset, g, shape, passes) in enumerate(specs):
        if len(passes) > _MAX_PASSES:
            raise ValueError(f"the forward kernel takes at most "
                             f"{_MAX_PASSES} passes a stack")
        member = int(np.prod(shape, dtype=np.int64))
        it = items[i]
        it.src = it.dst = offset
        it.member, it.g, it.passes = member, g, len(passes)
        it.scratch = -1
        if len(passes) > 1 and member * 8 > _SMEM_MEMBER_BYTES:
            it.scratch, scratch = scratch, scratch + g * member
        for p, (axis, pred) in enumerate(passes):
            _, it.n[p], it.inner[p] = _view(shape, axis)
            it.lp[p], it.rp[p], it.lm[p], it.rm[p] = (t.data_ptr()
                                                      for t in pred)
            keep += pred
        if passes:
            members.append(member)
        order += [(-member * max(1, len(passes)), i, m) for m in range(g)]
    order.sort()
    blocks = np.asarray([(i, m) for _, i, m in order], np.int32)
    return _ForwardTable(
        items=torch.frombuffer(bytearray(items), dtype=torch.uint8).to(device),
        blocks=torch.from_numpy(blocks.reshape(-1, 2)).to(device),
        nblocks=len(order), members=tuple(members), scratch=scratch,
        keep=tuple(keep))


def _launch_forward(src: torch.Tensor, dst: torch.Tensor,
                    table: _ForwardTable) -> None:
    """One ``axis_pass_fwd`` launch of ``table`` from ``src`` into ``dst``
    (flat buffers of the stacks, same layout)."""
    cap = _SMEM_MEMBER_BYTES // src.element_size()
    smem = max((m for m in table.members if m <= cap), default=0)
    scratch = src.new_empty(table.scratch) if table.scratch else None
    fn = _build.kernel("axis_pass_fwd", _DTYPE_TAG[src.dtype])
    _raise_on(fn(table.items.data_ptr(), table.blocks.data_ptr(),
                 table.nblocks, src.data_ptr(), dst.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), smem,
                 _stream(src)), "axis_pass_fwd")


def _stack_passes(x: torch.Tensor, member_levels, pred, axes) -> torch.Tensor:
    """Passes along the live bucket ``axes`` of the stack ``x`` in one
    launch, into a fresh buffer (``pred``: each axis's runtime data, or
    None to build it from ``member_levels``)."""
    x = _check_stack(x)
    out = torch.empty_like(x)
    if pred is None:
        levels = tuple(tuple(int(l) for l in lv) for lv in member_levels)
        table = _grouped_table(((tuple(x.shape[1:]), levels, tuple(axes)),),
                               x.device)
    else:
        table = _forward_table([(0, x.shape[0], tuple(x.shape[1:]), [
            (k, _runtime_pred(p, k, x)) for k, p in zip(axes, pred)])],
            x.device)
    _launch_forward(x, out, table)
    return out


def _launch_inverse_pass(src: torch.Tensor, dst: torch.Tensor, axis: int,
                         levels: Tuple[int, ...]) -> None:
    outer, n, inner = _view(src.shape[1:], axis)
    lv = _level_tensor(levels, n, src.device)
    fn = _build.kernel("axis_pass_inv", _DTYPE_TAG[src.dtype])
    _raise_on(fn(src.data_ptr(), dst.data_ptr(), lv.data_ptr(), src.shape[0],
                 outer, n, inner, _stream(src)), "axis_pass_inv")


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def hier_tail_batched(x: torch.Tensor, member_levels, *,
                      inverse: bool = False, pred=None,
                      axes: Sequence[int] | None = None) -> torch.Tensor:
    """Forward-hierarchize tail axes of a (G, N1, ..., Nd) bucket stack,
    in the order given (default 1..d-1).

    ``member_levels[g]`` is member g's level vector in bucket axis order.
    ``pred`` (forward only) gives the predecessor data instead, as
    runtime arrays: ``4 * (d-1)`` arrays ``(lp, rp, lm, rm)`` of shape
    (G, N_k) for axes 1..d-1 in order (the tail slice of
    ``member_pred_arrays``); ``member_levels`` is then ignored.
    ``inverse=True`` is ``dehier_tail_batched``.  On CUDA: one
    ``axis_pass_fwd`` launch that applies every axis of extent > 1 (a
    level-1 axis is the identity; none such: ``x`` is returned) into a
    fresh buffer; ``x`` itself is never written."""
    if inverse:
        if pred is not None:
            raise ValueError("pred= is forward only")
        return dehier_tail_batched(x, member_levels, axes=axes)
    _record(hier_tail_batched, x=x, member_levels=member_levels, pred=pred,
            axes=axes)
    if x.device.type == "cpu":
        return _tail_plain(x, member_levels, pred=pred, axes=axes)
    live = _live_axes(x, axes)
    if not live:
        return x
    out = _stack_passes(x, member_levels, None if pred is None else
                        [_tail_pred(pred, k) for k in live], live)
    hier_tail_batched.launches += 1
    return out


def dehier_tail_batched(x: torch.Tensor,
                        member_levels: Sequence[Sequence[int]], *,
                        axes: Sequence[int] | None = None) -> torch.Tensor:
    """Dehierarchize tail axes of a (G, N1, ..., Nd) bucket stack, in the
    order given (default 1..d-1): member g along axis k over its own head
    of ``2**member_levels[g][k] - 1`` nodes, its padding copied.  On CUDA:
    one ``axis_pass_inv`` launch per axis of extent > 1, ping-ponging two
    fresh buffers; ``x`` itself is never written."""
    _record(dehier_tail_batched, x=x, member_levels=member_levels, axes=axes)
    if x.device.type == "cpu":
        return _dehier_tail_plain(x, member_levels, axes=axes)
    live = _live_axes(x, axes)
    x = _check_stack(_contiguous(x))
    bufs = [torch.empty_like(x) for _ in range(min(2, len(live)))]
    for i, k in enumerate(live):
        _launch_inverse_pass(x, bufs[i % 2], k,
                             _axis_levels(member_levels, k))
        dehier_tail_batched.launches += 1
        x = bufs[i % 2]
    return x


def hier_axis0_batched(x: torch.Tensor, levels0, *, inverse: bool = False,
                       pred=None) -> torch.Tensor:
    """Forward-hierarchize axis 0 of a (G, N, ...) bucket stack;
    ``levels0[g]`` is member g's level along it, or ``pred`` (forward
    only) gives its ``(lp, rp, lm, rm)`` arrays of shape (G, N) instead.
    ``inverse=True`` is ``dehier_axis0_batched``.  On CUDA: one
    ``axis_pass_fwd`` launch into a fresh buffer."""
    if inverse:
        if pred is not None:
            raise ValueError("pred= is forward only")
        return dehier_axis0_batched(x, levels0)
    _record(hier_axis0_batched, x=x, levels0=levels0, pred=pred)
    if x.shape[1] == 1:
        return x
    if x.device.type == "cpu":
        return _axis0_plain(x, levels0, pred=pred)
    out = _stack_passes(x, None if levels0 is None else
                        [(int(l),) for l in levels0],
                        None if pred is None else [pred], [0])
    hier_axis0_batched.launches += 1
    return out


def dehier_axis0_batched(x: torch.Tensor,
                         levels0: Sequence[int]) -> torch.Tensor:
    """Dehierarchize axis 0 of a (G, N, ...) bucket stack; ``levels0[g]``
    is member g's level along it, its padding copied.  On CUDA: one
    ``axis_pass_inv`` launch into a fresh buffer."""
    _record(dehier_axis0_batched, x=x, levels0=levels0)
    if x.shape[1] == 1:
        return x
    if x.device.type == "cpu":
        return _dehier_axis0_plain(x, levels0)
    x = _check_stack(_contiguous(x))
    out = torch.empty_like(x)
    _launch_inverse_pass(x, out, 0, tuple(int(l) for l in levels0))
    dehier_axis0_batched.launches += 1
    return out


def hier_axis0_scatter_batched(x: torch.Tensor, levels: Sequence[int],
                               coeffs: torch.Tensor, index: torch.Tensor,
                               acc: torch.Tensor, *,
                               axis: int = 0) -> torch.Tensor:
    """Fused epilogue of the CT gather: forward-hierarchize bucket axis
    ``axis`` of the (G, *shape) stack ``x`` (every other axis already
    transformed) and add ``coeffs[g]`` times member g's surpluses into the
    flat fine buffer ``acc`` through the (G, P) index map ``index``.

    ``levels[g]`` is member g's level along ``axis``.  ``acc`` holds the
    fine grid plus one dump slot at its end, where every pad position of
    ``index`` points; pad positions are skipped.  ``acc`` is updated IN
    PLACE (it is the whole fine grid) and returned.  Per fine slot the
    adds happen once per member, in member order — the left fold of the
    unfused scatter, so fused and unfused give the same bits.  On CUDA:
    the one-bucket case of ``hier_scatter_grouped``, its slot-owner table
    built from ``index`` on the host at each call (``index`` is copied to
    the host), then two ``axis_pass_scatter_fwd`` launches."""
    _record(hier_axis0_scatter_batched, x=x, levels=levels, coeffs=coeffs,
            index=index, acc=acc, axis=axis)
    g = x.shape[0]
    if acc.dtype != x.dtype or coeffs.dtype != x.dtype:
        raise TypeError("acc and coeffs must have the stack's dtype")
    if acc.ndim != 1 or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous 1-D fine buffer")
    if index.dtype != torch.int32 or index.numel() != x.numel():
        raise ValueError("index must be an int32 (G, P) map of the stack")
    if x.device.type == "cpu":
        return _axis0_scatter_plain(x, levels, coeffs, index, acc, axis=axis)
    x = _check_stack(x)
    coeffs = _cuda_operand(coeffs, "coeffs")
    _cuda_operand(acc, "acc")
    table = scatter_table([(tuple(x.shape[1:]), tuple(int(l) for l in levels),
                            axis)], [index.cpu().numpy().reshape(g, -1)],
                          acc.shape[0] - 1)
    _launch_scatter(x.reshape(-1), table, coeffs, acc)
    hier_axis0_scatter_batched.launches += 2
    return acc


# ---------------------------------------------------------------------------
# Grouped launches: every stack of a CT ingest at once
# ---------------------------------------------------------------------------

def _stack_spans(sizes: Sequence[int]) -> list:
    """``(start, end)`` of consecutive stacks of ``sizes`` elements."""
    ends = np.cumsum([0] + [int(n) for n in sizes])
    return list(zip(ends[:-1].tolist(), ends[1:].tolist()))


def _stack_size(shape: Sequence[int], levels) -> int:
    return len(levels) * int(np.prod(shape, dtype=np.int64))


def _check_grouped(x: torch.Tensor, sizes: Sequence[int], what: str) -> None:
    if x.ndim != 1 or x.numel() != sum(sizes):
        raise ValueError(f"{what} must be the flat concatenation of the "
                         f"stacks ({sum(sizes)} values), got shape "
                         f"{tuple(x.shape)}")


def _forward_grouped_plain(x: torch.Tensor, stacks) -> torch.Tensor:
    out = torch.empty_like(x)
    sizes = [_stack_size(shape, levels) for shape, levels, _ in stacks]
    for (a, b), (shape, levels, axes) in zip(_stack_spans(sizes), stacks):
        y = x[a:b].view((len(levels),) + tuple(shape))
        for k in axes:
            if shape[k] > 1:
                y = _axis_pass_plain(y, k, _axis_pred(
                    _axis_levels(levels, k), k, y))
        out[a:b] = y.reshape(-1)
    return out


@functools.lru_cache(maxsize=256)
def _grouped_table(stacks, device: torch.device) -> _ForwardTable:
    """The work table of ``hier_forward_grouped``'s ``stacks`` (each axis
    of extent > 1 a pass).  Cached: built once per stacks and device."""
    sizes = [_stack_size(shape, levels) for shape, levels, _ in stacks]
    return _forward_table([
        (a, len(levels), tuple(shape), [
            (k, _pred_tensors(tuple(lv[k] for lv in levels), shape[k],
                              device)) for k in axes if shape[k] > 1])
        for (a, _), (shape, levels, axes) in zip(_stack_spans(sizes),
                                                 stacks)], device)


@functools.lru_cache(maxsize=256)
def _grouped_sizes(stacks) -> Tuple[int, ...]:
    return tuple(_stack_size(shape, levels) for shape, levels, _ in stacks)


def hier_forward_grouped(x: torch.Tensor, stacks) -> torch.Tensor:
    """Forward passes over several bucket stacks at once: the passes before
    each bucket's last in a CT ingest.

    ``x`` is the flat concatenation of the stacks, stack i a (G_i,
    *shape_i) array; ``stacks[i] = (shape_i, member_levels_i, axes_i)``
    (hashable tuples), ``axes_i`` the bucket axes to pass along, in order
    (a level-1 axis is the identity).  Returns a new flat tensor, each
    stack passed along its axes, bitwise what ``forward_passes`` gives
    stack by stack.  On CUDA: ONE ``axis_pass_fwd`` launch, a block a
    member, every member of every stack (the work table is built once per
    ``stacks`` and device)."""
    _record(hier_forward_grouped, x=x, stacks=stacks)
    _check_grouped(x, _grouped_sizes(stacks), "x")
    if x.device.type == "cpu":
        return _forward_grouped_plain(x, stacks)
    x = _check_stack(x)
    out = torch.empty_like(x)
    _launch_forward(x, out, _grouped_table(stacks, x.device))
    hier_forward_grouped.launches += 1
    return out


class _ScatterBucket(ctypes.Structure):
    """``axis_pass_scatter_fwd.cu``'s ``ScatterBucket``."""
    _fields_ = [(f, ctypes.c_int64) for f in (
        "start", "member", "first", "n", "inner", "lp", "rp", "lm", "rm")]


class OwnerTable:
    """A slot-owner table: the runs of an ordered fold into a flat buffer.

    ``entries`` (int32) are element offsets into the values being folded,
    run by run; owner i is buffer slot ``slots[i]`` and its run is
    ``entries[offsets[i]:offsets[i + 1]]``, in the order the values are
    to be added; owners with longer runs come first, ``long_owners`` of
    them longer than 32.  ``dump`` is the buffer's pad slot, which no
    entry lists.  ``owner_table`` builds one; ``ScatterTable`` (row 9's
    table) is one whose values are a grouped scatter's products."""

    def __init__(self, entries, slots, offsets, dump):
        self.entries, self.slots, self.offsets = entries, slots, offsets
        self.dump = int(dump)
        counts = np.diff(offsets)
        self.long_owners = int((counts > 32).sum())
        # alive[r]: owners whose run is longer than r (a prefix)
        self.alive = np.searchsorted(-counts, -np.arange(
            int(counts.max()) if counts.size else 0), side="left")
        self._on: dict = {}
        self._lock = _lockdep.make_lock("owner-tables")

    @property
    def owners(self) -> int:
        return len(self.slots)

    def _device_extras(self, device: torch.device, t: dict) -> None:
        """Further tensors of a subclass on ``device`` (added to ``t``)."""

    def on(self, device: torch.device) -> dict:
        """The table's tensors on ``device`` (built once per device):
        ``entries``, ``slots``, ``offsets`` and a subclass's extras."""
        with self._lock:
            t = self._on.get(device)
            if t is not None:
                return t
        t = {k: torch.from_numpy(v).to(device) for k, v in (
            ("entries", self.entries), ("slots", self.slots),
            ("offsets", self.offsets))}
        self._device_extras(device, t)
        with self._lock:
            return self._on.setdefault(device, t)


def _owner_runs(flat: np.ndarray, dump: int) -> tuple:
    """``(entries, slots, offsets)`` of the non-dump positions of the flat
    int map ``flat``: a stable sort by slot keeps each slot's positions in
    map order, and the longest runs come first."""
    if flat.size >= 2 ** 31:
        raise ValueError("the map exceeds the table's int32 offsets")
    pos = np.flatnonzero(flat != dump)
    slot = flat[pos]
    order = np.argsort(slot, kind="stable")
    pos, slot = pos[order], slot[order]
    first = np.flatnonzero(np.r_[True, slot[1:] != slot[:-1]]) \
        if slot.size else np.zeros(0, np.int64)
    counts = np.diff(np.r_[first, slot.size])
    rank = np.argsort(-counts, kind="stable")      # longest runs first
    counts = counts[rank]
    offsets = np.r_[0, np.cumsum(counts)].astype(np.int64)
    take = np.repeat(first[rank] - offsets[:-1], counts) + np.arange(
        offsets[-1])
    return (pos[take].astype(np.int32), slot[first[rank]].astype(np.int32),
            offsets)


def owner_table(targets, dump: int) -> OwnerTable:
    """The slot-owner table of an ordered fold into a buffer: ``targets``
    is a sequence of int maps, taken flat one after the other, value ``j``
    of the fold going to slot ``j`` of that concatenation; ``dump``
    positions are skipped.  Each slot's run lists its values in that
    order."""
    flat = np.concatenate([np.asarray(t).reshape(-1) for t in targets])
    return OwnerTable(*_owner_runs(flat, dump), dump)


class ScatterTable(OwnerTable):
    """The slot-owner table of a grouped scatter (``scatter_table``).

    ``stacks[b] = (shape, levels, axis)``: bucket b's stack shape, its
    members' levels along its last pass axis ``axis``, laid out one after
    the other in the concatenation.  ``entries`` are element offsets into
    that concatenation, and each owner's run is in global member order
    (bucket order, then member order); see ``OwnerTable``."""

    def __init__(self, stacks, entries, slots, offsets, dump):
        super().__init__(entries, slots, offsets, dump)
        self.stacks = tuple(stacks)
        sizes = [_stack_size(shape, lv) for shape, lv, _ in self.stacks]
        self.spans = _stack_spans(sizes)
        self.size = sum(sizes)
        self.members = sum(len(lv) for _, lv, _ in self.stacks)

    def _device_extras(self, device: torch.device, t: dict) -> None:
        """On CUDA: the packed ``ScatterBucket`` structs (``buckets``) and
        the predecessor tensors they point at."""
        if device.type != "cuda":
            return
        bk = (_ScatterBucket * max(1, len(self.stacks)))()
        keep, first = [], 0
        for b, ((shape, levels, axis), (start, _)) in enumerate(
                zip(self.stacks, self.spans)):
            pred = _pred_tensors(levels, shape[axis], device)
            _, n, inner = _view(shape, axis)
            bk[b].start, bk[b].first = start, first
            bk[b].member = int(np.prod(shape, dtype=np.int64))
            bk[b].n, bk[b].inner = n, inner
            bk[b].lp, bk[b].rp, bk[b].lm, bk[b].rm = (
                p.data_ptr() for p in pred)
            keep += pred
            first += len(levels)
        t["buckets"] = torch.frombuffer(bytearray(bk),
                                        dtype=torch.uint8).to(device)
        t["keep"] = keep


def scatter_table(stacks, indices, dump: int) -> ScatterTable:
    """Build the slot-owner table of a grouped scatter on the host.

    ``stacks[b] = (shape, levels, axis)`` as in ``ScatterTable``;
    ``indices[b]`` is bucket b's (G, P) int map into the fine buffer, its
    pad positions on ``dump``.  Each member's map must be injective off the
    dump slot.  A stable sort by slot of the concatenation's non-pad
    positions gives every slot's entries in global member order."""
    flat = np.concatenate([np.asarray(i).reshape(-1) for i in indices]) \
        if len(indices) else np.zeros(0, np.int64)
    return ScatterTable(stacks, *_owner_runs(flat, dump), dump)


def _check_scatter(y, table: ScatterTable, coeffs, acc) -> None:
    if acc.dtype != y.dtype or coeffs.dtype != y.dtype:
        raise TypeError("acc and coeffs must have the stacks' dtype")
    if acc.ndim != 1 or not acc.is_contiguous() or \
            acc.shape[0] != table.dump + 1:
        raise ValueError(f"acc must be a contiguous 1-D fine buffer of "
                         f"{table.dump + 1} values (the dump slot last)")
    if coeffs.numel() != table.members:
        raise ValueError(f"expected {table.members} coefficients, got "
                         f"{coeffs.numel()}")
    _check_grouped(y, [b - a for a, b in table.spans], "y")


def _scatter_grouped_plain(y: torch.Tensor, table: ScatterTable,
                           coeffs: torch.Tensor,
                           acc: torch.Tensor) -> torch.Tensor:
    """The kernel's function on the same table: every entry's weighted
    surplus, then the runs folded rank by rank (at rank r the owners with
    a run longer than r, each slot once)."""
    t = table.on(y.device)
    prods, first = [], 0
    for (shape, levels, axis), (a, b) in zip(table.stacks, table.spans):
        g = len(levels)
        v = y[a:b].view((g,) + tuple(shape))
        alpha = _axis_pass_plain(v, axis, _axis_pred(levels, axis, v))
        prods.append((coeffs[first:first + g, None]
                      * alpha.reshape(g, -1)).reshape(-1))
        first += g
    p = torch.cat(prods)[t["entries"].long()] if prods else y[:0]
    slots, offsets = t["slots"].long(), t["offsets"]
    for r, k in enumerate(table.alive.tolist()):
        s = slots[:k]
        acc[s] = acc[s] + p[offsets[:k] + r]
    return acc


def _launch_scatter(y: torch.Tensor, table: ScatterTable,
                    coeffs: torch.Tensor, acc: torch.Tensor) -> None:
    t = table.on(y.device)
    prod = torch.empty(len(table.entries), dtype=y.dtype, device=y.device)
    fn = _build.kernel("axis_pass_scatter_fwd", _DTYPE_TAG[y.dtype])
    _raise_on(fn(t["buckets"].data_ptr(), len(table.stacks),
                 t["entries"].data_ptr(), len(table.entries),
                 t["slots"].data_ptr(), t["offsets"].data_ptr(),
                 table.owners, table.long_owners, y.data_ptr(),
                 coeffs.data_ptr(), prod.data_ptr(), acc.data_ptr(),
                 _stream(y)), "axis_pass_scatter_fwd")


def hier_scatter_grouped(y: torch.Tensor, table: ScatterTable,
                         coeffs: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """Fused epilogue of a CT ingest over every bucket at once: each
    bucket's last forward pass along its table axis, weighted by its
    members' coefficients and added into the flat fine buffer ``acc``
    (the fine grid plus the dump slot), IN PLACE.

    ``y`` is the flat concatenation of the stacks (``table.stacks``'s
    layout), ``coeffs`` the (total members,) coefficients in plan order.
    Per fine slot the adds run once per member, in global member order:
    the left fold of per-bucket, per-member scatters, so the bits are
    those of ``hier_axis0_scatter_batched`` bucket by bucket.  On CUDA: two
    ``axis_pass_scatter_fwd`` launches (products, then the ordered fold)."""
    _record(hier_scatter_grouped, y=y, table=table, coeffs=coeffs, acc=acc)
    _check_scatter(y, table, coeffs, acc)
    if y.device.type == "cpu":
        return _scatter_grouped_plain(y, table, coeffs, acc)
    y = _check_stack(y)
    _cuda_operand(acc, "acc")
    _launch_scatter(y, table, _cuda_operand(coeffs, "coeffs"), acc)
    hier_scatter_grouped.launches += 2
    return acc


def _check_fold(values, table: OwnerTable, acc) -> None:
    if acc.dtype != values.dtype:
        raise TypeError("acc must have the values' dtype")
    if acc.ndim != 1 or not acc.is_contiguous() or \
            acc.shape[0] != table.dump + 1:
        raise ValueError(f"acc must be a contiguous 1-D buffer of "
                         f"{table.dump + 1} values (the dump slot last)")
    if values.ndim != 1 or values.device != acc.device:
        raise ValueError(f"values must be a flat tensor on acc's device "
                         f"{acc.device}, got shape {tuple(values.shape)} on "
                         f"{values.device}")


def _owner_fold_plain(values: torch.Tensor, table: OwnerTable,
                      acc: torch.Tensor) -> torch.Tensor:
    """The kernel's function on the same table: the runs folded rank by
    rank (at rank r the owners with a run longer than r, each slot once)."""
    t = table.on(values.device)
    p = values[t["entries"].long()]
    slots, offsets = t["slots"].long(), t["offsets"]
    for r, k in enumerate(table.alive.tolist()):
        s = slots[:k]
        acc[s] = acc[s] + p[offsets[:k] + r]
    return acc


def owner_fold(values: torch.Tensor, table: OwnerTable,
               acc: torch.Tensor) -> torch.Tensor:
    """Ordered fold of ready values into a flat buffer, IN PLACE: for every
    owner i of ``table`` (``owner_table``), ``acc[slots[i]]`` plus the
    run's values ``values[entries[j]]`` one after the other, each sum
    rounded on its own.  ``acc`` holds the buffer plus its dump slot.

    The 2-D (member x slab) ingest's slab owner folds every group's shipped
    payload with it, in global member order, so the slab is bitwise the
    single-device surplus (``core.distributed.gather_slab_scatter_2d``).
    On CUDA: one ``owner_fold`` launch, no atomics."""
    _record(owner_fold, values=values, table=table, acc=acc)
    _check_fold(values, table, acc)
    if values.device.type == "cpu":
        return _owner_fold_plain(values, table, acc)
    values = _check_stack(values)
    _cuda_operand(acc, "acc")
    t = table.on(values.device)
    fn = _build.kernel("owner_fold", _DTYPE_TAG[values.dtype])
    _raise_on(fn(t["entries"].data_ptr(), t["slots"].data_ptr(),
                 t["offsets"].data_ptr(), table.owners, table.long_owners,
                 values.data_ptr(), values.numel(), acc.data_ptr(),
                 _stream(values)), "owner_fold")
    owner_fold.launches += 1
    return acc


# ---------------------------------------------------------------------------
# Assembly: every member grid of an ingest into the flat stacks at once
# ---------------------------------------------------------------------------

#: ``assemble_members.cu``'s ``kMaxDims`` and ``AsmMember`` layout: src,
#: dst, size, ndim, then shape, ext and stride, ``_ASM_DIMS`` each.
_ASM_DIMS = 10
_ASM_COLS = 4 + 3 * _ASM_DIMS
#: Slot elements a block of the assembly kernel walks (256 threads x 4).
_ASM_CHUNK = 1024


@functools.lru_cache(maxsize=256)
def _assembly_layout(stacks):
    """The signature-determined part of ``assemble_grouped``'s work table:
    one row a member with its slot's offset, volume, rank and the bucket
    shape; the members' perms as an (M, d) array; the flat size; the
    chunks a member's slot is split into.  Every stack has one rank d (a
    plan's grids share the scheme's dimension)."""
    ranks = {len(shape) for shape, _ in stacks}
    if len(ranks) > 1 or max(ranks, default=0) > _ASM_DIMS:
        raise ValueError(f"the assembly takes stacks of one rank, up to "
                         f"{_ASM_DIMS}, got ranks {sorted(ranks)}")
    d = max(ranks, default=0)
    rows, perms, offset = [], [], 0
    for shape, bucket_perms in stacks:
        size = int(np.prod(shape, dtype=np.int64))
        for perm in bucket_perms:
            row = np.zeros(_ASM_COLS, np.int64)
            row[1:4] = offset, size, d
            row[4:4 + d] = shape
            rows.append(row)
            perms.append(tuple(perm))
            offset += size
    biggest = max((int(np.prod(s, dtype=np.int64)) for s, _ in stacks),
                  default=0)
    chunks = max(1, min(64, -(-biggest // _ASM_CHUNK)))
    table = np.stack(rows) if rows else np.zeros((0, _ASM_COLS), np.int64)
    return table, np.asarray(perms, np.int64).reshape(-1, d), offset, chunks


def storage_released(t: torch.Tensor) -> bool:
    """Whether ``t``'s storage holds fewer bytes than its extent needs: a
    tensor whose storage was released (``ExecSpec(donate=True)`` frees a
    donated grid's storage).  Reading such a tensor faults, on the card an
    illegal address that ends the CUDA context; this reads only its
    metadata."""
    n = t.numel()
    if n == 0:
        return False
    if t.is_contiguous():
        extent = t.storage_offset() + n
    else:
        extent = t.storage_offset() + 1 + sum(
            (s - 1) * st for s, st in zip(t.shape, t.stride()))
    return t.untyped_storage().nbytes() < extent * t.element_size()


def _check_parts(parts, stacks) -> Tuple[torch.dtype, torch.device]:
    perms = _assembly_layout(stacks)[1]
    if len(parts) != len(perms):
        raise ValueError(f"expected {len(perms)} member grids, got "
                         f"{len(parts)}")
    dtype, device = parts[0].dtype, parts[0].device
    for m, part in enumerate(parts):
        if part.dtype != dtype or part.device != device:
            raise TypeError(f"the member grids must share one dtype and "
                            f"device, got {part.dtype} on {part.device} "
                            f"beside {dtype} on {device}")
        if storage_released(part):
            raise ValueError(
                f"member {m} of shape {tuple(part.shape)} has a storage of "
                f"{part.untyped_storage().nbytes()} B, fewer than its extent "
                f"needs: its storage was released (a donated grid) and "
                f"cannot be read")
    return dtype, device


def _assemble_grouped_plain(parts, stacks) -> torch.Tensor:
    dtype, device = _check_parts(parts, stacks)
    size = _assembly_layout(stacks)[2]
    out = torch.zeros(size, dtype=dtype, device=device)
    spans = _stack_spans([len(p) * int(np.prod(s, dtype=np.int64))
                          for s, p in stacks])
    m = 0
    for (shape, bucket_perms), (a, b) in zip(stacks, spans):
        x = out[a:b].view((len(bucket_perms),) + tuple(shape))
        for g, perm in enumerate(bucket_perms):
            p = parts[m].permute(perm)
            x[(g,) + tuple(slice(0, s) for s in p.shape)] = p
            m += 1
    return out


def assemble_grouped(parts: Sequence[torch.Tensor], stacks) -> torch.Tensor:
    """The flat concatenation of a CT ingest's bucket stacks, assembled from
    its member grids.

    ``stacks[b] = (shape_b, perms_b)`` (hashable tuples): bucket b's
    canonical shape and its members' axis permutations, canonical axis k
    <- member axis ``perm[k]``.  ``parts`` are the member grids in bucket
    order, then member order, of one dtype and device, any strides.
    Member g of bucket b, permuted, fills the head of its (shape_b) slot of
    stack b, a ``(G_b, *shape_b)`` array; the rest of the slot is 0.  On
    CUDA: ONE ``assemble_members`` launch on a work table of one row a
    member, copied to the device from pinned memory at each call (the
    caching host allocator hands that block out again only once the copy
    has run); bitwise the plain version.  Both refuse, with a
    ``ValueError`` before anything reads it, a part whose storage was
    released (``storage_released``)."""
    _record(assemble_grouped, parts=parts, stacks=stacks)
    dtype, device = _check_parts(parts, stacks)
    if device.type == "cpu":
        return _assemble_grouped_plain(parts, stacks)
    if device.type != "cuda" or dtype not in _DTYPE_TAG:
        _check_stack(parts[0])          # raises, naming what it takes
    static, perms, size, chunks = _assembly_layout(stacks)
    d = perms.shape[1]
    try:
        shapes = np.array([tuple(p.shape) for p in parts],
                          np.int64).reshape(-1, d)
        strides = np.array([p.stride() for p in parts],
                           np.int64).reshape(-1, d)
    except ValueError:
        raise ValueError(f"the member grids must all be {d}-dim") from None
    table = torch.empty(static.shape, dtype=torch.int64, pin_memory=True)
    rows = table.numpy()
    rows[:] = static
    rows[:, 0] = [p.data_ptr() for p in parts]
    ext = rows[:, 4 + _ASM_DIMS:4 + _ASM_DIMS + d]
    ext[:] = np.take_along_axis(shapes, perms, 1)
    rows[:, 4 + 2 * _ASM_DIMS:4 + 2 * _ASM_DIMS + d] = np.take_along_axis(
        strides, perms, 1)
    over = np.flatnonzero((ext > rows[:, 4:4 + d]).any(1))
    if over.size:
        m = int(over[0])
        raise ValueError(f"member {m} of shape {tuple(parts[m].shape)} does "
                         f"not fit its slot {tuple(rows[m, 4:4 + d])} under "
                         f"perm {tuple(perms[m])}")
    out = torch.empty(size, dtype=dtype, device=device)
    members = table.to(device, non_blocking=True)
    fn = _build.kernel("assemble_members", _DTYPE_TAG[dtype])
    _raise_on(fn(members.data_ptr(), len(parts), chunks, out.data_ptr(),
                 _stream(out)), "assemble_members")
    assemble_grouped.launches += 1
    return out


# ---------------------------------------------------------------------------
# Per-grid transforms: pole bundles and dense per-axis operators
# ---------------------------------------------------------------------------

_GRID_TAG = {torch.float32: "f32", torch.float64: "f64",
             torch.bfloat16: "bf16"}
_MAX_TAIL_AXES = 9       # fused_tail.cu's kMaxTail: grids of up to 10 dims


def _bundle_level(x: torch.Tensor) -> int:
    if x.ndim != 2:
        raise ValueError(f"expected an (N, B) pole bundle, got shape "
                         f"{tuple(x.shape)}")
    return ref._level_of_length(x.shape[0])


def _op_dtype(dtype: torch.dtype) -> torch.dtype:
    """The operators' type: the grid's, but float32 for bf16 input (whose
    products are summed in float32), as in the reference."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _operator_matrix(level: int, inverse: bool) -> np.ndarray:
    return (ref.dehier_operator_matrix(level) if inverse
            else ref.operator_matrix(level))


@functools.lru_cache(maxsize=256)
def _operator(level: int, inverse: bool, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The dense (N, N) 1-D operator H (or H^-1) at the true N = 2**level
    - 1.  Its entries are dyadic rationals, exact in every type used."""
    return torch.from_numpy(_operator_matrix(level, inverse)).to(
        dtype=dtype, device=device).contiguous()


#: The operator tile of ``axis_operator.cu`` and ``fused_tail.cu``
#: (``operator_slab_tile.cuh``): rows of an operator tile (kOpM) and depth
#: of a k-slab (kOpK).  Every launch passes it, and the kernels refuse a
#: tile that is not their own.
OPERATOR_TILE = (64, 16)


def _operator_slabs(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The k-slabs where each ``OPERATOR_TILE`` row tile of ``h`` has a
    nonzero, in CSR form: ``(offsets, slabs)``, int32, row tile r's slabs
    (ascending) being ``slabs[offsets[r]:offsets[r + 1]]``; slab s covers
    columns ``[s * tile_k, (s + 1) * tile_k)`` and row tile r rows
    ``[r * tile_m, (r + 1) * tile_m)``."""
    tile_m, tile_k = OPERATOR_TILE
    rows, cols = -(-h.shape[0] // tile_m), -(-h.shape[1] // tile_k)
    nz = np.zeros((rows * tile_m, cols * tile_k), dtype=bool)
    nz[:h.shape[0], :h.shape[1]] = h != 0
    live = nz.reshape(rows, tile_m, cols, tile_k).any(axis=(1, 3))
    offsets = np.concatenate([[0], np.cumsum(live.sum(axis=1))])
    return offsets.astype(np.int32), np.nonzero(live)[1].astype(np.int32)


@functools.lru_cache(maxsize=256)
def _operator_tiles(level: int, inverse: bool, dtype: torch.dtype,
                    device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The operand of ``axis_operator`` and ``fused_tail``: H (or H^-1) as
    its nonzero ``OPERATOR_TILE`` tiles, ``(tiles (nnz, tile_m, tile_k),
    offsets, slabs)`` (``_operator_slabs``), each tile row-major and
    zero-padded past N.  Built on the host once per key and cached, so a
    call copies nothing."""
    h = _operator_matrix(level, inverse)
    tm, tk = OPERATOR_TILE
    offsets, slabs = _operator_slabs(h)
    rows, cols = -(-h.shape[0] // tm), -(-h.shape[1] // tk)
    padded = np.zeros((rows * tm, cols * tk))
    padded[:h.shape[0], :h.shape[1]] = h
    blocks = padded.reshape(rows, tm, cols, tk).transpose(0, 2, 1, 3)
    tiles = blocks[np.repeat(np.arange(rows), np.diff(offsets)), slabs]
    return (torch.from_numpy(np.ascontiguousarray(tiles)).to(
                dtype=dtype, device=device),
            torch.from_numpy(offsets).to(device),
            torch.from_numpy(slabs).to(device))


_NONFINITE_STATE: dict = {}


def _strips(outer: int, inner: int) -> int:
    """Column strips (64 lines each, one per block column) of an operator
    pass over an (outer, n, inner) view."""
    tile = OPERATOR_TILE[0]
    return -(-outer // tile) if inner == 1 else outer * -(-inner // tile)


def _nonfinite_state(x: torch.Tensor, strips: int) -> torch.Tensor:
    """The device state of the operator kernels' non-finite repair
    (``operator_slab_tile.cuh``'s ``NonFinite``) for passes of up to
    ``strips`` column strips: a 64-line mask (two words) a strip, zero
    between calls (the repair launch zeroes what it reads), one per device
    and stream, grown when a call needs more."""
    key = (x.device, _stream(x))
    words = 2 * strips
    state = _NONFINITE_STATE.get(key)
    if state is None or state.numel() < words:
        state = torch.zeros(words, dtype=torch.int32, device=x.device)
        _NONFINITE_STATE[key] = state
    return state


def _pole_axis(x: torch.Tensor, axis: int) -> Tuple[int, int]:
    """``(axis, level)`` of a pole pass along ``axis`` of ``x`` (a negative
    axis counts from the end)."""
    if not -x.ndim <= axis < x.ndim:
        raise ValueError(f"axis {axis} is out of range for a grid of shape "
                         f"{tuple(x.shape)}")
    axis %= x.ndim
    return axis, ref._level_of_length(x.shape[axis])


def _pole_plain(x: torch.Tensor, *, reduced_op: bool = True,
                axis: int = 0) -> torch.Tensor:
    return ref.hierarchize_1d_ref(x, axis, reduced_op=reduced_op)


def _dehier_pole_plain(a: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
    return ref.dehierarchize_1d_ref(a, axis)


def _contract(x: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    """``x`` with axis ``axis`` contracted with its dense operator (one
    tensordot), in the operators' type."""
    h = _operator(ref._level_of_length(x.shape[axis]), inverse,
                  _op_dtype(x.dtype), x.device)
    return torch.movedim(torch.tensordot(h, x, dims=([1], [axis])), 0, axis)


def _axis_matmul_plain(x: torch.Tensor, *,
                       inverse: bool = False) -> torch.Tensor:
    _bundle_level(x)
    return _contract(x.to(_op_dtype(x.dtype)), 0, inverse).to(x.dtype)


def _fused_tail_plain(x: torch.Tensor, *,
                      inverse: bool = False) -> torch.Tensor:
    y = x.to(_op_dtype(x.dtype))
    for axis in range(1, x.ndim):
        if x.shape[axis] > 1:
            y = _contract(y, axis, inverse)
    return y.to(x.dtype)


def hier_pole(x: torch.Tensor, *, reduced_op: bool = True,
              axis: int = 0) -> torch.Tensor:
    """Hierarchize along ``axis`` of a grid, N = 2**l - 1 points along it
    (by default axis 0 of an (N, B) pole bundle): the paper's fine-to-coarse
    level loop.  ``reduced_op=False`` spells the update ``odd - 0.5*l -
    0.5*r`` (the paper's ablation).  On CUDA: one ``pole_fwd`` launch over
    the (outer, N, inner) view of the grid, so that any axis is passed in
    place (a strided grid is made contiguous first), into a fresh buffer;
    bitwise the plain version."""
    _record(hier_pole, x=x, reduced_op=reduced_op, axis=axis)
    axis, level = _pole_axis(x, axis)
    if level == 1:
        return x
    if x.device.type == "cpu":
        return _pole_plain(x, reduced_op=reduced_op, axis=axis)
    x = _check_stack(x)
    out = torch.empty_like(x)
    _raise_on(_build.kernel("pole_fwd", _DTYPE_TAG[x.dtype])(
        x.data_ptr(), out.data_ptr(), *_view(x.shape, axis), level,
        int(reduced_op), _stream(x)), "pole_fwd")
    hier_pole.launches += 1
    return out


def dehier_pole(a: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
    """Dehierarchize along ``axis`` of a grid (by default axis 0 of an (N,
    B) pole bundle): the coarse-to-fine level loop, the inverse of
    ``hier_pole``.  On CUDA: one ``pole_inv`` launch over the (outer, N,
    inner) view, the axis passed in place, into a fresh buffer; bitwise the
    plain version."""
    _record(dehier_pole, a=a, axis=axis)
    axis, level = _pole_axis(a, axis)
    if level == 1:
        return a
    if a.device.type == "cpu":
        return _dehier_pole_plain(a, axis=axis)
    a = _check_stack(a)
    out = torch.empty_like(a)
    _raise_on(_build.kernel("pole_inv", _DTYPE_TAG[a.dtype])(
        a.data_ptr(), out.data_ptr(), *_view(a.shape, axis), level,
        _stream(a)), "pole_inv")
    dehier_pole.launches += 1
    return out


def apply_axis_matmul(x: torch.Tensor, *,
                      inverse: bool = False) -> torch.Tensor:
    """(De)hierarchize along axis 0 of an (N, B) bundle as one operator
    product ``H . x`` (``H^-1 . x`` with ``inverse``).  On CUDA: one
    ``axis_operator`` launch (f64 on the tensor cores, f32, or bf16 summed
    in f32) that multiplies only the operator's nonzero tiles
    (``_operator_tiles``), then a repair launch on the same stream that
    gives a column holding a NaN or Inf the dense product's non-finite
    pattern, as the plain version has it (it returns at once on finite
    input; ``apply_axis_matmul.launches`` counts the tile launches)."""
    _record(apply_axis_matmul, x=x, inverse=inverse)
    level = _bundle_level(x)
    if level == 1:
        return x
    if x.device.type == "cpu":
        return _axis_matmul_plain(x, inverse=inverse)
    x = _check_stack(x, _GRID_TAG)
    tiles, offsets, slabs = _operator_tiles(level, inverse,
                                            _op_dtype(x.dtype), x.device)
    out = torch.empty_like(x)
    state = _nonfinite_state(x, _strips(1, x.shape[1]))
    _raise_on(_build.kernel("axis_operator", _GRID_TAG[x.dtype])(
        tiles.data_ptr(), offsets.data_ptr(), slabs.data_ptr(), x.data_ptr(),
        out.data_ptr(), state.data_ptr(), x.shape[0], x.shape[1],
        *OPERATOR_TILE, _stream(x)), "axis_operator")
    apply_axis_matmul.launches += 1
    return out


def _tail_passes(shape: Sequence[int]) -> list:
    """The passes of ``hier_fused_tail`` on a grid of ``shape``: ``(axis,
    outer, n, inner)`` for each tail axis 1..d-1 of extent > 1, in order,
    the axis viewed over the whole grid (a level-1 axis is the identity)."""
    return [(k, *_view(shape, k)) for k in range(1, len(shape))
            if shape[k] > 1]


def hier_fused_tail(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """(De)hierarchize every tail axis 1..d-1 of a (N0, ..., N_{d-1}) grid
    with the per-axis operators.  On CUDA: one ``fused_tail`` call (d <=
    10) that launches one pass per tail axis of extent > 1 (none when every
    tail axis has extent 1), each multiplying only the operator's nonzero
    tiles (``_operator_tiles``), each followed by a repair launch that
    gives a line holding a NaN or Inf the dense product's non-finite
    pattern, as in ``apply_axis_matmul``.  ``hier_fused_tail.launches``
    counts the passes."""
    _record(hier_fused_tail, x=x, inverse=inverse)
    if x.ndim < 2:
        raise ValueError("need >= 2 dims; use apply_axis_matmul for 1-D")
    for n in x.shape:
        ref._level_of_length(n)
    passes = _tail_passes(x.shape)
    if not passes:
        return x
    if x.device.type == "cpu":
        return _fused_tail_plain(x, inverse=inverse)
    if len(passes) > _MAX_TAIL_AXES:
        raise ValueError(f"the fused_tail kernel takes at most "
                         f"{_MAX_TAIL_AXES} tail axes, got {len(passes)}")
    x = _check_stack(x, _GRID_TAG)
    acc = _op_dtype(x.dtype)
    ws = [torch.empty(x.shape, dtype=acc, device=x.device)
          for _ in range(min(2, len(passes) - 1))]   # the ping-pong buffers
    ws_ptrs = [w.data_ptr() for w in ws] + [None] * (2 - len(ws))
    _, outer, n, inner = zip(*passes)
    ops = [_operator_tiles(ref._level_of_length(m), inverse, acc, x.device)
           for m in n]
    ints = lambda v: (ctypes.c_int64 * len(v))(*v)
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    tiles, offsets, slabs = zip(*ops)
    out = torch.empty_like(x)
    state = _nonfinite_state(x, max(_strips(o, i)
                                    for o, i in zip(outer, inner)))
    _raise_on(_build.kernel("fused_tail", _GRID_TAG[x.dtype])(
        x.data_ptr(), ws_ptrs[0], ws_ptrs[1], out.data_ptr(),
        state.data_ptr(), len(passes),
        ints(outer), ints(n), ints(inner), ptrs(tiles), ptrs(offsets),
        ptrs(slabs), *OPERATOR_TILE, _stream(x)), "fused_tail")
    hier_fused_tail.launches += len(passes)
    return out


def hier_axis0(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """(De)hierarchize axis 0 only of a d-dim grid, its trailing axes
    flattened onto the bundle's columns (``apply_axis_matmul``)."""
    shape = x.shape
    out = apply_axis_matmul(x.reshape(shape[0], -1), inverse=inverse)
    return out.reshape(shape)


def hierarchize_nd_fused(x: torch.Tensor) -> torch.Tensor:
    """Full d-dim hierarchization in two passes: every tail axis in one
    ``hier_fused_tail`` pass, then axis 0 (one pass if d == 1)."""
    if x.ndim == 1:
        return apply_axis_matmul(x[:, None])[:, 0]
    return hier_axis0(hier_fused_tail(x))


def dehierarchize_nd_fused(a: torch.Tensor) -> torch.Tensor:
    """The inverse of ``hierarchize_nd_fused``, in the same two passes."""
    if a.ndim == 1:
        return apply_axis_matmul(a[:, None], inverse=True)[:, 0]
    return hier_axis0(hier_fused_tail(a, inverse=True), inverse=True)


WRAPPERS = (hier_tail_batched, hier_axis0_batched, hier_axis0_scatter_batched,
            dehier_tail_batched, dehier_axis0_batched,
            hier_pole, dehier_pole, apply_axis_matmul, hier_fused_tail,
            hier_forward_grouped, hier_scatter_grouped, assemble_grouped,
            owner_fold)
for _w, _plain in zip(WRAPPERS, (_tail_plain, _axis0_plain,
                                 _axis0_scatter_plain, _dehier_tail_plain,
                                 _dehier_axis0_plain, _pole_plain,
                                 _dehier_pole_plain, _axis_matmul_plain,
                                 _fused_tail_plain, _forward_grouped_plain,
                                 _scatter_grouped_plain,
                                 _assemble_grouped_plain,
                                 _owner_fold_plain)):
    _w.launches = 0
    _w.plain = _plain


@contextlib.contextmanager
def count_launches():
    """Count kernel launches inside the block.

    Yields a dict, filled when the block EXITS, mapping each wrapper's
    name to the launches it made inside the block (the inverse wrappers
    under their own names)."""
    saved = {w: w.launches for w in WRAPPERS}
    result: dict = {}
    try:
        yield result
    finally:
        result.update({w.__name__: w.launches - saved[w] for w in WRAPPERS})


def _passes(x: torch.Tensor, member_levels, axes: Sequence[int], *,
            inverse: bool = False, pred=None) -> torch.Tensor:
    """Passes along bucket ``axes`` in the order given: each run of tail
    axes through ``hier_tail_batched``, axis 0 through
    ``hier_axis0_batched`` (their inverses with ``inverse``; ``pred`` the
    forward transform's runtime data, ``member_pred_arrays`` layout)."""
    run: list = []
    for k in list(axes) + [None]:
        if k is not None and k > 0:
            run.append(k)
            continue
        if run:
            x = hier_tail_batched(x, member_levels, inverse=inverse,
                                  pred=None if pred is None else pred[4:],
                                  axes=run)
            run = []
        if k == 0:
            x = hier_axis0_batched(x, _axis_levels(member_levels, 0),
                                   inverse=inverse,
                                   pred=None if pred is None else pred[:4])
    return x


def forward_passes(x: torch.Tensor, member_levels: Sequence[Sequence[int]],
                   axes: Sequence[int]) -> torch.Tensor:
    """Forward passes along bucket ``axes`` in the order given."""
    return _passes(x, member_levels, axes)


def hierarchize_batched(x: torch.Tensor,
                        member_levels: Sequence[Sequence[int]], *,
                        inverse: bool = False,
                        method: str = "auto") -> torch.Tensor:
    """Full d-dim (de)hierarchization of a (G, *bucket_shape) stack.

    ``method`` picks only the axis order (``axis_order``: ``"auto"``
    takes the reference's rule for the shape), since every bucket runs
    through the same kernels."""
    return _passes(x, member_levels, axis_order(x.shape[1:], method),
                   inverse=inverse)


def dehierarchize_batched(a: torch.Tensor,
                          member_levels: Sequence[Sequence[int]], *,
                          method: str = "auto") -> torch.Tensor:
    return hierarchize_batched(a, member_levels, inverse=True, method=method)


def hierarchize_batched_data(x: torch.Tensor, pred, *,
                             method: str = "auto") -> torch.Tensor:
    """Forward ``hierarchize_batched`` with the per-member predecessor
    data passed as runtime arrays (``member_pred_arrays(levels, shape)``,
    ``4 * d`` arrays) instead of member levels.  With that data it equals
    ``hierarchize_batched(x, levels, method=method)`` bitwise."""
    if len(pred) != 4 * (x.ndim - 1):
        raise ValueError(f"expected {4 * (x.ndim - 1)} predecessor arrays "
                         f"for a {x.ndim - 1}-dim stack, got {len(pred)}")
    return _passes(x, None, axis_order(x.shape[1:], method), pred=pred)
