"""The host tables of the ingest's two port-only kernels, on the CPU.

Rows 11 (``csrc/assemble_members.cu``) and 12 (``csrc/owner_fold.cu``, whose
staged fold row 9's second phase shares through ``csrc/hier3.cuh``) run
only on the card, so their index math is checked here by emulating it in
numpy on the very tables the wrappers build:

* the assembly: ``AssemblyPlan`` (collapsed descriptors, block map, groups)
  and the per-call records, walked block by block as the kernel walks them
  (the parameter blocks packed as the C entry point packs them), equal to
  ``_assemble_grouped_plain`` bitwise with every slot element written once;
* ``fast_divmod``: exact quotients for every extent and dividend below 2**31
  (seeded draws, as ``tests/proptest.py`` draws its cases: the suite takes
  no ``hypothesis``), and at the edges;
* the staged fold: the block ranges cover every short owner once within
  the shared-memory budget, and the fold staged as the kernel stages it
  equals ``_owner_fold_plain`` bitwise.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import executor as E
from repro_torch.core.levels import CombinationScheme, grid_shape
from repro_torch.kernels import hierarchize as H

DTYPES = [torch.float64, torch.float32]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(bits[a.dtype]), b.contiguous().view(bits[b.dtype]))


# ---------------------------------------------------------------------------
# (a) the assembly
# ---------------------------------------------------------------------------

def _pack(groups, over, nover):
    """The C entry point's launches: per group, runs of its members whose
    addresses, flags and strides fit one parameter block (``AsmCall``).
    Yields ``(group, first, count, {member: strides})``."""
    r = 0
    for g, (first, members, _, _) in enumerate(groups.tolist()):
        m0 = first
        while m0 < first + members:
            m1, strides, q, mine = m0, 0, r, {}
            while m1 < first + members:
                n = over[q + 1] if q < nover and over[q] == m1 else 0
                count = m1 + 1 - m0
                if count + (count + 3) // 4 + strides + n > H._ASM_CALL_WORDS:
                    break
                if n:
                    mine[m1] = over[q + 2:q + 2 + n]
                    q += 2 + n
                strides += n
                m1 += 1
            assert m1 > m0
            yield g, m0, m1 - m0, mine
            r, m0 = q, m1
    assert r == nover


def _element_offsets(e, axes, wide):
    """The kernel's ``element``: each slot element's source offset, and
    whether it lies inside the member (numpy, vectorised over ``e``); the
    32-bit path divides by the ``fast_divmod`` constants."""
    e = e.astype(np.int64)
    off = np.zeros_like(e)
    inside = np.ones(e.shape, bool)
    for s, m, t, mul, shift in axes[:0:-1]:
        if wide:
            q = e // s
        else:
            assert e.max(initial=0) < 2 ** 31
            q = ((e.astype(np.uint64) * np.uint64(mul))
                 >> np.uint64(shift)).astype(np.int64)
        i = e - q * s
        inside &= i < m
        off += i * t
        e = q
    inside &= e < axes[0][1]
    off += e * axes[0][2]
    assert wide or off[inside].max(initial=0) < 2 ** 31
    return off, inside


def _emulate(parts, stacks, wide=None):
    """``assemble_grouped``'s kernel in numpy on the wrapper's own tables:
    returns the flat stacks, how often each element was written and the
    launches made."""
    dtype, _, ptrs, shapes, strided = H._scan_parts(parts, stacks)
    plan = H._assembly_plan(stacks, shapes)
    over, call_wide = H._strided_records(plan, parts, strided)
    wide = call_wide or plan.wide if wide is None else wide
    memory = {}
    for p, ptr in zip(parts, ptrs):
        words = p.untyped_storage().nbytes() // p.element_size()
        memory[ptr] = (p.as_strided((words,), (1,), 0).numpy(),
                       p.storage_offset())
    itemsize = parts[0].element_size()
    V = 16 // itemsize
    out = np.full(plan.size, np.nan, {torch.float64: np.float64,
                                      torch.float32: np.float32}[dtype])
    writes = np.zeros(plan.size, np.int64)
    launches = 0
    for g, first, count, mine in _pack(plan.groups, over, len(over)):
        launches += 1
        _, _, block0, nblocks = plan.groups[g].tolist()
        for member, start in plan.blocks[block0:block0 + nblocks].tolist():
            if not first <= member < first + count:
                continue                    # another launch's member
            d = plan.desc[member]
            if member in mine:
                nd = int(d["nfull"])
                axes = [(int(a["slot"]), int(a["member"]), int(t),
                         int(a["mul"]), int(a["shift"]))
                        for a, t in zip(d["full"][:nd], mine[member])]
            else:
                axes = [tuple(int(a[f]) for f in ("slot", "member", "stride",
                                                   "mul", "shift"))
                        for a in d["axis"][:int(d["ndim"])]]
            base, size = int(d["offset"]), int(d["size"])
            lo, hi = start, min(start + plan.chunk, size)
            assert 0 <= lo < hi
            # aligned groups of V: the range cut out of the first and last
            g0, g1 = (base + lo) // V, -(-(base + hi) // V)
            e = np.arange(g0 * V, g1 * V) - base
            e = e[(e >= lo) & (e < hi)]
            src, offset = memory[ptrs[member]]
            rel, inside = _element_offsets(e, axes, wide)
            vals = np.zeros(e.size, out.dtype)
            vals[inside] = src[offset + rel[inside]]
            out[base + e] = vals
            np.add.at(writes, base + e, 1)
    return torch.from_numpy(out), writes, launches


def _views(plan, rng, dtype, kind):
    """The plan's member grids: contiguous, or alternately laid out with
    their axes reversed (a permuted view) and as every other element of a
    wider buffer (a strided slice), or all reversed."""
    parts = []
    for b in plan.buckets:
        for ell in b.ells:
            u = torch.from_numpy(rng.standard_normal(grid_shape(ell))).to(
                dtype)
            rev = tuple(reversed(range(u.ndim)))
            if kind == "contiguous":
                parts.append(u)
            elif kind == "strided" and len(parts) % 2:
                wide = torch.zeros(u.shape[:-1] + (2 * u.shape[-1],),
                                   dtype=dtype)
                wide[..., ::2] = u
                parts.append(wide[..., ::2])
            else:
                parts.append(u.permute(rev).contiguous().permute(rev))
    return parts


PLANS = {
    "prod_3d": lambda: E.build_plan(CombinationScheme(3, 9)),
    "fig7_4d": lambda: E.build_plan(CombinationScheme(4, 6)),
    "prod_3d_merged": lambda: E.build_plan(CombinationScheme(3, 9),
                                           merge=E.MergeConfig()),
    "fig8_10d": lambda: E.build_plan(CombinationScheme(10, 3)),
    "members_462": lambda: E.build_plan(CombinationScheme(6, 6)),
    "regular_4_7": lambda: E.build_plan(CombinationScheme(4, 7)),
}

CASES = [
    ("prod_3d", "contiguous", torch.float64, 1),
    ("fig7_4d", "contiguous", torch.float32, 1),
    ("prod_3d_merged", "contiguous", torch.float64, 1),
    ("fig8_10d", "contiguous", torch.float64, 1),
    ("prod_3d", "strided", torch.float64, 1),
    ("prod_3d_merged", "strided", torch.float32, 1),
    ("fig8_10d", "strided", torch.float32, 1),
    # more members than a parameter block holds: two groups of the table;
    # every member strided: the group launched again for its further runs
    ("members_462", "contiguous", torch.float64, 2),
    ("regular_4_7", "reversed", torch.float64, 2),
]


@pytest.mark.parametrize("name,kind,dtype,launches", CASES,
                         ids=[f"{n}-{k}-{str(d)[6:]}" for n, k, d, _ in CASES])
def test_assembly_tables_emulated_equal_the_plain_version(name, kind, dtype,
                                                           launches):
    plan = PLANS[name]()
    parts = _views(plan, np.random.default_rng(41), dtype, kind)
    stacks = tuple((b.shape, b.perms) for b in plan.buckets)
    got, writes, made = _emulate(parts, stacks)
    want = H.assemble_grouped.plain(parts, stacks)
    assert _same(got, want)
    assert (writes == 1).all(), "every slot element written exactly once"
    assert made == launches
    if kind == "contiguous":
        # the copy collapsed: no member keeps more axes than it has
        # non-unit slot axes, and the prod_3d members mostly run flat
        a = H._assembly_plan(stacks, tuple(p.shape for p in parts))
        assert (a.desc["ndim"] <= np.maximum(a.desc["nfull"], 1)).all()


def test_assembly_tables_wide_index_math_and_layout():
    """The 64-bit instantiation's index math gives the same copy; the
    descriptor dtype is the C struct's 664 bytes; the block map lists each
    group's blocks heaviest first, inside one member each, covering every
    slot; the chunk gives about four blocks a multiprocessor."""
    plan = PLANS["prod_3d"]()
    parts = _views(plan, np.random.default_rng(42), torch.float64,
                   "strided")
    stacks = tuple((b.shape, b.perms) for b in plan.buckets)
    narrow, _, _ = _emulate(parts, stacks, wide=False)
    wide, writes, _ = _emulate(parts, stacks, wide=True)
    assert _same(narrow, wide) and (writes == 1).all()
    assert H._ASM_DESC.itemsize == 664 and H._ASM_AXIS.itemsize == 32
    a = H._assembly_plan(stacks, tuple(p.shape for p in parts))
    assert a.chunk == 512 and not a.wide
    assert a.groups.tolist() == [[0, 109, 0, len(a.blocks)]]
    sizes = a.desc["size"]
    work = np.minimum(a.chunk, sizes[a.blocks[:, 0]] - a.blocks[:, 1])
    assert (np.diff(work) <= 0).all() and (work > 0).all()
    covered = sorted(a.blocks.tolist())
    assert covered == [[m, s] for m in range(a.members)
                       for s in range(0, int(sizes[m]), a.chunk)]
    ndim = np.bincount(a.desc["ndim"], minlength=4)
    assert ndim[1] > ndim[2] > ndim[3] > 0     # most prod_3d members flat


def test_assembly_refuses_before_reading():
    plan = PLANS["fig8_10d"]()
    stacks = tuple((b.shape, b.perms) for b in plan.buckets)
    parts = _views(plan, np.random.default_rng(43), torch.float64,
                   "contiguous")
    with pytest.raises(ValueError, match="expected 66 member grids"):
        H._scan_parts(parts[:-1], stacks)
    with pytest.raises(TypeError, match="share one dtype"):
        H._scan_parts(parts[:-1] + [parts[-1].float()], stacks)
    big = list(parts)
    big[0] = torch.zeros(tuple(2 * n + 1 for n in parts[0].shape),
                         dtype=torch.float64)
    with pytest.raises(ValueError, match="does not fit"):
        H._assembly_plan(stacks, tuple(p.shape for p in big))
    with pytest.raises(ValueError, match="10-dim"):
        H._assembly_plan(stacks, tuple(p.shape for p in parts[:-1])
                         + ((1, 1),))


# ---------------------------------------------------------------------------
# (b) fast divmod
# ---------------------------------------------------------------------------

def _check_divmod(d: np.ndarray, n: np.ndarray) -> None:
    consts = [H.fast_divmod(int(x)) for x in d]
    mul = np.asarray([c[0] for c in consts], np.uint64)
    shift = np.asarray([c[1] for c in consts], np.uint64)
    assert (mul < 2 ** 32).all() and (shift >= 31).all() and \
        (shift <= 62).all()
    n = n.astype(np.uint64)
    q = (n * mul) >> shift                  # n * mul < 2**63: no overflow
    d = d.astype(np.uint64)
    assert np.array_equal(q, n // d)
    assert np.array_equal(n - q * d, n % d)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_divmod_is_exact_below_2_31(seed):
    """Seeded draws: extents log-uniform over 1 .. 2**31 - 1, dividends
    uniform below 2**31 and beside multiples of the extent."""
    rng = np.random.default_rng(seed)
    d = np.unique(np.exp(rng.uniform(0, np.log(2 ** 31 - 1), 4000))
                  .astype(np.int64).clip(1, 2 ** 31 - 1))
    d = np.repeat(d, 8)
    n = rng.integers(0, 2 ** 31, d.size)
    k = n // d
    near = (k * d + rng.integers(-2, 3, d.size)).clip(0, 2 ** 31 - 1)
    _check_divmod(d, n)
    _check_divmod(d, near)


def test_fast_divmod_edges():
    top = 2 ** 31 - 1
    ds = [1, 2, 3, 5, 7, 511, 1023, 1575, 2 ** 30, 2 ** 30 + 1, top - 1, top]
    ds += [2 ** k + j for k in range(1, 31) for j in (-1, 0, 1)]
    ds = np.asarray(sorted({x for x in ds if 1 <= x <= top}), np.int64)
    for d in ds:
        n = np.asarray(sorted({0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d,
                               top - top % d - 1, top - top % d, top - 1,
                               top}), np.int64)
        n = n[(n >= 0) & (n <= top)]
        _check_divmod(np.full(n.size, d), n)


# ---------------------------------------------------------------------------
# (c) the staged fold
# ---------------------------------------------------------------------------

def _check_ranges(table) -> None:
    table.on(torch.device("cpu"))
    assert table.fold_ranges.dtype == np.int64
    r, first = table.fold_ranges.T
    assert np.array_equal(first, table.offsets[r])
    assert r[0] == table.long_owners
    assert r[-1] == table.owners and (np.diff(r) > 0).all()
    assert (np.diff(r) <= H._FOLD_THREADS).all()
    spans = table.offsets[r[1:]] - table.offsets[r[:-1]]
    assert (spans <= H._FOLD_SPAN).all()
    runs = np.diff(table.offsets)
    assert (runs[:table.long_owners] > 32).all()
    assert (runs[table.long_owners:] <= 32).all()


def _staged_fold(values: torch.Tensor, table, acc: torch.Tensor):
    """``fold_owner_runs`` in numpy: the long owners' runs in order, then
    each range's span staged and each short owner folded from it."""
    v = values.numpy()
    out = acc.numpy().copy()
    entries, slots, offsets = table.entries, table.slots, table.offsets
    for o in range(table.long_owners):
        x = out[slots[o]]
        for j in range(offsets[o], offsets[o + 1]):
            x = x + v[entries[j]]
        out[slots[o]] = x
    r = table.fold_ranges
    for (o0, first), (o1, last) in zip(r[:-1].tolist(), r[1:].tolist()):
        staged = v[entries[first:last]]
        assert staged.size <= H._FOLD_SPAN
        for o in range(o0, o1):
            x = out[slots[o]]
            for j in range(offsets[o] - first, offsets[o + 1] - first):
                x = x + staged[j]
            out[slots[o]] = x
    return torch.from_numpy(out)


@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_fold_on_runs_of_1_to_200(dtype):
    rng = np.random.default_rng(44)
    size, n = 3000, 60000
    dst = rng.integers(0, size + 1, n).astype(np.int32)
    dst[:200] = 5
    dst[200:233] = 7                        # a run of 33 and more: a warp
    table = H.owner_table([dst], size)
    assert table.long_owners >= 2 and np.diff(table.offsets).max() >= 200
    _check_ranges(table)
    vals = torch.from_numpy(rng.choice([-3.0, -1.0, 1.0, 3.0], n)
                            * rng.standard_normal(n)).to(dtype)
    acc = torch.from_numpy(rng.standard_normal(size + 1)).to(dtype)
    want = H.owner_fold(vals, table, acc.clone())
    assert _same(_staged_fold(vals, table, acc), want)


def test_staged_fold_on_the_prod_3d_2d_tables():
    """The 2-D ingest's slab-owner tables at prod_3d (two slabs), and row 9's
    scatter table of the same plan: ranges within budget; the staged fold
    bitwise the plain one on the slab tables' runs (their slots renumbered
    into a compact buffer, so the 0.5 GB slabs are not allocated)."""
    from repro_torch.core.distributed import two_d_tables
    plan = E.build_plan(CombinationScheme(3, 9))
    splan = E.shard_plan(plan, 2, n_groups=2)
    folds = two_d_tables(splan).folds
    assert len(folds) == 2
    rng = np.random.default_rng(45)
    for slab in folds:
        _check_ranges(slab)
        table = H.OwnerTable(slab.entries, np.arange(slab.owners,
                                                     dtype=np.int32),
                             slab.offsets, slab.owners)
        _check_ranges(table)
        assert np.array_equal(table.fold_ranges, slab.fold_ranges)
        n = int(table.entries.max()) + 1
        vals = torch.from_numpy(rng.standard_normal(n))
        acc = torch.from_numpy(rng.standard_normal(table.dump + 1))
        want = H.owner_fold(vals, table, acc.clone())
        assert _same(_staged_fold(vals, table, acc), want)
    _check_ranges(E._ingest_table(plan).scatter)
