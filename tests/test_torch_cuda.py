"""CUDA kernels of ``repro_torch`` against their plain PyTorch versions, on
the card.

Every test here needs a CUDA device: the ``cuda`` fixture skips (with a
reason) when there is none, which is decided at run time, never while the
module is collected.  The file imports no JAX, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX for the
reference's tests.)  Inputs are made with numpy from a seed.  The batched and pole kernels
round every product and sum separately, so their comparisons are bitwise;
the dense-operator kernels (``apply_axis_matmul``, ``hier_fused_tail``)
sum in another order than the plain version's tensordot and are held to
the reference's tolerances (f64 rtol 1e-11 / atol 1e-12, f32 2e-5, bf16
a max abs error below 0.15 against the f64 brute force and one bf16 ulp
plus 2**-12 against the plain version, which also sums in f32).  The
flash-attention kernel is held to its plain version at the reference
kernel's bars, 2e-5 in f32 and 2e-2 in bf16 (the f32 kernel keeps scores
and probabilities in f32 and sums in another order; the bf16 kernel runs
on the warpgroup tensor-core products and rounds the probabilities to
bf16 before the value product), in bf16 also within 1e-2 relative L2.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.executor import (MergeConfig, build_plan,
                                       ct_transform_with_plan)
from repro_torch.core.levels import (CombinationScheme, GeneralScheme,
                                     grid_shape)
from repro_torch.core.iterated import run_iterated_heat
from repro_torch.kernels import hierarchize as H
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (dehierarchize_1d_bruteforce,
                                     hierarchize_1d_bruteforce)
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as F
from repro_torch.launch.serve import CTSurrogate, ServeConfig, generate
from repro_torch.models import model as M
from repro_torch.models.transformer import init_params

pytestmark = pytest.mark.gpu

DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _stack(rng, levels, shape, dtype):
    """(G, *shape) stack, member g holding random data at its own level
    vector and zeros on the padding, as the executor assembles it."""
    x = np.zeros((len(levels),) + tuple(shape))
    for g, lv in enumerate(levels):
        sl = tuple(slice(0, (1 << l) - 1) for l in lv)
        x[(g,) + sl] = rng.standard_normal(grid_shape(lv))
    return torch.from_numpy(x).to(dtype)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (tells -0.0 from +0.0)."""
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    return a.dtype == b.dtype and torch.equal(a.view(bits[a.dtype]),
                                              b.view(bits[b.dtype]))


STACKS = [
    ((15, 15), ((4, 4), (3, 4), (4, 2))),
    ((7, 7, 7), ((3, 3, 3), (3, 2, 1), (2, 3, 3))),
    ((31, 7, 3), ((5, 3, 2), (4, 3, 1))),
    ((7, 3, 3, 1), ((3, 2, 2, 1), (3, 1, 2, 1))),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,levels", STACKS)
def test_tail_and_axis0_match_plain(cuda, dtype, shape, levels):
    x = _stack(np.random.default_rng(1), levels, shape, dtype)
    y = H.hier_tail_batched(x.to(cuda), levels)
    assert y.is_cuda and _same(y, H.hier_tail_batched(x, levels))
    l0 = [lv[0] for lv in levels]
    z = H.hier_axis0_batched(y, l0)
    assert _same(z, H.hier_axis0_batched(y.cpu(), l0))
    assert _same(H.hierarchize_batched(x.to(cuda), levels),
                 H.hierarchize_batched(x, levels))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,levels", STACKS)
def test_scatter_matches_plain_on_every_axis(cuda, dtype, shape, levels):
    rng = np.random.default_rng(2)
    x = _stack(rng, levels, shape, dtype)
    g, p = x.shape[0], x[0].numel()
    fine = 4 * p
    # injective per member, pad positions on the dump slot, members
    # overlapping so the member-order fold is exercised
    index = np.empty((g, p), np.int32)
    for m, lv in enumerate(levels):
        real = np.zeros(shape, bool)
        real[tuple(slice(0, (1 << l) - 1) for l in lv)] = True
        index[m] = np.where(real.ravel(), rng.permutation(fine)[:p], fine)
    index = torch.from_numpy(index)
    coeffs = torch.tensor([3.0, -3.0, 1.0][:g], dtype=dtype)
    acc = torch.from_numpy(rng.standard_normal(fine + 1)).to(dtype)
    for axis in range(len(shape)):
        lv = [l[axis] for l in levels]
        want = H.hier_axis0_scatter_batched(x, lv, coeffs, index, acc.clone(),
                                            axis=axis)
        got = H.hier_axis0_scatter_batched(x.to(cuda), lv, coeffs.to(cuda),
                                           index.to(cuda), acc.to(cuda),
                                           axis=axis)
        assert _same(got, want), axis


def test_masked_neighbours_do_not_leak(cuda):
    """An Inf/NaN in a pad slot is selected away, never multiplied in."""
    levels = ((2, 2), (3, 3))
    x = _stack(np.random.default_rng(3), levels, (7, 7), torch.float64)
    x[0, 3:, :] = float("nan")
    x[0, :, 3:] = float("inf")
    got = H.hierarchize_batched(x.to(cuda), levels)
    want = H.hierarchize_batched(x, levels)
    assert torch.isfinite(got[0, :3, :3]).all()
    # the pads themselves hold NaN/Inf, whose NaN payloads may differ
    assert _same(got[0, :3, :3], want[0, :3, :3]) and _same(got[1], want[1])


def test_wrappers_count_launches(cuda):
    levels = ((3, 3, 3), (3, 2, 1))
    x = _stack(np.random.default_rng(4), levels, (7, 7, 7),
               torch.float64).to(cuda)
    with H.count_launches() as n:
        H.hierarchize_batched(x, levels)
    # axis 0, then both tail axes in one launch
    assert n == {"hier_tail_batched": 1, "hier_axis0_batched": 1,
                 "hier_axis0_scatter_batched": 0, "dehier_tail_batched": 0,
                 "dehier_axis0_batched": 0, "hier_pole": 0,
                 "dehier_pole": 0, "apply_axis_matmul": 0,
                 "hier_fused_tail": 0, "hier_forward_grouped": 0,
                 "hier_scatter_grouped": 0, "assemble_grouped": 0,
                 "owner_fold": 0}
    with H.count_launches() as n:
        H.dehierarchize_batched(x, levels)
    assert {k: v for k, v in n.items() if v} == {"dehier_tail_batched": 2,
                                                 "dehier_axis0_batched": 1}



def test_ptxas_report_survives_a_cached_build(cuda):
    """nvcc's ``-Xptxas -v`` report is kept beside each library, so a
    process that finds the libraries built still has it."""
    from repro_torch.kernels import _build
    _build.load_all()
    for name in _build.KERNELS:
        path = _build._library_path(name)
        assert path.is_file()
        assert "ptxas" in path.with_suffix(".ptxas.txt").read_text()
        assert _build.PTXAS_LOG[name] == \
            path.with_suffix(".ptxas.txt").read_text()

# ---------------------------------------------------------------------------
# The batched inverse kernel (rows 6 and 8 of the TPU-kernel table)
# ---------------------------------------------------------------------------

INVERSE_STACKS = [
    ((31,), ((5,), (3,), (1,))),                          # 1 axis
    ((15, 15), ((4, 4), (1, 4), (4, 1))),
    ((7, 7, 7), ((3, 3, 3), (3, 2, 1), (1, 3, 2))),
    ((63, 1, 7), ((6, 1, 3), (2, 1, 1))),                 # a level-1 axis
    ((15, 7, 3, 3), ((4, 3, 2, 2), (4, 1, 2, 1))),
    ((255, 31, 3, 1), ((8, 5, 2, 1), (7, 5, 1, 1))),
    # prod_3d's extremes: three 511-long columns, one per member
    ((511, 1, 1), ((9, 1, 1), (9, 1, 1), (8, 1, 1))),
    # a merged (12, 511, 3, 1) stack, members below the target (padding
    # copied)
    ((511, 3, 1), ((9, 2, 1), (8, 2, 1), (7, 1, 1), (9, 1, 1), (6, 2, 1),
                   (8, 1, 1), (5, 2, 1), (7, 2, 1), (4, 1, 1), (3, 2, 1),
                   (9, 2, 1), (2, 1, 1))),
    # one member whose last axis has 511-long rows (inner = 1): tiles of
    # two whole rows
    ((1023, 511), ((10, 9),)),
    # more columns than one block's tile (axis 0: 8 of 2047 per tile; 32
    # of 8191, 131 KB in f64, as on the 511^3 grid)
    ((255, 2047), ((8, 11), (7, 10))),
    ((511, 8191), ((9, 13), (8, 12))),
    # tiles of whole outer positions of an inner of 3 (axis 1: 21 of them,
    # 63 columns)
    ((4095, 7, 3), ((12, 3, 2), (11, 2, 2))),
    # 32767-long columns: past one block's shared memory in f64 (the
    # per-thread branch), a 128 KB tile in f32
    ((32767, 3), ((15, 2), (14, 1))),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,levels", INVERSE_STACKS)
def test_inverse_kernel_matches_plain(cuda, dtype, shape, levels):
    x = _stack(np.random.default_rng(7), levels, shape, dtype)
    xc = x.to(cuda)
    with H.count_launches() as n:
        tail = H.dehier_tail_batched(xc, levels)
        axis0 = H.dehier_axis0_batched(xc, [lv[0] for lv in levels])
        full = H.dehierarchize_batched(xc, levels)
    assert _same(tail, H.dehier_tail_batched.plain(x, levels))
    assert _same(axis0, H.dehier_axis0_batched.plain(
        x, [lv[0] for lv in levels]))
    assert _same(full, H.dehierarchize_batched(x, levels))
    live = sum(1 for k in shape[1:] if k > 1)
    assert n["dehier_tail_batched"] == 2 * live
    assert n["dehier_axis0_batched"] == 2 * (shape[0] > 1)
    back = H.dehierarchize_batched(H.hierarchize_batched(xc, levels), levels)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((back.cpu() - x).abs().max()) <= tol


def test_inverse_kernel_refuses_what_it_does_not_take(cuda):
    levels = ((3, 3), (2, 3))
    x = _stack(np.random.default_rng(8), levels, (7, 7),
               torch.float64).to(cuda)
    with pytest.raises(TypeError, match="float"):
        H.dehier_tail_batched(x.to(torch.float16), levels)
    with pytest.raises(ValueError, match="contiguous"):
        H.dehier_tail_batched(x.transpose(1, 2), levels)
    with pytest.raises(ValueError, match="contiguous"):
        H.dehier_axis0_batched(x.transpose(1, 2), [3, 2])
    with pytest.raises(ValueError, match="does not fit"):
        H.dehier_axis0_batched(x, [4, 2])


@pytest.mark.parametrize("merged", [False, True])
def test_ct_scatter_card_equals_cpu(cuda, merged):
    from repro_torch.core.executor import MergeConfig, ct_scatter_with_plan
    scheme = CombinationScheme(3, 5)
    rng = np.random.default_rng(9)
    plan = build_plan(scheme, merge=MergeConfig(launch_cost_bytes=1 << 30)
                      if merged else None)
    full = torch.from_numpy(rng.standard_normal(plan.fine_shape))
    with H.count_launches() as n:
        card = ct_scatter_with_plan(full.to(cuda), plan, device=cuda)
    cpu = ct_scatter_with_plan(full, plan, device="cpu")
    assert n["dehier_tail_batched"] > 0 and n["dehier_axis0_batched"] > 0
    assert set(card) == set(cpu)
    for ell, u in cpu.items():
        assert card[ell].is_cuda and _same(card[ell], u)


SCHEMES = [CombinationScheme(4, 3), CombinationScheme(3, 4),
           GeneralScheme.from_levels([(6, 5), (5, 6)], close=True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scheme", SCHEMES, ids=str)
def test_ct_transform_card_equals_cpu(cuda, dtype, scheme):
    rng = np.random.default_rng(5)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
             .to(dtype) for ell, _ in scheme.grids}
    plan = build_plan(scheme)
    want = ct_transform_with_plan(grids, plan, device="cpu")
    fused = ct_transform_with_plan(grids, plan, device=cuda)
    unfused = ct_transform_with_plan(grids, plan, fused=False, device=cuda)
    assert _same(fused, want) and _same(unfused, want)


def test_surrogate_card_matches_cpu(cuda):
    scheme = CombinationScheme(3, 4)
    rng = np.random.default_rng(6)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
             for ell, _ in scheme.grids}
    pts = rng.random((64, 3))
    card = CTSurrogate(scheme, grids, device=cuda)
    cpu = CTSurrogate(scheme, grids, device="cpu")
    assert _same(card.surplus, cpu.surplus)
    np.testing.assert_allclose(card.query(pts), cpu.query(pts), rtol=1e-12,
                               atol=1e-14)


# ---------------------------------------------------------------------------
# The grouped ingest kernels (rows 5, 7 and 9 of the TPU-kernel table)
# ---------------------------------------------------------------------------

GROUPED = {
    "prod_3d": lambda: build_plan(CombinationScheme(3, 9)),
    "prod_3d_merged": lambda: build_plan(CombinationScheme(3, 9),
                                         merge=MergeConfig()),
    "regular_4_6": lambda: build_plan(CombinationScheme(4, 6)),
    "fig8_10d": lambda: build_plan(CombinationScheme(10, 3)),
    # 32767-long and 255 x 255 members: the forward kernel's device-memory
    # branch
    "long_axis_2_15": lambda: build_plan(CombinationScheme(2, 15)),
}


def _grouped_scatter_table(plan, table, rng):
    """The plan's slot-owner table, or, where the plan's fine grid is over
    2**28 values, one of the same stacks on random injective maps into a
    compact fine buffer (members overlapping, pads on the dump slot)."""
    sc = table.scatter
    if plan.fine_size <= 1 << 28:
        return sc
    fine = 2 * sc.size
    maps = []
    for b in plan.buckets:
        real = b.index != plan.fine_size
        maps.append(np.where(real, np.stack([
            rng.permutation(fine)[:b.index.shape[1]]
            for _ in range(b.index.shape[0])]), fine).astype(np.int32))
    return H.scatter_table(sc.stacks, maps, fine)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(GROUPED))
def test_grouped_kernels_match_plain(cuda, name, dtype):
    """One launch of the grouped forward passes and two of the grouped
    scatter over every bucket of the plan, each bitwise its plain version
    (the scatter from a random starting fine buffer, +-1 and +-3
    coefficients)."""
    from repro_torch.core.executor import _ingest_table
    plan = GROUPED[name]()
    table = _ingest_table(plan)
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.standard_normal(table.scatter.size)).to(dtype)
    with H.count_launches() as n:
        y = H.hier_forward_grouped(x.to(cuda), table.stacks)
    want = H.hier_forward_grouped(x, table.stacks)
    assert _same(y, want)
    sc = _grouped_scatter_table(plan, table, rng)
    cs = torch.from_numpy(rng.choice([-3.0, -1.0, 1.0, 3.0],
                                     sc.members)).to(dtype)
    acc = torch.zeros(sc.dump + 1, dtype=dtype)
    acc[torch.from_numpy(sc.slots).long()] = torch.from_numpy(
        rng.standard_normal(sc.owners)).to(dtype)
    with H.count_launches() as m:
        got = H.hier_scatter_grouped(y, sc, cs.to(cuda), acc.to(cuda))
    assert _same(got, H.hier_scatter_grouped(want, sc, cs, acc))
    assert n["hier_forward_grouped"] == 1 and m["hier_scatter_grouped"] == 2


FORWARD_STACKS = (
    # device memory: 3 passes (scratch twice), then 2 passes (once)
    ((31, 63, 127), ((5, 6, 7),), (0, 1, 2)),
    ((3, 127, 127), ((2, 7, 7), (2, 7, 6), (1, 6, 7)), (1, 2)),
    # shared memory, a level-1 axis, a stack with no pass (a copy)
    ((7, 1, 15), ((3, 1, 4), (2, 1, 3)), (2, 1, 0)),
    ((15,), ((4,), (2,)), ()),
)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_forward_device_memory_branch(cuda, dtype):
    """Members past two shared buffers (116,224 bytes each) walk their
    passes in device memory, ping-ponging through the scratch."""
    rng = np.random.default_rng(31)
    size = sum(len(lv) * int(np.prod(s)) for s, lv, _ in FORWARD_STACKS)
    x = torch.from_numpy(rng.standard_normal(size)).to(dtype)
    got = H.hier_forward_grouped(x.to(cuda), FORWARD_STACKS)
    assert _same(got, H.hier_forward_grouped(x, FORWARD_STACKS))


def test_prod_3d_ingest_makes_three_launches(cuda):
    """Three launches of the hierarchization kernels (rows 5, 7 and 9) and
    one of the assembly: four in all, however many grids."""
    scheme = CombinationScheme(3, 9)
    rng = np.random.default_rng(32)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
             .to(cuda) for ell, _ in scheme.grids}
    plan = build_plan(scheme)
    with H.count_launches() as n:
        ct_transform_with_plan(grids, plan, device=cuda)
    assert {k: v for k, v in n.items() if v} == {
        "assemble_grouped": 1, "hier_forward_grouped": 1,
        "hier_scatter_grouped": 2}


def _member_views(plan, rng, dtype, device):
    """The plan's member grids on ``device``, alternately laid out with
    their axes reversed (a permuted view) and as every other element of a
    wider buffer (a strided slice)."""
    parts = []
    for b in plan.buckets:
        for ell in b.ells:
            u = torch.from_numpy(rng.standard_normal(grid_shape(ell))).to(
                dtype=dtype, device=device)
            rev = tuple(reversed(range(u.ndim)))
            if len(parts) % 2:
                wide = torch.zeros(u.shape[:-1] + (2 * u.shape[-1],),
                                   dtype=dtype, device=device)
                wide[..., ::2] = u
                parts.append(wide[..., ::2])
            else:
                parts.append(u.permute(rev).contiguous().permute(rev))
    return parts


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["prod_3d", "prod_3d_merged", "fig8_10d",
                                  "long_axis_2_15"])
def test_assemble_grouped_matches_plain(cuda, name, dtype):
    """One ``assemble_members`` launch, bitwise the plain copy loop, on
    permuted and strided member grids (the padding written as zeros)."""
    plan = GROUPED[name]()
    parts = _member_views(plan, np.random.default_rng(33), dtype, cuda)
    assert sum(not p.is_contiguous() for p in parts) >= len(parts) // 3
    stacks = tuple((b.shape, b.perms) for b in plan.buckets)
    with H.count_launches() as n:
        got = H.assemble_grouped(parts, stacks)
    assert n["assemble_grouped"] == 1
    assert _same(got, H.assemble_grouped([p.cpu() for p in parts], stacks))
    assert _same(got, H.assemble_grouped.plain(parts, stacks))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,kind,launches", [
    ("fig7_4d", "strided", 1), ("members_462", "contiguous", 2),
    ("regular_4_7", "reversed", 2)])
def test_assembly_past_one_parameter_block(cuda, name, kind, launches,
                                           dtype):
    """The CPU emulation's shapes (``test_torch_ingest_tables.py``) on the
    card: bitwise the plain version; a plan of 462 members is two groups of
    the table, and 195 members all read through their strides overflow one
    parameter block: two launches each."""
    from test_torch_ingest_tables import PLANS, _views
    plan = PLANS[name]()
    parts = []
    for p in _views(plan, np.random.default_rng(46), dtype, kind):
        # on the card with its own strides and storage offset
        flat = p.as_strided((p.untyped_storage().nbytes()
                             // p.element_size(),), (1,), 0).to(cuda)
        parts.append(flat.as_strided(p.shape, p.stride(),
                                     p.storage_offset()))
    if kind != "contiguous":
        assert any(not p.is_contiguous() for p in parts)
    stacks = tuple((b.shape, b.perms) for b in plan.buckets)
    with H.count_launches() as n:
        got = H.assemble_grouped(parts, stacks)
    assert n["assemble_grouped"] == launches
    assert _same(got, H.assemble_grouped([p.cpu() for p in parts], stacks))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_scatter_on_462_members(cuda, dtype):
    """Row 9 (both launches, the staged fold) on the 6-D plan of 462
    members (its 63**6 fine grid replaced by compact random maps), from a
    random fine buffer, bitwise its plain version."""
    from repro_torch.core.executor import _ingest_table
    from test_torch_ingest_tables import PLANS
    plan = PLANS["members_462"]()
    table = _ingest_table(plan)
    rng = np.random.default_rng(47)
    y = torch.from_numpy(rng.standard_normal(table.scatter.size)).to(dtype)
    sc = _grouped_scatter_table(plan, table, rng)
    cs = torch.from_numpy(rng.choice([-3.0, -1.0, 1.0, 3.0],
                                     sc.members)).to(dtype)
    acc = torch.from_numpy(rng.standard_normal(sc.dump + 1)).to(dtype)
    with H.count_launches() as n:
        got = H.hier_scatter_grouped(y.to(cuda), sc, cs.to(cuda),
                                     acc.to(cuda))
    assert n["hier_scatter_grouped"] == 2
    assert _same(got, H.hier_scatter_grouped(y, sc, cs, acc.clone()))


def test_engine_prod_3d_tenants_share_one_executable(cuda):
    """Two prod_3d tenants of one signature: 1 miss and 1 hit, each
    surplus bitwise ``ct_transform_with_plan``'s, each ingest four
    launches."""
    from repro_torch.core.engine import CTEngine, clear_compile_cache
    scheme = CombinationScheme(3, 9)
    plan = build_plan(scheme)
    clear_compile_cache()
    eng = CTEngine(device=cuda, ingest_workers=0)
    rng = np.random.default_rng(34)
    for name in ("a", "b"):
        grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
                 .to(cuda) for ell, _ in scheme.grids}
        with H.count_launches() as n:
            eng.register(name, scheme, grids)
        assert sum(n.values()) == 4
        assert _same(eng.surplus(name),
                     ct_transform_with_plan(grids, plan, device=cuda))
    st = eng.stats()["ingest_cache"]
    assert (st["misses"], st["hits"]) == (1, 1)


def test_engine_ingest_on_the_pool_thread(cuda):
    """An ingest run by the shared pool's thread (the default engine) and
    its query: the surplus bitwise the caller-thread transform, the
    answers bitwise a one-tenant query, a failing ingest failing its own
    future only."""
    from repro_torch.core.engine import CTEngine
    scheme = CombinationScheme(3, 4)
    plan = build_plan(scheme)
    rng = np.random.default_rng(35)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
             .to(cuda) for ell, _ in scheme.grids}
    eng = CTEngine(device=cuda)
    eng.register("t", scheme, {k: 0.5 * v for k, v in grids.items()})
    pts = rng.random((64, 3))
    fi = eng.submit_ingest("t", grids)
    fq = eng.submit_query("t", pts)
    bad = eng.submit_ingest("t", {k: v for k, v in list(grids.items())[1:]})
    eng.flush()
    assert _same(fi.result(), ct_transform_with_plan(grids, plan,
                                                     device=cuda))
    with pytest.raises(ValueError, match="missing"):
        bad.result()
    assert fi.result() is eng.surplus("t")
    assert np.array_equal(fq.result(), eng.query("t", pts))
    eng.close()


# ---------------------------------------------------------------------------
# The per-grid kernels (rows 1-4 of the TPU-kernel table)
# ---------------------------------------------------------------------------

OP_TOL = {torch.float64: dict(rtol=1e-11, atol=1e-12),
          torch.float32: dict(rtol=2e-5, atol=2e-5)}
BUNDLES = [(1, 8), (2, 1), (5, 33), (8, 200), (9, 1000),   # (level, cols)
           (9, 1001), (10, 77), (11, 130)]      # not multiples of the tile


def _bundle(level, cols, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        ((1 << level) - 1, cols)))


#: Long poles (levels 13-15) with few columns: the pole kernels split them
#: into spans over many blocks.
LONG_POLES = [(level, cols) for level in (13, 14, 15) for cols in (1, 3, 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level,cols", BUNDLES + LONG_POLES)
def test_pole_kernels_match_plain(cuda, dtype, level, cols):
    x = _bundle(level, cols, 11).to(dtype)
    for reduced_op in (True, False):
        got = H.hier_pole(x.to(cuda), reduced_op=reduced_op)
        assert _same(got, H.hier_pole.plain(x, reduced_op=reduced_op))
    assert _same(H.dehier_pole(x.to(cuda)), H.dehier_pole.plain(x))


def _same_on_card(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors on the card, compared there."""
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    a, b = a.contiguous(), b.contiguous()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(bits[a.dtype]), b.view(bits[b.dtype]))


#: Every axis of the 511^3 cube and of the 16383 x 8191 plane (1.07 GB in
#: f64), and of small grids, passed in place.
POLE_VIEWS = [((511, 511, 511), 0), ((511, 511, 511), 1),
              ((511, 511, 511), 2), ((16383, 8191), 0), ((16383, 8191), 1),
              ((15, 7, 31), 1), ((7, 3, 15), 2), ((3, 255, 5), 1)]


@pytest.mark.parametrize("shape,axis", POLE_VIEWS, ids=str)
def test_pole_kernels_in_place_axis(cuda, shape, axis):
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        shape)).to(cuda)
    for dtype in DTYPES:
        y = x.to(dtype)
        for reduced_op in (True, False):
            with H.count_launches() as n:
                got = H.hier_pole(y, reduced_op=reduced_op, axis=axis)
            assert n["hier_pole"] == 1
            assert _same_on_card(got, H.hier_pole.plain(
                y, reduced_op=reduced_op, axis=axis))
            del got
        assert _same_on_card(H.dehier_pole(y, axis=axis),
                             H.dehier_pole.plain(y, axis=axis))
        del y


def test_pole_kernels_take_strided_grids_and_refuse_bf16(cuda):
    """A strided grid is made contiguous first (as before the kernels took
    an axis in place); a type the kernels lack raises."""
    x = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (31, 63))).to(cuda).T
    assert not x.is_contiguous()
    for axis in (0, 1, -1):
        assert _same(H.hier_pole(x, axis=axis),
                     H.hier_pole.plain(x.cpu(), axis=axis))
        assert _same(H.dehier_pole(x, axis=axis),
                     H.dehier_pole.plain(x.cpu(), axis=axis))
    with pytest.raises(TypeError, match="f32 or f64|float32 or float64"):
        H.hier_pole(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="out of range"):
        H.dehier_pole(x, axis=2)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level,cols", BUNDLES)
def test_axis_operator_kernel_matches_plain(cuda, dtype, level, cols,
                                            inverse):
    x = _bundle(level, cols, 12).to(dtype)
    got = H.apply_axis_matmul(x.to(cuda), inverse=inverse)
    want = H.apply_axis_matmul.plain(x, inverse=inverse)
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **OP_TOL[dtype])


def _kernels_holding(library, instruction, kernel):
    """{kernel name: count of ``instruction`` in its SASS} for the kernels
    of ``library`` whose mangled name contains ``kernel``."""
    from repro_torch.kernels import _build
    return {name: text.count(instruction)
            for name, text in _build.sass(library).items() if kernel in name}


def test_axis_operator_f64_runs_on_dmma(cuda):
    """Row 3's f64 product is compiled to the f64 tensor cores' DMMA."""
    counts = _kernels_holding("axis_operator", "DMMA",
                              "axis_operator_f64_kernel")
    assert len(counts) == 1 and all(counts.values()), counts


def _same_masks(got, want):
    """NaN, +Inf and -Inf at the same places; the finite rest held to the
    operator kernels' tolerances (bf16: one bf16 ulp + 2**-12)."""
    got = got.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(mask(got), mask(want)), mask.__name__
    fin = torch.isfinite(want)
    g, w = got[fin].double(), want[fin].double()
    if want.dtype == torch.bfloat16:
        bar = torch.exp2((torch.frexp(w.float()).exponent - 8).double()) \
            + 2.0 ** -12
    else:
        bar = OP_TOL[want.dtype]["atol"] + OP_TOL[want.dtype]["rtol"] * w.abs()
    assert bool(((g - w).abs() <= bar).all())


def _non_finite(x, seed):
    """``x`` with three +Infs, three -Infs and three NaNs at seeded
    places."""
    rng = np.random.default_rng(seed)
    x = x.clone()
    flat = x.view(-1)
    picks = torch.from_numpy(rng.choice(flat.numel(), 9, replace=False))
    flat[picks[:3]] = float("inf")
    flat[picks[3:6]] = float("-inf")
    flat[picks[6:]] = float("nan")
    return x


NONFINITE_DTYPES = DTYPES + [torch.bfloat16]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", NONFINITE_DTYPES)
def test_axis_operator_spreads_non_finite_as_the_plain_version(
        cuda, dtype, inverse):
    """Row 3 multiplies only the operator's nonzero tiles; its last block
    repairs each column that holds a NaN or Inf, so the card gives the
    dense product's NaN / +-Inf pattern (the plain version's), not one
    kept inside the tiles that touch it."""
    x = _bundle(9, 70, 15).to(dtype)
    x[0, 0] = float("inf")         # only H[0, 0] touches it along axis 0
    x[[5, 300], 2] = torch.tensor([float("inf"), float("-inf")]).to(dtype)
    x[200, 3] = float("nan")
    x[:, 1] = float("-inf")        # a whole column
    x = _non_finite(x, 21)
    got = H.apply_axis_matmul(x.to(cuda), inverse=inverse)
    want = H.apply_axis_matmul.plain(x, inverse=inverse)
    assert not torch.isfinite(want[:, 0]).any()
    _same_masks(got, want)
    # the state is left clean: a finite call afterwards is finite
    y = _bundle(9, 70, 16).to(dtype)
    assert torch.isfinite(H.apply_axis_matmul(y.to(cuda))).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_axis_operator_fully_non_finite(cuda, dtype):
    """Every column marked: a 511 x 4096 bundle of NaN and +-Inf."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.choice([np.inf, -np.inf, np.nan],
                                    (511, 4096))).to(dtype)
    for inverse in (False, True):
        got = H.apply_axis_matmul(x.to(cuda), inverse=inverse)
        _same_masks(got, H.apply_axis_matmul.plain(x, inverse=inverse))
    x[:, ::2] = 1.0                # every other column finite
    _same_masks(H.apply_axis_matmul(x.to(cuda)),
                H.apply_axis_matmul.plain(x))


TAIL_SHAPES = [(7, 7), (15, 3), (3, 7, 15), (7, 3, 3, 7), (3, 1, 7),
               (31, 63, 127), (3,) * 10]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", TAIL_SHAPES, ids=str)
def test_fused_tail_kernel_matches_plain(cuda, dtype, shape, inverse):
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        shape)).to(dtype)
    got = H.hier_fused_tail(x.to(cuda), inverse=inverse)
    want = H.hier_fused_tail.plain(x, inverse=inverse)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **OP_TOL[dtype])


def test_fused_tail_f64_runs_on_dmma(cuda):
    """Both roles of row 4's f64 pass (inner > 1 and the swapped inner = 1)
    are compiled to the f64 tensor cores' DMMA."""
    counts = _kernels_holding("fused_tail", "DMMA", "fused_tail_f64_kernel")
    assert len(counts) == 2 and all(counts.values()), counts


LARGE_TAILS = [(31, 63, 511), (7, 511, 3)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", DTYPES + [torch.bfloat16])
@pytest.mark.parametrize("shape", LARGE_TAILS, ids=str)
def test_fused_tail_large_axes(cuda, shape, dtype, inverse):
    """511-long tail axes as the inner > 1 (axis 1 of (7, 511, 3)) and the
    swapped inner = 1 pass (the last axis of (31, 63, 511)), 64-row tiles
    past the grid's edge in both roles (extents 3, 7, 31, 63)."""
    x = torch.from_numpy(np.random.default_rng(16).standard_normal(
        shape)).to(dtype)
    with H.count_launches() as n:
        got = H.hier_fused_tail(x.to(cuda), inverse=inverse)
    assert n["hier_fused_tail"] == len(shape) - 1
    assert got.dtype == dtype and got.shape == x.shape
    want = H.hier_fused_tail.plain(x, inverse=inverse)
    if dtype != torch.bfloat16:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   **OP_TOL[dtype])
        return
    brute = (dehierarchize_1d_bruteforce if inverse
             else hierarchize_1d_bruteforce)
    exact = x.double().numpy()
    for axis in range(1, len(shape)):
        exact = brute(exact, axis=axis)
    assert np.max(np.abs(got.double().cpu().numpy() - exact)) < 0.15
    ulp = torch.exp2((torch.frexp(want.float()).exponent - 8).float())
    assert bool(((got.cpu().float() - want.float()).abs()
                 <= ulp + 2.0 ** -12).all())


def test_fused_tail_launches_once_per_live_axis(cuda):
    """``hier_fused_tail.launches`` counts passes: one per tail axis of
    extent > 1, none for a grid whose tail axes are all level 1."""
    rng = np.random.default_rng(17)
    for shape, passes in (((7, 7, 7), 2), ((7, 1, 7), 1), ((3,) * 10, 9),
                          ((7, 1, 1), 0)):
        x = torch.from_numpy(rng.standard_normal(shape)).to(cuda)
        with H.count_launches() as n:
            H.hier_fused_tail(x)
            H.hier_fused_tail(x, inverse=True)
        assert n["hier_fused_tail"] == 2 * passes, shape


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", NONFINITE_DTYPES)
@pytest.mark.parametrize("shape", [(3, 127, 127), (7, 63, 15, 127)],
                         ids=str)
def test_fused_tail_spreads_non_finite_as_the_plain_version(
        cuda, shape, dtype, inverse):
    """Row 4 repairs each pass's lines that hold a NaN or Inf before the
    next pass reads them: the grid gets the dense products' NaN / +-Inf
    pattern (the plain version's), in both operand roles."""
    x = torch.from_numpy(np.random.default_rng(18).standard_normal(
        shape)).to(dtype)
    x[(0,) * len(shape)] = float("inf")
    x[(1, slice(None)) + (2,) * (len(shape) - 2)] = float("nan")  # a line
    x = _non_finite(x, 23)
    got = H.hier_fused_tail(x.to(cuda), inverse=inverse)
    _same_masks(got, H.hier_fused_tail.plain(x, inverse=inverse))
    y = torch.from_numpy(np.random.default_rng(19).standard_normal(shape))
    assert torch.isfinite(H.hier_fused_tail(y.to(dtype).to(cuda))).all()


def test_fused_tail_fully_non_finite(cuda):
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.choice([np.inf, -np.inf, np.nan],
                                    (31, 63, 127)))
    for inverse in (False, True):
        _same_masks(H.hier_fused_tail(x.to(cuda), inverse=inverse),
                    H.hier_fused_tail.plain(x, inverse=inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("row", ["matmul", "fused_tail"])
def test_operator_kernels_bf16(cuda, row, inverse):
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (127, 63))).to(torch.bfloat16)
    brute = (dehierarchize_1d_bruteforce if inverse
             else hierarchize_1d_bruteforce)
    wrapper, axis = ((H.apply_axis_matmul, 0) if row == "matmul"
                     else (H.hier_fused_tail, 1))
    got = wrapper(x.to(cuda), inverse=inverse)
    want = brute(x.double().numpy(), axis=axis)
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(got.double().cpu().numpy() - want)) < 0.15
    # Kernel and plain version both sum in f32 and round to bf16 once: one
    # bf16 ulp (2**(e - 8) for |t| = m * 2**e, 0.5 <= m < 1) apart at most,
    # plus the f32 sums' order.
    plain = wrapper.plain(x, inverse=inverse).float()
    ulp = torch.exp2((torch.frexp(plain).exponent - 8).float())
    assert bool(((got.cpu().float() - plain).abs()
                 <= ulp + 2.0 ** -12).all())


@pytest.mark.parametrize("method", ["pole", "matmul", "fused", "auto"])
def test_ops_round_trip_on_the_card(cuda, method):
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (31, 15, 63)))
    with H.count_launches() as n:
        alpha = ops.hierarchize(x.to(cuda), method)
        back = ops.dehierarchize(alpha, method)
    want = ops.hierarchize(x, method)
    if method == "pole":
        assert _same(alpha, want)
    else:
        np.testing.assert_allclose(alpha.cpu().numpy(), want.numpy(),
                                   rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(back.cpu().numpy(), x.numpy(), rtol=0,
                               atol=1e-12 * float(x.abs().max()))
    launched = {k for k, v in n.items() if v}
    assert launched == {"pole": {"hier_pole", "dehier_pole"},
                        "matmul": {"apply_axis_matmul"}}.get(
        method, {"apply_axis_matmul", "hier_fused_tail"})


def test_iterated_round_card_matches_cpu(cuda):
    for method in ("auto", "pole"):
        card, t = run_iterated_heat(2, 5, rounds=1, t_steps=2,
                                    hier_method=method, device=cuda)
        cpu, _ = run_iterated_heat(2, 5, rounds=1, t_steps=2,
                                   hier_method=method, device="cpu")
        for ell in cpu.grids:
            np.testing.assert_allclose(card.grids[ell].cpu().numpy(),
                                       cpu.grids[ell].numpy(), rtol=1e-12,
                                       atol=1e-15)


# ---------------------------------------------------------------------------
# Flash attention (row 10) and the dense LM
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, sq, skv, h, kv, hd, causal: tests/test_flash_attention.py's cases,
    # then smollm's smoke and full head widths, head_dim 128, tiles past 64
    (2, 16, 16, 4, 2, 8, True),
    (1, 64, 64, 2, 2, 16, True),
    (2, 8, 24, 4, 4, 8, False),
    (1, 33, 33, 2, 1, 8, True),
    (1, 1, 40, 4, 2, 8, False),
    (1, 128, 128, 8, 8, 32, True),
    (1, 24, 24, 3, 1, 20, True),
    (2, 200, 200, 15, 5, 64, True),
    (1, 130, 70, 2, 1, 128, False),
    (1, 97, 97, 4, 2, 128, True),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(case, dtype, seed=0):
    b, sq, skv, h, kv, hd, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((b, sq, h, hd), (b, skv, kv, hd),
                                 (b, skv, kv, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    q, k, v = _qkv(case, dtype)
    before = F.flash_attention.launches
    got = F.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                            causal=case[-1])
    torch.cuda.synchronize()
    assert F.flash_attention.launches == before + 1
    assert got.is_cuda and got.dtype == dtype and got.shape == q.shape
    want = F.flash_attention_ref(q, k, v, causal=case[-1])
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("q_offset", [0, 5, 64])
def test_flash_kernel_offset_strides_and_bhsd(cuda, q_offset):
    """A causal mask shifted by ``q_offset``; q, k and v read through the
    strides of views (no copy); the (BH, S, hd) spelling."""
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal(
        (2, 70, 3, 4, 32)).astype(np.float32)).to(cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1, :2], qkv[:, :, 2, :2]
    assert not q.is_contiguous()
    got = F.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    want = F.flash_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    qb, kb, vb = (t.permute(0, 2, 1, 3).reshape(-1, 70, 32)
                  for t in (q[:, :, :2], k, v))
    got = F.flash_attention_bhsd(qb, kb, vb, causal=True, q_offset=q_offset)
    want = F.flash_attention_bhsd(qb.cpu(), kb.cpu(), vb.cpu(), causal=True,
                                  q_offset=q_offset)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 8, 8, 2, 1, 160, True), torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        F.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda))
    q, k, v = _qkv((1, 8, 8, 2, 1, 16, True), torch.float64)
    with pytest.raises(TypeError):
        F.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda))
    q, k, v = _qkv((1, 8, 8, 2, 1, 16, True), torch.float32)
    with pytest.raises(ValueError, match="device"):
        F.flash_attention(q.to(cuda), k, v.to(cuda))


def test_flash_bf16_runs_on_hgmma(cuda):
    """Row 10's bf16 kernels run every product on the warpgroup products
    (HGMMA) and hold no HMMA: the forward's (head_dim 64 with two or three
    consumer warpgroups and 128 with two, each with and without the
    log-sum-exp output) and the backward's (dq, dk/dv, head_dim 64 and
    128); the f32 entries' kernels hold neither."""
    fwd = _kernels_holding("flash_attention", "HGMMA", "flash_kernel_wgmma")
    assert len(fwd) == 6 and all(fwd.values()), fwd
    hmma = _kernels_holding("flash_attention", "HMMA", "flash_kernel")
    assert len(hmma) == 10 and not any(hmma.values()), hmma
    f32 = _kernels_holding("flash_attention", "HGMMA", "flash_kernel_f32")
    assert len(f32) == 4 and not any(f32.values()), f32
    bwd = _kernels_holding("flash_attention_bwd", "HGMMA", "bwd_d")
    wgmma = {k: n for k, n in bwd.items() if "_wgmma" in k}
    assert len(bwd) == 8 and len(wgmma) == 4 and all(wgmma.values()), bwd
    assert not any(n for k, n in bwd.items() if k not in wgmma), bwd
    hmma = _kernels_holding("flash_attention_bwd", "HMMA", "bwd_d")
    assert len(hmma) == 8 and not any(hmma.values()), hmma


def _hold_bf16(got, want):
    """The bf16 forward against its plain version: 2e-2 element by element
    and 1e-2 relative L2 as a whole."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    g, w = got.float().cpu(), want.float().cpu()
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-2, atol=2e-2)
    assert float((g - w).norm() / w.norm()) <= 1e-2


def test_flash_bf16_bits_fixed_call_to_call(cuda):
    """Two bf16 forward calls on the same causal GQA inputs, and the call
    with the log-sum-exp, give the same bits: each output element is
    written once, by one block, and the schedule does not change them."""
    q, k, v = (t.to(cuda) for t in _qkv((2, 300, 300, 15, 5, 64, True),
                                         torch.bfloat16, seed=3))
    first = F.flash_attention(q, k, v, causal=True)
    second = F.flash_attention(q, k, v, causal=True)
    out, _, _ = F.flash_attention_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, out)


@pytest.mark.parametrize("kind", ["strided", "unaligned", "hd 20"])
def test_flash_bf16_copy_route(cuda, kind):
    """Operands TMA cannot describe in place (a stride that is not whole 16
    bytes, a base off a 16-byte boundary, head_dim 20) go through
    ``_tma_rows``' aligned copies into the same kernel; the result is the
    plain version's, and a strided view TMA can describe is read in place
    with the same result."""
    rng = np.random.default_rng(8)
    b, s, h, kv, hd = 2, 200, 6, 2, (20 if kind == "hd 20" else 64)

    def rand(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).to(cuda)

    q = rand((b, s, h, hd))
    if kind == "strided":
        k, v = (rand((b, s, kv, hd + 3))[..., 2:hd + 2] for _ in range(2))
    elif kind == "unaligned":
        k, v = (rand((b * s * kv * hd + 1,))[1:].view(b, s, kv, hd)
                for _ in range(2))
        assert k.data_ptr() % 16 and v.data_ptr() % 16
    else:
        k, v = rand((b, s, kv, hd)), rand((b, s, kv, hd))
    assert F._tma_rows(k) is not k
    before = F.flash_attention.launches
    got = F.flash_attention(q, k, v, causal=True)
    assert F.flash_attention.launches == before + 1
    _hold_bf16(got, F.flash_attention_ref(q, k, v, causal=True))
    if kind == "strided":             # a fused projection's view
        qkv = rand((b, s, 3, h, hd))
        qv, kvv, vv = qkv[:, :, 0], qkv[:, :, 1, :kv], qkv[:, :, 2, :kv]
        assert F._tma_rows(kvv) is kvv
        _hold_bf16(F.flash_attention(qv, kvv, vv, causal=True),
                   F.flash_attention_ref(qv, kvv, vv, causal=True))


@pytest.mark.parametrize("case", [(1, 448, 1500, 4, 4, 64, False),
                                  (4, 1500, 1500, 12, 12, 64, False)],
                         ids=["cross", "encoder"])
def test_flash_bf16_ragged_full_keys(cuda, case):
    """Full attention over 1500 keys, 11 whole 128-key tiles and 92 more
    (whisper's frames): the tail read as zeros and masked.  At the encoder's
    full shape the launch takes three consumer warpgroups (192-row query
    tiles, the last one ragged too)."""
    q, k, v = (t.to(cuda) for t in _qkv(case, torch.bfloat16, seed=4))
    _hold_bf16(F.flash_attention(q, k, v, causal=False),
               F.flash_attention_ref(q, k, v, causal=False))


@pytest.mark.parametrize("q_offset", [0, 64, 133])
def test_flash_bf16_hd128_gqa7_causal_offset(cuda, q_offset):
    """head_dim 128 with 7 query heads a KV head (llava's grouping),
    causal with the queries shifted by ``q_offset`` against more keys."""
    b, sq, h, kv, hd = 1, 200, 14, 2, 128
    case = (b, sq, sq + q_offset, h, kv, hd, True)
    q, k, v = (t.to(cuda) for t in _qkv(case, torch.bfloat16, seed=5))
    got, lse, lo = F.flash_attention_lse(q, k, v, causal=True,
                                         q_offset=q_offset)
    want, lse_want, _ = F.flash_attention_lse_ref(q, k, v, causal=True,
                                                  q_offset=q_offset)
    _hold_bf16(got, want)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert lo.dtype == torch.bfloat16 and lo.shape == got.shape


BWD_CASES = [  # b, sq, skv, h, kv, hd, causal, q_offset
    (2, 200, 200, 15, 5, 64, True, 0), (1, 70, 133, 4, 2, 128, False, 9),
    (2, 65, 130, 6, 2, 20, True, 65), (1, 1, 40, 3, 3, 8, True, 39),
    (1, 129, 257, 3, 3, 20, True, 128)]     # rows of 120 B: padded
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_lse_and_bwd_kernels_match_plain(cuda, case, dtype):
    """Row 10's forward with its log-sum-exp (the output bitwise the
    forward's without it) and its backward kernels against their plain
    versions on the same inputs."""
    b, sq, skv, h, kv, hd, causal, q_offset = case
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype).to(cuda) for s in (
        (b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd), (b, sq, h, hd)))
    kw = dict(causal=causal, q_offset=q_offset)
    before = (F.flash_attention_lse.launches, F.flash_attention_bwd.launches)
    o, lse, lo = F.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o, F.flash_attention(q, k, v, **kw))
    np.testing.assert_allclose(
        lse.cpu().numpy(), F.flash_attention_lse_ref(q, k, v, **kw)[1]
        .cpu().numpy(), rtol=1e-4, atol=1e-4)
    got = F.flash_attention_bwd(q, k, v, o, lse, do, o_lo=lo, **kw)
    torch.cuda.synchronize()
    assert (F.flash_attention_lse.launches, F.flash_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 2)
    want = F.flash_attention_bwd_ref(q, k, v, o, lse, do, o_lo=lo, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **BWD_TOL[dtype])


def _bwd_inputs(case, dtype, cuda, seed=11):
    b, sq, skv, h, kv, hd, causal, q_offset = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype).to(cuda) for s in (
        (b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd), (b, sq, h, hd)))
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse, lo = F.flash_attention_lse(q, k, v, **kw)
    return (q, k, v, o, lse, do), dict(kw, o_lo=lo)


def test_flash_bwd_bits_fixed_run_to_run(cuda):
    """Two bf16 backward calls on the same causal GQA inputs give the same
    bits: each output element is written once, by one block, with no
    atomics."""
    args, kw = _bwd_inputs((2, 300, 300, 15, 5, 64, True, 0),
                           torch.bfloat16, cuda)
    first = F.flash_attention_bwd(*args, **kw)
    second = F.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_on_unaligned_views(cuda, dtype):
    """Operands that are contiguous views at an offset that is not 16-byte
    aligned: the bf16 wrapper copies them to aligned tensors before the
    TMA loads; the result is the plain version's within BWD_TOL."""
    case = (2, 200, 200, 15, 5, 64, True, 0)
    args, kw = _bwd_inputs(case, dtype, cuda, seed=5)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    q, k, v, o, lse, do = (shifted(t) for t in args)
    if kw["o_lo"] is not None:
        kw["o_lo"] = shifted(kw["o_lo"])
    assert all(t.data_ptr() % 16 for t in (q, k, v, o, do))
    got = F.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = F.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), **BWD_TOL[dtype])


def test_train_gradients_on_the_card_match_cpu(cuda):
    """One f32 smoke step's loss and gradients (remat full: row 10's
    forward with its log-sum-exp twice a layer, its backward once) on the
    card against the CPU."""
    from repro_torch.launch.steps import init_train_state, loss_and_grads
    cfg = get_smoke_config("smollm_360m").replace(remat=True)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 33)))
    out = []
    for device in ("cpu", cuda):
        params, _ = init_train_state(cfg, seed=0, device="cpu")
        before = F.flash_attention_bwd.launches
        loss, grads = loss_and_grads(params.to(device), cfg, {
            "tokens": tokens[:, :-1].to(device),
            "labels": tokens[:, 1:].to(device)})
        out.append((float(loss), {n: g.cpu() for n, g in grads.items()}))
    assert F.flash_attention_bwd.launches == before + 2 * cfg.num_layers
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for n, g in out[0][1].items():
        np.testing.assert_allclose(out[1][1][n].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 4])
@pytest.mark.parametrize("hd", [8, 40])
def test_flash_kernel_on_unaligned_rows(cuda, hd, offset, dtype):
    """K and V as slices of a wider cache, ``buf[..., offset:offset + hd]``:
    row starts 2, 4 or 8 bytes apart from a 16-byte boundary in bf16 take
    the kernel's narrower copies."""
    b, s, h, kv = 2, 100, 4, 2
    rng = np.random.default_rng(19)
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(
        np.float32)).to(dtype).to(cuda)
    bufs = [torch.from_numpy(rng.standard_normal(
        (b, s, kv, hd + offset)).astype(np.float32)).to(dtype).to(cuda)
        for _ in range(2)]
    k, v = (t[..., offset:] for t in bufs)
    assert k.stride(-1) == 1 and k.stride(2) == hd + offset
    before = F.flash_attention.launches
    got = F.flash_attention(q, k, v, causal=True)
    assert F.flash_attention.launches == before + 1
    want = F.flash_attention_ref(q, k, v, causal=True)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


def test_prefill_launches_once_per_layer_and_matches_cpu(cuda):
    cfg = get_smoke_config("smollm_360m")
    model = init_params(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 70))
    want = M.prefill_step(model, cfg, {"tokens": tokens})
    before = F.flash_attention.launches
    got = M.prefill_step(model.to(cuda), cfg, {"tokens": tokens})
    assert F.flash_attention.launches == before + cfg.num_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_generate_card_matches_cpu(cuda):
    cfg = get_smoke_config("smollm_360m")
    model = init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6))
    sc = ServeConfig(max_new_tokens=6)
    want = generate(sc, prompts, params=model)
    got = generate(sc, prompts, params=model.to(cuda))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], rtol=1e-4,
                               atol=1e-4)


def _whisper_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    audio = torch.from_numpy((rng.standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32))
    return tokens, audio


def test_whisper_prefill_card_matches_cpu(cuda):
    """The encdec smoke prefill: 3 row-10 launches a layer pair (encoder
    full, decoder causal, cross full), logits the CPU's."""
    cfg = get_smoke_config("whisper_small")
    model = init_params(cfg, seed=0, device="cpu")
    tokens, audio = _whisper_inputs(cfg, 2, 40, 6)
    want = M.prefill_step(model, cfg, {"tokens": tokens,
                                       "audio_embeds": audio})
    before = F.flash_attention.launches
    got = M.prefill_step(model.to(cuda), cfg, {
        "tokens": tokens.to(cuda), "audio_embeds": audio.to(cuda)})
    assert F.flash_attention.launches == \
        before + cfg.encoder_layers + 2 * cfg.num_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_whisper_train_step_card_matches_cpu(cuda):
    """One f32 encdec smoke step (remat full) on the card against the CPU:
    its loss and gradients, row 10's forward with its log-sum-exp twice and
    its backward once for each of the encoder's, the decoder's and the
    cross attention calls."""
    from repro_torch.launch.steps import (init_train_state, loss_and_grads,
                                          make_train_step)
    from repro_torch.optim.adamw import adamw_init
    cfg = get_smoke_config("whisper_small").replace(remat=True)
    tokens, audio = _whisper_inputs(cfg, 2, 24, 7)
    calls = cfg.encoder_layers + 2 * cfg.num_layers
    out = []
    for device in ("cpu", cuda):
        params, _ = init_train_state(cfg, seed=0, device="cpu")
        params = params.to(device)
        opt = adamw_init(dict(params.named_parameters()))
        batch = {"tokens": tokens[:, :-1].to(device),
                 "labels": tokens[:, 1:].to(device),
                 "audio_embeds": audio.to(device)}
        before = (F.flash_attention_lse.launches,
                  F.flash_attention_bwd.launches)
        loss, grads = loss_and_grads(params, cfg, batch)
        launches = (F.flash_attention_lse.launches - before[0],
                    F.flash_attention_bwd.launches - before[1])
        params, opt, metrics = make_train_step(
            cfg, lambda s_: torch.tensor(1e-3))(params, opt, batch)
        assert int(opt.step) == 1 and bool(torch.isfinite(metrics["loss"]))
        out.append((float(loss), {n: g.cpu() for n, g in grads.items()},
                    launches))
    assert out[1][2] == (2 * calls, 2 * calls)
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for n, g in out[0][1].items():
        np.testing.assert_allclose(out[1][1][n].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6)


#: Row 10 where the encdec and vlm families call it at full size: the
#: cross-attention (448 queries over 1500 keys, full) and the cut llava
#: prefill (576 patches + 1024 tokens, causal, head_dim 128, GQA 7:1).
FAMILY_SHAPES = [(1, 448, 1500, 12, 12, 64, False),
                 (1, 1600, 1600, 56, 8, 128, True)]
#: dq, dk, dv: every element within rtol |plain| + atol_rms RMS(plain) +
#: atol, and the relative L2 of the whole within rel_l2 (chip_smoke's bar).
FAMILY_BWD_TOL = {
    torch.float32: dict(rtol=1e-4, atol=1e-5, atol_rms=0.0, rel_l2=1e-4),
    torch.bfloat16: dict(rtol=2e-2, atol=0.0, atol_rms=0.1, rel_l2=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FAMILY_SHAPES, ids=str)
def test_flash_forward_and_backward_at_the_family_shapes(cuda, case, dtype):
    b, sq, skv, h, kv, hd, causal = case
    q, k, v = (t.to(cuda) for t in _qkv(case, dtype, seed=8))
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (b, sq, h, hd)).astype(np.float32)).to(dtype).to(cuda)
    tol = FLASH_TOL[dtype]
    got = F.flash_attention(q, k, v, causal=causal)
    want = F.flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    o, lse, lo = F.flash_attention_lse(q, k, v, causal=causal)  # training's
    assert torch.equal(o, got) and (lo is None) == (dtype == torch.float32)
    np.testing.assert_allclose(
        lse.cpu().numpy(), F.flash_attention_lse_ref(
            q, k, v, causal=causal)[1].cpu().numpy(), rtol=1e-4, atol=1e-4)
    bar = FAMILY_BWD_TOL[dtype]
    for g, w in zip(F.flash_attention_bwd(q, k, v, o, lse, do,
                                          causal=causal, o_lo=lo),
                    F.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                              causal=causal, o_lo=lo)):
        assert g.dtype == w.dtype and g.shape == w.shape
        w = w.float()
        diff = (g.float() - w).abs()
        rms = float(w.square().mean().sqrt())
        assert float(diff.norm() / w.norm()) <= bar["rel_l2"]
        assert bool((diff <= bar["atol"] + bar["atol_rms"] * rms
                     + bar["rtol"] * w.abs()).all())


@pytest.mark.parametrize("case", [(2, 200, 300, 4, 4, 64, False),
                                  (1, 130, 130, 6, 2, 20, True),
                                  (1, 97, 150, 7, 1, 128, False)], ids=str)
def test_flash_residual_restores_d_on_a_common_part(cuda, case):
    """bf16 inputs whose values share a large common part (v = 4 + noise,
    so each output row is nearly the mean of v): the forward's residual
    (out + o_lo the plain f32 output within the bf16 bar; |o_lo| at most
    2^-8 |out|; out bitwise the serving launch's), and the backward with
    it within 1e-2 (relative L2) of the plain backward given the f32
    output, where the plain backward from the bf16 output alone puts dq
    farther than 2e-2 off."""
    b, sq, skv, h, kv, hd, causal = case
    rng = np.random.default_rng(12)
    q, k, do = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(cuda) for sh in ((b, sq, h, hd), (b, skv, kv, hd),
                                         (b, sq, h, hd)))
    v = torch.from_numpy((4.0 + 0.3 * rng.standard_normal(
        (b, skv, kv, hd))).astype(np.float32)).to(cuda)
    bq, bk, bv, bdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
    o, lse, lo = F.flash_attention_lse(bq, bk, bv, causal=causal)
    assert torch.equal(o, F.flash_attention(bq, bk, bv, causal=causal))
    args = (bq.float(), bk.float(), bv.float())
    full = F.flash_attention_ref(*args, causal=causal)
    np.testing.assert_allclose((o.float() + lo.float()).cpu().numpy(),
                               full.cpu().numpy(), rtol=2e-2, atol=2e-2)
    assert bool((lo.float().abs() <= o.float().abs() * 2.0 ** -8).all())
    want = F.flash_attention_bwd_ref(*args, full, lse, bdo.float(),
                                     causal=causal)
    rel = lambda a, w: float((a.float() - w).norm() / w.norm())
    with_lo = F.flash_attention_bwd(bq, bk, bv, o, lse, bdo, causal=causal,
                                    o_lo=lo)
    without = F.flash_attention_bwd_ref(bq, bk, bv, o, lse, bdo,
                                        causal=causal)
    assert all(rel(g, w) <= 1e-2 for g, w in zip(with_lo, want))
    assert rel(without[0], want[0]) > 2e-2


def _prod_3d_grids(seed, device):
    """prod_3d grids on ``device``, each owning its storage whole."""
    rng = np.random.default_rng(seed)
    return {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
            .to(device) for ell, _ in CombinationScheme(3, 9).grids}


def test_durable_restore_at_prod_3d_is_bitwise(cuda, tmp_path):
    """Register and two updates with a snapshot at seq 2 (1.07 GB) and
    one WAL entry past it; a fresh engine on a fresh store restores
    bitwise the never-crashed surplus, its replayed ingest four launches."""
    from repro_torch.core.engine import CTEngine
    from repro_torch.runtime.durability import DurableStore
    scheme = CombinationScheme(3, 9)
    eng = CTEngine(device=cuda, ingest_workers=0, snapshot_interval=2,
                   store=DurableStore(str(tmp_path), "h0"))
    eng.register("t", scheme, _prod_3d_grids(40, cuda))
    for seed in (41, 42):
        eng.update("t", _prod_3d_grids(seed, cuda))
    back = CTEngine(device=cuda, ingest_workers=0)
    with H.count_launches() as n:
        info = back.restore(DurableStore(str(tmp_path), "h0"))["t"]
    assert (info.snapshot_seq, info.pending, info.replayed) == (2, 1, 1)
    assert sum(n.values()) == 4
    assert _same(back.surplus("t"), eng.surplus("t"))


def test_donation_at_prod_3d(cuda):
    """A donated ingest is bitwise the non-donating tenant's, releases
    every grid (``memory_allocated`` drops by what the grids were
    charged), a NaN under ``check_finite`` raises the named error with the
    surplus unchanged, and released grids are refused before any launch,
    after which the next ingest runs."""
    from repro_torch.core.engine import (CTEngine, ExecSpec,
                                         IngestBuffersDonated)
    scheme = CombinationScheme(3, 9)
    eng = CTEngine(device=cuda, ingest_workers=0)
    eng.register("plain", scheme, _prod_3d_grids(43, cuda))
    eng.register("donated", scheme, _prod_3d_grids(43, cuda),
                 spec=ExecSpec(donate=True))
    kept = _prod_3d_grids(44, cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    given = _prod_3d_grids(44, cuda)
    charged = torch.cuda.memory_allocated() - before
    before = torch.cuda.memory_allocated()
    eng.update("donated", given)
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() == charged >= 73915 * 8
    assert all(H.storage_released(v) for v in given.values())
    eng.update("plain", kept)
    assert _same(eng.surplus("donated"), eng.surplus("plain"))
    nan = _prod_3d_grids(45, cuda)
    nan[(9, 1, 1)].view(-1)[0] = float("nan")
    fut = eng.submit_ingest("donated", nan, check_finite=True)
    eng.flush()
    with pytest.raises(IngestBuffersDonated, match="non-finite"):
        fut.result()
    assert _same(eng.surplus("donated"), eng.surplus("plain"))
    with H.count_launches() as n:
        with pytest.raises(IngestBuffersDonated, match="donated"):
            eng.update("donated", given)
    assert not any(n.values())
    eng.update("donated", _prod_3d_grids(46, cuda))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(eng.surplus("donated")).all())


def test_cluster_failover_and_restart_on_the_card(cuda, tmp_path):
    """A 2-host durable cluster on the card (``CombinationScheme(3, 5)``):
    kill the tenant's primary, fail over, restart it; placement returns to
    the pre-kill map, and the surplus is bitwise a never-failed engine's
    on the card fed the newest acked payload, its cluster-routed ingest at
    most four launches."""
    from repro_torch.core.engine import CTEngine
    from repro_torch.runtime.cluster import CTCluster
    scheme = CombinationScheme(3, 5)

    def grids(seed):
        rng = np.random.default_rng(seed)
        return {ell: rng.standard_normal(grid_shape(ell))
                for ell, _ in scheme.grids}

    cl = CTCluster(2, replication=1, seed=7, device=cuda,
                   durability_dir=str(tmp_path), snapshot_interval=2)
    cl.register("t", scheme, grids(50))
    with H.count_launches() as n:
        cl.update("t", grids(51))
    assert 0 < sum(n.values()) <= 4
    cl.update("t", grids(52))
    before = cl.owners_of("t")
    victim = before[0]
    cl.injector.kill(victim)
    assert cl.check_health() == [victim]
    assert victim not in cl.owners_of("t")
    cl.update("t", grids(53))                 # on the new owner
    assert cl.restart_host(victim) == {"t": "adopted"}
    assert cl.owners_of("t") == before
    oracle = CTEngine(device=cuda, ingest_workers=0)
    oracle.register("t", scheme, grids(53))
    assert cl.surplus("t").device.type == cuda.type
    assert _same(cl.surplus("t"), oracle.surplus("t"))
    pts = np.random.default_rng(54).random((16, 3))
    np.testing.assert_array_equal(cl.query("t", pts), oracle.query("t", pts))


def _card_mesh(cuda, shape, names):
    from repro_torch.core.mesh import make_mesh
    return make_mesh(shape, names, devices=[cuda] * int(np.prod(shape)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_slab_scatter_tables_match_plain(cuda, dtype):
    """Row 9 slab-local: the grouped scatter on each slab's table into its
    ``slab_size + 1`` buffer, bitwise its plain version, from a non-zero
    buffer, and the slabs together bitwise the single-device surplus."""
    from repro_torch.core import executor as E
    from repro_torch.core.distributed import slab_scatter_tables
    rng = np.random.default_rng(31)
    scheme = CombinationScheme(3, 5)
    splan = E.shard_plan(build_plan(scheme), 3)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell))).to(
        dtype) for ell, _ in scheme.grids}
    x = E._assemble(grids, splan.buckets, dtype)
    y = H.hier_forward_grouped(x, E._pass_specs(splan.plan)[0])
    coeffs = torch.from_numpy(np.concatenate(
        [b.coeffs for b in splan.buckets])).to(dtype)
    want = ct_transform_with_plan(grids, splan.plan, device="cpu").reshape(-1)
    for s, table in enumerate(slab_scatter_tables(splan)):
        acc = torch.from_numpy(rng.standard_normal(
            splan.slab_size + 1)).to(dtype)
        got = H.hier_scatter_grouped(y.to(cuda), table, coeffs.to(cuda),
                                     acc.to(cuda))
        plain = H.hier_scatter_grouped(y, table, coeffs, acc.clone())
        assert _same(got.cpu(), plain)
        zero = torch.zeros(splan.slab_size + 1, dtype=dtype, device=cuda)
        H.hier_scatter_grouped(y.to(cuda), table, coeffs.to(cuda), zero)
        a = s * splan.slab_size
        n = min(splan.slab_size, splan.fine_size - a)
        assert _same(zero[:n].cpu(), want[a:a + n])


@pytest.mark.parametrize("dtype", DTYPES)
def test_owner_fold_matches_plain(cuda, dtype):
    """``owner_fold`` on runs of one to 200 values (warp-folded past 32),
    dump entries and a non-zero buffer, bitwise its plain version."""
    rng = np.random.default_rng(32)
    size, n = 3000, 60000
    dst = rng.integers(0, size + 1, n).astype(np.int32)
    dst[:200] = 5
    table = H.owner_table([dst], size)
    assert table.long_owners >= 1
    vals = torch.from_numpy(rng.choice([-3.0, -1.0, 1.0, 3.0], n)
                            * rng.standard_normal(n)).to(dtype)
    acc = torch.from_numpy(rng.standard_normal(size + 1)).to(dtype)
    before = H.owner_fold.launches
    got = H.owner_fold(vals.to(cuda), table, acc.to(cuda))
    assert H.owner_fold.launches == before + 1
    assert _same(got.cpu(), H.owner_fold(vals, table, acc.clone()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_owner_fold_on_the_prod_3d_2d_tables(cuda, dtype):
    """Row 12 on the 2-D prod_3d ingest's two slab tables (their runs, the
    slots renumbered into a compact buffer), one launch each, bitwise its
    plain version."""
    from repro_torch.core import executor as E
    from repro_torch.core.distributed import two_d_tables
    splan = E.shard_plan(build_plan(CombinationScheme(3, 9)), 2, n_groups=2)
    rng = np.random.default_rng(48)
    for slab in two_d_tables(splan).folds:
        table = H.OwnerTable(slab.entries, np.arange(slab.owners,
                                                     dtype=np.int32),
                             slab.offsets, slab.owners)
        n = int(table.entries.max()) + 1
        vals = torch.from_numpy(rng.standard_normal(n)).to(dtype)
        acc = torch.from_numpy(rng.standard_normal(table.dump + 1)).to(dtype)
        with H.count_launches() as c:
            got = H.owner_fold(vals.to(cuda), table, acc.to(cuda))
        assert c["owner_fold"] == 1
        assert _same(got, H.owner_fold(vals, table, acc.clone()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_ingests_on_the_card_match_single_device(cuda, dtype):
    """1-D fused, 1-D unfused and 2-D ingests on meshes that repeat the
    card: bitwise the card's single-device surplus; the 2-D path folds
    with one owner_fold launch a slab."""
    from repro_torch.core.distributed import ct_transform_sharded
    from repro_torch.core.engine import ExecSpec
    rng = np.random.default_rng(33)
    scheme = CombinationScheme(3, 5)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell))).to(
        device=cuda, dtype=dtype) for ell, _ in scheme.grids}
    want = ct_transform_with_plan(grids, build_plan(scheme), device=cuda)
    m4 = _card_mesh(cuda, (4,), ("slab",))
    m22 = _card_mesh(cuda, (2, 2), ("member", "slab"))
    for mesh, kw in ((m4, {}), (m4, {"spec": ExecSpec(fused=False)}),
                     (m22, {"member_axis": "member"})):
        with H.count_launches() as n:
            got = ct_transform_sharded(grids, scheme, mesh, "slab", **kw)
        assert _same(got, want), kw
        parts = ct_transform_sharded(grids, scheme, mesh, "slab",
                                     gather=False, **kw)
        assert _same(parts.full(), want)
        if "member_axis" in kw:
            assert n["owner_fold"] == 2
        elif not kw:
            assert n["hier_scatter_grouped"] == 2 * 4
