"""Meshed tenants of the port's CT engine (``ExecSpec(mesh=...)``,
``CTEngine.rebind``, ``runtime.elastic.rebalance_engine``,
``CTCluster.over_device_slices``, ``CTSurrogate(mesh=)``) on the CPU.

Every mesh is the CPU repeated, so the slab-sharded ingests (1-D and 2-D
member x slab) run their plain versions.  A meshed tenant's surplus is the
gathered fine grid, bitwise the unmeshed tenant's, so its queries,
durability and the cluster's failover read it unchanged.  The reference's
``test_meshed_spec_on_unsharded_plan_raises``,
``test_execspec_mesh_nslabs_conflict_raises`` and
``test_meshed_hosts_over_disjoint_device_slices`` have twins here."""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import engine as E
from repro_torch.core import executor as tex
from repro_torch.core.engine import CTEngine, ExecSpec
from repro_torch.core.executor import build_plan, ct_transform_with_plan
from repro_torch.core.levels import CombinationScheme, grid_shape
from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.launch.serve import CTSurrogate
from repro_torch.runtime.cluster import CTCluster
from repro_torch.runtime.durability import DurableStore
from repro_torch.runtime.elastic import rebalance_engine

SCHEME = CombinationScheme(3, 3)


@pytest.fixture(autouse=True)
def _fresh_caches():
    E.clear_compile_cache()
    E.reset_deprecation_warnings()
    yield


def _grids(scheme, seed):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(grid_shape(ell))
            for ell, _ in scheme.grids}


def _mesh(shape, names=("slab",)):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _engine(**kw):
    return CTEngine(device="cpu", ingest_workers=0, **kw)


def _bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


SPECS = {
    "slab_fused": lambda: ExecSpec(mesh=_mesh((4,))),
    "slab_unfused": lambda: ExecSpec(mesh=_mesh((3,)), fused=False),
    "member_x_slab": lambda: ExecSpec(mesh=_mesh((2, 2), ("member", "slab")),
                                      member_axis="member"),
}


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_meshed_tenants_share_an_executable_and_serve_bitwise(kind):
    """Two meshed tenants of one signature share one executable (1 miss,
    1 hit); each surplus and its queries are bitwise an unmeshed
    tenant's, after the register and after an update; a refit and a
    drop_grid keep the tenant sharded and bitwise the unmeshed ones."""
    eng = _engine()
    spec = SPECS[kind]()
    pts = np.random.default_rng(1).random((32, 3))
    eng.register("plain", SCHEME, _grids(SCHEME, 1))
    eng.register("a", SCHEME, _grids(SCHEME, 1), spec=spec)
    eng.register("b", SCHEME, _grids(SCHEME, 2), spec=spec)
    assert eng.stats()["ingest_cache"]["misses"] == 2
    assert eng.stats()["ingest_cache"]["hits"] == 1
    assert isinstance(eng.plan("a"), tex.ShardedPlan)
    _bitwise(eng.surplus("a"), eng.surplus("plain"))
    _bitwise(eng.query("a", pts), eng.query("plain", pts))
    for name in ("plain", "a"):
        eng.update(name, _grids(SCHEME, 5))
    _bitwise(eng.surplus("a"), eng.surplus("plain"))
    finer = SCHEME.as_general().with_levels([(3, 1, 1)])
    for name in ("plain", "a"):
        eng.refit(name, finer, _grids(finer, 6))
    assert eng.plan("a").n_slabs == spec.slabs
    _bitwise(eng.surplus("a"), eng.surplus("plain"))
    for name in ("plain", "a"):
        eng.drop_grid(name, [(3, 1, 1)], _grids(finer, 6))
    _bitwise(eng.surplus("a"), eng.surplus("plain"))
    _bitwise(eng.query("a", pts), eng.query("plain", pts))
    stats = eng.stats()["per_tenant"]["a"]
    assert stats["launches"] > 0


def test_rebind_outcomes_carry_the_surplus():
    eng = _engine()
    eng.register("t", SCHEME, _grids(SCHEME, 3))
    surplus = eng.surplus("t")
    m4, m22 = _mesh((4,)), _mesh((2, 2), ("member", "slab"))
    assert eng.rebind("t") == "kept"
    assert eng.rebind("t", mesh=m4) == "sharded"
    assert eng.rebind("t", mesh=m4) == "kept"
    assert eng.rebind("t", mesh=m22, member_axis="member") == "resharded"
    assert eng.plan("t").n_groups == 4
    assert eng.rebind("t", mesh=None, member_axis=None) == "unsharded"
    assert eng.plan("t") is build_plan(SCHEME)
    assert eng.rebind("t", axis_name="rows") == "rebound"
    assert eng.surplus("t") is surplus
    # the re-bound executable ingests bitwise the original
    eng.rebind("t", mesh=_mesh((3,), ("rows",)))
    _bitwise(eng.update("t", _grids(SCHEME, 3)), surplus)
    with pytest.raises(KeyError):
        eng.rebind("missing", mesh=m4)


def test_rebalance_engine_onto_a_2d_mesh_and_back():
    eng = _engine()
    for i, n in enumerate(("a", "b", "c")):
        eng.register(n, SCHEME, _grids(SCHEME, 10 + i))
    before = {n: eng.surplus(n) for n in eng.names()}
    m22 = _mesh((2, 2), ("member", "slab"))
    assert rebalance_engine(eng, m22, member_axis="member") == \
        dict.fromkeys(("a", "b", "c"), "sharded")
    assert rebalance_engine(eng, m22, member_axis="member",
                            names=["a"]) == {"a": "kept"}
    assert rebalance_engine(eng, _mesh((3,))) == \
        dict.fromkeys(("a", "b", "c"), "resharded")
    for n, s in before.items():
        assert eng.surplus(n) is s
        _bitwise(eng.update(n, _grids(SCHEME, 10 + "abc".index(n))), s)
    assert rebalance_engine(eng, None) == \
        dict.fromkeys(("a", "b", "c"), "unsharded")
    assert all(eng.spec(n).member_axis is None for n in eng.names())


class FakeMesh:                     # shape-duck-typed; no devices needed
    shape = {"slab": 4}


def test_meshed_spec_on_unsharded_plan_raises():
    """A meshed spec never silently degrades to the single-device path."""
    spec = ExecSpec(mesh=FakeMesh())
    with pytest.raises(ValueError, match="not slab-sharded"):
        ct_transform_with_plan(_grids(SCHEME, 79), build_plan(SCHEME),
                               spec=spec)


def test_execspec_mesh_nslabs_conflict_raises():
    class Fake8:
        shape = {"slab": 8}

    with pytest.raises(ValueError, match="conflicts with mesh axis"):
        ExecSpec(mesh=Fake8(), n_slabs=4)
    assert ExecSpec(mesh=Fake8(), n_slabs=8).slabs == 8   # consistent OK
    m = _mesh((2, 3), ("member", "slab"))
    with pytest.raises(ValueError, match="must differ"):
        ExecSpec(mesh=m, member_axis="slab")
    with pytest.raises(ValueError, match="member_axis 'rows'"):
        ExecSpec(mesh=m, member_axis="rows")
    assert hash(ExecSpec(mesh=m)) == hash(ExecSpec(
        mesh=_mesh((2, 3), ("member", "slab"))))
    assert ExecSpec(mesh=m) != ExecSpec(mesh=_mesh((3, 2),
                                                   ("member", "slab")))


def test_meshes_name_their_devices():
    m = make_mesh((2, 2), ("member", "slab"), devices=["cpu"] * 4)
    assert isinstance(m, Mesh) and m.shape == {"member": 2, "slab": 2}
    assert m.devices.shape == (2, 2)
    assert m.axis_devices("slab") == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("member", "slab"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="one type"):
        make_mesh((2,), ("slab",), devices=["cpu", "meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh((2,), ("slab",))
    # a gather onto a device of another type than the mesh's is refused
    with pytest.raises(ValueError, match="no path mixes"):
        from repro_torch.core.distributed import ct_transform_sharded
        ct_transform_sharded(_grids(SCHEME, 1), SCHEME, _mesh((2,)), "slab",
                             device="meta")


def test_durable_meshed_tenant_restores_bitwise(tmp_path):
    """A meshed tenant journals and snapshots its gathered surplus: a fresh
    engine restoring it under the same spec (snapshot + one WAL replay
    through the sharded ingest) is bitwise the never-crashed one."""
    spec = SPECS["member_x_slab"]()
    e1 = _engine(store=DurableStore(str(tmp_path), "h0"),
                 snapshot_interval=2)
    e1.register("t", SCHEME, _grids(SCHEME, 1), spec=spec)
    e1.update("t", _grids(SCHEME, 2))        # seq 2: the snapshot
    e1.update("t", _grids(SCHEME, 3))        # seq 3: one WAL entry
    e2 = _engine(store=DurableStore(str(tmp_path), "h0"))
    info = e2.restore(specs={"t": spec})["t"]
    assert (info.snapshot_seq, info.pending, info.replayed) == (2, 1, 1)
    assert isinstance(e2.plan("t"), tex.ShardedPlan)
    _bitwise(e2.surplus("t"), e1.surplus("t"))


@pytest.mark.parametrize("members", [1, 2])
def test_hosts_over_disjoint_device_slices(members):
    """Twin of the reference's ``test_meshed_hosts_over_disjoint_device_
    slices``: two hosts over disjoint 2-device slices of 4 devices (1-D,
    or 2-D member x slab with ``members=2``), every tenant bitwise a fresh
    engine's, before and after its primary is killed."""
    cl = CTCluster.over_device_slices(2, devices=["cpu"] * 4,
                                      members=members, seed=11)
    shape = {"member": 2, "slab": 1} if members == 2 else {"slab": 2}
    assert all(h.spec.mesh.shape == shape for h in cl._hosts.values())
    eng = _engine()
    pts = np.random.default_rng(7).random((16, 3))
    for i in range(3):
        cl.register(f"t{i}", SCHEME, _grids(SCHEME, i))
        eng.register(f"t{i}", SCHEME, _grids(SCHEME, i))
    for i in range(3):
        _bitwise(cl.query(f"t{i}", pts), eng.query(f"t{i}", pts))
    assert isinstance(cl.plan("t0"), tex.ShardedPlan)
    with pytest.raises(ValueError, match="mesh-free"):
        cl.register("x", SCHEME, _grids(SCHEME, 0),
                    spec=ExecSpec(mesh=_mesh((2,))))
    victim = cl.owners_of("t0")[0]
    cl.injector.kill(victim)
    cl.check_health()
    for i in range(3):
        _bitwise(cl.query(f"t{i}", pts), eng.query(f"t{i}", pts))
    with pytest.raises(ValueError, match="must divide"):
        CTCluster.over_device_slices(2, devices=["cpu"] * 6, members=2)
    with pytest.raises(ValueError, match="mesh-free"):
        CTCluster(1, device="cpu", spec=ExecSpec(mesh=_mesh((2,))))


def test_surrogate_legacy_mesh_keywords_fold_into_a_spec():
    """``CTSurrogate(mesh=, axis_name=)`` warns once and runs sharded on the
    mesh's device, bitwise a plain surrogate."""
    g = _grids(SCHEME, 9)
    plain = CTSurrogate(SCHEME, g, device="cpu")
    mesh = _mesh((2,), ("rows",))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sur = CTSurrogate(SCHEME, g, mesh=mesh, axis_name="rows")
        CTSurrogate(SCHEME, g, mesh=mesh, axis_name="rows")
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(dep) == 1 and "mesh=" in str(dep[0].message)
    assert sur.engine.device == torch.device("cpu")
    assert sur.engine.spec("surrogate").mesh == mesh
    _bitwise(sur.surplus, plain.surplus)
    with pytest.raises(ValueError, match="not both"):
        CTSurrogate(SCHEME, g, spec=ExecSpec(), mesh=mesh)
