"""The port's CT query and serving path against the reference, plus the
package guards: no JAX and no ``repro`` import in the port, and no silent
CPU fallback.

Queries are held to rtol 1e-12: both sides contract the same surplus with
the same hat basis, but the matrix products (XLA's dot on one side,
PyTorch's on the other) sum in different orders.  Surpluses are bitwise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import combination as rcomb
from repro.core import interpolation as rinterp
from repro.core import levels as rlev
from repro.launch.serve import CTSurrogate as RefSurrogate
from repro.launch.steps import make_ct_eval_step as ref_eval_step
from repro_torch.convert import state_from_numpy
from repro_torch.core import combination as tcomb
from repro_torch.core import interpolation as tinterp
from repro_torch.core import levels as tlev
from repro_torch.core.executor import MergeConfig, ct_transform
from repro_torch.launch.serve import CTSurrogate
from repro_torch.launch.steps import make_ct_eval_step, make_ct_step

REPO = Path(__file__).resolve().parents[1]


def _bump(*xs):
    """A smooth function vanishing on the boundary of [0,1]^d."""
    out = 1.0
    for x in xs:
        out = out * 4.0 * x * (1.0 - x)
    return out * (1.0 + 0.5 * xs[0])


def _grids(scheme, seed):
    rng = np.random.default_rng(seed)
    return {ell: rng.standard_normal(rlev.grid_shape(ell))
            for ell, _ in scheme.grids}


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dim,level", [(2, 4), (3, 4), (4, 3)])
def test_surrogate_matches_reference(dim, level):
    rs, ts = rlev.CombinationScheme(dim, level), tlev.CombinationScheme(
        dim, level)
    grids = _grids(rs, seed=dim)
    ref = RefSurrogate(rs, {k: jnp.asarray(v) for k, v in grids.items()})
    tgrids, _ = state_from_numpy(grids, device="cpu")
    srv = CTSurrogate(ts, tgrids, device="cpu")
    _bitwise(srv.surplus, ref.surplus)
    pts = np.random.default_rng(dim + 1).random((33, dim))
    np.testing.assert_allclose(srv.query(pts), ref.query(pts), rtol=1e-12,
                               atol=1e-13)
    grids2 = {k: -2.0 * v + 1.0 for k, v in grids.items()}
    ref.update({k: jnp.asarray(v) for k, v in grids2.items()})
    srv.update(state_from_numpy(grids2, device="cpu")[0])
    _bitwise(srv.surplus, ref.surplus)
    np.testing.assert_allclose(srv.query(pts), ref.query(pts), rtol=1e-12,
                               atol=1e-13)


def test_surrogate_merged_and_unfused_give_the_same_bits():
    ts = tlev.GeneralScheme.from_levels([(6, 5), (5, 6)], close=True)
    tgrids, _ = state_from_numpy(_grids(ts, 3), device="cpu")
    base = CTSurrogate(ts, tgrids, device="cpu").surplus
    merged = CTSurrogate(ts, tgrids, device="cpu",
                         merge=MergeConfig(launch_cost_bytes=1 << 30)).surplus
    unfused = CTSurrogate(ts, tgrids, fused=False, device="cpu").surplus
    _bitwise(merged, base.numpy())
    _bitwise(unfused, base.numpy())


def test_surrogate_validates_points():
    ts = tlev.CombinationScheme(2, 3)
    srv = CTSurrogate(ts, state_from_numpy(_grids(ts, 0), device="cpu")[0],
                      device="cpu")
    with pytest.raises(ValueError, match=r"\(Q, 2\)"):
        srv.query(np.zeros((4, 3)))
    with pytest.raises(TypeError, match="floating"):
        srv.query(np.zeros((4, 2), np.int64))
    assert srv.query(np.array([0.5, 0.25])).shape == (1,)


@pytest.mark.parametrize("levels", [(3,), (4, 2), (3, 2, 3)])
def test_query_eval_matches_reference(levels):
    rng = np.random.default_rng(len(levels))
    alpha = rng.standard_normal(rlev.grid_shape(levels))
    pts = rng.random((40, len(levels)))
    want = rinterp.interpolate_hierarchical(jnp.asarray(alpha),
                                            jnp.asarray(pts))
    got = tinterp.interpolate_hierarchical(torch.from_numpy(alpha),
                                           torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)
    u = rng.standard_normal(rlev.grid_shape(levels))
    np.testing.assert_allclose(
        tinterp.interpolate_nodal(torch.from_numpy(u),
                                  torch.from_numpy(pts)).numpy(),
        np.asarray(rinterp.interpolate_nodal(jnp.asarray(u),
                                             jnp.asarray(pts))),
        rtol=1e-12, atol=1e-13)


def test_batched_eval_rows_equal_unbatched_bitwise():
    rng = np.random.default_rng(11)
    alpha = torch.from_numpy(rng.standard_normal((3, 15, 7, 3)))
    pts = torch.from_numpy(rng.random((3, 25, 3)))
    batched = tinterp.interpolate_hierarchical_batched(alpha, pts)
    assert batched.shape == (3, 25)
    for t in range(3):
        assert torch.equal(batched[t], tinterp.interpolate_hierarchical(
            alpha[t], pts[t]))
    one = tinterp.interpolate_hierarchical_batched(alpha[:1], pts[:1])
    assert torch.equal(one[0], tinterp.interpolate_hierarchical(alpha[0],
                                                                pts[0]))



@pytest.mark.parametrize("setting", [False, True])
def test_query_leaves_the_callers_tf32_setting(setting):
    """The eval runs its products without TF32 and restores the
    process-wide flag it found."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = setting
    try:
        alpha = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (7, 3)))
        tinterp.interpolate_hierarchical(alpha, torch.full((4, 2), 0.3))
        assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

def test_sample_function_and_interpolant_oracle_match_reference():
    rs, ts = rlev.CombinationScheme(2, 4), tlev.CombinationScheme(2, 4)
    for ell, _ in ts.grids:
        _bitwise(tinterp.sample_function(_bump, ell, device="cpu"),
                 rinterp.sample_function(_bump, ell))
    grids = {ell: tinterp.sample_function(_bump, ell, device="cpu")
             for ell, _ in ts.grids}
    pts = np.random.default_rng(2).random((30, 2))
    want = rcomb.combined_interpolant_points(
        {k: jnp.asarray(v.numpy()) for k, v in grids.items()}, rs,
        jnp.asarray(pts))
    got = tcomb.combined_interpolant_points(grids, ts, torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)
    # the served interpolant reproduces the direct combination solution
    srv = CTSurrogate(ts, grids, device="cpu")
    np.testing.assert_allclose(srv.query(pts), got.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_steps_match_reference():
    rs, ts = rlev.CombinationScheme(3, 3), tlev.CombinationScheme(3, 3)
    grids = _grids(rs, 5)
    tgrids, _ = state_from_numpy(grids, device="cpu")
    step = make_ct_step(ts, device="cpu")
    _bitwise(step(tgrids), ct_transform(tgrids, ts, device="cpu").numpy())
    pts = np.random.default_rng(6).random((17, 3))
    want = ref_eval_step(rs)({k: jnp.asarray(v) for k, v in grids.items()},
                             jnp.asarray(pts))
    got = make_ct_eval_step(ts, device="cpu")(tgrids, torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)


def test_state_from_numpy_is_exact():
    grids = _grids(rlev.CombinationScheme(2, 3), 1)
    surplus = np.random.default_rng(2).standard_normal((7, 7))
    tg, ts = state_from_numpy(grids, surplus, device="cpu")
    assert set(tg) == set(grids)
    for k, v in grids.items():
        _bitwise(tg[k], v)
    _bitwise(ts, surplus)
    tg32, _ = state_from_numpy(grids, device="cpu", dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in tg32.values())


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def _port_sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    smoke = REPO / "chip_smoke.py"
    assert files and smoke.is_file()
    return files + [smoke]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.launch.steps, repro_torch.core.combination, "
            "repro_torch.core.iterated, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = tlev.CombinationScheme(2, 3)
    grids = {k: torch.from_numpy(v) for k, v in _grids(ts, 0).items()}
    for call in (lambda: ct_transform(grids, ts),
                 lambda: CTSurrogate(ts, grids),
                 lambda: make_ct_step(ts),
                 lambda: state_from_numpy(_grids(ts, 0), device=None),
                 lambda: tinterp.sample_function(_bump, (2, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
