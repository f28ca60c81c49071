"""The port's iterated combination technique against the reference, on the
CPU: the heat solver of the compute phase, the subspace gather/scatter of
the communication phase, one communication phase and the whole run.

Tolerances, from the same grids (the reference's, carried over with
``convert.state_from_numpy``):

* bitwise: one ``heat_step``, the gather and scatter, and a communication
  phase whose methods are bitwise (``ref``, ``pole``);
* rtol 1e-12: ``heat_run`` (the reference's ``lax.scan`` compiles the
  steps together and XLA may contract ``u + c*lap`` into a fused
  multiply-add), ``heat_init`` (``jnp.sin`` and ``torch.sin`` differ in
  the last bit on some nodes), a communication phase with the dense
  operator methods, and ``run_iterated_heat`` (all of the above).

The JAX side stays small (scheme (2, 4), one round of 4 steps): its jit
is what makes ``tests/test_iterated_ct.py`` slow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import combination as rcomb
from repro.core import pde as rpde
from repro.core.hierarchize import hierarchize as ref_hierarchize
from repro.core.iterated import IteratedCombination as RefIterated
from repro.core.iterated import run_iterated_heat as ref_run
from repro.core.levels import CombinationScheme as RefScheme
from repro_torch.convert import state_from_numpy
from repro_torch.core import combination as tcomb
from repro_torch.core import pde as tpde
from repro_torch.core.hierarchize import hierarchize
from repro_torch.core.iterated import IteratedCombination, run_iterated_heat
from repro_torch.core.levels import CombinationScheme, fine_levels

NU = 0.05


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.contiguous().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
        float(np.max(np.abs(got - want)))


def _close(got: torch.Tensor, want, rtol=1e-12) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-15)


def _exact(pts, dim, t):
    return rpde.heat_exact_factor(dim, NU, t) * np.prod(
        np.sin(np.pi * np.asarray(pts)), axis=1)


def _ref_grids(scheme, seed=None):
    """The reference's initial heat grids, or seeded random ones."""
    rng = None if seed is None else np.random.default_rng(seed)
    return {ell: np.array(rpde.heat_init(ell)) if rng is None
            else rng.standard_normal(tuple((1 << l) - 1 for l in ell))
            for ell, _ in scheme.grids}


# ---------------------------------------------------------------------------
# core.pde
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [(3, 2), (5, 5), (2, 3, 1)])
def test_heat_solver_matches_reference(levels):
    dt = rpde.stable_dt(levels, NU)
    assert dt == tpde.stable_dt(levels, NU)
    assert rpde.heat_exact_factor(3, NU, 0.1) == \
        tpde.heat_exact_factor(3, NU, 0.1)
    u = np.array(rpde.heat_init(levels))
    _close(tpde.heat_init(levels, device="cpu"), u, rtol=1e-15)
    _bitwise(tpde.heat_step(torch.from_numpy(u), nu=NU, dt=dt),
             rpde.heat_step(jnp.asarray(u), nu=NU, dt=dt))
    _close(tpde.heat_run(torch.from_numpy(u), 16, nu=NU, dt=dt),
           rpde.heat_run(jnp.asarray(u), 16, nu=NU, dt=dt))


def test_heat_solver_single_grid_convergence():
    """The reference test's exact-solution check
    (``tests/test_iterated_ct.py``), on the port: atol 2e-3."""
    levels, steps = (5, 5), 64
    dt = tpde.stable_dt(levels, NU)
    u0 = tpde.heat_init(levels, device="cpu")
    out = tpde.heat_run(u0, steps, nu=NU, dt=dt)
    exact = tpde.heat_exact_factor(2, NU, steps * dt) * u0
    np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=0,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# core.combination: the subspace gather and scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,level", [(2, 4), (3, 3)])
def test_gather_scatter_subspaces_match_reference(dim, level):
    ref_scheme, scheme = RefScheme(dim, level), CombinationScheme(dim, level)
    hier = {ell: np.asarray(ref_hierarchize(jnp.asarray(u), "ref"))
            for ell, u in _ref_grids(ref_scheme, seed=dim).items()}
    want = rcomb.gather_subspaces({k: jnp.asarray(v) for k, v in
                                   hier.items()}, ref_scheme)
    got = tcomb.gather_subspaces(state_from_numpy(hier, device="cpu")[0],
                                 scheme)
    assert got.keys() == want.keys()
    for m in want:
        _bitwise(got[m], want[m])
    want_s = rcomb.scatter_subspaces(want, ref_scheme)
    got_s = tcomb.scatter_subspaces(got, scheme)
    assert got_s.keys() == want_s.keys()
    for ell in want_s:
        _bitwise(got_s[ell], want_s[ell])
    ell0, full = next(iter(got_s)), fine_levels(scheme)
    emb = tcomb.embed_to_full(got_s[ell0], ell0, full)
    _bitwise(tcomb.extract_from_full(emb, ell0, full),
             rcomb.extract_from_full(jnp.asarray(emb.numpy()), ell0, full))
    _bitwise(tcomb.extract_from_full(emb, ell0, full), got_s[ell0].numpy())


def test_scatter_takes_the_blocks_dtype():
    scheme = CombinationScheme(2, 3)
    grids = {ell: torch.ones(tuple((1 << l) - 1 for l in ell),
                             dtype=torch.float32) for ell, _ in scheme.grids}
    out = tcomb.scatter_subspaces(tcomb.gather_subspaces(grids, scheme),
                                  scheme)
    assert {v.dtype for v in out.values()} == {torch.float32}


# ---------------------------------------------------------------------------
# core.iterated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["ref", "pole", "fused"])
def test_communication_phase_matches_reference(method):
    """One communication phase from the same grids: bitwise where every
    step is (``ref``, ``pole``), else rtol 1e-12."""
    ref_scheme, scheme = RefScheme(2, 4), CombinationScheme(2, 4)
    grids = _ref_grids(ref_scheme, seed=7)
    ref_it = RefIterated(ref_scheme, None, method,
                         {k: jnp.asarray(v) for k, v in grids.items()})
    ref_it.communication_phase()
    it = IteratedCombination(scheme, None, method,
                             state_from_numpy(grids, device="cpu")[0])
    it.communication_phase()
    assert it.grids.keys() == ref_it.grids.keys()
    for ell in it.grids:
        if method == "fused":
            _close(it.grids[ell], ref_it.grids[ell])
        else:
            _bitwise(it.grids[ell], ref_it.grids[ell])


@pytest.mark.parametrize("method", ["fused", "pole"])
def test_run_iterated_heat_matches_reference(method):
    """``run_iterated_heat(2, 4)`` at rtol 1e-12 against the reference,
    and within the reference test's bound of the exact solution."""
    ref_it, ref_t = ref_run(2, 4, rounds=1, t_steps=4, hier_method=method)
    it, t = run_iterated_heat(2, 4, rounds=1, t_steps=4, hier_method=method,
                              device="cpu")
    assert t == ref_t
    for ell in it.grids:
        _close(it.grids[ell], ref_it.grids[ell])
    pts = np.random.default_rng(0).random((64, 2)) * 0.8 + 0.1
    got = it.evaluate(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_it.evaluate(
        jnp.asarray(pts))), rtol=1e-12, atol=1e-15)
    assert np.max(np.abs(got - _exact(pts, 2, t))) < 0.05


def test_run_iterated_heat_3d_tracks_exact_solution():
    it, t = run_iterated_heat(3, 3, rounds=1, t_steps=4, device="cpu")
    pts = np.random.default_rng(1).random((32, 3)) * 0.8 + 0.1
    err = np.max(np.abs(it.evaluate(torch.from_numpy(pts)).numpy()
                        - _exact(pts, 3, t)))
    assert err < 0.08, err


def test_iterated_state_round_trips_through_convert():
    """The reference's ``it.grids`` carried into the port are exact."""
    grids = _ref_grids(RefScheme(2, 3))
    port, _ = state_from_numpy(grids, device="cpu")
    for ell, u in grids.items():
        _bitwise(port[ell], u)


def test_run_iterated_heat_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_iterated_heat(2, 3, rounds=1, t_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpde.heat_init((2, 2))
    hierarchize(torch.zeros((3, 3), dtype=torch.float64), "pole")  # CPU: ok
