"""Quickstart on the PyTorch/CUDA port: the twin of ``examples/quickstart.py``
on ``repro_torch``, the paper's pipeline behind the unified front door.

1. Build the combination scheme for a 2-D sparse grid.
2. Sample functions on every combination grid (the "solver" output).
3. ``ExecSpec`` — ONE config object for the whole execution stack —
   drives the batched gather (``ct_transform``): every member grid
   assembled into the bucket stacks, hierarchized in grouped kernel
   launches and added into the fine grid in member order.
4. ``CTEngine`` — serve SEVERAL surrogates multi-tenant: equal plan
   shape-signatures share one ingest executable, and queries submitted
   together coalesce into one batched eval dispatch.
5. Scatter back (``ct_scatter``) for the iterated-CT round trip.
6. The pre-ExecSpec keywords still work as deprecation shims (warn once).

It runs on the CUDA card by default (the kernels of ``repro_torch.kernels``)
and on the CPU with ``--device cpu`` (their plain PyTorch versions).

Run:  PYTHONPATH=src python examples_torch/quickstart.py
      PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""

import argparse
import warnings

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import CTEngine, ExecSpec
from repro_torch.core.executor import MergeConfig, ct_scatter, ct_transform
from repro_torch.core.interpolation import sample_function
from repro_torch.core.levels import CombinationScheme


def f(x, y):
    return torch.sin(torch.pi * x) * y * (1 - y)


def g(x, y):
    return x * (1 - x) * torch.sin(torch.pi * y)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    scheme = CombinationScheme(dim=2, level=5)
    print(f"sparse grid level {scheme.level}: {len(scheme.grids)} combination "
          f"grids, {scheme.total_points()} grid points total "
          f"(vs {(2 ** 5 - 1) ** 2} for the full grid), on {device}")

    # --- compute phase (black-box solver; here: sampling f and g) ---
    nodal_f = {ell: sample_function(f, ell, device=device)
               for ell, _ in scheme.grids}
    nodal_g = {ell: sample_function(g, ell, device=device)
               for ell, _ in scheme.grids}

    # --- one ExecSpec drives every execution knob (all defaults here:
    #     no merging, single device, fused epilogue) ---
    spec = ExecSpec()
    full = ct_transform(nodal_f, scheme, spec=spec, device=device)
    print(f"combined surplus buffer: {tuple(full.shape)}")

    # --- multi-tenant serving: two surrogates, ONE ingest executable ---
    engine = CTEngine(spec=spec, device=device, ingest_workers=0)
    engine.register("f", scheme, nodal_f)
    engine.register("g", scheme, nodal_g)   # same shape-signature: cache hit
    cache = engine.stats()["ingest_cache"]
    print(f"ingest executables: {cache['misses']} built, "
          f"{cache['hits']} shared (2 tenants)")
    assert cache["misses"] == 1 and cache["hits"] == 1

    # --- continuous batching: both queries in ONE batched dispatch ---
    pts = np.random.default_rng(0).random((512, 2))
    fut_f = engine.submit_query("f", pts)
    fut_g = engine.submit_query("g", pts)
    engine.flush()
    x, y = torch.from_numpy(pts).T
    err_f = float(np.max(np.abs(np.asarray(fut_f.result())
                                - f(x, y).numpy())))
    err_g = float(np.max(np.abs(np.asarray(fut_g.result())
                                - g(x, y).numpy())))
    ev = engine.stats()["eval"]
    print(f"max interpolation error at 512 random points: "
          f"f {err_f:.2e}, g {err_g:.2e} "
          f"({ev['queries']} queries in {ev['batches']} batched dispatch)")
    assert err_f < 5e-3 and err_g < 5e-3 and ev["batches"] == 1

    # --- scatter back (iterated-CT round trip): the combined interpolant
    #     reproduces consistent component-grid values at their own nodes ---
    back = ct_scatter(engine.surplus("f"), scheme, spec=spec, device=device)
    drift = max(float((back[ell] - nodal_f[ell]).abs().max())
                for ell, _ in scheme.grids)
    print(f"round-trip drift on consistent grids: {drift:.2e}")

    # --- the legacy kwargs still work (deprecation shims, warn once) ---
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = ct_transform(nodal_f, scheme, merge=None,
                              device=device)      # defaults: no warning
        assert not caught
        legacy = ct_transform(nodal_f, scheme, merge=MergeConfig(),
                              device=device)
    assert torch.equal(legacy, full)
    print(f"legacy merge= kwarg: same result bit-for-bit, "
          f"{len(caught)} DeprecationWarning (then silent)")
    print("OK")


if __name__ == "__main__":
    main()
