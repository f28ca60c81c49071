#!/usr/bin/env python3
"""Time rows 9, 11 and 12 of two source trees of the port in turns on one
CUDA card: the grouped scatter (``hier_scatter_grouped``, row 9), the
assembly (``assemble_grouped``, row 11) and the 2-D slab owner's fold
(``owner_fold``, row 12), at ``prod_3d`` = ``CombinationScheme(3, 9)``.

    python3 tools/ab_ingest_kernels.py ROOT_A ROOT_B [--rounds 2]

Each root holds a ``src/repro_torch`` (a checkout, or an unpacked ``git
archive`` of one).  The trees run in turns, A B B A for two rounds, each
turn in a process of its own that builds the four kernel libraries the
ingest runs into its tree's ``build/`` and prints one JSON line; the script
then prints the median of each number per tree.  The calls are the ones the
port's own paths make, recorded from a fused ``ct_transform_with_plan``
(rows 9, 11) and a 2-D ``ct_transform_sharded`` on a (2, 2) mesh of the
card repeated (row 12, one call a slab), on f64 grids drawn from a seed.
Times are CUDA events around 20 calls queued behind a sleep kernel (device
time without the host's dispatch); ``wrapper`` times are events around 20
calls without it (with the host's dispatch), and ``update`` is the host
clock's median of 7 warm ``CTEngine.update`` calls ending in a synchronise.
The assembly is also timed with every member given as a strided view (its
axes reversed over a copy laid out the other way).

Every kernel output is checked bitwise against its plain version on the
same input; the script exits 1 if one differs.  It prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 20


def child(root: str) -> int:
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from repro_torch.core import executor as E
    from repro_torch.core.distributed import ct_transform_sharded
    from repro_torch.core.engine import CTEngine
    from repro_torch.core.levels import CombinationScheme, grid_shape
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels import hierarchize as H

    _build.KERNELS = {k: v for k, v in _build.KERNELS.items()
                      if k in ("assemble_members", "axis_pass_fwd",
                               "axis_pass_scatter_fwd", "owner_fold")}
    _build.load_all()
    cuda = torch.device("cuda")

    def events_ms(fn, sleep=True) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if sleep:
            torch.cuda._sleep(int(2e9 * (REPS * host_s + 0.005)))
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / REPS

    def same(a, b) -> bool:
        bits = {torch.float64: torch.int64, torch.float32: torch.int32}
        a, b = a.contiguous(), b.contiguous()
        return a.shape == b.shape and torch.equal(a.view(bits[a.dtype]),
                                                  b.view(bits[b.dtype]))

    rng = np.random.default_rng(0)
    scheme = CombinationScheme(3, 9)
    plan = E.build_plan(scheme)
    grids = {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell))).to(
        cuda) for ell, _ in scheme.grids}
    with H.record_calls() as calls:
        E.ct_transform_with_plan(grids, plan, device=cuda)
    mesh = make_mesh((2, 2), ("member", "slab"), devices=[cuda] * 4)
    with H.record_calls() as calls_2d:
        ct_transform_sharded(grids, scheme, mesh, "slab",
                             member_axis="member")
    torch.cuda.synchronize()
    (_, asm), = [c for c in calls if c[0] is H.assemble_grouped]
    (_, sc), = [c for c in calls if c[0] is H.hier_scatter_grouped]
    folds = [a for w, a in calls_2d if w is H.owner_fold]
    rev = [p.permute(*reversed(range(p.ndim))).contiguous().permute(
        *reversed(range(p.ndim))) for p in asm["parts"]]
    strided = {**asm, "parts": rev}

    out, bitwise = {}, True
    for label, args in (("assembly", asm), ("assembly strided", strided)):
        got = H.assemble_grouped(**args)
        bitwise &= same(got, H.assemble_grouped.plain(**args))
        out[f"row 11 {label}"] = events_ms(
            lambda: H.assemble_grouped(**args))
        out[f"row 11 {label} wrapper"] = events_ms(
            lambda: H.assemble_grouped(**args), sleep=False)
    acc0 = torch.from_numpy(rng.standard_normal(sc["acc"].numel())).to(cuda)
    got = H.hier_scatter_grouped(**{**sc, "acc": acc0.clone()})
    want = H.hier_scatter_grouped.plain(**{**sc, "acc": acc0.clone()})
    bitwise &= same(got, want)
    acc = acc0.clone()
    out["row 9 scatter"] = events_ms(
        lambda: H.hier_scatter_grouped(**{**sc, "acc": acc}))
    out["row 9 scatter wrapper"] = events_ms(
        lambda: H.hier_scatter_grouped(**{**sc, "acc": acc}), sleep=False)
    bufs = [torch.from_numpy(rng.standard_normal(a["acc"].numel())).to(cuda)
            for a in folds]
    for a, b in zip(folds, bufs):
        got = H.owner_fold(**{**a, "acc": b.clone()})
        bitwise &= same(got, H.owner_fold.plain(**{**a, "acc": b.clone()}))

    def fold_all():
        for a, b in zip(folds, bufs):
            H.owner_fold(**{**a, "acc": b})

    out[f"row 12 owner_fold ({len(folds)} slabs)"] = events_ms(fold_all)
    out[f"row 12 owner_fold ({len(folds)} slabs) wrapper"] = events_ms(
        fold_all, sleep=False)

    engine = CTEngine(device=cuda, ingest_workers=0)
    engine.register("bump", scheme, grids)
    ms = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.update("bump", grids)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["CTEngine.update (host clock, median of 7 warm)"] = \
        statistics.median(ms[1:])
    print(json.dumps({"root": root, "bitwise": bitwise, "ms": out}))
    return 0 if bitwise else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.root_a)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    a, b = args.root_a, args.root_b
    turns = ([a, b, b, a] * args.rounds)[:2 * args.rounds]
    times: dict = {a: {}, b: {}}
    failed = False
    for root in turns:
        run = subprocess.run([sys.executable, __file__, root, root,
                              "--child"], capture_output=True, text=True)
        line = run.stdout.strip().splitlines()[-1] if run.stdout else ""
        print(line or run.stderr[-3000:], flush=True)
        if run.returncode != 0 or not line:
            failed = True
            continue
        for key, ms in json.loads(line)["ms"].items():
            times[root].setdefault(key, []).append(ms)
    keys = sorted({k for t in times.values() for k in t})
    print(f"{'median ms':52s} {'A':>10s} {'B':>10s}")
    for key in keys:
        cells = [f"{statistics.median(times[r][key]):10.4f}"
                 if key in times[r] else f"{'-':>10s}"
                 for r in (a, b)]
        print(f"{key:52s} {cells[0]} {cells[1]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
