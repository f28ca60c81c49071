#!/usr/bin/env python3
"""Time rows 1, 2, 6 and 8 of two source trees of the port in turns on one
CUDA card: the pole kernels (``hier_pole``, ``dehier_pole``) and the batched
inverse (``dehier_tail_batched``, ``dehier_axis0_batched``), which share
``csrc/pole_tile.cuh``.

    python3 tools/ab_pole_kernels.py ROOT_A ROOT_B [--rounds 2]

Each root holds a ``src/repro_torch`` (a checkout, or an unpacked ``git
archive`` of one).  The trees run in turns, A B B A for two rounds, each
turn in a process of its own that builds the three kernel libraries into
its tree's ``build/`` and prints one JSON line; the script then prints the
median of each time per tree.  Times are CUDA events around 20 calls queued
behind a sleep kernel (device time without the host's dispatch), on f64
inputs drawn from a seed:

* rows 1 and 2 on the 511^3 cube's axis 0 as an (N, B) bundle, the 16383 x
  8191 plane's axis 0, a (255, 9638) f32 bundle and a single pole of 16383
  points, and, where the tree's wrappers take ``axis=``, on the cube's
  axes 1 and 2 and the plane's axis 1 in place;
* the ``"pole"`` round trip through ``kernels.ops`` on the cube and the
  plane (whatever copies the tree's path makes);
* rows 6 and 8 on the cube as a one-member stack.

Every kernel output is checked bitwise against its plain version on the
same input; the script exits 1 if one differs.  It prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

REPS = 20


def child(root: str) -> int:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import hierarchize as H
    from repro_torch.kernels import ops

    _build.KERNELS = {k: v for k, v in _build.KERNELS.items()
                      if k in ("pole_fwd", "pole_inv", "axis_pass_inv")}
    _build.load_all()
    cuda = torch.device("cuda")

    def events_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
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

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)

    def randn(shape, dtype=torch.float64):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float64).to(dtype)

    in_place = "axis" in inspect.signature(H.hier_pole).parameters
    cube, plane = randn((511, 511, 511)), randn((16383, 8191))
    shapes = {"cube axis 0 (bundle)": (cube.reshape(511, -1), 0),
              "plane axis 0": (plane, 0),
              "codec bundle f32": (randn((255, 9638), torch.float32), 0),
              "level-14 pole": (randn((16383, 1)), 0)}
    if in_place:
        shapes.update({"cube axis 1": (cube, 1), "cube axis 2": (cube, 2),
                       "plane axis 1": (plane, 1)})
    out, bitwise = {}, True
    for label, (x, axis) in shapes.items():
        kw = {"axis": axis} if in_place else {}
        for name in ("hier_pole", "dehier_pole"):
            wrapper = getattr(H, name)
            bitwise &= same(wrapper(x, **kw), wrapper.plain(x, **kw))
            out[f"{name} {label}"] = events_ms(lambda: wrapper(x, **kw))
    for label, x in (("cube", cube), ("plane", plane)):
        out[f"pole round trip {label}"] = events_ms(
            lambda: ops.dehierarchize(ops.hierarchize(x, "pole"), "pole"))
    stack = cube[None]
    for name, args in (("dehier_axis0_batched", (stack, [9])),
                       ("dehier_tail_batched", (stack, [(9, 9, 9)]))):
        wrapper = getattr(H, name)
        bitwise &= same(wrapper(*args), wrapper.plain(*args))
        out[f"{name} cube"] = events_ms(lambda: wrapper(*args))
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
    print(f"{'median ms':40s} {'A':>10s} {'B':>10s}")
    for key in keys:
        cells = [f"{statistics.median(times[r][key]):10.4f}"
                 if key in times[r] else f"{'-':>10s}"
                 for r in (a, b)]
        print(f"{key:40s} {cells[0]} {cells[1]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
