"""PyTorch/CUDA port of the sparse-grid combination-technique system.

The JAX package ``repro`` is the reference; this package keeps its module
and public function names so each counterpart is easy to find.  It
imports ``torch`` and numpy only — never JAX, never ``repro``.

Ported so far: the CT ingest-and-query path (``core.executor.ct_transform``,
``core.interpolation.interpolate_hierarchical``), the single-device CT
engine (``core.engine``: ``ExecSpec``, ``CTEngine`` with
signature-shared ingest executables, coalesced queries and donation, and
``launch.serve.CTSurrogate`` as its one-tenant view) with its durable
store (``runtime.durability``: WAL, surplus snapshots, restore and replay,
on the checkpoint layer ``checkpoint.checkpoint``) and the multi-host
cluster over it (``runtime.cluster.CTCluster``: consistent-hash placement,
health monitor, failover by recombination, restart from the store, the
fault injector and chaos schedules; its hosts share one device), the
multi-device layer (``core.mesh``, ``core.distributed``: slab-sharded and
2-D member x slab ingest, the psum gather, pole-parallel hierarchization,
meshed ``ExecSpec``s, ``CTEngine.rebind``, ``runtime.elastic.
rebalance_engine``, ``CTCluster.over_device_slices``; single-controller,
on meshes that may repeat one device), the per-grid
transforms (``kernels.ops``) and the iterated combination technique
(``core.iterated``), the scatter phase with adaptivity
(``core.executor.ct_scatter``, ``core.adaptive``,
``runtime.fault_tolerance``), and the dense LM's serving steps
(``models``: ``transformer.DenseLM``/``forward``, ``model.prefill_step``/
``serve_step``, ``launch.serve.generate``; ``convert.lm_params_from_numpy``
carries the reference's weights across).  Every TPU kernel of the
reference is written by hand in CUDA for Hopper (``kernels/csrc``): the
hierarchization kernels and flash attention, and the ingest's member
assembly and the 2-D ingest's ordered owner fold are hand-written
launches too.  The concurrency analysis (``analysis``: the lock registry,
the static pass ``python -m repro_torch.analysis`` and the runtime
sanitizer under ``REPRO_TORCH_LOCKDEP=1``) covers every lock of the port.
Not ported yet: of the LM stack the moe, ssm, hybrid, encdec and vlm
families, training
(``launch/train.py``, ``optim``, ``data``, the loss) and ``make_batch``/
``input_specs`` (ROADMAP.md, Queue A).  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; with no card and no
``device="cpu"`` they raise — there is no silent CPU fallback.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is present, instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
