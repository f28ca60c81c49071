"""Serving drivers: the LM's token-by-token ``generate``, and sparse-grid
surrogate serving on the batched executor (``CTSurrogate``).

Port of ``repro.launch.serve``.  ``generate`` keeps the reference's
semantics: one batch of prompts is prefilled token by token through
``serve_step`` and then extended by greedy or temperature sampling, with
the log-probability of each chosen token; for an encdec model the stub
audio frames (normal times 0.02, in the model's type) are drawn first and
encoded once into the cache's ``"cross"`` entry (``encode_for_decode``).
Two differences: temperature sampling and the stub audio draw from
``torch.Generator``s seeded with ``sc.seed`` (the same distributions as
the reference's ``jax.random``, other draws; ``audio_embeds=`` hands in
given frames instead), and the log-probabilities are taken in float32
whatever the model's type.  Every architecture runs
(``models.transformer.FAMILIES``; a vlm decodes its text as the reference
does, without patches; an ssm or hybrid model carries its recurrent
states in the cache).  ``generate`` runs under
``torch.inference_mode()``, so it records no autograd graph on a model
that also trains.

``CTSurrogate`` is the port of ``repro.launch.serve.CTSurrogate``: a
single-tenant view over ``repro_torch.core.engine.CTEngine``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.executor import resolve_spec
from repro_torch.models import model as M
from repro_torch.models.transformer import LM, init_params

__all__ = ["ServeConfig", "generate", "CTSurrogate"]


@dataclass(frozen=True)
class ServeConfig:
    arch: str = "smollm_360m"
    smoke: bool = True
    max_new_tokens: int = 16
    temperature: float = 0.0          # 0 = greedy
    seed: int = 0


@torch.inference_mode()
def generate(sc: ServeConfig, prompts, params: LM | None = None, *,
             device=None, audio_embeds=None) -> Dict[str, np.ndarray]:
    """prompts: (B, T) int token prompts (right-aligned, no padding).

    Runs on the device of ``params`` or, without them, on ``device``
    (default CUDA) with weights from ``init_params(seed=sc.seed)``.  An
    encdec model encodes ``audio_embeds`` (B, encoder_seq, d), by default
    stub frames drawn from ``sc.seed``.  Returns dict with "tokens" (B, T
    + max_new) int32 and "logprobs" (B, max_new) float32."""
    cfg = get_smoke_config(sc.arch) if sc.smoke else get_config(sc.arch)
    if params is None:
        params = init_params(cfg, seed=sc.seed, device=device)
    elif device is not None and resolve_device(device) != params.device:
        raise ValueError(f"params lie on {params.device}, not on {device}")
    device = params.device
    tokens = torch.as_tensor(np.asarray(prompts), device=device).long()
    b, t = tokens.shape
    if t == 0:
        raise ValueError("generate needs at least one prompt token")
    cache = M.init_decode_cache(cfg, b, t + sc.max_new_tokens, device=device)
    if cfg.family == "encdec":
        if audio_embeds is None:
            agen = torch.Generator(device=device)
            agen.manual_seed(sc.seed)
            audio_embeds = (torch.randn(
                (b, cfg.encoder_seq, cfg.d_model), generator=agen,
                device=device) * 0.02).to(getattr(torch, cfg.dtype))
        cache["cross"] = M.encode_for_decode(params, cfg, audio_embeds)
    gen = None
    if sc.temperature > 0:
        gen = torch.Generator(device=device)
        gen.manual_seed(sc.seed)
    last_logits = None
    for pos in range(t):        # prefill through the decode path
        last_logits, cache = M.serve_step(
            params, cfg, cache, {"token": tokens[:, pos:pos + 1], "pos": pos})
    out, logprobs = [tokens], []
    for i in range(sc.max_new_tokens):
        logits = last_logits[:, 0, :cfg.vocab_size].float()
        if sc.temperature > 0:
            cur = torch.multinomial(torch.softmax(logits / sc.temperature, -1),
                                    1, generator=gen)[:, 0]
        else:
            cur = torch.argmax(logits, -1)
        lp = torch.log_softmax(logits, -1)
        logprobs.append(lp.gather(1, cur[:, None])[:, 0])
        out.append(cur[:, None])
        if i + 1 < sc.max_new_tokens:   # the last token needs no step
            last_logits, cache = M.serve_step(
                params, cfg, cache, {"token": cur[:, None], "pos": t + i})
    return {"tokens": torch.cat(out, dim=1).cpu().numpy().astype(np.int32),
            "logprobs": torch.stack(logprobs, dim=1).cpu().numpy()}


class CTSurrogate:
    """Sparse-grid surrogate server: ingest once, answer point queries.

    A thin single-tenant view over ``repro_torch.core.engine.CTEngine``, as
    the reference's: the surrogate registers itself as tenant ``name`` of
    a private engine (or of ``engine=``, shared with other tenants) and
    delegates ingest, queries and lifecycle to it, so its ingest executable
    is shared with every tenant of the same plan signature.

    A solver produces nodal values on every component grid; ``update``
    runs the CT transform into the served surplus on the common fine grid,
    ``query`` evaluates the hierarchical interpolant of that surplus at a
    batch of points in [0,1]^d.  ``refit`` (a refined scheme) and
    ``drop_grid`` (fault recovery) swap scheme, plan and surplus through
    the executor's incremental plan rebuilds; ``submit_query`` /
    ``submit_update`` enqueue on the engine and return futures.

    Execution policy comes as ``spec=ExecSpec(...)``; ``merge=``,
    ``fused=``, ``mesh=`` and ``axis_name=`` are deprecated spellings of
    its fields (they warn once).  A meshed spec runs the ingest
    slab-sharded over the mesh (``repro_torch.core.distributed``).
    ``device=`` is the private engine's device (default: a meshed spec's
    first mesh device, else CUDA); with ``engine=`` it must be the
    engine's.  ``cluster=`` (a
    ``repro_torch.runtime.cluster.CTCluster``) registers the tenant through
    the cluster's front door instead, so every call is routed through
    placement, health and failover; ``engine=`` and ``cluster=`` exclude
    each other, and with ``cluster=`` the device is the cluster's.

    ``store=`` (a ``repro_torch.runtime.durability.DurableStore``) makes
    the surrogate's own engine durable: every admitted update is journaled
    at admission and the served surplus snapshotted every
    ``snapshot_interval`` acked updates, so a crashed process rebuilds the
    surrogate bitwise with ``CTSurrogate.restore(store, ...)``.  With a
    shared ``engine=`` or a ``cluster=`` durability is theirs
    (``CTEngine(store=)``, ``CTCluster(durability_dir=)``), and passing
    ``store=`` too raises.
    """

    def __init__(self, scheme, nodal_grids, spec=None, *, engine=None,
                 cluster=None, name: str = "surrogate", store=None,
                 snapshot_interval: int = 16, merge=None, fused=None,
                 mesh=None, axis_name=None, device=None):
        from repro_torch.core.engine import CTEngine
        if engine is not None and cluster is not None:
            raise ValueError("pass engine= or cluster=, not both")
        if store is not None and (engine is not None or cluster is not None):
            raise ValueError(
                "store= applies to the surrogate's own engine; a shared "
                "engine= / cluster= carries its own durability "
                "(CTEngine(store=...) / CTCluster(durability_dir=...))")
        spec = resolve_spec("CTSurrogate", spec, merge=merge, fused=fused,
                            mesh=mesh, axis_name=axis_name)
        if cluster is not None:
            if device is not None and resolve_device(device) != \
                    cluster.device:
                raise ValueError(f"device={device} differs from the "
                                 f"cluster's {cluster.device}")
            engine = cluster            # the engine's serving surface
        elif engine is None:
            if device is None and spec.mesh is not None:
                device = spec.mesh.first_device()
            engine = CTEngine(device=device, store=store,
                              snapshot_interval=snapshot_interval)
        elif device is not None and resolve_device(device) != engine.device:
            raise ValueError(f"device={device} differs from the engine's "
                             f"{engine.device}")
        self._engine = engine
        self._name = name
        engine.register(name, scheme, nodal_grids, spec=spec)

    @classmethod
    def restore(cls, store, *, name: str = "surrogate", spec=None,
                snapshot_interval: int = 16, device=None) -> "CTSurrogate":
        """Rebuild a durable surrogate after a crash: adopt tenant
        ``name``'s newest intact snapshot from ``store`` onto ``device``
        (default CUDA) and replay the newer WAL entries through the normal
        ingest, so it answers bitwise as one that never crashed.  Raises
        ``KeyError`` when the store holds no tenant ``name``."""
        from repro_torch.core.engine import CTEngine
        engine = CTEngine(device=device, store=store,
                          snapshot_interval=snapshot_interval)
        specs = None if spec is None \
            else {name: resolve_spec("CTSurrogate", spec)}
        if engine.restore(store, names=[name], specs=specs).get(name) is None:
            raise KeyError(f"durable store holds no tenant {name!r}")
        self = cls.__new__(cls)
        self._engine = engine
        self._name = name
        return self

    @property
    def engine(self):
        """The backing (possibly shared) ``CTEngine``, or the
        ``CTCluster`` given as ``cluster=``."""
        return self._engine

    @property
    def scheme(self):
        return self._engine.scheme(self._name)

    @property
    def device(self) -> torch.device:
        return self._engine.device

    @property
    def _plan(self):
        return self._engine.plan(self._name)

    @property
    def surplus(self) -> torch.Tensor:
        """Sparse-grid surplus on the common fine grid (the served state)."""
        return self._engine.surplus(self._name)

    def update(self, nodal_grids) -> None:
        """Re-ingest new solver output for the same scheme."""
        self._engine.update(self._name, nodal_grids)

    def refit(self, scheme, nodal_grids) -> None:
        """Serve a (refined) scheme: the plan is rebuilt incrementally
        (``extend_plan``) and ``nodal_grids`` ingested under it.  A failing
        ingest (a grid missing from ``nodal_grids`` raises ``ValueError``
        naming it) raises before any state changes."""
        self._engine.refit(self._name, scheme, nodal_grids)

    def drop_grid(self, failed, nodal_grids) -> None:
        """Fault recovery: recombine without grid(s) ``failed``
        (``recombine_after_fault``: coefficient-only when possible, else an
        ``extend_plan`` rebuild).  ``nodal_grids`` must hold FINITE data for
        the dropped grids (their coefficient is 0) and, when the reduction
        activates a previously coefficient-0 grid, that grid's data too.
        Later ``update`` calls recombine with the reduced coefficients."""
        self._engine.drop_grid(self._name, failed, nodal_grids)

    def query(self, points) -> np.ndarray:
        """points: (Q, d) in [0,1]^d -> combined-interpolant values (Q,)."""
        return self._engine.query(self._name, points)

    def submit_query(self, points, **kw):
        """Asynchronous ``query``: the engine's ``CTFuture`` (keywords:
        ``deadline_ms=``, ``priority=``, ``block=``, ...)."""
        return self._engine.submit_query(self._name, points, **kw)

    def submit_update(self, nodal_grids, **kw):
        """Asynchronous ``update``: the engine's ``CTFuture``."""
        return self._engine.submit_ingest(self._name, nodal_grids, **kw)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    sc = ServeConfig(arch=args.arch, max_new_tokens=args.max_new_tokens)
    cfg = get_smoke_config(args.arch)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    out = generate(sc, prompts, device=args.device)
    print("generated:", out["tokens"].shape, "mean logprob:",
          float(out["logprobs"].mean()))


if __name__ == "__main__":
    main()
