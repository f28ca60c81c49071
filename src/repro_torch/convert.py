"""State carriers between the reference and the port.

The CT system has no weights: its state is the nodal component grids and
the served surplus.  ``state_from_numpy`` turns the reference's
``{ell: np.ndarray}`` grids and a served surplus (``np.asarray(ref.surplus)``)
into the port's tensors, so both packages compute from identical state.
``lm_params_from_numpy`` does the same for the LM's parameters (every
family) and ``train_state_from_numpy`` for its
train state (parameters and AdamW's moments); ``lm_params_to_numpy`` and
``train_state_to_numpy`` carry the port's back into the reference's
layout (each layer stack along a leading L axis), so the tests compare
leaf by leaf.

``reference_key`` names the reference's leaf that holds an ``LM``
parameter, as the reference's checkpoint manifests spell it
(``segments/0/attn/wq`` for ``blocks.<i>.attn.wq``, ``segments/<s>/...``
for ``segments.<s>.<i>...`` of the ssm and hybrid families,
``encoder/stack/...`` for ``encoder.blocks.<i>...``), with the layer's
index along its stacked axis; ``stack_by_reference_key`` groups
``{parameter name: leaf}`` into ``{reference key: stacked leaf}`` (the
port's training checkpoints are written so, under the reference's names).
Every family carries across: the moe layers' ``moe`` leaves, the Mamba2,
mLSTM and sLSTM layers' and the hybrid's ``shared_attn`` (not stacked;
the reference's ``segments`` holds ``{}`` at its sites).
"""

from __future__ import annotations

from typing import (Callable, Dict, List, Mapping, Optional, Tuple, TypeVar,
                    Union)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (LM, SEGMENTED, Encoder,
                                            has_shared_attn, segment_plan)
from repro_torch.optim.adamw import AdamWState

__all__ = ["state_from_numpy", "lm_params_from_numpy",
           "train_state_from_numpy", "lm_params_to_numpy",
           "train_state_to_numpy", "reference_key",
           "stack_by_reference_key", "unstack_by_reference_key"]

T = TypeVar("T")


def _tensor(a, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``a`` as a tensor on ``device``, its values copied exactly, in its
    own dtype unless ``dtype`` is given (bf16 arrays of ``ml_dtypes``,
    which torch cannot read, are carried across as their bits)."""
    a = np.array(a, order="C")             # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def state_from_numpy(nodal_grids: Mapping[tuple, np.ndarray],
                     surplus: Optional[np.ndarray] = None, *, device,
                     dtype: Optional[torch.dtype] = None
                     ) -> Tuple[Dict[tuple, torch.Tensor],
                                Optional[torch.Tensor]]:
    """``({ell: tensor}, surplus tensor or None)`` on ``device``, keeping
    each array's dtype unless ``dtype`` is given.  Values are copied
    exactly (no rounding unless ``dtype`` narrows them)."""
    device = resolve_device(device)
    conv = lambda a: _tensor(a, device, dtype)
    grids = {tuple(int(l) for l in ell): conv(u)
             for ell, u in nodal_grids.items()}
    return grids, None if surplus is None else conv(surplus)


# ---------------------------------------------------------------------------
# Parameter names: the port's against the reference's key paths
# ---------------------------------------------------------------------------

#: The port's per-layer prefixes and the reference's stacked leaves.
_STACKS = (("blocks", ("segments", "0")), ("encoder.blocks",
                                           ("encoder", "stack")))


def reference_key(name: str) -> Tuple[str, Optional[int]]:
    """``(key, layer)``: the reference's key path of the leaf that holds
    ``LM`` parameter ``name``, joined by ``/`` as its checkpoint manifests
    spell it, and the layer's index along that leaf's stacked axis (None
    for a leaf that is not stacked)."""
    if name.startswith("segments."):
        _, seg, layer, rest = name.split(".", 3)
        return "/".join(("segments", seg) + tuple(rest.split("."))), \
            int(layer)
    for prefix, ref in _STACKS:
        if name.startswith(prefix + "."):
            layer, rest = name[len(prefix) + 1:].split(".", 1)
            return "/".join(ref + tuple(rest.split("."))), int(layer)
    return name.replace(".", "/"), None


def stack_by_reference_key(named: Mapping[str, T],
                           stack: Callable[[List[T]], T],
                           leaf: Callable[[T], T] = lambda t: t
                           ) -> Dict[str, T]:
    """``{parameter name: leaf}`` (parameters, gradients, moments) as
    ``{reference key: leaf}``: each layer stack's leaves joined by
    ``stack`` (given them in layer order), every other leaf passed through
    ``leaf``."""
    groups: Dict[str, list] = {}
    for name, t in named.items():
        key, layer = reference_key(name)
        groups.setdefault(key, []).append((layer, t))
    return {key: leaf(ts[0][1]) if ts[0][0] is None
            else stack([t for _, t in sorted(ts, key=lambda x: x[0])])
            for key, ts in groups.items()}


def unstack_by_reference_key(flat: Mapping[str, T],
                             names) -> Dict[str, T]:
    """The inverse of ``stack_by_reference_key``: ``{name: leaf}`` for
    each parameter name of ``names``, a stacked leaf indexed by layer."""
    out = {}
    for name in names:
        key, layer = reference_key(name)
        out[name] = flat[key] if layer is None else flat[key][layer]
    return out


def _flatten(tree, path=()) -> Dict[str, object]:
    """The reference's pytree of dicts and lists as ``{key path: leaf}``."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(path): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, path + (str(k),)))
    return out


def _nest(flat: Mapping[str, object], n_segments: int) -> Dict:
    """``{key path: leaf}`` as the reference's pytree: dicts, with the
    ``segments`` list of ``n_segments`` (``{}`` where no leaf lies: a
    hybrid's shared-attention site)."""
    tree: Dict = {}
    for key, a in flat.items():
        node = tree
        *parents, last = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = a
    segs = tree.get("segments", {})
    tree["segments"] = [segs.get(str(i), {}) for i in range(n_segments)]
    return tree


def _named_from_tree(tree: Mapping, cfg: ModelConfig) -> Dict[str, object]:
    """The reference's LM pytree (any leaves) by ``LM`` parameter name,
    each stacked layer segment split per layer (``blocks.<i>``, or
    ``segments.<s>.<i>`` for the ssm and hybrid families)."""
    out = {}
    for key, a in _flatten(tree).items():
        parts = key.split("/")
        if parts[0] == "segments" and cfg.family in SEGMENTED:
            head, rest = f"segments.{parts[1]}", ".".join(parts[2:])
            out.update({f"{head}.{i}.{rest}": a[i] for i in range(len(a))})
            continue
        for prefix, ref in _STACKS:
            head = "/".join(ref) + "/"
            if key.startswith(head):
                rest = key[len(head):].replace("/", ".")
                out.update({f"{prefix}.{i}.{rest}": a[i]
                            for i in range(len(a))})
                break
        else:
            out[key.replace("/", ".")] = a
    return out


def _subtree(named: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    """The parameters under ``prefix.`` as nested dicts of their leaves."""
    tree: Dict = {}
    for name, t in named.items():
        if name.startswith(prefix + "."):
            *path, leaf = name[len(prefix) + 1:].split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t
    return tree


def _layers(named: Mapping[str, torch.Tensor], prefix: str, n: int):
    """The ``n`` layers under ``prefix.<i>.`` as nested dicts."""
    tree = _subtree(named, prefix)
    return [tree.get(str(i), {}) for i in range(n)]


def _lm_from_named(named: Mapping[str, torch.Tensor], cfg: ModelConfig) -> LM:
    encoder = None
    if cfg.family == "encdec":
        encoder = Encoder(cfg, named["encoder.pos"],
                          _layers(named, "encoder.blocks",
                                  cfg.encoder_layers),
                          _subtree(named, "encoder.final_norm"))
    if cfg.family in SEGMENTED:
        layers = [layer for s, (kind, n) in enumerate(segment_plan(cfg))
                  if kind != "shared_attn"
                  for layer in _layers(named, f"segments.{s}", n)]
    else:
        layers = _layers(named, "blocks", cfg.num_layers)
    shared = _subtree(named, "shared_attn") if has_shared_attn(cfg) \
        else None
    return LM(cfg, named["embed"], _subtree(named, "final_norm"), layers,
              named.get("lm_head"), encoder=encoder,
              dec_pos=named.get("dec_pos"), shared_attn=shared)


# ---------------------------------------------------------------------------
# Parameters and train states across the packages
# ---------------------------------------------------------------------------

def lm_params_from_numpy(params_np: Mapping, cfg: ModelConfig, *, device,
                         dtype: Optional[torch.dtype] = None) -> LM:
    """The reference's LM parameter pytree, as numpy
    (``jax.tree.map(np.asarray, params)``), as the port's ``LM`` on
    ``device``, value for value: each array keeps its dtype unless
    ``dtype`` is given.  Each stacked layer segment (leading axis L) is
    split into one block per layer."""
    device = resolve_device(device)
    return _lm_from_named({n: _tensor(a, device, dtype) for n, a in
                           _named_from_tree(params_np, cfg).items()}, cfg)


def train_state_from_numpy(params_np: Mapping, opt_np, cfg: ModelConfig, *,
                           device, dtype: Optional[torch.dtype] = None
                           ) -> Tuple[LM, AdamWState]:
    """The reference's train state ``(params, AdamWState)``, as numpy
    (``jax.tree.map(np.asarray, state)``), as the port's: an ``LM`` whose
    parameters take gradients (``dtype`` as in ``lm_params_from_numpy``)
    and an ``AdamWState`` with the moments by parameter name (float32, as
    stored) and the step as int32."""
    params = lm_params_from_numpy(params_np, cfg, device=device,
                                  dtype=dtype).requires_grad_(True)
    device = params.device
    moments = [{k: _tensor(a, device, torch.float32)
                for k, a in _named_from_tree(tree, cfg).items()}
               for tree in (opt_np.m, opt_np.v)]
    step = torch.tensor(int(np.asarray(opt_np.step)), dtype=torch.int32,
                        device=device)
    return params, AdamWState(step, *moments)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy: bf16 widened to float32 (exactly;
    numpy has no bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(params: Union[LM, Mapping[str, torch.Tensor]],
                       cfg: ModelConfig) -> Dict:
    """An ``LM``, or any ``{parameter name: tensor}`` mapping of its
    shapes (gradients, AdamW's moments), in the reference's pytree layout
    as numpy: each layer stack's tensors stacked along a leading L axis,
    bf16 widened to float32."""
    named = dict(params.named_parameters()) if isinstance(
        params, LM) else dict(params)
    return _nest(stack_by_reference_key(
        {n: _numpy(t) for n, t in named.items()}, np.stack),
        len(segment_plan(cfg)))


def train_state_to_numpy(params: LM, opt: AdamWState,
                         cfg: ModelConfig) -> Tuple[Dict, AdamWState]:
    """The port's train state in the reference's layout as numpy:
    ``(params tree, AdamWState(step, m tree, v tree))``."""
    return (lm_params_to_numpy(params, cfg),
            AdamWState(np.asarray(int(opt.step), np.int32),
                       lm_params_to_numpy(opt.m, cfg),
                       lm_params_to_numpy(opt.v, cfg)))
