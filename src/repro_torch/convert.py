"""State carriers between the reference and the port.

The CT system has no weights: its state is the nodal component grids and
the served surplus.  ``state_from_numpy`` turns the reference's
``{ell: np.ndarray}`` grids and a served surplus (``np.asarray(ref.surplus)``)
into the port's tensors, so both packages compute from identical state.
``lm_params_from_numpy`` does the same for the dense LM's parameters and
``train_state_from_numpy`` for its train state (parameters and AdamW's
moments); ``lm_params_to_numpy`` and ``train_state_to_numpy`` carry the
port's back into the reference's layout (the layer stack along a leading
L axis), so the tests compare leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DenseLM, check_dense
from repro_torch.optim.adamw import AdamWState

__all__ = ["state_from_numpy", "lm_params_from_numpy",
           "train_state_from_numpy", "lm_params_to_numpy",
           "train_state_to_numpy"]


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


def lm_params_from_numpy(params_np: Mapping, cfg: ModelConfig, *, device,
                         dtype: Optional[torch.dtype] = None) -> DenseLM:
    """The reference's dense-LM parameter pytree, as numpy
    (``jax.tree.map(np.asarray, params)``), as the port's ``DenseLM`` on
    ``device``, value for value: each array keeps its dtype unless
    ``dtype`` is given.  The stacked layer segment (leading axis L) is
    split into one ``DenseBlock`` per layer."""
    check_dense(cfg)
    device = resolve_device(device)
    conv = lambda a: _tensor(a, device, dtype)
    (stack,) = params_np["segments"]
    layers = [{part: {name: conv(a[i]) for name, a in group.items()}
               for part, group in stack.items()}
              for i in range(cfg.num_layers)]
    head = params_np.get("lm_head")
    return DenseLM(cfg, conv(params_np["embed"]),
                   {k: conv(a) for k, a in params_np["final_norm"].items()},
                   layers, None if head is None else conv(head))


def _named_from_tree(tree: Mapping, cfg: ModelConfig) -> Dict[str, object]:
    """The reference's dense-LM pytree (any leaves) by ``DenseLM``
    parameter name, the stacked layer segment split per layer."""
    out = {"embed": tree["embed"]}
    out.update({f"final_norm.{k}": a for k, a in tree["final_norm"].items()})
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    (stack,) = tree["segments"]
    for i in range(cfg.num_layers):
        for part, group in stack.items():
            for name, a in group.items():
                out[f"blocks.{i}.{part}.{name}"] = a[i]
    return out


def train_state_from_numpy(params_np: Mapping, opt_np, cfg: ModelConfig, *,
                           device, dtype: Optional[torch.dtype] = None
                           ) -> Tuple[DenseLM, AdamWState]:
    """The reference's train state ``(params, AdamWState)``, as numpy
    (``jax.tree.map(np.asarray, state)``), as the port's: a ``DenseLM``
    whose parameters take gradients (``dtype`` as in
    ``lm_params_from_numpy``) and an ``AdamWState`` with the moments by
    parameter name (float32, as stored) and the step as int32."""
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


def lm_params_to_numpy(params: Union[DenseLM, Mapping[str, torch.Tensor]],
                       cfg: ModelConfig) -> Dict:
    """A ``DenseLM``, or any ``{parameter name: tensor}`` mapping of its
    shapes (gradients, AdamW's moments), in the reference's pytree layout
    as numpy: the layers' tensors stacked along a leading L axis, bf16
    widened to float32."""
    check_dense(cfg)
    named = dict(params.named_parameters()) if isinstance(
        params, DenseLM) else dict(params)
    tree = {"embed": _numpy(named["embed"]),
            "final_norm": {k.split(".", 1)[1]: _numpy(t)
                           for k, t in named.items()
                           if k.startswith("final_norm.")},
            "segments": []}
    if "lm_head" in named:
        tree["lm_head"] = _numpy(named["lm_head"])
    stack: Dict[str, Dict[str, list]] = {}
    for k, t in named.items():
        if k.startswith("blocks."):
            _, i, part, name = k.split(".")
            stack.setdefault(part, {}).setdefault(name, []).append(
                (int(i), _numpy(t)))
    tree["segments"].append({
        part: {name: np.stack([a for _, a in sorted(layers,
                                                     key=lambda x: x[0])])
               for name, layers in group.items()}
        for part, group in stack.items()})
    return tree


def train_state_to_numpy(params: DenseLM, opt: AdamWState,
                         cfg: ModelConfig) -> Tuple[Dict, AdamWState]:
    """The port's train state in the reference's layout as numpy:
    ``(params tree, AdamWState(step, m tree, v tree))``."""
    return (lm_params_to_numpy(params, cfg),
            AdamWState(np.asarray(int(opt.step), np.int32),
                       lm_params_to_numpy(opt.m, cfg),
                       lm_params_to_numpy(opt.v, cfg)))
