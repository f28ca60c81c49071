"""State carriers between the reference and the port.

The CT system has no weights: its state is the nodal component grids and
the served surplus.  ``state_from_numpy`` turns the reference's
``{ell: np.ndarray}`` grids and a served surplus (``np.asarray(ref.surplus)``)
into the port's tensors, so both packages compute from identical state.
``lm_params_from_numpy`` does the same for the dense LM's parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DenseLM, check_dense

__all__ = ["state_from_numpy", "lm_params_from_numpy"]


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
