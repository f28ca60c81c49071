"""State carrier between the reference and the port.

The CT system has no weights: its state is the nodal component grids and
the served surplus.  ``state_from_numpy`` turns the reference's
``{ell: np.ndarray}`` grids and a served surplus (``np.asarray(ref.surplus)``)
into the port's tensors, so both packages compute from identical state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["state_from_numpy"]


def state_from_numpy(nodal_grids: Mapping[tuple, np.ndarray],
                     surplus: Optional[np.ndarray] = None, *, device,
                     dtype: Optional[torch.dtype] = None
                     ) -> Tuple[Dict[tuple, torch.Tensor],
                                Optional[torch.Tensor]]:
    """``({ell: tensor}, surplus tensor or None)`` on ``device``, keeping
    each array's dtype unless ``dtype`` is given.  Values are copied
    exactly (no rounding unless ``dtype`` narrows them)."""
    device = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    grids = {tuple(int(l) for l in ell): conv(u)
             for ell, u in nodal_grids.items()}
    return grids, None if surplus is None else conv(surplus)
