"""AdamW with decoupled weight decay, plain PyTorch.

Port of ``repro.optim.adamw``, computed outside any kernel as the
reference computes it.  Parameters, gradients and the moments are flat
mappings ``{name: tensor}`` (a model's ``named_parameters()``); the state
keeps ``m`` and ``v`` in float32 whatever the parameter's type and the
step as an int32 0-d tensor.  ``adamw_update`` returns new parameters
and a new state and leaves its inputs as they are; with ``inplace=True``
it writes each leaf's new value into the parameter, and puts its new
moments in place of the old in ``state``'s mappings, as soon as they are
computed, so no second copy of the weights or the moments is ever held.

``decay[name]`` says which parameters take weight decay; the caller
decides (the train step's ``steps.decay_mask``).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm"]

Tree = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor               # int32, 0-d
    m: Dict[str, torch.Tensor]       # float32, by parameter name
    v: Dict[str, torch.Tensor]


def adamw_init(params: Tree) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = next(iter(params.values())).device if params else "cpu"
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()})


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return ({k: (g.float() * scale).to(g.dtype) for k, g in grads.items()},
            norm)


def adamw_update(grads: Tree, state: AdamWState, params: Tree, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, decay: Mapping[str, bool],
                 inplace: bool = False
                 ) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
    """Returns (new_params, new_state).  ``lr`` is a number or a 0-d
    tensor (a schedule's value); ``decay[name]`` says whether parameter
    ``name`` takes weight decay.  With ``inplace`` the parameters (under
    ``torch.no_grad()`` if they take gradients) are overwritten and the
    entries of ``state.m`` and ``state.v`` replaced, leaf by leaf, and
    the same mappings returned."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=stepf.device), stepf)
    if inplace:
        new_p, new_m, new_v = dict(params), state.m, state.v
    else:
        new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        g32 = grads[name].float()
        m_new = b1 * state.m[name] + (1.0 - b1) * g32
        v_new = b2 * state.v[name] + (1.0 - b2) * g32 * g32
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if decay[name]:
            delta = delta + weight_decay * p.float()
        value = (p.float() - lr * delta).to(p.dtype)
        if inplace:
            p.copy_(value)
        else:
            new_p[name] = value
        new_m[name], new_v[name] = m_new, v_new
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
