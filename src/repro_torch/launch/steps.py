"""Step functions: the LM's train, prefill and serve steps and the
combination-technique steps, as plain functions (PyTorch runs eagerly, so
nothing is jitted).

Port of ``repro.launch.steps``.  The train state is ``(LM,
AdamWState)``: the model's parameters take gradients, the moments are
float32 by parameter name.  ``make_train_step``'s step differentiates
``transformer.loss_fn`` (row 10's backward kernels through
``FlashAttention``), clips by the global norm, reads the learning rate at
the step *before* the increment (the first warmup step has lr 0) and
writes AdamW's new values into the model's parameters and the moment
mappings in place, leaf by leaf (no second copy of the weights or the
moments),
returning the model, the optimizer state and the metrics.  For the CT steps ``spec=`` carries the execution policy;
``merge=`` and ``fused=`` are its deprecated spellings (they warn once).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (LM, init_params, loss_fn,
                                            reference_rank)
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "init_train_state", "loss_and_grads", "decay_mask",
           "make_ct_step", "make_ct_eval_step"]


def init_train_state(cfg: ModelConfig, *, seed: int = 0,
                     device=None) -> Tuple[LM, AdamWState]:
    """Random weights (``init_params``) that take gradients, and AdamW's
    zero state, on ``device`` (default CUDA)."""
    params = init_params(cfg, seed=seed, device=device).requires_grad_(True)
    return params, adamw_init(dict(params.named_parameters()))


def decay_mask(params: LM) -> Dict[str, bool]:
    """Which parameters take weight decay, by name.  The reference decays
    its leaves of rank >= 2 and stacks each layer's leaves along a leading
    L axis, so every layer's norm scales and biases ((L, d) there), the
    encoder's as the decoder's, are decayed and only the final norms'
    (d,) are not: the rank that counts is the reference leaf's
    (``transformer.reference_rank``)."""
    return {n: reference_rank(n, p) >= 2
            for n, p in params.named_parameters()}


def loss_and_grads(params: LM, cfg: ModelConfig, batch,
                   grad_accum: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(mean loss, {name: gradient}) of ``loss_fn`` over ``batch`` (its
    stub frontends, ``audio_embeds`` or ``patch_embeds``, included).  With
    ``grad_accum`` > 1 the batch is split into that many microbatches run
    one after the other, their gradients summed in f32 and divided, as the
    reference's scan does."""
    named = dict(params.named_parameters())

    def one(mb):
        loss = loss_fn(params, cfg, mb)
        return loss.detach(), torch.autograd.grad(loss, list(named.values()))

    if grad_accum == 1:
        loss, grads = one(batch)
        return loss, dict(zip(named, grads))
    micro = {k: torch.as_tensor(t).reshape(
        (grad_accum, t.shape[0] // grad_accum) + tuple(t.shape[1:]))
        for k, t in batch.items()}
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in named.items()}
    loss = torch.zeros((), dtype=torch.float32, device=params.device)
    for i in range(grad_accum):
        l, grads = one({k: t[i] for k, t in micro.items()})
        loss = loss + l
        for n, g in zip(named, grads):
            acc[n] = acc[n] + g
    return loss / grad_accum, {n: a / grad_accum for n, a in acc.items()}


def make_train_step(cfg: ModelConfig, lr_fn: Callable,
                    grad_clip: float = 1.0, grad_accum: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and ``opt_state``'s moment mappings updated in place."""

    def step(params: LM, opt_state: AdamWState, batch):
        loss, grads = loss_and_grads(params, cfg, batch, grad_accum)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(opt_state.step)
        named = dict(params.named_parameters())
        with torch.no_grad():
            _, new_opt = adamw_update(grads, opt_state, named, lr=lr,
                                      decay=decay_mask(params), inplace=True)
        metrics = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr}
        return params, new_opt, metrics

    return step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def step(params, batch):
        return M.prefill_step(params, cfg, batch)
    return step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def step(params, cache, batch):
        return M.serve_step(params, cfg, cache, batch)
    return step


def _bind(fn_name: str, scheme, spec, merge, fused, device) -> Callable:
    from repro_torch.core.executor import (build_plan, ct_transform_with_plan,
                                           resolve_spec)
    spec = resolve_spec(fn_name, spec, merge=merge, fused=fused)
    device = resolve_device(device)
    spec.resolve_interpret(device)
    plan = build_plan(scheme, spec=spec)
    return lambda nodal_grids: ct_transform_with_plan(
        nodal_grids, plan, spec=spec, device=device)


def make_ct_step(scheme, *, merge=None, fused=None, spec=None,
                 device=None) -> Callable:
    """``{ell: nodal}`` -> sparse-grid surplus on the common fine grid,
    with the scheme's plan built once and bound."""
    return _bind("make_ct_step", scheme, spec, merge, fused, device)


def make_ct_eval_step(scheme, *, merge=None, fused=None, spec=None,
                      device=None) -> Callable:
    """``({ell: nodal}, points (Q, d))`` -> combined-interpolant values
    (Q,): the transform followed by the hierarchical-basis evaluation."""
    from repro_torch.core.interpolation import interpolate_hierarchical
    transform = _bind("make_ct_eval_step", scheme, spec, merge, fused,
                      device)
    return lambda nodal_grids, points: interpolate_hierarchical(
        transform(nodal_grids), points)
