"""Training driver: the fault-tolerant loop of the LM (every family).

Port of ``repro.launch.train``.  It wires together the data pipeline
(deterministic addressing: ``data.pipeline.SyntheticLM``), the train step
(``launch.steps.make_train_step``: loss, row 10's backward kernels,
clipping, AdamW on a warmup-cosine schedule), the health monitor
(``runtime.fault_tolerance.HealthMonitor``: NaN, loss spike, straggler),
atomic checkpoints every ``checkpoint_every`` steps
(``checkpoint.checkpoint``; bf16 leaves included) and rollback to the last
good checkpoint, skipping the poisoned range of the data stream, or resume
from the latest checkpoint.

The reference jits its step on a device mesh; the port runs it eagerly on
one device (``TrainConfig.device``, default CUDA; ``"cpu"`` for the tests)
and updates the parameters in place.  The encdec and vlm families get
their stub frontends every step, as the reference's loop gives them
(``stub_frontends``: ``audio_embeds`` or ``patch_embeds``, normal times
0.02 in the model's type, from a ``torch.Generator`` seeded by the run's
seed and the step; the reference folds the step into its key, so the
draws differ).  The moe family's loss is ``loss_fn``'s, its aux loss
dropped as in the reference.  A checkpoint holds the
train state under the reference's names and layout
(``convert.stack_by_reference_key``: ``0/segments/0/attn/wq`` a stacked
leaf, ``1/m/...`` AdamW's first moments), so the reference's
manifest-driven restore reads it.  ``train`` takes an optional initial
state, so a run can start from given weights (the tests start it from
the reference's).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import (latest_step, restore_checkpoint,
                                               save_checkpoint)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import (stack_by_reference_key,
                                 unstack_by_reference_key)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.fault_tolerance import HealthConfig, HealthMonitor

__all__ = ["TrainConfig", "TrainResult", "train", "model_config",
           "stub_frontends"]


@dataclass(frozen=True)
class TrainConfig:
    arch: str = "smollm_360m"
    smoke: bool = True               # reduced config (CPU); False = published
    steps: int = 50
    seq_len: int = 64
    global_batch: int = 8
    peak_lr: float = 1e-3
    warmup_steps: int = 20
    grad_clip: float = 1.0
    grad_accum: int = 1
    seed: int = 0
    # fault tolerance
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 20
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    max_rollbacks: int = 3
    log_every: int = 10
    # test hooks
    loss_poison_step: Optional[int] = None    # inject a NaN at this step
    # the port's own: the device (None: CUDA; "cpu" for the tests)
    device: Optional[str] = None


@dataclass
class TrainResult:
    losses: Dict[int, float]
    final_step: int
    rollbacks: int
    events: list
    params: object = None
    opt_state: object = None


def model_config(tc: TrainConfig) -> ModelConfig:
    """The architecture's config as ``tc`` trains it: the smoke one or the
    published one (which rematerialises every layer, ``"full"``)."""
    return get_smoke_config(tc.arch) if tc.smoke else get_config(tc.arch)


def stub_frontends(cfg: ModelConfig, batch_size: int, seed: int, step: int,
                   device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s stub frontend inputs: ``audio_embeds`` (B,
    encoder_seq, d) for encdec, ``patch_embeds`` (B, vision_patches, d)
    for vlm, nothing for dense; normal times 0.02 in the model's type."""
    n = {"encdec": cfg.encoder_seq, "vlm": cfg.vision_patches}.get(
        cfg.family)
    if n is None:
        return {}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + step)
    x = torch.randn((batch_size, n, cfg.d_model), generator=gen,
                    device=device) * 0.02
    name = "audio_embeds" if cfg.family == "encdec" else "patch_embeds"
    return {name: x.to(getattr(torch, cfg.dtype))}


def _host_stack(ts):
    return torch.stack([t.detach().cpu() for t in ts])


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _ckpt_tree(params: LM, opt: AdamWState, *, template: bool = False):
    """The train state as its checkpoint holds it, under the reference's
    key paths: ``({key: leaf}, AdamWState(step, {key: m}, {key: v}))``,
    each layer stack's leaves stacked on the host; with ``template`` the
    same tree of ``meta`` tensors (a restore's template)."""
    if template:
        stack = lambda ts: torch.empty((len(ts),) + tuple(ts[0].shape),
                                       dtype=ts[0].dtype, device="meta")
        leaf = _meta
    else:
        stack, leaf = _host_stack, lambda t: t
    ref = lambda named: stack_by_reference_key(named, stack, leaf)
    return (ref(dict(params.named_parameters())),
            AdamWState(leaf(opt.step), ref(opt.m), ref(opt.v)))


def _restore(directory: str, step: int, params: LM,
             opt: AdamWState) -> AdamWState:
    """Checkpoint ``step`` into ``params`` (in place); returns its
    optimizer state (each moment a view of its stacked leaf)."""
    (named, ropt), _ = restore_checkpoint(
        directory, step, _ckpt_tree(params, opt, template=True),
        device=params.device)
    with torch.no_grad():
        restored = unstack_by_reference_key(
            named, [n for n, _ in params.named_parameters()])
        for n, p in params.named_parameters():
            p.copy_(restored[n])
    return AdamWState(ropt.step, unstack_by_reference_key(ropt.m, opt.m),
                      unstack_by_reference_key(ropt.v, opt.v))


def train(tc: TrainConfig, *,
          state: Optional[Tuple[LM, AdamWState]] = None
          ) -> TrainResult:
    cfg = model_config(tc)
    device = resolve_device(tc.device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=tc.seq_len,
                                  global_batch=tc.global_batch,
                                  seed=tc.seed), device=device)
    step_fn = make_train_step(
        cfg, warmup_cosine(tc.peak_lr, tc.warmup_steps, tc.steps),
        grad_clip=tc.grad_clip, grad_accum=tc.grad_accum)
    monitor = HealthMonitor(tc.health)

    # ---- resume or init ----
    params, opt = state if state is not None else init_train_state(
        cfg, seed=tc.seed, device=device)
    start = 0
    if tc.checkpoint_dir:
        last = latest_step(tc.checkpoint_dir)
        if last is not None:
            opt = _restore(tc.checkpoint_dir, last, params, opt)
            start = last

    losses: Dict[int, float] = {}
    rollbacks = 0
    last_good = start
    step = start
    while step < tc.steps:
        t0 = time.time()
        batch = data.batch(step)
        batch.update(stub_frontends(cfg, tc.global_batch, tc.seed, step,
                                    device))
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        if tc.loss_poison_step is not None and step == tc.loss_poison_step:
            loss = float("nan")   # simulated bad node / bit flip
        verdict = monitor.observe(loss, time.time() - t0)

        if verdict.rollback:
            rollbacks += 1
            if not tc.checkpoint_dir or rollbacks > tc.max_rollbacks:
                raise RuntimeError(
                    f"unrecoverable bad step at {step}: {verdict.reason}")
            opt = _restore(tc.checkpoint_dir, last_good, params, opt)
            # deterministic pipeline: skip the poisoned data range
            step = last_good + 1 if tc.loss_poison_step != last_good \
                else last_good + 2
            if tc.loss_poison_step is not None and step <= tc.loss_poison_step:
                step = tc.loss_poison_step + 1
            continue

        losses[step] = loss
        step += 1
        if tc.checkpoint_dir and step % tc.checkpoint_every == 0:
            save_checkpoint(tc.checkpoint_dir, step, _ckpt_tree(params, opt),
                            metadata={"arch": tc.arch, "loss": loss})
            last_good = step

    return TrainResult(losses=losses, final_step=step, rollbacks=rollbacks,
                       events=monitor.events, params=params, opt_state=opt)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    tc = TrainConfig(arch=args.arch, steps=args.steps, seq_len=args.seq_len,
                     global_batch=args.global_batch,
                     checkpoint_dir=args.ckpt_dir,
                     smoke=not args.full_config, device=args.device)
    res = train(tc)
    ls = sorted(res.losses)
    print(f"steps={res.final_step} first_loss={res.losses[ls[0]]:.4f} "
          f"last_loss={res.losses[ls[-1]]:.4f} rollbacks={res.rollbacks}")


if __name__ == "__main__":
    main()
