"""End-to-end LM training driver on the PyTorch/CUDA port: the twin of
``examples/train_lm.py`` on ``repro_torch.launch.train`` (deterministic
data pipeline, AdamW + cosine schedule, health monitor, atomic
checkpoints, row 10's backward kernels on the card).

Presets:
  --preset 100m   ~100M-param smollm-family model
  --preset 20m    ~20M params
  --preset smoke  seconds, CI-scale (runs on the CPU with --device cpu)

Run:  PYTHONPATH=src python examples_torch/train_lm.py --preset 20m --steps 200
      PYTHONPATH=src python examples_torch/train_lm.py --preset smoke \\
          --steps 20 --device cpu
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.config import ModelConfig


def preset_config(name: str) -> ModelConfig:
    base = get_config("smollm_360m")
    if name == "100m":
        # smollm-family, ~100M params (vocab padded): 12L x 768
        return base.replace(num_layers=12, d_model=768, num_heads=12,
                            num_kv_heads=4, head_dim=64, d_ff=2048,
                            vocab_size=32000, dtype="float32", remat=False)
    if name == "20m":
        return base.replace(num_layers=8, d_model=384, num_heads=6,
                            num_kv_heads=2, head_dim=64, d_ff=1024,
                            vocab_size=8192, dtype="float32", remat=False)
    if name == "smoke":
        return base.replace(num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=2, head_dim=16, d_ff=128,
                            vocab_size=512, dtype="float32", remat=False)
    raise ValueError(name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="20m",
                    choices=["100m", "20m", "smoke"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="results/train_lm_ckpt")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = preset_config(args.preset)
    print(f"preset={args.preset}: {cfg.param_count() / 1e6:.1f}M params")

    import repro_torch.launch.train as T

    orig_smoke = T.get_smoke_config
    T.get_smoke_config = lambda arch: cfg    # inject the preset config
    try:
        tc = TrainConfig(arch="smollm_360m", smoke=True, steps=args.steps,
                         seq_len=args.seq_len,
                         global_batch=args.global_batch,
                         peak_lr=args.lr,
                         warmup_steps=max(10, args.steps // 10),
                         checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=max(20, args.steps // 5),
                         log_every=10, device=args.device)
        res = train(tc)
    finally:
        T.get_smoke_config = orig_smoke

    steps = sorted(res.losses)
    k = max(1, len(steps) // 10)
    first = sum(res.losses[s] for s in steps[:k]) / k
    last = sum(res.losses[s] for s in steps[-k:]) / k
    for s in steps[:: max(1, len(steps) // 20)]:
        print(f"step {s:5d}  loss {res.losses[s]:.4f}")
    print(f"\nfirst-{k} mean loss {first:.4f} -> last-{k} mean loss "
          f"{last:.4f}  (rollbacks: {res.rollbacks})")
    assert last < first, "loss did not improve"
    print("OK")


if __name__ == "__main__":
    main()
