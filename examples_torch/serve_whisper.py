"""Serve the encoder-decoder family on the PyTorch/CUDA port: ``whisper_small``
with random weights from a seed, a batch of prompts decoded greedily over
stub audio frames (``repro_torch.launch.serve.generate``: the frames
encoded once into the decode cache's cross-attention entry, then token by
token), and the same prompts' prefill logits checked against the decode's.

Run:  PYTHONPATH=src python examples_torch/serve_whisper.py --device cpu
      PYTHONPATH=src python examples_torch/serve_whisper.py --full
(the smoke config on the CPU; ``--full`` the published widths and depth,
on the card).
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import ServeConfig, generate
from repro_torch.models import model as M
from repro_torch.models.transformer import init_params

ARCH = "whisper_small"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="the published config (on the card)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(ARCH) if args.full else get_smoke_config(ARCH)
    model = init_params(cfg, seed=0, device=args.device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    sc = ServeConfig(arch=ARCH, smoke=not args.full,
                     max_new_tokens=args.max_new_tokens)
    out = generate(sc, prompts, params=model)
    print(f"{ARCH}: {cfg.encoder_layers} + {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.encoder_seq} stub frames; generated "
          f"{out['tokens'].shape}, mean logprob "
          f"{float(out['logprobs'].mean()):.4f}")

    # the decode cache against the prefill on the same frames
    gen = torch.Generator(device=model.device)
    gen.manual_seed(1)
    audio = (torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device=model.device) * 0.02).to(
        getattr(torch, cfg.dtype))
    tokens = torch.from_numpy(prompts).to(model.device)
    want = M.prefill_step(model, cfg, {"tokens": tokens,
                                       "audio_embeds": audio}).float()
    cache = M.init_decode_cache(cfg, args.batch, args.prompt_len,
                                device=model.device)
    cache["cross"] = M.encode_for_decode(model, cfg, audio)
    got = torch.stack([M.serve_step(model, cfg, cache, {
        "token": tokens[:, p:p + 1], "pos": p})[0][:, 0].float()
        for p in range(args.prompt_len)], dim=1)
    err = float((got - want).abs().max())
    print(f"decode against prefill: max abs diff {err:.3g} "
          f"(|logits| up to {float(want.abs().max()):.3g})")
    print("OK")


if __name__ == "__main__":
    main()
