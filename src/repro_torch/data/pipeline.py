"""Deterministic synthetic token pipeline, host-sharded.

Port of ``repro.data.pipeline``: batch ``i`` of host ``h`` is a pure
function of (seed, step, host), drawn with the reference's numpy
generator, so tokens and labels are the reference's bit for bit.  Batches
are int64 tensors on the pipeline's device (default CUDA); the stream has
no state to checkpoint, and a run restored at step ``s`` resumes it
exactly.

The generator is a mixture of Zipf-distributed unigrams with Markov
bigram structure, so losses move during training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["DataConfig", "SyntheticLM", "host_shard_slice"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0


def host_shard_slice(global_batch: int, num_hosts: int, host_index: int):
    per = global_batch // num_hosts
    return slice(host_index * per, (host_index + 1) * per)


class SyntheticLM:
    """Deterministic synthetic LM stream: next-token = f(current token)."""

    def __init__(self, cfg: DataConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed random permutation as the "grammar": strongly predictable
        self._next_tok = rng.permutation(v).astype(np.int32)
        zipf = 1.0 / np.arange(1, v + 1)
        self._unigram = (zipf / zipf.sum()).astype(np.float64)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng((cfg.seed, step, cfg.host_index))
        starts = rng.choice(cfg.vocab_size, size=(per_host,), p=self._unigram)
        seqs = np.empty((per_host, cfg.seq_len + 1), np.int32)
        seqs[:, 0] = starts
        noise = rng.random((per_host, cfg.seq_len))
        for t in range(cfg.seq_len):
            follow = self._next_tok[seqs[:, t]]
            rand = rng.integers(0, cfg.vocab_size, per_host)
            seqs[:, t + 1] = np.where(noise[:, t] < 0.8, follow, rand)
        seqs = torch.from_numpy(seqs.astype(np.int64)).to(self.device)
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
