"""Deterministic, resumable synthetic token pipeline, in PyTorch: the port
of ``repro/data/pipeline.py``.

Batches are a pure function of (seed, step): the reference's numpy
``RandomState`` stream, drawn in the same order, so tokens, targets, stub
image embeddings and frames are bit-equal to the reference's.  Recovery
just sets the step counter.  The token stream has learnable structure (a
noisy affine bigram process) so smoke training shows decreasing loss.
The tensors land on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1            # fraction of random next-tokens
    frontend_tokens: int = 0      # VLM/audio stub embeddings
    frontend_dim: int = 0
    encoder_decoder: bool = False


def batch_at(cfg: DataConfig, step: int,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Batch for one step; identical for identical (cfg, step)."""
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % 2 ** 31)
    V = cfg.vocab_size
    a = 31 % V or 1
    c = 17 % V
    B, S = cfg.global_batch, cfg.seq_len
    toks = np.empty((B, S + 1), np.int32)
    toks[:, 0] = rng.randint(0, V, B)
    noise = rng.rand(B, S) < cfg.noise
    rand_next = rng.randint(0, V, (B, S))
    for t in range(S):
        nxt = (toks[:, t] * a + c) % V
        toks[:, t + 1] = np.where(noise[:, t], rand_next[:, t], nxt)
    arrays = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend_tokens:
        arrays["frontend_embeds"] = rng.randn(
            B, cfg.frontend_tokens, cfg.frontend_dim).astype(np.float32)
    if cfg.encoder_decoder:
        arrays["frames"] = rng.randn(B, S, cfg.frontend_dim).astype(
            np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def stream(cfg: DataConfig, start_step: int = 0,
           device="cuda") -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step, device)
        step += 1
