"""Deterministic synthetic LM data (port of ``repro/data/synthetic.py``).

Stream properties, as in the reference:

* **step-seeded**: ``batch_at(step)`` draws every batch from a generator
  seeded by ``(seed, step)``, so a restarted job regenerates the identical
  stream with no iterator state;
* **learnable structure**: Zipf-distributed unigrams + Markov bigram chains
  + induction segments (a random motif repeated later in the sequence).

The numbers come from a ``torch.Generator`` on the stream's device, so the
stream is not the reference's bit for bit (nor the same on the CPU and on
the card); tests that compare the two packages feed both the same
numpy-made batches.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["SyntheticConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    motif_len: int = 16
    zipf_a: float = 1.2
    n_bigram_states: int = 64


class SyntheticLM:
    def __init__(self, cfg: SyntheticConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        V = cfg.vocab_size
        gen = self._generator(cfg.seed + 1)
        # fixed random bigram table: state -> preferred successor
        self.bigram_next = torch.randint(
            0, V, (min(cfg.n_bigram_states, V),), generator=gen,
            device=self.device)
        # Zipf weights over the vocab
        ranks = torch.arange(1, V + 1, dtype=torch.float64,
                             device=self.device)
        self.zipf_probs = ranks ** -cfg.zipf_a

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        gen = self._generator(cfg.seed * 1_000_003 + step)
        B, T = cfg.batch, cfg.seq_len + 1
        dev = self.device
        toks = torch.multinomial(self.zipf_probs, B * T, replacement=True,
                                 generator=gen).reshape(B, T)
        # bigram chains: with p=0.5, next token = table[prev % states]
        gates = torch.rand((B, T), generator=gen, device=dev) < 0.5
        S = self.bigram_next.shape[0]
        prev = toks[:, 0]
        cols = []
        for t in range(T):
            prev = torch.where(gates[:, t], self.bigram_next[prev % S],
                               toks[:, t])
            cols.append(prev)
        toks = torch.stack(cols, dim=1)
        # induction motif: copy a motif to a later position in each row
        M = min(cfg.motif_len, T // 4)
        src = torch.randint(0, T // 2 - M, (B,), generator=gen, device=dev)
        dst = torch.randint(T // 2, T - M, (B,), generator=gen, device=dev)
        idx = torch.arange(T, device=dev)[None, :]
        in_dst = (idx >= dst[:, None]) & (idx < (dst + M)[:, None])
        src_idx = torch.clamp(idx - dst[:, None] + src[:, None], 0, T - 1)
        motif = torch.gather(toks, 1, src_idx)
        toks = torch.where(in_dst, motif, toks).to(torch.int32)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}

    def batches(self, start_step: int, n: int):
        for s in range(start_step, start_step + n):
            yield self.batch_at(s)
