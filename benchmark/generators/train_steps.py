"""Training traffic: every step a new batch of ``rows_per_step`` sequences
of ``seq + 1`` uniform token ids, drawn on the device from the run's seed
and the step's index, so that no two steps and no two rows repeat.

A traffic file of this kind holds ``{"generator": "train_steps", "seq":
..., "rows_per_step": ...}``.
"""

from __future__ import annotations

import torch

from benchmark import weights


class Feed:
    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        self.rows = int(traffic["rows_per_step"])
        self.seq = int(traffic["seq"])
        self.vocab, self.seed, self.device = vocab, seed, device

    @property
    def tokens_per_step(self) -> int:
        return self.rows * self.seq

    def batch(self, step: int) -> torch.Tensor:
        """Step ``step``'s tokens [rows, seq + 1] (int64)."""
        return weights.tokens(self.seed, "train", step,
                              (self.rows, self.seq + 1), self.vocab,
                              self.device)
