"""Deterministic synthetic LM data (a numpy copy of the reference's
``MarkovLMDataset`` in ``repro/data/synthetic.py``).

Tokens follow a low-entropy first-order Markov chain; ``batch_at(step)``
is a pure function of (table seed, step, host), so the port and the
reference draw the same request tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


def _chain(vocab: int, branching: int, seed: int) -> np.ndarray:
    """Transition table: each token can be followed by `branching` tokens."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branching), dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class MarkovLMConfig:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-host batch
    branching: int = 4         # successors per token (entropy = log2(b) bits)
    table_seed: int = 1234     # the "language" (fixed across hosts/steps)


class MarkovLMDataset:
    """Stateless batch generator: ``batch_at(step)`` is pure."""

    def __init__(self, cfg: MarkovLMConfig, host_id: int = 0,
                 num_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.table = _chain(cfg.vocab_size, cfg.branching, cfg.table_seed)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (step * self.num_hosts + self.host_id) * 2654435761 % (2 ** 63))
        b, s = cfg.batch_size, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        choices = rng.integers(0, cfg.branching, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self.table[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
