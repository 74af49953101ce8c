"""Deterministic synthetic data (numpy copies of the reference's
``MarkovLMDataset`` and ``CaptionProxyDataset`` in
``repro/data/synthetic.py``).

Tokens follow a low-entropy first-order Markov chain; captions are a
fixed table per "image" with 10 % noise, beside fixed random visual
embeddings.  ``batch_at(step)`` is a pure function of (table seed, step,
host) drawn from numpy streams alone, so the port and the reference draw
the same batches bit for bit.
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


@dataclasses.dataclass(frozen=True)
class CaptionProxyConfig:
    vocab_size: int
    seq_len: int               # caption length
    d_model: int               # visual embedding width
    n_vis: int                 # visual tokens per sample
    batch_size: int
    n_images: int = 4096       # distinct "images"
    table_seed: int = 77


class CaptionProxyDataset:
    """(visual embeds, caption tokens) pairs with a deterministic mapping.

    Caption token t of image i is ``captions[i, t]`` with 10 % noise: a
    captioner must use the visual embedding, so its quality degrades
    measurably when the agent-side stages are quantized too hard.
    """

    def __init__(self, cfg: CaptionProxyConfig, host_id: int = 0,
                 num_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        rng = np.random.default_rng(cfg.table_seed)
        self.captions = rng.integers(
            0, cfg.vocab_size, size=(cfg.n_images, cfg.seq_len),
            dtype=np.int32)
        # visual embeddings: fixed random per image, unit-ish scale
        self.vis_basis = rng.normal(
            0, 1, size=(cfg.n_images, cfg.n_vis, cfg.d_model)
        ).astype(np.float32) / np.sqrt(cfg.d_model)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (step * self.num_hosts + self.host_id) * 1099511628211
            % (2 ** 63))
        ids = rng.integers(0, cfg.n_images, size=cfg.batch_size)
        caps = self.captions[ids].copy()
        noise = rng.random(caps.shape) < 0.1
        caps[noise] = rng.integers(0, cfg.vocab_size, size=int(noise.sum()))
        # teacher forcing: inputs are BOS-shifted, so position t predicts
        # caption[t] from the image and caption[<t]
        bos = np.zeros((cfg.batch_size, 1), np.int32)
        tokens = np.concatenate([bos, caps[:, :-1]], axis=1)
        return {"image_id": ids.astype(np.int32),
                "embeds": self.vis_basis[ids],
                "tokens": tokens,
                "labels": caps}

    def references(self, ids: np.ndarray) -> np.ndarray:
        """Ground-truth captions for CIDEr-style scoring."""
        return self.captions[ids]
