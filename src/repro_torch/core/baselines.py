"""Benchmark schemes of paper §VI-C (port of ``repro/core/baselines.py``).

  1) PPO-based design  — PPO-clip on a tabular softmax policy over a
     discretized (b_hat, f, f~) grid with penalty-driven constraints.
  2) Fixed-frequency   — f = f_max, f~ = f~_max; only b_hat is optimized.
  3) Feasible random   — 400 bit-widths drawn uniformly, the feasible ones
     kept (frequencies optimized per trial), all of them reported.

Every scheme returns :class:`repro_torch.core.codesign.CodesignSolution`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .codesign import (CodesignSolution, _pack, distortion_gap,
                       feasible_bitwidth)
from .cost_model import SystemParams, total_delay, total_energy


def solve_fixed_frequency(lam: float, p: SystemParams, t0: float, e0: float,
                          b_max: int = 16) -> Optional[CodesignSolution]:
    """Max frequencies, bit-width is the only knob."""
    f, fs = p.f_max, p.f_server_max
    for b_hat in range(b_max, 0, -1):
        t = float(total_delay(b_hat, f, fs, p))
        e = float(total_energy(b_hat, f, fs, p))
        if t <= t0 * (1 + 1e-9) and e <= e0 * (1 + 1e-9):
            return _pack(b_hat, f, fs, lam, p)
    return None


def solve_feasible_random(lam: float, p: SystemParams, t0: float, e0: float,
                          b_max: int = 16, trials: int = 400,
                          seed: int = 0) -> List[CodesignSolution]:
    """The paper's 400-trial random scheme; returns every feasible trial
    (the reference's ``np.random.default_rng(seed)`` stream)."""
    rng = np.random.default_rng(seed)
    out: List[CodesignSolution] = []
    for _ in range(trials):
        b_hat = int(rng.integers(1, b_max + 1))
        ok, f, fs, _ = feasible_bitwidth(b_hat, p, t0, e0)
        if ok:
            out.append(_pack(b_hat, f, fs, lam, p))
    return out


def solve_ppo(lam: float, p: SystemParams, t0: float, e0: float,
              b_max: int = 16, n_f: int = 8, n_fs: int = 8,
              iters: int = 300, batch: int = 64, lr: float = 0.15,
              clip: float = 0.2, penalty: float = 50.0,
              seed: int = 0) -> Optional[CodesignSolution]:
    """PPO-clip over the discretized joint action space.

    Reward = -gap(b_hat) minus a penalty proportional to relative
    constraint violation; tabular softmax policy, advantage = reward -
    running mean, one clipped surrogate ascent step per iteration.
    """
    rng = np.random.default_rng(seed)
    f_grid = np.linspace(p.f_max / n_f, p.f_max, n_f)
    fs_grid = np.linspace(p.f_server_max / n_fs, p.f_server_max, n_fs)
    n_actions = b_max * n_f * n_fs
    logits = np.zeros(n_actions)

    def decode(a: int):
        b_hat = a // (n_f * n_fs) + 1
        rem = a % (n_f * n_fs)
        return b_hat, f_grid[rem // n_fs], fs_grid[rem % n_fs]

    def reward(a: int) -> float:
        b_hat, f, fs = decode(a)
        t = float(total_delay(b_hat, f, fs, p))
        e = float(total_energy(b_hat, f, fs, p))
        viol = max(0.0, t / t0 - 1.0) + max(0.0, e / e0 - 1.0)
        return -distortion_gap(b_hat, lam) * lam - penalty * viol

    baseline_r = 0.0
    for it in range(iters):
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        acts = rng.choice(n_actions, size=batch, p=probs)
        rs = np.array([reward(a) for a in acts])
        if it == 0:
            baseline_r = rs.mean()
        adv = rs - baseline_r
        baseline_r = 0.9 * baseline_r + 0.1 * rs.mean()
        old_probs = probs[acts]
        new_probs_all = np.exp(logits - logits.max())
        new_probs_all /= new_probs_all.sum()
        ratio = new_probs_all[acts] / np.maximum(old_probs, 1e-12)
        use = np.where((adv >= 0) & (ratio > 1 + clip) |
                       (adv < 0) & (ratio < 1 - clip), 0.0, 1.0)
        grad = np.zeros_like(logits)
        for a, ad, u in zip(acts, adv, use):
            if u == 0.0:
                continue
            # d log pi(a) / d logits = e_a - probs
            grad += ad * (np.eye(1, n_actions, a)[0] - new_probs_all)
        logits += lr * grad / batch

    # greedy action from the trained policy; report only if feasible
    for a in np.argsort(-logits):
        b_hat, f, fs = decode(int(a))
        t = float(total_delay(b_hat, f, fs, p))
        e = float(total_energy(b_hat, f, fs, p))
        if t <= t0 * (1 + 1e-9) and e <= e0 * (1 + 1e-9):
            return _pack(b_hat, f, fs, lam, p)
    return None
