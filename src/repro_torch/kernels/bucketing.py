"""Geometric shape-bucket ladder (from ``repro/kernels/bucketing.py``).

``seq_bucket`` is the sequence-length ladder ``base * 2^k`` (default base
16).  ``models.layers.blockwise_attention`` snaps its block sizes to it,
never to the raw S/T, so right-padding a sequence inside its bucket
partitions it into the same blocks, and the compiled forward pads a
batch's sequences to it (``seq_ladder`` is what ``warmup()`` captures).
The reference's ``row_bucket`` is not needed: the port's quantized-matmul
kernels mask the ragged M edge themselves and pad nothing.
"""

from __future__ import annotations

from typing import Tuple

DEFAULT_SEQ_BASE = 16


def next_geometric(n: int, base: int, ratio: int = 2) -> int:
    """Smallest ``base * ratio^k`` (k >= 0) that is >= ``n``."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    if base < 1 or ratio < 2:
        raise ValueError(f"need base >= 1, ratio >= 2, got {base}/{ratio}")
    b = base
    while b < n:
        b *= ratio
    return b


def seq_bucket(s: int, base: int = DEFAULT_SEQ_BASE, ratio: int = 2) -> int:
    """The sequence-length bucket serving pads ``s`` up to."""
    return next_geometric(s, base, ratio)


def seq_ladder(max_s: int, base: int = DEFAULT_SEQ_BASE,
               ratio: int = 2) -> Tuple[int, ...]:
    """Every bucket up to (and including) the one covering ``max_s``:
    what ``warmup()`` captures."""
    out, b = [], base
    top = next_geometric(max_s, base, ratio)
    while b <= top:
        out.append(b)
        b *= ratio
    return tuple(out)
