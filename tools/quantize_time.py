#!/usr/bin/env python3
"""Device time of ``group_quantize`` for one configure of qwen2-0.5b.

    python3 tools/quantize_time.py

Runs ``chip_smoke.check_group_quantize``: both routes against the plain
version (main-path shapes, a ragged column tile, SIMT shapes; codes,
scales and packed nibbles equal), then one configure's 42 matrices
(7 per agent layer x 6, G = 128) timed as the one grouped launch of the
vector route, as one vector launch per matrix, and as the first design's
kernel (the SIMT route) launched per matrix, beside the plain version and
the byte bound.  CUDA events, L2 flushed before each timed call
(``chip_smoke.time_ms``).  Prints the card line.  Needs a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.device import set_float32_numerics
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    set_float32_numerics()
    build.build_all(("group_quantize",), verbose=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    row = cs.check_group_quantize(FULL, dev, flush)
    print(row)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
