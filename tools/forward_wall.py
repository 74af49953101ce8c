#!/usr/bin/env python3
"""The eager served forward's wall on the CUDA card, for comparing two
trees of the port (a parent commit's and a change's) in one call.

    python3 tools/forward_wall.py [--src SRC_DIR]

Imports ``repro_torch`` from ``SRC_DIR`` (default: this checkout's
``src``; unpack a parent with ``git archive <commit> src | tar -x -C
build/parent`` and pass ``build/parent/src``), builds its kernels, and
serves qwen2-0.5b ``FULL`` (seeded random weights) through
``CoInferenceEngine(path="kernel")`` at b̂ = 8 and b̂ = 4: 4 requests x 64
tokens as one batch, eagerly, 3 warm-up forwards then 20 timed (host
clock around work that ends in ``torch.cuda.synchronize``).  Prints the
median and the least wall per operating point, with the card's name and
power limit.  Run parent, change, change, parent in one call: only
walls taken on one card compare.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.configs.qwen2_0_5b import FULL as cfg
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.device import set_float32_numerics
    from repro_torch.kernels import build
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CoInferenceEngine
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    build.build_all()
    set_float32_numerics()
    dev = torch.device("cuda")
    b, s = 4, 64
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * b * s,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * b * s)
    tokens = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=s, batch_size=b)).batch_at(0)[
            "tokens"]
    eng = CoInferenceEngine(model, params, sysp, path="kernel")
    for b_hat in (8, 4):
        eng.configure(b_hat)
        for _ in range(3):
            eng.serve_batch({"tokens": tokens})
        walls = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve_batch({"tokens": tokens})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"forward_wall src={src} b_hat={b_hat} {b}x{s} eager "
              f"serve_batch wall ms median={statistics.median(walls):.3f} "
              f"min={min(walls):.3f} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
