#!/usr/bin/env python3
"""The eager served forward's wall on the CUDA card, for comparing two
trees of the port (a parent commit's and a change's) in one call.

    python3 tools/forward_wall.py [--src SRC_DIR]

Imports ``repro_torch`` from ``SRC_DIR`` (default: this checkout's
``src``; unpack a parent with ``git archive <commit> src | tar -x -C
build/parent`` and pass ``build/parent/src``), builds its kernels, and
serves qwen2-0.5b ``FULL`` (seeded random weights) through
``CoInferenceEngine(path="kernel")`` at b̂ = 8 and b̂ = 4: 4 requests x 64
tokens as one batch, 3 warm-up forwards then 20 timed (host clock around
work that ends in ``torch.cuda.synchronize``), eagerly and from the
forward's CUDA graph (``compiled=True``).  Prints the median and the
least wall per operating point, and for the graph the device time, busy
share and the products' share of the device time over 5 traced replays
(``torch.profiler``: the split forward's float32 products, cuBLAS's
kernels or ``tc_gemm``'s, apart from the agent's ``qmm``; every kernel
is listed by name with its device ms a forward), with the card's name and
power limit.  Run parent, change, change, parent in one
call: only walls taken on one card compare.

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
    for mode in ("eager", "graph"):
        eng = CoInferenceEngine(model, params, sysp, path="kernel",
                                compiled=mode == "graph")
        for b_hat in (8, 4):
            eng.configure(b_hat)

            def serve():
                eng.serve_batch({"tokens": tokens})
            for _ in range(3):
                serve()
            walls = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            line = (f"forward_wall src={src} b_hat={b_hat} {b}x{s} {mode} "
                    f"serve_batch wall ms median="
                    f"{statistics.median(walls):.3f} min={min(walls):.3f}")
            if mode == "graph":
                line += "; " + traced(serve, torch)
            print(f"{line} ({card})")
        del eng
    return 0


def is_product(name: str) -> bool:
    """A kernel of the split forward's float32 products: ``tc_gemm``'s
    (and its split-K ``tc_gemm_combine``) or cuBLAS's (its GEMMs and
    their split-K reduce, ``cublasLt::splitKreduce_kernel``); not
    ``qmm`` or ``row_gemm``."""
    low = name.lower()
    if "qmm" in low or "row_gemm" in low:
        return False
    return any(key in low for key in ("tc_gemm", "gemm", "xmma", "cutlass",
                                      "nvjet", "cublas", "splitkreduce"))


def traced(fn, torch, n: int = 5) -> str:
    """Device ms, busy share and the products' share of ``n`` calls of
    ``fn`` under ``torch.profiler`` (kernels' own device time); first
    prints every kernel with its device ms a call and whether it is
    counted a product, the largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        rows.append((us, e.count, e.key))
    dev_us = sum(us for us, _, _ in rows)
    prod_us = sum(us for us, _, key in rows if is_product(key))
    for us, calls, key in sorted(rows, reverse=True):
        print(f"  kernel {us / 1e3 / n:9.4f} ms {calls // n:4d}x "
              f"{'product' if is_product(key) else 'other  '} {key[:110]}")
    if not dev_us:
        return f"traced wall {wall:.3f} ms, device time not measured"
    dev = dev_us / 1e3 / n
    return (f"traced wall {wall:.3f} ms, device {dev:.3f} ms "
            f"({dev / wall:.1%} busy), products {prod_us / 1e3 / n:.3f} ms "
            f"({prod_us / dev_us:.1%} of the device time)")


if __name__ == "__main__":
    sys.exit(main())
