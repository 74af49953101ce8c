#!/usr/bin/env python3
"""Sweep ``row_gemm``'s row-major route on the CUDA card: the unroll of
its k loop (a compile-time constant) against its schedule (the wrapper's
TARGET_BLOCKS and MIN_PER_WARP), at the decode step's four projection
shapes of qwen2-0.5b (M = 4).

    python3 tools/row_gemm_tune.py [--unroll 8 16 32]

Each unroll builds a copy of ``csrc/row_gemm.cu`` into ``build/`` (one
``nvcc`` each, in parallel).  Every (unroll, target, min per warp) point
is checked against the wrapper's output (within 1e-5 of its scale; the
split of K changes the order of additions) and timed with CUDA events, L2
flushed (``chip_smoke.time_ms``); the summary ranks the points by their
time summed over one token step's 168 projections.  Prints the card's
name and power limit.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LOOP = re.compile(r"#pragma unroll \d+(\n\s*for \(int kk = kw_lo)")


def build_variant(unroll: int, build):
    """Start nvcc on a copy of the source whose k loop unrolls ``unroll``
    times; returns (library path, process)."""
    src = (build.CSRC / "row_gemm.cu").read_text()
    text, n = LOOP.subn(f"#pragma unroll {unroll}\\1", src)
    assert n == 1, "the row-major k loop was not found"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"row_gemm_u{unroll}.cu"
    cu.write_text(text)
    lib = cu.with_suffix(".so")
    return lib, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                                  str(lib), str(cu)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--unroll", type=int, nargs="+", default=[8, 16, 32])
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.kernels import build
    rg = importlib.import_module("repro_torch.kernels.row_gemm")

    fns = {}
    for unroll, (lib, proc) in [(u, build_variant(u, build))
                                for u in args.unroll]:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for unroll {unroll}")
        fn = ctypes.CDLL(str(lib)).row_gemm_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[unroll] = fn

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(name, k, n, per)
              for name, k, n, per, layout in cs.row_gemm_shapes(FULL)
              if layout == "kn"]
    defaults = (rg.TARGET_BLOCKS, rg.MIN_PER_WARP)
    per_step = {}
    try:
        for name, k, n, per in shapes:
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            x = torch.randn((4, k), generator=gen, device=dev)
            want = rg.row_gemm(x, w)
            for unroll, fn in fns.items():
                for target in (264, 528, 1056):
                    for mpw in (8, 16, 32):
                        rg.TARGET_BLOCKS, rg.MIN_PER_WARP = target, mpw
                        chunk, splits = rg.schedule(k, n)
                        out = torch.empty((4, n), device=dev)
                        ws = torch.empty(splits * 4 * n, device=dev)
                        cnt = build.arrival_counters(dev, -(-n // 128))

                        def call():
                            build.check(fn(
                                x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                ws.data_ptr(), cnt.data_ptr(), 4, k, n, n,
                                0, chunk, splits,
                                torch.cuda.current_stream().cuda_stream),
                                "row_gemm variant")

                        call()
                        torch.cuda.synchronize()
                        err = float((out - want).abs().max())
                        assert err <= 1e-5 * float(want.abs().max()), err
                        ms = cs.time_ms(call, flush, reps=9)
                        print(f"{name:8s} K={k} N={n} unroll={unroll} "
                              f"target={target} min/warp={mpw} "
                              f"chunk={chunk} splits={splits} ms={ms:.4f}")
                        key = (unroll, target, mpw)
                        per_step[key] = per_step.get(key, 0.0) + per * ms
    finally:
        rg.TARGET_BLOCKS, rg.MIN_PER_WARP = defaults
    print("one token step's 168 projections, ms (unroll, target, "
          "min/warp):")
    for key, ms in sorted(per_step.items(), key=lambda kv: kv[1]):
        print(f"  {key} {ms:.4f}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
