#!/usr/bin/env python3
"""Measurements behind the tensor-core qmm kernel's tuning, on the card.

    python3 tools/qmm_tune.py            # both
    python3 tools/qmm_tune.py --splits   # split-K sweep
    python3 tools/qmm_tune.py --clock    # cycles per pipeline stage

``--splits`` times ``csrc/qmm.cu``'s tensor-core kernel at each main-path
shape of qwen2-0.5b (G = 128, int8 codes) at M = 64 and M = 256 for every
split count of K, with CUDA events and L2 flushed (``chip_smoke.time_ms``),
beside the count ``qmm.splits`` picks; ``qmm.splits`` was set from it.

``--clock`` builds the kernel once more with ``-DQMM_STAGE_CLOCK`` (into
``build/kernels/``, apart from the port's library) and prints, for one
block of the down projection (K = 4864, N = 896, no split), the median
cycles of each part of a 64-deep stage: issuing the 12 wgmmas, converting
the next codes, waiting for the wgmmas, promoting, splitting the next x,
the barrier, the refill's TMA copies, and back to the loop's head.

Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))
PARTS = ("issue", "convert", "wait", "promote", "split", "barrier", "tma",
         "loop")


def _case(k, n, m, dev):
    import torch
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(k + n + m)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    codes, scales = ref.group_quantize_ref(w, 128, 8)
    x = torch.randn((m, k), generator=gen, device=dev)
    return x, codes, scales


def sweep_splits(dev) -> None:
    import torch
    from chip_smoke import time_ms
    from repro_torch.kernels import build, ref
    q = importlib.import_module("repro_torch.kernels.qmm")
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    counters = build.arrival_counters(dev, 4096)
    sms = q._sm_count(dev.index or 0)
    for k, n in SHAPES:
        for m in (64, 256):
            x, codes, scales = _case(k, n, m, dev)
            out = torch.empty((m, n), device=dev)
            want = ref.qmm_ref(x, codes, scales)
            times = []
            for s in range(1, min(k // 128, 16) + 1):
                ws = torch.empty((s, m, n), device=dev)

                def call(s=s, ws=ws):
                    status = q._entry("qmm_wgmma_f32")(
                        x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                        m, k, n, 128, s,
                        torch.cuda.current_stream().cuda_stream)
                    assert status == 0, status
                call()
                torch.cuda.synchronize()
                torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
                times.append((s, time_ms(call, flush) * 1e3))
            best = min(times, key=lambda t: t[1])[0]
            print(f"K={k} N={n} M={m}: " + " ".join(
                f"{s}:{t:.1f}" for s, t in times) + f" us; fastest {best}, "
                f"qmm.splits {q.splits(k, n, 128, sms)}", flush=True)


def stage_clock(dev) -> None:
    import torch
    from repro_torch.kernels import build
    out_so = build.BUILD_DIR / "qmm-stage-clock.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DQMM_STAGE_CLOCK",
                    "-o", str(out_so), str(build.CSRC / "qmm.cu")],
                   check=True)
    fn = ctypes.CDLL(str(out_so)).qmm_wgmma_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k, n = 4864, 896
    for m in (1, 256):
        x, codes, scales = _case(k, n, m, dev)
        out = torch.empty((m, n), device=dev)
        stamps = torch.zeros((16, 8), dtype=torch.int64, device=dev)
        for _ in range(3):
            status = fn(x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                        out.data_ptr(), None, stamps.data_ptr(), m, k, n,
                        128, 1, torch.cuda.current_stream().cuda_stream)
            assert status == 0, f"cudaError_t {status}"
        torch.cuda.synchronize()
        t = stamps.cpu().tolist()
        rows = [[t[i][j + 1] - t[i][j] for j in range(7)]
                + [t[i + 1][0] - t[i][7]] for i in range(2, 14)]
        med = [statistics.median(r[j] for r in rows) for j in range(8)]
        print(f"K={k} N={n} M={m} cycles per stage (median of stages "
              f"2-13): " + ", ".join(f"{p} {c:.0f}" for p, c in
                                     zip(PARTS, med))
              + f"; total {sum(med):.0f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--clock", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    if args.splits or not args.clock:
        sweep_splits(dev)
    if args.clock:
        stage_clock(dev)
    elif not args.splits:
        # its own process: a second build of qmm.cu loaded beside the
        # port's refuses to launch
        return subprocess.run([sys.executable, __file__, "--clock"]).returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
