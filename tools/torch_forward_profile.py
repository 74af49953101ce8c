#!/usr/bin/env python3
"""Where the time of one served forward goes, on the CUDA card.

    python3 tools/torch_forward_profile.py [--seq 64] [--batch 4]

Serves qwen2-0.5b at full width (24 layers, seeded random weights)
through ``repro_torch``'s ``CoInferenceEngine(path="kernel")`` at b̂ = 8,
b̂ = 4 and the plan [4, 4, 4, 8, 8, 8], and for each prints

* the wall time of the agent stage, the uplink quantizer and the server
  stage (host clock around work that ends in ``torch.cuda.synchronize``,
  median of 5 after warm-up);
* a ``torch.profiler`` trace of 3 forwards: device time by kernel name
  (top 12) and the device's busy share of the traced wall time.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _wall_ms(fn, reps: int = 5) -> float:
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def _kernel_us(evt) -> float:
    """Device time of a kernel event (0 for host-side op events, whose
    device time is their kernels' and would be counted twice)."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    # the attribute was renamed from cuda_* to device_* in torch 2.4
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.core.quantization import QuantPlan
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CoInferenceEngine

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card.splitlines()[0]}")
    cfg = FULL
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = CoInferenceEngine(model, params,
                            SystemParams(n_flop_agent=1.0, n_flop_server=1.0),
                            path="kernel")
    tokens = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch)).batch_at(0)["tokens"]
    batch = {"tokens": tokens}

    for point in (8, 4, QuantPlan.from_layer_bits([4, 4, 4, 8, 8, 8])):
        eng.configure(point)
        for _ in range(2):
            eng.serve_batch(batch)
        emb, pos = eng.agent_stage(batch)
        rx, _ = eng.transport(emb)
        t_agent = _wall_ms(lambda: eng.agent_stage(batch))
        t_tx = _wall_ms(lambda: eng.transport(emb))
        t_server = _wall_ms(lambda: eng.server_stage(rx, pos))
        t_all = _wall_ms(lambda: eng.serve_batch(batch))
        print(f"\n{eng.agent_path} [{args.batch}x{args.seq}]: serve_batch "
              f"{t_all:.2f} ms = agent {t_agent:.2f} + uplink {t_tx:.2f} "
              f"+ server {t_server:.2f} ms (wall, median of 5)")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                eng.serve_batch(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = [(e.key, _kernel_us(e), e.count)
                for e in prof.key_averages() if _kernel_us(e) > 0]
        busy = sum(us for _, us, _ in rows)
        print(f"  traced 3 forwards: wall {wall_us / 1e3:.2f} ms, device "
              f"busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%)")
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
            print(f"  {us / 1e3 / 3:9.3f} ms/forward  {count // 3:5d}x  "
                  f"{key[:90]}")
    print(card.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
