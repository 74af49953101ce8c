"""Adaptive co-inference serving under a changing environment on the
PyTorch port (``examples/adaptive_serve.py``'s run, DESIGN.md §9).

A thermal throttle replays the paper's Table I coarse frequency profiles
(high -> low -> high) while a Markov-chain Wi-Fi uplink fades and
recovers.  The same request stream is served twice:

  * static   — the paper's one-shot (P1) co-design, solved for the
               initial state and never revisited; when the device
               throttles, its plan silently runs slow and misses
               deadlines.
  * adaptive — ``AdaptiveCoInferenceEngine`` watches the (quantized)
               environment state and realized per-batch QoS, re-solves
               (P1) through the environment-keyed codesign cache after a
               sustained change, and degrades gracefully in windows
               where no plan can meet the class at all.

Everything is calibrated to the *smoke* model's realized workload: the
engine bills batches at the model's actual FLOPs, so the QoS deadline
and the trace's dwell times live at that scale.  Runs on the CUDA card
unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_adaptive_serve.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.device import resolve_device, set_float32_numerics
from repro_torch.env import Environment, MarkovLink, TraceReplay
from repro_torch.models.registry import build_model
from repro_torch.runtime import (AdaptiveCoInferenceEngine, CoInferenceEngine,
                                 QosClass)

SEQ = 32
N_REQUESTS = 24
HORIZON_S = 36.0e-3     # smoke-workload timescale: one request ~0.05 ms


def smoke_scale(model, device):
    """Per-request SystemParams + a deadline sized to the smoke model."""
    probe = CoInferenceEngine(
        model, model.init(torch.Generator(device=device).manual_seed(9)),
        SystemParams(n_flop_agent=1.0, n_flop_server=1.0), device=device)
    n_a, n_s = probe.flop_split(SEQ)
    sysp = SystemParams(n_flop_agent=n_a, n_flop_server=n_s,
                        emb_bytes_full=float(SEQ * model.cfg.d_model * 2),
                        link_bps=2.0e8, tx_power_w=0.25)
    # deadline: ~78% of the full-precision, full-frequency request time —
    # tight enough that the throttled window forces bits off the plan
    t_ref = n_a / (sysp.c_agent * sysp.f_max) \
        + n_s / (sysp.c_server * sysp.f_server_max)
    return sysp, QosClass("interactive", t0=0.78 * t_ref, e0=2.0e-3)


def build_env():
    """f_max 2.0 -> 0.6 -> 2.0 GHz (Table I profiles), Wi-Fi fading."""
    return Environment(
        dt_s=1.0e-3, horizon_s=HORIZON_S, seed=0,
        f_cap=TraceReplay(values=(2.0e9, 0.6e9, 2.0e9),
                          dwell_s=HORIZON_S / 3.0),
        link=MarkovLink(rates_bps=(2.0e8, 4.0e7),
                        transition=((0.95, 0.05), (0.10, 0.90))))


def serve(policy: str, model, params, sysp, qos, device):
    eng = AdaptiveCoInferenceEngine(
        model, params, sysp, classes=[qos], max_batch=4,
        environment=build_env(), policy=policy, hysteresis_steps=2,
        device=device)
    rng = np.random.default_rng(3)
    for i in range(N_REQUESTS):
        toks = rng.integers(0, model.cfg.vocab_size,
                            size=int(rng.integers(SEQ // 2, SEQ + 1)))
        eng.submit(toks, qos.name, arrival_s=i * HORIZON_S / N_REQUESTS)
    eng.drain()
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_numerics()

    cfg = get_smoke("qwen2-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sysp, qos = smoke_scale(model, device)
    print(f"arch={cfg.name}; trace: f_max 2.0 -> 0.6 -> 2.0 GHz "
          f"(Table I profiles), Wi-Fi 2e8 <-> 4e7 B/s (Markov); "
          f"T0={qos.t0 * 1e6:.1f}us E0={qos.e0 * 1e3:.1f}mJ\n")

    for policy in ("static", "adaptive"):
        eng = serve(policy, model, params, sysp, qos, device)
        rep = eng.adaptive_report()
        print(f"policy={policy}:")
        line = []
        for b in eng.batch_history:
            # same accounting as the violation counter: worst member's
            # queue wait + the batch's forward delay against T0
            viol = b.queue_wait_max_s + b.batch_delay_s > qos.t0
            line.append(f"b̂={b.b_hat:2d}@{b.f / 1e9:.1f}GHz"
                        + ("!" if viol else " "))
        for lo in range(0, len(line), 6):
            print("   " + "  ".join(line[lo:lo + 6]))
        print(f"  -> violations {rep.deadline_violations}/"
              f"{rep.requests_served}, replans {rep.replans} "
              f"(plan switches {rep.plan_switches}), "
              f"degraded batches {rep.degraded_batches}")
        for e in eng.replan_events:
            print(f"     t={e.t_s * 1e3:5.1f}ms {e.reason}: b̂ "
                  f"{e.b_before:.0f} -> {e.b_after:.0f}"
                  + (" (degraded)" if e.degraded else ""))
        print()

    print("same requests, same physics ('!' marks a missed deadline): "
          "the static plan rides the throttled window at full width and "
          "misses deadlines; the adaptive controller sheds bits while "
          "the device is hot and takes them back when it cools.")


if __name__ == "__main__":
    main()
