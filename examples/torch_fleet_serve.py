"""Multi-agent fleet co-inference over one shared edge server on the
PyTorch port (``examples/fleet_serve.py``'s run, DESIGN.md §11).

Three heterogeneous embodied agents share a single edge server: a
deadline-tight delivery drone, and two slack monitors over a different
architecture.  The fleet allocator splits the server frequency across
them — the water-filling joint codesign against the equal-split
baseline, both serving the *identical* per-agent request streams
through :class:`FleetCoInferenceEngine` at the same per-agent (T0, E0)
budgets — and the realized output distortion is measured against a
full-precision reference per agent.

Under an equal split the tight agent's small server slice forces it to a
coarse bit-width; the joint allocator shrinks the slack agents to their
feasibility thresholds and hands the freed share to the tight agent,
whose b̂ — and measured distortion — improves at matched budgets.  Runs
on the CUDA card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_fleet_serve.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.device import resolve_device, set_float32_numerics
from repro_torch.models.registry import build_model
from repro_torch.runtime import (CoInferenceEngine, FleetAgentSpec,
                                 FleetCoInferenceEngine, QosClass)

SEQ = 24
N_REQUESTS = 6
MAX_BATCH = 2
# calibrated decision-scale workload (DESIGN.md §7): the server term is
# a real fraction of the tight deadline, so the share split has teeth
SYSP = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)

AGENTS = [
    # (name, arch, T0, E0, weight)
    ("drone", "qwen2-0.5b", 0.8, 8.0, 1.0),
    ("monitor-a", "stablelm-3b", 3.0, 4.0, 1.0),
    ("monitor-b", "stablelm-3b", 3.0, 4.0, 1.0),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_numerics()

    models = {}
    specs = []
    for name, arch, t0, e0, weight in AGENTS:
        if arch not in models:
            cfg = get_smoke(arch)
            model = build_model(cfg)
            models[arch] = (model, model.init(
                torch.Generator(device=device).manual_seed(0)))
        model, params = models[arch]
        specs.append(FleetAgentSpec(
            name=name, model=model, params=params, sysp=SYSP,
            qos=QosClass(name, t0=t0, e0=e0), weight=weight))

    # identical per-agent streams for both allocators
    rng = np.random.default_rng(4)
    streams = {
        s.name: [rng.integers(0, s.model.cfg.vocab_size,
                              size=int(rng.integers(SEQ // 2, SEQ + 1)))
                 for _ in range(N_REQUESTS)]
        for s in specs}

    # full-precision references (one clean engine per architecture)
    refs, clean = {}, {}
    for s in specs:
        if id(s.model) not in clean:
            eng = CoInferenceEngine(s.model, s.params, SYSP, b_emb=16,
                                    device=device)
            eng.configure(16)
            clean[id(s.model)] = eng
        refs[s.name] = [
            clean[id(s.model)].serve_batch(
                {"tokens": torch.as_tensor(t, dtype=torch.long)[None]})[0][0]
            for t in streams[s.name]]

    for allocator in ("equal", "joint"):
        fleet = FleetCoInferenceEngine(specs, allocator=allocator,
                                       max_batch=MAX_BATCH, device=device)
        for s in specs:
            for toks in streams[s.name]:
                fleet.submit(s.name, toks)
        responses = fleet.drain()
        rep = fleet.report()

        print(f"\nallocator={allocator}  aggregate bound="
              f"{rep.aggregate_bound:.4e}")
        print(f"{'agent':12s} {'share':>6s} {'b_hat':>5s} {'bound':>10s} "
              f"{'distortion':>10s} {'occup':>6s}")
        for s, pa in zip(specs, rep.per_agent):
            by_id = {r.request_id: r for r in responses[s.name]}
            dist = sum(float(torch.sum(torch.abs(by_id[i].logits
                                                 - refs[s.name][i])))
                       for i in range(N_REQUESTS)) / N_REQUESTS
            print(f"{pa.name:12s} {pa.share:6.3f} {pa.b_hat:5d} "
                  f"{pa.bound:10.3e} {dist:10.2f} "
                  f"{pa.mean_occupancy:6.2f}")
        print(f"shared codesign cache: {rep.codesign_misses} solves / "
              f"{rep.codesign_hits} hits across {rep.n_agents} agents")

    print("\nsame budgets, same streams — only the server split differs: "
          "the joint allocator buys the deadline-tight agent a finer "
          "bit-width with share the slack agents never needed.")


if __name__ == "__main__":
    main()
