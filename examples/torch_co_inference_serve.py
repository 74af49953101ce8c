"""Batched co-inference serving with per-QoS-class co-design on the
PyTorch port (``examples/co_inference_serve.py``'s run, DESIGN.md §7).

Three QoS classes (realtime / interactive / batch) each get their own
(b̂, f, f̃) from Algorithm 1, solved once per class through the codesign
cache.  A mixed-traffic queue is drained into per-class batches: each
batch runs the quantized agent -> uplink -> server pipeline (the
``qmm``/``qmm_int4`` kernels for the agent stage on the card), with
per-class delay/energy accounting from the paper's cost model and
batch-level occupancy/queue-wait stats.  A full-precision engine measures
the realized output distortion per class.

With ``--mixed-precision`` each class gets a per-layer bit allocation
(core/mixed_precision.py, DESIGN.md §8) instead of one uniform b̂; with
``--compiled`` every batch replays a CUDA graph per (plan, bucket) on the
card, captured by ``warmup()`` (the same closure runs uncaptured on the
CPU).  Runs on the CUDA card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_co_inference_serve.py \\
          [--mixed-precision] [--compiled] [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.device import resolve_device, set_float32_numerics
from repro_torch.models.registry import build_model
from repro_torch.runtime import (BatchedCoInferenceEngine, CodesignCache,
                                 CoInferenceEngine, QosClass)

# (T0, E0) chosen so the classes land on b_hat = 4 / 8 / 16: the two
# tight classes really exercise the int4/int8 kernel path, the loose one
# runs effectively unquantized (b_hat=16 -> fake path)
CLASSES = [
    QosClass("realtime", t0=1.15, e0=0.95),
    QosClass("interactive", t0=1.30, e0=1.25),
    QosClass("batch", t0=2.50, e0=4.0),
]
SEQ = 32
N_REQUESTS = 24


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mixed-precision", action="store_true",
                    help="per-layer bit allocation per class "
                         "(DESIGN.md §8) instead of one uniform b̂")
    ap.add_argument("--compiled", action="store_true",
                    help="serve through the compiled fast path "
                         "(DESIGN.md §10): bucket-padded CUDA graphs, "
                         "captured by warmup(), bitwise identical "
                         "per request to eager serving")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_numerics()

    cfg = get_smoke("stablelm-3b")
    if args.mixed_precision:
        # widen the agent partition (smoke default is a single layer) so
        # the allocator has layers to trade bits between
        cfg = dataclasses.replace(cfg, split_layer=2)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sysp = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)

    # kernel path: for classes whose b̂ lands on 4 or 8 the agent weights
    # are int4/int8-resident through the quantized matmul kernels; other
    # bit-widths fall back to fake quantization -- each batch below
    # prints which path really ran.  One engine serves all classes,
    # re-materializing weights only on an operating point it has not seen
    # yet (weight cache keyed on the stable plan key)
    cache = CodesignCache()
    eng = BatchedCoInferenceEngine(model, params, sysp, classes=CLASSES,
                                   max_batch=8, path="kernel",
                                   codesign_cache=cache,
                                   mixed_precision=args.mixed_precision,
                                   compiled=args.compiled, device=device)
    if args.compiled:
        print(f"warmup: {eng.warmup(SEQ)} compiled forward variants")
    clean = CoInferenceEngine(model, params, sysp, device=device)
    clean.configure(16)
    clean.b_emb = 16

    print(f"{'class':13s} {'bits':>12s} {'f GHz':>6s} {'f~ GHz':>6s} "
          f"{'T (model)':>10s} {'E (model)':>10s}")
    for qos in CLASSES:
        s = eng.solution_for(qos.name)
        bdesc = "/".join(map(str, s.bits)) if args.mixed_precision \
            else str(s.b_hat)
        print(f"{qos.name:13s} {bdesc:>12s} {s.f / 1e9:6.2f} "
              f"{s.f_server / 1e9:6.2f} {s.delay:9.3f}s {s.energy:9.3f}J")

    # mixed traffic: round-robin classes, ragged lengths
    rng = np.random.default_rng(0)
    sent = {}
    for i in range(N_REQUESTS):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(SEQ // 2, SEQ + 1)))
        sent[eng.submit(toks, CLASSES[i % len(CLASSES)].name)] = toks

    responses = eng.drain()

    # realized distortion per class vs the clean full-precision engine
    dist = {c.name: 0.0 for c in CLASSES}
    count = {c.name: 0 for c in CLASSES}
    for r in responses:
        toks = torch.as_tensor(sent[r.request_id], dtype=torch.long)[None]
        ref, _ = clean.serve_batch({"tokens": toks})
        dist[r.stats.qos] += float(torch.sum(torch.abs(r.logits - ref[0])))
        count[r.stats.qos] += 1

    print(f"\nserved {len(responses)} requests in "
          f"{len(eng.batch_history)} single-class batches:")
    for b in eng.batch_history:
        bdesc = "/".join(map(str, b.plan_bits)) if b.plan_bits \
            else f"{b.b_hat:2d}"
        print(f"  [{b.qos:12s}] n={b.batch_size} b_hat={bdesc} "
              f"({b.agent_path}) occupancy={b.occupancy:.2f} "
              f"amortized T={b.amortized_delay_s * 1e3:7.2f}ms/req "
              f"E={b.amortized_energy_j:.4f}J/req "
              f"uplink={b.emb_bytes / 1024:.1f}KiB")

    print(f"\n{'class':13s} {'requests':>8s} {'distortion':>11s}")
    for c in CLASSES:
        print(f"{c.name:13s} {count[c.name]:8d} "
              f"{dist[c.name] / max(count[c.name], 1):11.1f}")

    rep = eng.report()
    print(f"\nreport: mean_batch={rep.mean_batch_size:.2f} "
          f"occupancy={rep.mean_occupancy:.2f} "
          f"modeled throughput={rep.throughput_rps:.0f} req/s; "
          f"codesign cache: {rep.codesign_misses} solves, "
          f"{rep.codesign_hits} hits")
    if args.compiled:
        print(f"compile cache: {rep.compiled_variants} variants, "
              f"{rep.compile_hits} hits / {rep.compile_misses} misses")
    print("\ntighter QoS -> smaller b_hat -> more distortion; batching "
          "amortizes delay/energy across a class without ever mixing "
          "classes in one forward — the paper's quality/latency/energy "
          "triangle, served at queue scale.")


if __name__ == "__main__":
    main()
