"""Continuous-batching greedy decode over a quantized KV cache on the
PyTorch port (``examples/decode_serve.py``'s run, DESIGN.md §12).

One ragged stream of prompts (staggered arrivals, per-request generation
budgets) is decoded twice through the *same* captured step functions:

  * barrier    — the FIFO baseline: a slot block admits a full batch,
                 then no new request enters until every member has
                 retired, so late arrivals wait out the longest request.
  * continuous — requests admit into any free slot between decode
                 rounds and retire independently; the batch stays full
                 and time-to-first-token stops paying for strangers.

Each QoS class decodes under the (b̂, f, f̃, b_kv) operating point the
decode codesign picks — the KV cache is *stored* at b_kv bits and read by
the ``quantized_decode_attention`` kernel on the card.  Every response is
bitwise-verified against the non-batched sequential reference.  Runs on
the CUDA card unless ``--device cpu``; on the card the prefill and token
step replay CUDA graphs.

Run:  PYTHONPATH=src python examples/torch_decode_serve.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.device import resolve_device, set_float32_numerics
from repro_torch.models.registry import build_model
from repro_torch.runtime import (CompiledForwardCache, DecodeEngine, QosClass,
                                 greedy_decode_reference)

SEQ = 24
MAX_NEW = 8
N_REQUESTS = 10
MAX_BATCH = 3


def make_sysp(cfg):
    """Smoke-scale FLOPs plus a KV-cost term sized so the b_kv rung is a
    real decision (full-precision cache read: 0.5 s / 1 J per step)."""
    per_layer = cfg.active_param_count() / max(cfg.n_layers, 1)
    tokens = MAX_BATCH * SEQ
    kv_full = (2.0 * cfg.n_layers * MAX_BATCH * (SEQ + MAX_NEW)
               * cfg.n_kv_heads * cfg.head_dim
               * np.dtype(cfg.dtype).itemsize)
    return SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * tokens,
        n_flop_server=2.0 * per_layer
        * (cfg.n_layers - cfg.split_layer) * tokens,
        kv_bytes_full=kv_full, kv_bw_bps=kv_full, kv_power_w=2.0)


def traffic(cfg, rng):
    # ragged generation budgets are what separates the two policies: a
    # short request retires mid-flight and its slot refills (continuous)
    # or sits empty until the whole block drains (barrier)
    for i in range(N_REQUESTS):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(SEQ // 2, SEQ + 1)))
        n_new = int(rng.integers(2, MAX_NEW + 1))
        yield toks, ("realtime", "interactive")[i % 2], 0.05 * i, n_new


def serve(admission, model, params, sysp, classes, compile_cache, device):
    eng = DecodeEngine(model, params, sysp, classes=classes,
                       max_batch=MAX_BATCH, max_new_tokens=MAX_NEW,
                       admission=admission, compile_cache=compile_cache,
                       device=device)
    eng.warmup(SEQ)
    prompts = {}
    for toks, qos, t, n_new in traffic(model.cfg, np.random.default_rng(7)):
        rid = eng.submit(toks, qos, max_new_tokens=n_new, arrival_s=t)
        prompts[rid] = np.asarray(toks, dtype=np.int32)
    return eng, eng.drain(), prompts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_numerics()

    cfg = get_smoke("qwen2-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sysp = make_sysp(cfg)
    classes = [QosClass("realtime", t0=1.2, e0=1.0),
               QosClass("interactive", t0=3.5, e0=2.0)]
    shared = CompiledForwardCache()  # both runs share the captured steps

    print(f"arch={cfg.name}: {N_REQUESTS} staggered prompts, "
          f"max_batch={MAX_BATCH}, {MAX_NEW} new tokens each\n")
    results = {}
    for admission in ("barrier", "continuous"):
        eng, responses, prompts = serve(admission, model, params, sysp,
                                        classes, shared, device)
        rep = eng.report()
        results[admission] = rep
        print(f"admission={admission}:")
        for cs in rep.classes:
            print(f"  [{cs.qos:12s}] n={cs.requests} b̂={cs.b_hat} "
                  f"b_kv={cs.b_kv} ttft={cs.ttft_mean_s * 1e3:7.1f}ms "
                  f"(max {cs.ttft_max_s * 1e3:7.1f}ms) "
                  f"itl={cs.itl_mean_s * 1e3:6.1f}ms")
        ratio = rep.kv_bytes / rep.kv_bytes_full if rep.kv_bytes_full \
            else 1.0
        print(f"  -> {rep.tokens_generated} tokens in "
              f"{rep.decode_rounds} rounds, "
              f"{rep.throughput_tps:.1f} tok/s (modeled), "
              f"kv cache {ratio:.2f}x of full precision")

        # every response is bitwise-checked against the sequential
        # reference decoding the same prompt alone (DESIGN.md §12)
        for r in responses:
            ref = greedy_decode_reference(
                model, eng.class_params(r.qos), prompts[r.request_id],
                len(r.tokens), b_kv=r.b_kv, compile_cache=shared,
                device=device)
            assert np.array_equal(np.asarray(r.tokens), ref), r.request_id
        print(f"  -> all {len(responses)} responses bitwise-match the "
              "non-batched reference\n")

    speedup = results["continuous"].throughput_tps \
        / results["barrier"].throughput_tps
    print(f"continuous admission: {speedup:.2f}x the barrier's modeled "
          "throughput on the same stream, same captured step functions, "
          "token-for-token identical output — batching is a scheduling "
          "decision, not a numerics decision (DESIGN.md §12).")


if __name__ == "__main__":
    main()
