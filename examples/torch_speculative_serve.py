"""Speculative co-inference on the PyTorch port: the agent drafts at
b_draft bits, the server verifies (``examples/speculative_serve.py``'s
run, DESIGN.md §16).

One ragged stream of prompts (staggered arrivals, per-request generation
budgets) is decoded twice:

  * decode      — continuous batching: one greedy target token per round,
                  every round pays the full (b̂, f, f̃) forward.
  * speculative — the agent partition fake-quantized at b_draft greedily
                  drafts k tokens per round; the server partition
                  verifies all k in one batched forward and keeps the
                  longest accepted prefix plus one correction token.

Acceptance is a numerics property: the draft head *is* the target model
squeezed through a b_draft-bit container, so the acceptance rate falls
out of the same distortion bound D^U(b_draft) the codesign already
trusts — α = exp(−γ·λ·D^U) — and (b_draft, k, f) become joint variables
in P1.  Rounds shrink by the accepted-prefix length while every delivered
stream stays bitwise identical to the sequential reference.  Runs on the
CUDA card unless ``--device cpu``; on the card the draft and verify steps
replay CUDA graphs.

Run:  PYTHONPATH=src python examples/torch_speculative_serve.py \\
          [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.cost_model import SystemParams
from repro_torch.device import resolve_device, set_float32_numerics
from repro_torch.models.registry import build_model
from repro_torch.runtime import (CompiledForwardCache, DecodeEngine, QosClass,
                                 SpeculativeDecodeEngine,
                                 greedy_decode_reference)

SEQ = 24
MAX_NEW = 8
N_REQUESTS = 10
MAX_BATCH = 3


def make_sysp(cfg):
    """Smoke-scale FLOPs plus a KV-cost term sized so b_kv is a real
    decision.  The cache stream gets 2x the decode example's bandwidth:
    a speculative round moves (k+1) cache streams where plain decode
    moves one, so the single-stream choke would starve every (b_kv,
    b_draft, k) point before the draft/verify trade-off even appears."""
    per_layer = cfg.active_param_count() / max(cfg.n_layers, 1)
    tokens = MAX_BATCH * SEQ
    kv_full = (2.0 * cfg.n_layers * MAX_BATCH * (SEQ + MAX_NEW)
               * cfg.n_kv_heads * cfg.head_dim
               * np.dtype(cfg.dtype).itemsize)
    return SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * tokens,
        n_flop_server=2.0 * per_layer
        * (cfg.n_layers - cfg.split_layer) * tokens,
        kv_bytes_full=kv_full, kv_bw_bps=2.0 * kv_full, kv_power_w=2.0)


def traffic(cfg, rng):
    for i in range(N_REQUESTS):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(SEQ // 2, SEQ + 1)))
        n_new = int(rng.integers(2, MAX_NEW + 1))
        yield toks, ("realtime", "interactive")[i % 2], 0.05 * i, n_new


def serve(engine_cls, model, params, sysp, classes, compile_cache, device):
    eng = engine_cls(model, params, sysp, classes=classes,
                     max_batch=MAX_BATCH, max_new_tokens=MAX_NEW,
                     compile_cache=compile_cache, device=device)
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

    print(f"arch={cfg.name}: {N_REQUESTS} staggered prompts, "
          f"max_batch={MAX_BATCH}, {MAX_NEW} new tokens each\n")
    results = {}
    for mode, engine_cls in (("decode", DecodeEngine),
                             ("speculative", SpeculativeDecodeEngine)):
        shared = CompiledForwardCache()
        eng, responses, prompts = serve(engine_cls, model, params, sysp,
                                        classes, shared, device)
        rep = eng.report()
        results[mode] = rep
        print(f"mode={mode}:")
        for cs in rep.classes:
            line = (f"  [{cs.qos:12s}] n={cs.requests} b̂={cs.b_hat} "
                    f"b_kv={cs.b_kv}")
            if mode == "speculative":
                b_d, k = eng.draft_schedule(cs.qos)
                line += f" b_draft={b_d} k={k}"
            print(line + f" ttft={cs.ttft_mean_s * 1e3:7.1f}ms "
                  f"itl={cs.itl_mean_s * 1e3:6.1f}ms")
        print(f"  -> {rep.tokens_generated} tokens in "
              f"{rep.decode_rounds} rounds, "
              f"{rep.throughput_tps:.1f} tok/s (modeled)")
        if mode == "speculative":
            st = eng.spec_stats()
            print(f"  -> acceptance={st.acceptance_rate:.2f}, "
                  f"accepted/round={st.accepted_per_round:.2f}, "
                  f"tokens/round={st.tokens_per_round:.2f}")

        # the house invariant, extended: drafting changes the schedule,
        # never the bits — every delivered stream is bitwise-checked
        # against the sequential reference (DESIGN.md §16)
        for r in responses:
            ref = greedy_decode_reference(
                model, eng.class_params(r.qos), prompts[r.request_id],
                len(r.tokens), b_kv=r.b_kv, compile_cache=shared,
                device=device)
            assert np.array_equal(np.asarray(r.tokens), ref), r.request_id
        print(f"  -> all {len(responses)} responses bitwise-match the "
              "non-batched reference\n")

    dec, spec = results["decode"], results["speculative"]
    print(f"speculative rounds: {dec.decode_rounds} -> "
          f"{spec.decode_rounds} decode rounds for the same stream "
          f"({dec.decode_rounds / max(spec.decode_rounds, 1):.1f}x fewer "
          "server round-trips), token-for-token identical output — the "
          "draft head only ever proposes; the target model commits "
          "(DESIGN.md §16).")


if __name__ == "__main__":
    main()
