"""Co-inference serving from the command line:
``python -m repro_torch.launch.serve --path kernel [--compiled]``,
``--engine sequential`` or ``--decode``.

Three modes of ``repro/launch/serve.py``, each on a model built from a
seeded ``torch.Generator``:

* batched (the default): three QoS classes, each with its (P1) solution
  from the codesign cache, a queue of Markov-chain requests packed into
  per-class batches, the batch-level and per-request delay/energy
  accounting, and with ``--compiled`` every (class, sequence bucket)
  forward captured by ``warmup()`` first (one CUDA graph each on the card);
* sequential (``--engine sequential``): solve (P1) for one QoS class with
  the paper's SCA, print the oracle and baseline solutions beside it,
  serve one batch agent -> uplink -> server, and print the modeled
  delay/energy split;
* ``--decode``: continuous-batching greedy decode over a quantized KV
  cache (``DecodeEngine``) for two QoS classes, each with its codesign
  (b̂, b_kv); ``--parity-check`` replays every response through
  ``greedy_decode_reference`` and requires equal tokens.

``--mixed-precision`` replaces the uniform b̂ by the layer-wise bit
allocation of ``core.mixed_precision`` in all three modes, printing the
reference's lines (the allocation, its bound beside the best uniform
b̂'s, and the per-layer bits of every batch).

Every mode takes ``--trace-out TRACE.json`` (a Chrome trace-event JSON of
the run) and ``--metrics-out METRICS.json`` (a metrics snapshot), written at
the end of the run even when it fails, as the reference's are.  Runs on the
CUDA card unless ``--device cpu``.  The reference's other modes
(speculative, adaptive, fleet, chaos) are not yet ported: each exits 2
with a one-line error, as does an arch with no servable config
(``fcdnn-16``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..core import baselines as bl
from ..core import codesign as cd
from ..core.cost_model import SystemParams
from ..data import MarkovLMConfig, MarkovLMDataset
from ..device import resolve_device
from ..models.lm import DecoderLM
from ..obs import NULL_METRICS, NULL_TRACER, MetricsRegistry, Tracer
from ..runtime import (BatchedCoInferenceEngine, CodesignCache,
                       CoInferenceEngine, DecodeEngine, QosClass,
                       greedy_decode_reference)

# flags of the reference's serve CLI whose modes are not ported yet
_NOT_PORTED = ("speculative", "env_trace", "fleet", "chaos_trace")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "sequential"])
    ap.add_argument("--requests", type=int, default=12,
                    help="number of queued requests (batched engine, "
                         "--decode)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4,
                    help="requests per serve_batch (sequential engine)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--t0", type=float, default=3.5)
    ap.add_argument("--e0", type=float, default=2.0)
    ap.add_argument("--path", default="fake", choices=["fake", "kernel"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--decode", action="store_true",
                    help="continuous-batching greedy decode over a "
                         "quantized KV cache, per-class b_kv from the "
                         "codesign")
    ap.add_argument("--max-new", type=int, default=16,
                    help="tokens to generate per request (--decode)")
    ap.add_argument("--parity-check", action="store_true",
                    help="replay every --decode request through the "
                         "batch-1 greedy reference and require equal "
                         "tokens")
    ap.add_argument("--compiled", action="store_true",
                    help="serve through the compiled fast path: one "
                         "bucket-padded agent -> transport -> server "
                         "forward per (plan, bucket), a CUDA graph on the "
                         "card, captured up front by warmup()")
    ap.add_argument("--mixed-precision", action="store_true",
                    help="per-layer bit allocation (core.mixed_precision) "
                         "instead of one uniform b_hat per QoS class")
    ap.add_argument("--speculative", action="store_true",
                    help="not yet ported (exits 2)")
    for flag in ("env-trace", "fleet", "chaos-trace"):
        ap.add_argument(f"--{flag}", default=None,
                        help="not yet ported (exits 2)")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="write a Chrome trace-event JSON of the run")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.json",
                    help="write a JSON metrics snapshot (counters, gauges, "
                         "histograms) at the end of the run")
    args = ap.parse_args(argv)

    used = [f"--{n.replace('_', '-')}" for n in _NOT_PORTED
            if getattr(args, n)]
    if used:
        print(f"error: {' '.join(used)} is not yet ported to repro_torch "
              "(the reference serves it: python -m repro.launch.serve)",
              file=sys.stderr)
        return 2
    try:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        device = resolve_device(args.device)
    except (KeyError, RuntimeError) as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if cfg is None:
        # fcdnn-16: the paper's FC benchmark model has no ModelConfig
        print(f"error: arch {args.arch} has no servable model config "
              "(it is the distortion-benchmark toy model, not a "
              "transformer); pick a DecoderLM-family arch "
              "(e.g. qwen2-0.5b)", file=sys.stderr)
        return 2
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens = args.batch * args.seq
    per_layer = cfg.active_param_count() / max(cfg.n_layers, 1)
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * tokens,
        n_flop_server=2.0 * per_layer
        * (cfg.n_layers - cfg.split_layer) * tokens)
    # observability is opt-in: without the flags the engines get the
    # no-op singletons and pay nothing
    tracer = Tracer() if args.trace_out else NULL_TRACER
    metrics = MetricsRegistry() if args.metrics_out else NULL_METRICS
    mode = serve_decode if args.decode else (
        serve_batched if args.engine == "batched" else serve_sequential)
    try:
        return mode(cfg, model, params, sysp, device, args, tracer, metrics)
    finally:
        _write_obs(args, tracer, metrics)


def _write_obs(args, tracer, metrics) -> None:
    """Flush --trace-out / --metrics-out (in a finally, so a failed run
    still leaves a loadable partial trace behind)."""
    if args.trace_out and tracer.enabled:
        tracer.write(args.trace_out)
        print(f"trace: {len(tracer.events)} events -> {args.trace_out}")
    if args.metrics_out and metrics.enabled:
        metrics.write(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")


def serve_sequential(cfg, model, params, sysp, device, args, tracer,
                     metrics) -> int:

    eng = CoInferenceEngine(model, params, sysp, path=args.path,
                            compiled=args.compiled, tracer=tracer,
                            metrics=metrics, device=device)
    print(f"arch={cfg.name} split={cfg.split_layer}/{cfg.n_layers} "
          f"lambda_hat={eng.lam:.2f} path={args.path} engine=sequential "
          f"compiled={args.compiled} device={device}")

    qos = QosClass("interactive", t0=args.t0, e0=args.e0)
    sol = eng.auto_configure_mixed(qos) if args.mixed_precision \
        else eng.auto_configure(qos)
    if sol is None:
        print(f"(P1) infeasible under T0={args.t0}s E0={args.e0}J")
        return 1
    if args.mixed_precision:
        print(f"mixed codesign: bits={list(sol.bits)} "
              f"(mean {sol.mean_bits:.2f}, uniform best "
              f"b_hat={sol.uniform_b}) f={sol.f / 1e9:.2f}GHz "
              f"f~={sol.f_server / 1e9:.2f}GHz "
              f"bound={sol.objective:.3e} (uniform "
              f"{sol.uniform_objective:.3e}) "
              f"T={sol.delay:.3f}s E={sol.energy:.3f}J "
              f"agent_path={eng.agent_path}")
    else:
        print(f"codesign: b_hat={sol.b_hat} f={sol.f / 1e9:.2f}GHz "
              f"f~={sol.f_server / 1e9:.2f}GHz gap={sol.objective:.3e} "
              f"T={sol.delay:.3f}s E={sol.energy:.3f}J "
              f"(SCA iters={sol.iterations}) agent_path={eng.agent_path}")

    for name, solver in (("oracle", cd.solve_oracle),
                         ("fixed-freq", bl.solve_fixed_frequency),
                         ("ppo", bl.solve_ppo)):
        s = solver(eng.lam, sysp, args.t0, args.e0)
        print(f"  {name:11s}: " + (
            f"b_hat={s.b_hat} gap={s.objective:.3e}" if s else "infeasible"))

    ds = MarkovLMDataset(MarkovLMConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.seq,
                                        batch_size=args.batch))
    batch = {"tokens": ds.batch_at(0)["tokens"]}
    logits, stats = eng.serve_batch(batch)
    print(f"served batch {tuple(batch['tokens'].shape)}: logits "
          f"{tuple(logits.shape)}")
    print(f"  agent {stats.agent_delay_s * 1e3:.2f}ms + uplink "
          f"{stats.transport_delay_s * 1e3:.2f}ms + server "
          f"{stats.server_delay_s * 1e3:.2f}ms = "
          f"{stats.total_delay_s * 1e3:.2f}ms, {stats.energy_j:.3f}J, "
          f"emb {stats.emb_bytes / 1024:.1f}KiB at b_emb={eng.b_emb}")
    return 0


def serve_batched(cfg, model, params, sysp, device, args, tracer,
                  metrics) -> int:
    """The batched engine over three QoS classes, printing what the
    reference's batched mode prints."""
    classes = [
        QosClass("realtime", t0=max(args.t0 / 3.0, 0.2),
                 e0=max(args.e0 / 2.0, 0.2)),
        QosClass("interactive", t0=args.t0, e0=args.e0),
        QosClass("batch", t0=args.t0 * 2.0, e0=args.e0 * 2.0),
    ]
    cache = CodesignCache()
    try:
        eng = BatchedCoInferenceEngine(
            model, params, sysp, classes=classes, max_batch=args.max_batch,
            path=args.path, codesign_cache=cache,
            mixed_precision=args.mixed_precision, compiled=args.compiled,
            tracer=tracer, metrics=metrics, device=device)
    except ValueError as e:
        print(e)
        return 1
    print(f"arch={cfg.name} split={cfg.split_layer}/{cfg.n_layers} "
          f"lambda_hat={eng.engine.lam:.2f} path={args.path} "
          f"engine=batched max_batch={args.max_batch} "
          f"mixed_precision={args.mixed_precision} "
          f"compiled={args.compiled} device={device}")
    if args.compiled:
        # capture every (class plan, seq bucket) forward up front, so
        # serving below never stalls on a capture
        t0 = time.perf_counter()
        n = eng.warmup(args.seq)
        print(f"warmup: {n} forward variants compiled in "
              f"{time.perf_counter() - t0:.1f}s")
    for c in classes:
        s = eng.solution_for(c.name)
        if args.mixed_precision:
            print(f"  class {c.name:12s} (T0={c.t0:.2f}s, E0={c.e0:.2f}J): "
                  f"bits={list(s.bits)} (mean {s.mean_bits:.2f}) "
                  f"f={s.f / 1e9:.2f}GHz f~={s.f_server / 1e9:.2f}GHz "
                  f"bound={s.objective:.3e} "
                  f"(uniform b_hat={s.uniform_b}: "
                  f"{s.uniform_objective:.3e})")
        else:
            print(f"  class {c.name:12s} (T0={c.t0:.2f}s, E0={c.e0:.2f}J): "
                  f"b_hat={s.b_hat} f={s.f / 1e9:.2f}GHz "
                  f"f~={s.f_server / 1e9:.2f}GHz gap={s.objective:.3e}")

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(args.seq // 2,
                                                  args.seq + 1)))
        eng.submit(toks, classes[i % len(classes)].name)
    responses = eng.drain()

    print(f"served {len(responses)} requests in "
          f"{len(eng.batch_history)} batches:")
    for b in eng.batch_history:
        bdesc = "/".join(map(str, b.plan_bits)) if b.plan_bits \
            else f"{b.b_hat:2d}"
        print(f"  [{b.qos:12s}] n={b.batch_size} b_hat={bdesc} "
              f"({b.agent_path}) occupancy={b.occupancy:.2f} "
              f"T={b.batch_delay_s * 1e3:.2f}ms "
              f"(amortized {b.amortized_delay_s * 1e3:.2f}ms/req) "
              f"E={b.energy_j:.3f}J wait<= {b.queue_wait_max_s * 1e3:.2f}ms")
    rep = eng.report()
    print(f"report: mean_batch={rep.mean_batch_size:.2f} "
          f"occupancy={rep.mean_occupancy:.2f} "
          f"throughput={rep.throughput_rps:.0f} req/s (modeled) "
          f"energy={rep.total_energy_j:.3f}J")
    print(f"codesign cache: {cache.misses} (P1) solves for "
          f"{len(responses)} requests ({cache.hits} hits)")
    if args.compiled:
        print(f"compile cache: {rep.compiled_variants} variants, "
              f"{rep.compile_hits} hits / {rep.compile_misses} misses "
              f"(every batch after warmup is a hit)")
    return 0


def decode_system_params(cfg, sysp, max_batch: int, seq: int,
                         max_new: int) -> SystemParams:
    """``sysp`` with a KV-cost term sized to this model's cache, so the
    b_kv rung is a real decision: a full-precision cache read costs
    0.5 s / 1.0 J per step, which forces a tight class down the ladder."""
    kv_full = (2.0 * cfg.n_layers * max_batch * (seq + max_new)
               * cfg.n_kv_heads * max(cfg.head_dim, 1)
               * np.dtype(cfg.dtype).itemsize)
    return dataclasses.replace(sysp, kv_bytes_full=kv_full,
                               kv_bw_bps=kv_full, kv_power_w=2.0)


def decode_classes(t0: float, e0: float) -> list:
    """The decode mode's two QoS classes around the (T0, E0) budget."""
    return [QosClass("realtime", t0=max(t0 / 3.0, 0.2),
                     e0=max(e0 / 2.0, 0.2)),
            QosClass("interactive", t0=t0, e0=e0)]


def serve_decode(cfg, model, params, sysp, device, args, tracer,
                 metrics) -> int:
    """Continuous-batching greedy decode over a quantized KV cache through
    ``DecodeEngine``, printing what the reference's decode mode prints."""
    sysp = decode_system_params(cfg, sysp, args.max_batch, args.seq,
                                args.max_new)
    classes = decode_classes(args.t0, args.e0)
    try:
        eng = DecodeEngine(model, params, sysp, classes=classes,
                           max_batch=args.max_batch,
                           max_new_tokens=args.max_new,
                           mixed_precision=args.mixed_precision,
                           codesign_cache=CodesignCache(), tracer=tracer,
                           metrics=metrics, device=device)
    except ValueError as e:
        print(e)
        return 1
    print(f"arch={cfg.name} split={cfg.split_layer}/{cfg.n_layers} "
          f"lambda_hat={eng.lam:.2f} lambda_kv={eng.lam_kv:.2f} "
          f"engine=decode max_batch={args.max_batch} "
          f"max_new={args.max_new} admission={eng.admission}")
    # capture every (class, bucket) prefill and token step up front, so
    # serving below never stalls on a capture
    t0 = time.perf_counter()
    n = eng.warmup(args.seq)
    print(f"warmup: {n} decode variants compiled in "
          f"{time.perf_counter() - t0:.1f}s")
    for c in classes:
        s = eng.solution_for(c.name)
        bdesc = "/".join(map(str, s.bits)) if args.mixed_precision \
            else str(s.b_hat)
        print(f"  class {c.name:12s} (T0={c.t0:.2f}s, E0={c.e0:.2f}J): "
              f"b_hat={bdesc} b_kv={s.b_kv} f={s.f / 1e9:.2f}GHz "
              f"f~={s.f_server / 1e9:.2f}GHz bound={s.objective:.3e}")

    rng = np.random.default_rng(0)
    prompts = {}
    for i in range(args.requests):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(max(args.seq // 2, 1),
                                                  args.seq + 1)))
        rid = eng.submit(toks, classes[i % len(classes)].name,
                         arrival_s=0.01 * i)
        prompts[rid] = (np.asarray(toks), classes[i % len(classes)].name)
    responses = eng.drain()

    rep = eng.report()
    print(f"served {rep.requests_served} requests, "
          f"{rep.tokens_generated} tokens in {rep.decode_rounds} rounds "
          f"({rep.prefills} prefills):")
    for cs in rep.classes:
        print(f"  [{cs.qos:12s}] n={cs.requests} b_kv={cs.b_kv} "
              f"ttft={cs.ttft_mean_s * 1e3:.2f}ms "
              f"(max {cs.ttft_max_s * 1e3:.2f}ms) "
              f"itl={cs.itl_mean_s * 1e3:.2f}ms")
    ratio = rep.kv_bytes / rep.kv_bytes_full if rep.kv_bytes_full else 1.0
    print(f"decode report: throughput={rep.throughput_tps:.1f} tok/s "
          f"(modeled), {rep.throughput_rps:.1f} req/s, "
          f"kv cache {rep.kv_bytes / 1024:.1f}KiB "
          f"({ratio:.2f}x of full precision) "
          f"energy={rep.total_energy_j:.3f}J")
    print(f"compile cache: {rep.compiled_variants} variants, "
          f"{rep.compile_hits} hits / {rep.compile_misses} misses")

    if args.parity_check:
        for r in responses:
            toks, qos = prompts[r.request_id]
            ref = greedy_decode_reference(
                model, eng.class_params(qos), toks, len(r.tokens),
                b_kv=r.b_kv, compile_cache=eng.compile_cache, device=device)
            if not np.array_equal(np.asarray(r.tokens), ref):
                print(f"error: parity mismatch on request {r.request_id}",
                      file=sys.stderr)
                return 1
        print(f"parity: all {len(responses)} requests bitwise-match the "
              "sequential reference")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
