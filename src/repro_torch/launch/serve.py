"""Co-inference serving from the command line:
``python -m repro_torch.launch.serve --path kernel [--compiled]``,
``--engine sequential``, ``--decode [--speculative]`` or ``--env-trace``.

The modes of ``repro/launch/serve.py``, each on a model built from a
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
  ``greedy_decode_reference`` and requires equal tokens;
* ``--speculative`` (implies ``--decode``): the agent drafts
  ``--lookahead`` tokens a round at ``--draft-bits``, the server verifies
  them (``SpeculativeDecodeEngine``), and the report adds the rounds and
  the acceptance;
* ``--env-trace NAME``: the batched engine's traffic spread over a canned
  dynamic environment (``env.presets``: Markov Wi-Fi, Rayleigh fading,
  profile replay, battery drain, ``edge-day``, ``constant``, seeded by
  ``--env-seed``) through ``AdaptiveCoInferenceEngine`` under
  ``--adaptive-policy`` (static, adaptive or oracle).

* ``--fleet SPEC.json``: a multi-agent fleet from one shared edge server
  (``FleetCoInferenceEngine``): the spec lists heterogeneous agents (arch,
  QoS budgets, weights, optional per-agent environment traces), the fleet
  allocator (``--allocator``: water-filling ``joint`` or the ``equal``
  split) divides the server frequency, and every agent serves through its
  own member engine over shared codesign and compile caches (see
  ``examples/fleet_spec.json``).

``--mixed-precision`` replaces the uniform b̂ by the layer-wise bit
allocation of ``core.mixed_precision`` in every mode, printing the
reference's lines (the allocation, its bound beside the best uniform
b̂'s, and the per-layer bits of every batch).

``--chaos-trace SPEC.json`` injects a seeded fault trace (link outages,
uplink corruption, server preemption, fleet agent dropout; see
``examples/chaos_spec.json``, ``--chaos-seed`` overrides its seed) and
serves the batched, adaptive, decode or fleet mode through the
``ServingSupervisor``, which retries with backoff, retransmits corrupted
uplinks, fails over to device-only serving and crash-recovers in-flight
decode state; ``--chaos-bare`` drops the defenses for the unsupervised
baseline.  ``--engine sequential`` has no queue to supervise and rejects
the flag.

Every mode takes ``--trace-out TRACE.json`` (a Chrome trace-event JSON of
the run) and ``--metrics-out METRICS.json`` (a metrics snapshot), written at
the end of the run even when it fails, as the reference's are.  Runs on the
CUDA card unless ``--device cpu``.  Exits 2 with a one-line error, as the
reference does, on an arch with no servable config (``fcdnn-16``) or one
the port does not register (also as a fleet agent's), an unreadable fleet
or chaos spec, ``--chaos-trace`` with ``--engine sequential``, an
off-ladder ``--draft-bits``, a ``--lookahead`` below 1, and
``--speculative`` or ``--decode`` on a model without the decode protocol.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
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
from ..env import presets as env_presets
from ..env.faults import chaos_from_spec
from ..models.lm import DecoderLM
from ..obs import NULL_METRICS, NULL_TRACER, MetricsRegistry, Tracer
from ..runtime import (AdaptiveCoInferenceEngine, BatchedCoInferenceEngine,
                       CodesignCache, CoInferenceEngine, DecodeEngine,
                       FleetAgentSpec, FleetCoInferenceEngine, QosClass,
                       ServingSupervisor, SpeculativeDecodeEngine,
                       greedy_decode_reference)
from ..runtime.decode_engine import decode_protocol_gap

# the realizable draft-container rungs --speculative may pin
SPEC_DRAFT_CHOICES = (2, 4, 8)

ENV_TRACES = {
    "wifi-markov": env_presets.wifi_markov,
    "rayleigh": env_presets.rayleigh_fading,
    "profiles": env_presets.profile_replay,
    "battery": env_presets.battery_drain,
    "edge-day": env_presets.edge_day,
    "constant": env_presets.constant,
}


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
                    help="speculative decode: the agent drafts "
                         "--lookahead tokens a round at --draft-bits, the "
                         "server verifies them with longest-accepted-"
                         "prefix rollback; implies --decode")
    ap.add_argument("--draft-bits", type=int, default=4,
                    help="draft bit-width b_draft for --speculative "
                         f"(one of {SPEC_DRAFT_CHOICES})")
    ap.add_argument("--lookahead", type=int, default=4,
                    help="draft tokens per speculative round (k >= 1)")
    ap.add_argument("--env-trace", default=None, choices=sorted(ENV_TRACES),
                    help="serve under a canned dynamic environment through "
                         "the adaptive engine")
    ap.add_argument("--env-seed", type=int, default=0)
    ap.add_argument("--adaptive-policy", default="adaptive",
                    choices=["static", "adaptive", "oracle"],
                    help="controller for --env-trace serving")
    ap.add_argument("--fleet", default=None, metavar="SPEC.json",
                    help="serve a multi-agent fleet from one shared edge "
                         "server; the JSON spec lists the agents (see "
                         "examples/fleet_spec.json)")
    ap.add_argument("--allocator", default=None,
                    choices=["joint", "equal"],
                    help="fleet share allocator: water-filling joint "
                         "codesign or the equal-split baseline "
                         "(default: the spec's choice, else joint)")
    ap.add_argument("--chaos-trace", default=None, metavar="SPEC.json",
                    help="inject a seeded fault trace and serve through "
                         "the ServingSupervisor (see "
                         "examples/chaos_spec.json)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="override the chaos spec's seed")
    ap.add_argument("--chaos-bare", action="store_true",
                    help="unsupervised baseline: the same injected faults, "
                         "no retry/failover/recovery (faults lose work)")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="write a Chrome trace-event JSON of the run")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.json",
                    help="write a JSON metrics snapshot (counters, gauges, "
                         "histograms) at the end of the run")
    args = ap.parse_args(argv)

    chaos, rc = _load_chaos(args)
    if rc is not None:
        return rc
    if args.speculative:
        if args.lookahead < 1:
            print(f"error: --lookahead {args.lookahead} is not a valid "
                  "draft length; speculative decode drafts k >= 1 tokens "
                  "per round", file=sys.stderr)
            return 2
        if args.draft_bits not in SPEC_DRAFT_CHOICES:
            print(f"error: --draft-bits {args.draft_bits} is off the "
                  f"realizable draft ladder {SPEC_DRAFT_CHOICES}; the "
                  "draft weights live in the same quantized containers "
                  "as every other plan", file=sys.stderr)
            return 2
        args.decode = True      # speculative serving is a decode mode
    # observability is opt-in: without the flags the engines get the
    # no-op singletons and pay nothing
    tracer = Tracer() if args.trace_out else NULL_TRACER
    metrics = MetricsRegistry() if args.metrics_out else NULL_METRICS
    try:
        return _dispatch(args, chaos, tracer, metrics)
    finally:
        _write_obs(args, tracer, metrics)


def _load_chaos(args):
    """Parse --chaos-trace into a ChaosTrace: (trace or None, None), or
    (None, 2) after a one-line error."""
    if args.chaos_trace is None:
        return None, None
    if args.engine == "sequential" and args.fleet is None \
            and not args.decode and not args.speculative \
            and args.env_trace is None:
        print("error: --chaos-trace needs a queued engine to supervise; "
              "--engine sequential serves one call at a time. Use the "
              "batched/adaptive/decode/fleet modes.", file=sys.stderr)
        return None, 2
    spec_path = pathlib.Path(args.chaos_trace)
    try:
        spec = json.loads(spec_path.read_text(encoding="utf-8"))
        chaos = chaos_from_spec(spec, seed=args.chaos_seed)
    except (OSError, ValueError) as e:
        print(f"error: cannot load chaos trace {spec_path}: {e}",
              file=sys.stderr)
        return None, 2
    return chaos, None


def _supervise(eng, chaos, args, tracer, metrics):
    """Wrap an engine for --chaos-trace serving (None without a trace)."""
    if chaos is None:
        return None
    return ServingSupervisor(eng, chaos=chaos,
                             supervised=not args.chaos_bare,
                             seed=chaos.seed, tracer=tracer,
                             metrics=metrics)


def _print_resilience(sup) -> None:
    r = sup.report()
    print(f"resilience [{r.mode}]: delivered {r.delivered}/"
          f"{r.requests_total} (failed {r.failed}, shed {r.shed}) "
          f"retries={r.retries} retransmits={r.retransmits} "
          f"failovers={r.failovers} recoveries={r.recoveries} "
          f"reallocations={r.reallocations} faults={r.faults_seen} "
          f"tokens lost/dup={r.tokens_lost}/{r.tokens_duplicated} "
          f"goodput={r.goodput:.1f} {r.goodput_unit}")


def _dispatch(args, chaos, tracer, metrics) -> int:
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.fleet is not None:
        return serve_fleet(args, device, tracer, metrics, chaos)
    try:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    except KeyError as e:
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
    err = unsupported_model_reason(model, args.arch, decode=args.decode,
                                   speculative=args.speculative)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens = args.batch * args.seq
    per_layer = cfg.active_param_count() / max(cfg.n_layers, 1)
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * tokens,
        n_flop_server=2.0 * per_layer
        * (cfg.n_layers - cfg.split_layer) * tokens)
    if args.decode:
        return serve_decode(cfg, model, params, sysp, device, args, tracer,
                            metrics, chaos)
    if args.env_trace is not None:
        return serve_adaptive(cfg, model, params, sysp, device, args,
                              tracer, metrics, chaos)
    if args.engine == "batched":
        return serve_batched(cfg, model, params, sysp, device, args, tracer,
                             metrics, chaos)
    return serve_sequential(cfg, model, params, sysp, device, args, tracer,
                            metrics)


def _write_obs(args, tracer, metrics) -> None:
    """Flush --trace-out / --metrics-out (in a finally, so a failed run
    still leaves a loadable partial trace behind)."""
    if args.trace_out and tracer.enabled:
        tracer.write(args.trace_out)
        print(f"trace: {len(tracer.events)} events -> {args.trace_out}")
    if args.metrics_out and metrics.enabled:
        metrics.write(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")


def unsupported_model_reason(model, arch: str, decode: bool = False,
                             speculative: bool = False):
    """One line saying why ``model`` cannot serve the invocation, or None:
    ``--decode`` and ``--speculative`` need the decode protocol (the
    complaint names the flag given)."""
    if decode or speculative:
        gap = decode_protocol_gap(model)
        if gap is not None:
            flag = "--speculative" if speculative else "--decode"
            return (f"{flag} does not support arch {arch}: {gap}. "
                    f"Drop {flag} or pick a dense DecoderLM-family arch "
                    "(e.g. qwen2-0.5b).")
    return None


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
                  metrics, chaos=None) -> int:
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

    sup = _supervise(eng, chaos, args, tracer, metrics)
    front = sup if sup is not None else eng
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(args.seq // 2,
                                                  args.seq + 1)))
        front.submit(toks, classes[i % len(classes)].name)
    responses = front.drain()

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
    if sup is not None:
        _print_resilience(sup)
    return 0


def serve_adaptive(cfg, model, params, sysp, device, args, tracer,
                   metrics, chaos=None) -> int:
    """The batched engine's traffic spread across a dynamic-environment
    trace through ``AdaptiveCoInferenceEngine``, printing what the
    reference's adaptive mode prints."""
    del sysp
    env = ENV_TRACES[args.env_trace](seed=args.env_seed)
    # (P1) decisions at the reference's calibrated workload, so the
    # (T0, E0) region, and with it the environment, is active whatever the
    # model's own FLOPs
    sysp = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11,
                        emb_bytes_full=4.0e5, tx_power_w=0.25)
    classes = decode_classes(args.t0, args.e0)
    eng = AdaptiveCoInferenceEngine(
        model, params, sysp, classes=classes, max_batch=args.max_batch,
        path=args.path, environment=env, policy=args.adaptive_policy,
        mixed_precision=args.mixed_precision, compiled=args.compiled,
        tracer=tracer, metrics=metrics, device=device)
    print(f"arch={cfg.name} env={args.env_trace} (seed {args.env_seed}, "
          f"{env.n_steps} x {env.dt_s}s) policy={args.adaptive_policy} "
          f"engine=adaptive")
    for c in classes:
        s = eng.solution_for(c.name)
        print(f"  class {c.name:12s} (T0={c.t0:.2f}s, E0={c.e0:.2f}J): "
              f"b_hat={s.b_hat} f={s.f / 1e9:.2f}GHz "
              f"f~={s.f_server / 1e9:.2f}GHz")

    sup = _supervise(eng, chaos, args, tracer, metrics)
    front = sup if sup is not None else eng
    # arrivals spread across the trace, so the stream lives through it
    rng = np.random.default_rng(1)
    span = env.horizon_s * 0.9
    for i in range(args.requests):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(args.seq // 2,
                                                  args.seq + 1)))
        front.submit(toks, classes[i % len(classes)].name,
                     arrival_s=i * span / max(args.requests, 1))
    responses = front.drain()

    print(f"served {len(responses)} requests in "
          f"{len(eng.batch_history)} batches:")
    for b in eng.batch_history:
        print(f"  [{b.qos:12s}] n={b.batch_size} b_hat={b.b_hat:2d} "
              f"f={b.f / 1e9:.2f}GHz T={b.batch_delay_s * 1e3:8.2f}ms "
              f"E={b.energy_j:.3f}J")
    rep = eng.adaptive_report()
    print(f"adaptive report: replans={rep.replans} "
          f"(switches={rep.plan_switches}, degraded="
          f"{rep.degraded_batches}) deadline violations="
          f"{rep.deadline_violations}/{rep.requests_served} "
          f"weight variants={rep.weight_variants} "
          f"env keys={rep.env_keys_seen}")
    for e in eng.replan_events:
        print(f"  t={e.t_s:7.2f}s [{e.qos:12s}] {e.reason}: "
              f"b {e.b_before:.0f} -> {e.b_after:.0f}"
              + (" (degraded)" if e.degraded else ""))
    if sup is not None:
        _print_resilience(sup)
    return 0


def decode_system_params(cfg, sysp, max_batch: int, seq: int,
                         max_new: int,
                         speculative: bool = False) -> SystemParams:
    """``sysp`` with a KV-cost term sized to this model's cache, so the
    b_kv rung is a real decision: a full-precision cache read costs
    0.5 s / 1.0 J per step, which forces a tight class down the ladder.
    A speculative round reads the cache k + 1 times, so there the
    bandwidth is doubled to keep every (b_draft, k) point in play."""
    kv_full = (2.0 * cfg.n_layers * max_batch * (seq + max_new)
               * cfg.n_kv_heads * max(cfg.head_dim, 1)
               * np.dtype(cfg.dtype).itemsize)
    kv_bw = kv_full * (2.0 if speculative else 1.0)
    return dataclasses.replace(sysp, kv_bytes_full=kv_full,
                               kv_bw_bps=kv_bw, kv_power_w=2.0)


def decode_classes(t0: float, e0: float) -> list:
    """The decode mode's two QoS classes around the (T0, E0) budget."""
    return [QosClass("realtime", t0=max(t0 / 3.0, 0.2),
                     e0=max(e0 / 2.0, 0.2)),
            QosClass("interactive", t0=t0, e0=e0)]


def serve_decode(cfg, model, params, sysp, device, args, tracer,
                 metrics, chaos=None) -> int:
    """Continuous-batching greedy decode over a quantized KV cache through
    ``DecodeEngine`` (``SpeculativeDecodeEngine`` with ``--speculative``),
    printing what the reference's decode mode prints."""
    sysp = decode_system_params(cfg, sysp, args.max_batch, args.seq,
                                args.max_new, speculative=args.speculative)
    classes = decode_classes(args.t0, args.e0)
    common = dict(classes=classes, max_batch=args.max_batch,
                  max_new_tokens=args.max_new,
                  mixed_precision=args.mixed_precision,
                  codesign_cache=CodesignCache(), tracer=tracer,
                  metrics=metrics, device=device)
    try:
        if args.speculative:
            # the draft menus pinned to the requested point: the codesign
            # still solves (b̂, f, f̃, b_kv) jointly around it
            eng = SpeculativeDecodeEngine(
                model, params, sysp, draft_bits=args.draft_bits,
                lookahead=args.lookahead, draft_ladder=(args.draft_bits,),
                lookahead_menu=(args.lookahead,), **common)
        else:
            eng = DecodeEngine(model, params, sysp, **common)
    except ValueError as e:
        print(e)
        return 1
    mode = "speculative" if args.speculative else "decode"
    print(f"arch={cfg.name} split={cfg.split_layer}/{cfg.n_layers} "
          f"lambda_hat={eng.lam:.2f} lambda_kv={eng.lam_kv:.2f} "
          f"engine={mode} max_batch={args.max_batch} "
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
        spec_desc = ""
        if args.speculative:
            b_d, k = eng.draft_schedule(c.name)
            spec_desc = f" b_draft={b_d} k={k}"
        print(f"  class {c.name:12s} (T0={c.t0:.2f}s, E0={c.e0:.2f}J): "
              f"b_hat={bdesc} b_kv={s.b_kv} f={s.f / 1e9:.2f}GHz "
              f"f~={s.f_server / 1e9:.2f}GHz bound={s.objective:.3e}"
              f"{spec_desc}")

    sup = _supervise(eng, chaos, args, tracer, metrics)
    front = sup if sup is not None else eng
    rng = np.random.default_rng(0)
    prompts = {}
    for i in range(args.requests):
        toks = rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(max(args.seq // 2, 1),
                                                  args.seq + 1)))
        rid = front.submit(toks, classes[i % len(classes)].name,
                           arrival_s=0.01 * i)
        prompts[rid] = (np.asarray(toks), classes[i % len(classes)].name)
    responses = front.drain()

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
    if args.speculative:
        st = eng.spec_stats()
        print(f"speculative: {st.rounds} rounds, "
              f"acceptance={st.acceptance_rate:.2f}, "
              f"accepted/round={st.accepted_per_round:.2f}, "
              f"tokens/round={st.tokens_per_round:.2f}")
    if sup is not None:
        _print_resilience(sup)

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


def serve_fleet(args, device, tracer, metrics, chaos=None) -> int:
    """A multi-agent fleet from a JSON spec, printing what the reference's
    fleet mode prints.

    The spec's ``agents`` list gives one entry per fleet member: ``name``
    and ``arch`` (required), ``t0``/``e0`` budgets, optional ``weight``,
    ``b_emb``, ``sysp`` field overrides (any ``SystemParams`` field),
    ``env_trace``/``env_seed``/``policy`` for a per-agent dynamic
    environment, and ``requests``/``seq`` per-agent traffic overrides.
    Top-level keys ``allocator``, ``max_batch``, ``path``, ``compiled``,
    ``mixed_precision``, ``requests_per_agent`` and ``seq`` set fleet-wide
    defaults; ``--allocator`` wins over the spec's when passed.  Agents of
    one arch share one params object, seeded by the arch's order of first
    appearance, as in the reference.
    """
    spec_path = pathlib.Path(args.fleet)
    try:
        spec = json.loads(spec_path.read_text(encoding="utf-8"))
    except (OSError, ValueError) as e:
        print(f"error: cannot read fleet spec {spec_path}: {e}",
              file=sys.stderr)
        return 2
    if not isinstance(spec, dict) or not spec.get("agents"):
        print(f"error: fleet spec {spec_path} must be a JSON object with "
              "a non-empty 'agents' list", file=sys.stderr)
        return 2

    allocator = args.allocator if args.allocator is not None \
        else spec.get("allocator", "joint")
    max_batch = int(spec.get("max_batch", args.max_batch))
    path = spec.get("path", args.path)
    compiled = bool(spec.get("compiled", args.compiled))
    mixed = bool(spec.get("mixed_precision", args.mixed_precision))
    n_default = int(spec.get("requests_per_agent", args.requests))
    seq_default = int(spec.get("seq", args.seq))

    models = {}
    specs, traffic = [], {}
    for a in spec["agents"]:
        # every per-agent failure (a missing key, an unknown or unported
        # arch or env trace, a bad sysp field, a non-numeric value) names
        # the broken agent entry in one line
        label = a.get("name", f"#{len(specs)}") \
            if isinstance(a, dict) else f"#{len(specs)}"
        try:
            arch = a["arch"]
            if arch not in models:
                cfg = get_smoke(arch) if args.smoke else get_config(arch)
                if cfg is None:
                    raise ValueError(f"arch {arch} has no servable model "
                                     "config")
                model = DecoderLM(cfg)
                models[arch] = (model, model.init(torch.Generator(
                    device=device).manual_seed(len(models))))
            model, params = models[arch]
            sysp = SystemParams(n_flop_agent=6.4e10, n_flop_server=1.92e11)
            if a.get("sysp"):
                sysp = dataclasses.replace(sysp, **a["sysp"])
            env = None
            if a.get("env_trace"):
                if a["env_trace"] not in ENV_TRACES:
                    raise ValueError(
                        f"unknown env_trace {a['env_trace']!r}; have "
                        f"{sorted(ENV_TRACES)}")
                env = ENV_TRACES[a["env_trace"]](
                    seed=int(a.get("env_seed", args.env_seed)))
            specs.append(FleetAgentSpec(
                name=a["name"], model=model, params=params, sysp=sysp,
                qos=QosClass(a["name"], t0=float(a.get("t0", args.t0)),
                             e0=float(a.get("e0", args.e0))),
                weight=float(a.get("weight", 1.0)),
                b_emb=int(a.get("b_emb", 8)),
                environment=env, policy=a.get("policy", "adaptive")))
            traffic[a["name"]] = (int(a.get("requests", n_default)),
                                  int(a.get("seq", seq_default)))
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            print(f"error: fleet agent {label!r}: {e}", file=sys.stderr)
            return 2

    try:
        fleet = FleetCoInferenceEngine(specs, allocator=allocator,
                                       max_batch=max_batch, path=path,
                                       compiled=compiled,
                                       mixed_precision=mixed,
                                       tracer=tracer, metrics=metrics,
                                       device=device)
    except (TypeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if compiled:
        n = fleet.warmup(max(s for _, s in traffic.values()))
        print(f"warmup: {n} compiled forward variants across the fleet")

    print(f"fleet: {len(specs)} agents, allocator={allocator} "
          f"max_batch={max_batch} path={path} device={device}")
    for s, share in zip(specs, fleet.allocation.shares):
        sol = fleet.solution_for(s.name)
        bdesc = "/".join(map(str, sol.bits)) if mixed else str(sol.b_hat)
        envd = f" env={type(s.environment).__name__}" \
            if s.environment is not None else ""
        print(f"  agent {s.name:12s} share={share:.3f} "
              f"(T0={s.qos.t0:.2f}s, E0={s.qos.e0:.2f}J, "
              f"w={s.weight:g}): b_hat={bdesc} f={sol.f / 1e9:.2f}GHz "
              f"f~={sol.f_server / 1e9:.2f}GHz "
              f"bound={sol.objective:.3e}{envd}")

    sup = _supervise(fleet, chaos, args, tracer, metrics)
    front = sup if sup is not None else fleet
    rng = np.random.default_rng(0)
    for s in specs:
        n_req, seq = traffic[s.name]
        cfg = s.model.cfg
        for _ in range(n_req):
            toks = rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(max(seq // 2, 1),
                                                      seq + 1)))
            front.submit(s.name, toks)
    front.drain()

    rep = fleet.report()
    print(f"\nserved {rep.requests_served} requests in "
          f"{rep.batches_served} batches across the fleet:")
    for pa in rep.per_agent:
        print(f"  agent {pa.name:12s} n={pa.requests_served} "
              f"batches={pa.batches_served} "
              f"occupancy={pa.mean_occupancy:.2f} "
              f"clock={pa.clock_s * 1e3:8.2f}ms E={pa.energy_j:.3f}J "
              f"violations={pa.deadline_violations}")
    print(f"fleet report: aggregate bound={rep.aggregate_bound:.4e} "
          f"makespan={rep.makespan_s * 1e3:.2f}ms "
          f"throughput={rep.throughput_rps:.0f} req/s (modeled) "
          f"energy={rep.total_energy_j:.3f}J")
    print(f"shared codesign cache: {rep.codesign_misses} solves, "
          f"{rep.codesign_hits} hits across {rep.n_agents} agents")
    if compiled:
        print(f"shared compile cache: {rep.compiled_variants} variants, "
              f"{rep.compile_hits} hits / {rep.compile_misses} misses")
    if sup is not None:
        _print_resilience(sup)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
