"""Co-inference serving from the command line:
``python -m repro_torch.launch.serve --engine sequential --path kernel``.

The sequential mode of ``repro/launch/serve.py``: build the model from a
seeded ``torch.Generator``, solve (P1) for one QoS class with the paper's
SCA, print the oracle and baseline solutions beside it, serve one batch of
Markov-chain requests agent -> uplink -> server, and print the modeled
delay/energy split.  Runs on the CUDA card unless ``--device cpu``.

The reference's other modes (batched, compiled, mixed precision, decode,
speculative, adaptive, fleet, chaos, trace/metrics output) are not yet
ported: each exits 2 with a one-line error.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..configs import get_config, get_smoke
from ..core import baselines as bl
from ..core import codesign as cd
from ..core.cost_model import SystemParams
from ..data import MarkovLMConfig, MarkovLMDataset
from ..device import resolve_device
from ..models.lm import DecoderLM
from ..runtime import CoInferenceEngine, QosClass

# flags of the reference's serve CLI whose modes are not ported yet
_NOT_PORTED = ("decode", "speculative", "compiled", "mixed_precision",
               "env_trace", "fleet", "chaos_trace", "trace_out",
               "metrics_out")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "sequential"])
    ap.add_argument("--batch", type=int, default=4,
                    help="requests per serve_batch (sequential engine)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--t0", type=float, default=3.5)
    ap.add_argument("--e0", type=float, default=2.0)
    ap.add_argument("--path", default="fake", choices=["fake", "kernel"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    for flag in ("decode", "speculative", "compiled", "mixed-precision"):
        ap.add_argument(f"--{flag}", action="store_true",
                        help="not yet ported (exits 2)")
    for flag in ("env-trace", "fleet", "chaos-trace", "trace-out",
                 "metrics-out"):
        ap.add_argument(f"--{flag}", default=None,
                        help="not yet ported (exits 2)")
    args = ap.parse_args(argv)

    used = [f"--{n.replace('_', '-')}" for n in _NOT_PORTED
            if getattr(args, n)]
    if args.engine != "sequential":
        used.insert(0, f"--engine {args.engine}")
    if used:
        print(f"error: {' '.join(used)} is not yet ported to repro_torch; "
              "run --engine sequential (the reference serves the rest: "
              "python -m repro.launch.serve)", file=sys.stderr)
        return 2
    try:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        device = resolve_device(args.device)
    except (KeyError, RuntimeError) as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    return serve_sequential(cfg, device, args)


def serve_sequential(cfg, device, args) -> int:
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens = args.batch * args.seq
    per_layer = cfg.active_param_count() / max(cfg.n_layers, 1)
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * tokens,
        n_flop_server=2.0 * per_layer
        * (cfg.n_layers - cfg.split_layer) * tokens)

    eng = CoInferenceEngine(model, params, sysp, path=args.path,
                            device=device)
    print(f"arch={cfg.name} split={cfg.split_layer}/{cfg.n_layers} "
          f"lambda_hat={eng.lam:.2f} path={args.path} engine=sequential "
          f"device={device}")

    sol = eng.auto_configure(QosClass("interactive", t0=args.t0, e0=args.e0))
    if sol is None:
        print(f"(P1) infeasible under T0={args.t0}s E0={args.e0}J")
        return 1
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


if __name__ == "__main__":
    raise SystemExit(main())
