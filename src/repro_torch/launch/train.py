"""Training from the command line:
``python -m repro_torch.launch.train --arch qwen2-0.5b [...]``.

The reference's training entry point (``repro/launch/train.py``) on one device:
Markov-chain LM data, AdamW with the cosine schedule, optional QAT of the
agent partition at ``--qat-bits`` and int8 error-feedback gradient
compression.  It prints the reference's lines: the model and its size,
one line every 10 steps, and whether the loss improved.  ``--ckpt-dir``
checkpoints every ``--ckpt-every`` steps (written asynchronously) and
resumes from the newest intact checkpoint there.

The model is ``models.registry.build_model``'s for ``--arch``: every
family but the encoder-decoder trains on that data, as in the reference.
The encoder-decoder (seamless-m4t-large-v2) needs frame embeddings that
the Markov data does not give (the reference's CLI dies there with a
``KeyError``): it exits 2 with a one-line error, and ``Trainer`` trains it
from batches that hold ``embeds``.  Runs on the CUDA card unless
``--device cpu``.

Across ranks: ``torchrun --standalone --nproc-per-node N -m
repro_torch.launch.train ...`` runs one rank a process (NCCL on the cards,
gloo with ``--device cpu``) over a ``(data, model)`` mesh, ``--data`` the
data-parallel degree (0: every rank, the reference's default) and the
ranks left over on ``model`` (every family computes on its shards there
where its sizes divide: ``parallel.tensor_parallel.model_plan``); each
rank takes its slice of the global batch, and rank 0 prints.  An MoE
model (a decoder LM, or the hybrid jamba) over several data-parallel
ranks sums its router statistics and counts its capacity queues over
them.  A ``--data`` that does not divide the ranks exits 2 with a
one-line error.
"""

from __future__ import annotations

import argparse
import sys

import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke
from ..data import MarkovLMConfig, MarkovLMDataset, ShardedLoader
from ..models.registry import build_model
from ..optim import AdamW, cosine_schedule
from ..runtime import TrainConfig, Trainer
from .mesh import init_ranks, make_host_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--qat-bits", type=int, default=0)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=0,
                    help="data-parallel degree (0 = all ranks)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    joined = dist.is_initialized()
    try:
        return _run(args)
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


def _run(args) -> int:
    try:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        device = init_ranks(args.device)
    except (KeyError, RuntimeError) as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    n_ranks = dist.get_world_size()
    data = args.data or n_ranks
    if data < 1 or n_ranks % data:
        print(f"error: --data {args.data} does not divide the {n_ranks} "
              "ranks", file=sys.stderr)
        return 2
    if cfg is None:
        print(f"error: arch {args.arch} has no model config to train (it "
              "is the distortion-benchmark FC model)", file=sys.stderr)
        return 2
    if cfg.n_enc_layers > 0:
        print(f"error: arch {args.arch} is an encoder-decoder: its loss "
              "needs frame embeddings (batch['embeds']) that the CLI's "
              "Markov-chain LM data does not give", file=sys.stderr)
        return 2

    mesh = make_host_mesh(data=data, model=n_ranks // data, device=device)
    loader = ShardedLoader(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch)), device=device, mesh=mesh)
    ckpt = CheckpointManager(args.ckpt_dir, save_interval=args.ckpt_every) \
        if args.ckpt_dir else None
    opt = AdamW(learning_rate=cosine_schedule(args.lr, 20, args.steps))
    tr = Trainer(build_model(cfg), opt, device,
                 TrainConfig(qat_bits=args.qat_bits,
                             grad_compression=args.grad_compression,
                             log_every=10),
                 ckpt=ckpt, mesh=mesh)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"arch={cfg.name} params={cfg.param_count():.3g} "
        f"devices={n_ranks} qat_bits={args.qat_bits} device={device} "
        f"mesh=(data {data}, model {n_ranks // data})")
    _, history = tr.fit(loader, args.steps,
                        on_metrics=lambda m: say(
                            f"step {m['step']:5d} loss {m['loss']:.4f} "
                            f"gnorm {m['grad_norm']:.3f} "
                            f"{m['steps_per_s']:.2f} it/s"))
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        say(f"loss {first:.4f} -> {last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
