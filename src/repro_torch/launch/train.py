"""Training from the command line:
``python -m repro_torch.launch.train --arch qwen2-0.5b [...]``.

The reference's training entry point (``repro/launch/train.py``) on one device:
Markov-chain LM data, AdamW with the cosine schedule, optional QAT of the
agent partition at ``--qat-bits`` and int8 error-feedback gradient
compression.  It prints the reference's lines: the model and its size,
one line every 10 steps, and whether the loss improved.  ``--ckpt-dir``
checkpoints every ``--ckpt-every`` steps (written asynchronously) and
resumes from the newest intact checkpoint there.

Runs on the CUDA card unless ``--device cpu``.  Data parallelism over
several chips (``--data`` > 1) is not yet ported: it exits 2 with a
one-line error.
"""

from __future__ import annotations

import argparse
import sys

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke
from ..data import MarkovLMConfig, MarkovLMDataset, ShardedLoader
from ..device import resolve_device
from ..models.lm import DecoderLM
from ..optim import AdamW, cosine_schedule
from ..runtime import TrainConfig, Trainer


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
                    help="data-parallel degree (0 or 1: one device; more "
                         "is not yet ported and exits 2)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.data > 1:
        print(f"error: --data {args.data} is not yet ported to repro_torch "
              "(training over several chips); run --data 1", file=sys.stderr)
        return 2
    try:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        device = resolve_device(args.device)
    except (KeyError, RuntimeError) as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    loader = ShardedLoader(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch)), device=device)
    ckpt = CheckpointManager(args.ckpt_dir, save_interval=args.ckpt_every) \
        if args.ckpt_dir else None
    opt = AdamW(learning_rate=cosine_schedule(args.lr, 20, args.steps))
    tr = Trainer(DecoderLM(cfg), opt, device,
                 TrainConfig(qat_bits=args.qat_bits,
                             grad_compression=args.grad_compression,
                             log_every=10),
                 ckpt=ckpt)
    print(f"arch={cfg.name} params={cfg.param_count():.3g} "
          f"devices=1 qat_bits={args.qat_bits} device={device}")
    _, history = tr.fit(loader, args.steps,
                        on_metrics=lambda m: print(
                            f"step {m['step']:5d} loss {m['loss']:.4f} "
                            f"gnorm {m['grad_norm']:.3f} "
                            f"{m['steps_per_s']:.2f} it/s"))
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
