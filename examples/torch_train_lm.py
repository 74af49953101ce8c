"""End-to-end training driver on the PyTorch port: ~100M-parameter LM,
quantization-aware, with checkpointing (``examples/train_lm.py``'s run).

The model is the qwen2 family at ~100M scale (12L x 768), trained on the
deterministic Markov-chain corpus with QAT on the agent partition (the
co-inference split it will be served at), int8 error-feedback gradient
compression enabled, and async checkpoints every 50 steps.  Kill it and
re-run: it resumes from the newest checkpoint at the exact data step.

Runs on the CUDA card unless ``--device cpu``; across ranks under
``torchrun --standalone --nproc-per-node N`` it trains data-parallel over
a (data N, model 1) mesh, each rank on its slice of the batch, and rank 0
prints.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
          examples/torch_train_lm.py --device cpu --steps 20
"""

import argparse
import dataclasses
import os
import tempfile

import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import MarkovLMConfig, MarkovLMDataset, ShardedLoader
from repro_torch.launch.mesh import init_ranks, make_host_mesh
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    device = init_ranks(args.device)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    # qwen2 family at ~100M: 12 x 768, GQA kv=4, vocab 32k
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"), name="qwen2-100m",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32768, split_layer=3)
    model = build_model(cfg)
    say(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
        f"QAT bits=8 on layers [0, {cfg.split_layer})")

    mesh = make_host_mesh(data=dist.get_world_size(), device=device)
    ds = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch, branching=4))
    loader = ShardedLoader(ds, device=device, mesh=mesh)

    trainer = Trainer(
        model,
        AdamW(learning_rate=cosine_schedule(3e-4, 30, args.steps)),
        device,
        TrainConfig(qat_bits=8, grad_compression="int8_ef", log_every=20),
        ckpt=CheckpointManager(args.ckpt_dir, save_interval=50, keep=2),
        mesh=mesh)

    _, hist = trainer.fit(
        loader, args.steps,
        on_metrics=lambda m: say(
            f"  step {m['step']:4d}  loss {m['loss']:.4f}  "
            f"gnorm {m['grad_norm']:.2f}  {m['steps_per_s']:.2f} it/s"))
    first, last = hist[0]["loss"], hist[-1]["loss"]
    # Markov chain with branching 4 -> optimal loss = ln(4) ~ 1.386
    say(f"\nloss {first:.3f} -> {last:.3f} "
        f"(entropy floor ~1.386); checkpoints in {args.ckpt_dir}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
