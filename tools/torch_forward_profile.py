#!/usr/bin/env python3
"""Where the time of one served forward, one decode step, or one training
step goes on the CUDA card.

    python3 tools/torch_forward_profile.py [--seq 64] [--batch 4] [--compiled]
    python3 tools/torch_forward_profile.py --decode [--eager] [--batch 4] [--cache 1024] [--synthetic]
    python3 tools/torch_forward_profile.py --train [--seq 128] [--batch 8]

Serves qwen2-0.5b at full width (24 layers, seeded random weights).
By default through ``repro_torch``'s ``CoInferenceEngine(path="kernel")``
at b̂ = 8, b̂ = 4 and the plan [4, 4, 4, 8, 8, 8], and for each prints

* the wall time of the agent stage, the uplink quantizer and the server
  stage (host clock around work that ends in ``torch.cuda.synchronize``,
  median of 5 after warm-up);
* a ``torch.profiler`` trace of 3 forwards: device time by kernel name
  (top 12) and the device's busy share of the traced wall time.

With ``--compiled`` each operating point is then served once more by a
``CoInferenceEngine(compiled=True)``, whose forward is one captured CUDA
graph (captured before timing): the wall of ``serve_batch`` (median of 5;
it includes copying the tokens in and the logits out) and a trace of 3
replays, read the same way.

With ``--decode``: ``--batch`` prompts are prefilled through
``greedy_decode_reference`` into one slot block of ``--cache`` positions
(b̂ = 8, b_kv = 8), and the decode engine's token step over that state
(``decode_step_q``, argmax, the token block and position update) is timed
as the engine runs it: replayed from its captured CUDA graph, or with
``--eager`` its closure run eagerly; the wall per step inside a chunk of 16
steps that ends by reading the token block back (median of 5), and a
trace of 2 chunks.  With ``--synthetic`` the slot block is filled instead
with a seeded synthetic int8 cache and ragged lengths, at any width: the
reference's ``DECODE_32K`` step is ``--batch 128 --cache 32768``.

With ``--train``: one training step of ``Trainer`` (QAT at 8 bits, int8
error-feedback gradients, per-layer recompute) at ``--batch`` x ``--seq``:
the wall of the whole step and of its parts (loss and backward, gradient
compression, AdamW update; host clock, medians of 3), the step's peak
device memory (``torch.cuda.max_memory_allocated``), and a trace of 2
steps.

Every trace names the port's own kernels (the flash kernel's launches in
a training step are its forward and its recompute under remat, equal work
each) and sums the device time by kind: the port's kernels, cuBLAS GEMMs,
and everything else (elementwise, reductions, copies: the optimizer, the
quantizers and the attention backward).

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _wall_ms(fn, reps: int = 5) -> float:
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def _kernel_us(evt) -> float:
    """Device time of a kernel event (0 for host-side op events, whose
    device time is their kernels' and would be counted twice)."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    # the attribute was renamed from cuda_* to device_* in torch 2.4
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# the CUDA symbol of each of the port's kernels (csrc/*.cu)
PORT_KERNELS = {"flash_fwd_kernel": "flash_attention_fwd",
                "qmm_": "qmm / qmm_int4",  # qmm_wgmma_kernel, qmm_kernel
                "decode_attn_kernel": "quantized_decode_attention",
                "group_quantize": "group_quantize",
                "row_gemm_kn": "row_gemm, row-major route (kn)",
                "row_gemm_nk": "row_gemm, transposed head route (nk)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens per request (64; 128 with --train)")
    ap.add_argument("--batch", type=int, default=None,
                    help="requests (4; 8 with --train)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--decode", action="store_true",
                      help="profile the decode token step instead")
    mode.add_argument("--train", action="store_true",
                      help="profile one training step instead")
    ap.add_argument("--cache", type=int, default=1024,
                    help="decode cache bucket (--decode)")
    ap.add_argument("--compiled", action="store_true",
                    help="also serve each point through the captured "
                         "forward (CUDA graph) and trace its replays")
    ap.add_argument("--eager", action="store_true",
                    help="with --decode: run the token step eagerly, not "
                         "from its CUDA graph")
    ap.add_argument("--synthetic", action="store_true",
                    help="with --decode: a seeded synthetic cache with "
                         "ragged lengths instead of prefilled prompts")
    args = ap.parse_args(argv)
    if args.seq is None:
        args.seq = 128 if args.train else 64
    if args.batch is None:
        args.batch = 8 if args.train else 4

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.core.quantization import QuantPlan
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CoInferenceEngine

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card.splitlines()[0]}")
    cfg = FULL
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    if args.decode or args.train:
        if args.decode:
            _profile_decode(cfg, model, params, args)
        else:
            del params
            _profile_train(cfg, args)
        print(card.splitlines()[0])
        return 0
    eng = CoInferenceEngine(model, params,
                            SystemParams(n_flop_agent=1.0, n_flop_server=1.0),
                            path="kernel")
    tokens = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch)).batch_at(0)["tokens"]
    batch = {"tokens": tokens}

    for point in (8, 4, QuantPlan.from_layer_bits([4, 4, 4, 8, 8, 8])):
        eng.configure(point)
        for _ in range(2):
            eng.serve_batch(batch)
        emb, pos = eng.agent_stage(batch)
        rx, _ = eng.transport(emb)
        t_agent = _wall_ms(lambda: eng.agent_stage(batch))
        t_tx = _wall_ms(lambda: eng.transport(emb))
        t_server = _wall_ms(lambda: eng.server_stage(rx, pos))
        t_all = _wall_ms(lambda: eng.serve_batch(batch))
        print(f"\n{eng.agent_path} [{args.batch}x{args.seq}]: serve_batch "
              f"{t_all:.2f} ms = agent {t_agent:.2f} + uplink {t_tx:.2f} "
              f"+ server {t_server:.2f} ms (wall, median of 5)")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                eng.serve_batch(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        _print_trace(prof, wall_us, 3, "forward")
        if args.compiled:
            _profile_compiled(eng, point, batch, args)
    print(card.splitlines()[0])
    return 0


def _profile_compiled(eager, point, batch, args) -> None:
    """The same forward as one replayed CUDA graph: wall and trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import CoInferenceEngine
    eng = CoInferenceEngine(eager.model, eager.params, eager.sysp,
                            path="kernel", compiled=True)
    eng.configure(point)
    for _ in range(2):                  # the capture, then one replay
        eng.serve_batch(batch)
    t_all = _wall_ms(lambda: eng.serve_batch(batch))
    (cf,) = eng.compile_cache._exe.values()
    per = ", ".join(f"{k} {n}" for k, n in sorted(cf.launches.items())
                    if "." not in k)
    print(f"{eng.agent_path} [{args.batch}x{args.seq}] compiled (one CUDA "
          f"graph; it launches {per}): serve_batch {t_all:.2f} ms (wall, "
          f"median of 5)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.serve_batch(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _print_trace(prof, wall_us, 3, "forward")


def _print_trace(prof, wall_us: float, n: int, what: str) -> None:
    """Device busy share of the traced wall and the top kernels by device
    time, per ``what`` (n of them traced)."""
    rows = [(e.key, _kernel_us(e), e.count)
            for e in prof.key_averages() if _kernel_us(e) > 0]
    busy = sum(us for _, us, _ in rows)
    launches = sum(count for _, _, count in rows)
    print(f"  traced {n} {what}s: wall {wall_us / 1e3:.2f} ms, device "
          f"busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
          f"{launches // n} kernel launches per {what}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {us / 1e3 / n:9.3f} ms/{what}  {count // n:5d}x  "
              f"{key[:90]}")
    kinds = {}
    for key, us, count in rows:
        port = [name for sym, name in PORT_KERNELS.items() if sym in key]
        if port:
            kind = port[0]
        elif "gemm" in key.lower() or "cutlass" in key.lower():
            kind = "cuBLAS GEMMs"
        else:
            kind = "other (elementwise, reductions, copies)"
        t, c = kinds.get(kind, (0.0, 0))
        kinds[kind] = (t + us, c + count)
    print(f"  device time by kind, per {what}:")
    for kind, (us, count) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        print(f"  {us / 1e3 / n:9.3f} ms/{what}  {count // n:5d}x  {kind}")


def _profile_decode(cfg, model, params, args) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cost_model import SystemParams
    from repro_torch.runtime import (CompiledForwardCache, DecodeEngine,
                                     QosClass, greedy_decode_reference)
    from repro_torch.runtime import decode_engine as de

    pin = QosClass("interactive", t0=6.0, e0=2.0)
    w = DecodeEngine(model, params, SystemParams(n_flop_agent=1.0,
                                                 n_flop_server=1.0),
                     classes=[pin], auto=False).class_params(pin.name)
    rng = np.random.default_rng(0)
    cache = CompiledForwardCache()
    buf = de._SlotBuffers(cfg, args.cache, args.batch, 8, "cuda")
    if args.synthetic:
        _synthetic_state(cfg, buf, rng)
    else:
        states = []
        for _ in range(args.batch):
            p = rng.integers(0, cfg.vocab_size,
                             size=int(rng.integers(args.cache // 4,
                                                   args.cache // 2)))
            states.append(greedy_decode_reference(
                model, w, p, 2, b_kv=8, reserve_tokens=args.cache - p.size,
                return_state=True, compile_cache=cache)[1])
        for k in ("k_codes", "v_codes", "k_scales", "v_scales"):
            getattr(buf, k).copy_(torch.from_numpy(np.concatenate(
                [st[k] for st in states], axis=1)))
        buf.pos.copy_(torch.tensor([int(st["pos"]) for st in states]))
        buf.tok.copy_(torch.tensor([int(st["last_token"])
                                    for st in states]))
    lens = buf.pos.tolist()
    if args.eager:
        how = "eager"

        def step():
            de._decode_step(model, 8, w, buf, buf.step_io)
    else:
        step = de._step_call(cache, model, 8, w, buf)
        how = (f"one CUDA graph; it launches "
               + ", ".join(f"{k} {n}" for k, n in sorted(
                   step.launches.items()) if "." not in k))
    live = np.ones(args.batch, np.int32)

    def chunk():
        # the engine's chunk: 16 steps, then the token block read back;
        # positions advance, so each step attends one position more
        de._decode_chunk(step, buf.step_io, live, 16)[0].cpu()

    with torch.no_grad():
        chunk()
        t_step = _wall_ms(chunk) / 16
        print(f"\ndecode step [B={args.batch}, T={args.cache}, b_hat=8, "
              f"b_kv=8, {'synthetic ' if args.synthetic else ''}lengths "
              f"{min(lens)}-{max(lens)}, mean {sum(lens) / len(lens):.0f} "
              f"at the first step] {how}: {t_step:.3f} ms wall per step "
              f"in a chunk of "
              f"16 (median of 5), {args.batch * 1e3 / t_step:.1f} tokens/s")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                chunk()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    _print_trace(prof, wall_us, 32, "step")


def _synthetic_state(cfg, buf, rng) -> None:
    """Fill a slot block with a seeded int8 cache (codes in [-127, 127],
    scales in [0.01, 0.03]), random last tokens and ragged lengths from
    T / 16 to T - 160 (the first row the longest), leaving room for the
    profile's 128 steps."""
    import torch
    t = buf.k_codes.shape[2]
    gen = torch.Generator(device=buf.k_codes.device).manual_seed(0)
    for i in range(cfg.n_layers):
        for x in (buf.k_codes[i], buf.v_codes[i]):
            x.random_(-127, 128, generator=gen)
    for x in (buf.k_scales, buf.v_scales):
        x.uniform_(0.01, 0.03, generator=gen)
    lens = rng.integers(max(1, t // 16), t - 160, buf.pos.shape[0])
    lens[0] = t - 160
    buf.pos.copy_(torch.as_tensor(lens, dtype=torch.int32))
    buf.tok.random_(0, cfg.vocab_size, generator=gen)


def _profile_train(cfg, args) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import (MarkovLMConfig, MarkovLMDataset,
                                  ShardedLoader)
    from repro_torch.models.lm import DecoderLM, tree_map
    from repro_torch.optim import AdamW, compress_tree, cosine_schedule
    from repro_torch.runtime import TrainConfig, Trainer

    tr = Trainer(DecoderLM(cfg),
                 AdamW(learning_rate=cosine_schedule(3e-4, 20, 100)), "cuda",
                 TrainConfig(qat_bits=8, grad_compression="int8_ef"))
    state = tr.init_state(0)
    batch = next(ShardedLoader(MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch)), device="cuda"))

    def step():
        # each step restarts from the same state: equal work every time
        return tr._step(*state, batch)

    def parts():
        """Walls of the step's parts, each ended by a synchronize."""
        params, opt_state, err = state
        walls = []
        t0 = time.perf_counter()
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        tr._loss_fn(leaves, batch).backward()
        grads = tree_map(lambda p: p.grad, leaves)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        grads, _ = compress_tree(grads, err)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tr.opt.update(grads, opt_state, params)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return walls

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_step = _wall_ms(step, reps=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = [statistics.median(w) * 1e3 for w in zip(*[parts()
                                                       for _ in range(3)])]
    print(f"\ntrain step [{cfg.name} B={args.batch} S={args.seq}, qat_bits=8, "
          f"int8_ef, remat]: {t_step:.2f} ms wall (median of 3) = loss and "
          f"backward {split[0]:.2f} + compress {split[1]:.2f} + AdamW "
          f"{split[2]:.2f} ms (walls of the parts, medians of 3); peak "
          f"device memory {peak:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _print_trace(prof, wall_us, 2, "step")


if __name__ == "__main__":
    sys.exit(main())
