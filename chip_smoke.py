#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with
no result line, when either is missing or any phase fails.  It imports
nothing of JAX or of the JAX package ``repro``.

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, TF32 flags.
2. Build: compiles every kernel of ``src/repro_torch/kernels/csrc/`` into
   ``build/kernels/`` (one ``nvcc`` per source, in parallel).
3. Kernels against their plain versions at the shapes of qwen2-0.5b's
   agent matmuls.  ``group_quantize`` on both routes (the main path's
   seven shapes and a ragged column tile on the vector route, in one
   launch; three SIMT shapes, one launch each) at bits 8, 4, 4 packed and
   3 packed: codes, scales and packed nibbles ``torch.equal``; then one
   configure (42 matrices) timed as the one grouped launch, as one vector
   launch per matrix, and as the first design's kernel (the SIMT route)
   per matrix, beside the plain version and the byte bound.
   ``qmm``/``qmm_int4`` on their tensor-core route at M in {1, 64, 256,
   1024} (64: the sequential engine, 256: the batched one) within
   rtol = atol = 1e-4 (the tolerance of tests/test_kernels.py), and every
   row of M = 64 and M = 256 bitwise equal to the row computed alone; one
   G = 1 shape on the SIMT route against the plain version.  Times each
   kernel, its plain version and one library call (``torch.matmul`` on
   the dequantized weight), with CUDA events, L2 flushed before every
   launch; the qmm bound is the arithmetic the kernel issues (3 bf16
   passes, 3 x 2MNK at 989 TFLOP/s) against its bytes, with the f32-SIMT
   bound (2MNK at 67 TFLOP/s) printed beside it.
4. The main path: qwen2-0.5b at full width (24 layers, seeded random
   weights) served through ``CoInferenceEngine(path="kernel")`` at
   b̂ = 8, b̂ = 4 and the plan [4, 4, 4, 8, 8, 8], 4 requests x 64 tokens
   as one batch and one at a time, then once more at the codesign's
   choice for T0 = 3.5 s, E0 = 2 J.  Launch counters are zeroed just
   before and read just after; every agent matmul must have gone through
   a kernel (7 per agent layer per forward), all on the tensor-core
   route (0 SIMT launches), and each configure must have quantized its
   weights in one vector-route ``group_quantize`` launch.  The boundary
   activation and the logits are then held against a forward on the
   card that runs the plain versions (tolerances at E2E_TOL and
   KERNEL_TOL below).
5. Decode attention against its plain version at qwen2-0.5b's heads
   (H = 14 over KV = 2, dh = 64): B in {1, 4}, T in {128, 1024, 4096},
   b_kv in {4, 8, 16}, ragged lengths including 0, one sliding window;
   six rows at lengths on and beside the kernel's chunk boundaries
   {0, 1, C - 1, C, C + 1, T} at T = 1024, and at T = 4096 under windows
   of 100 and 1000; within DECODE_TOL x max|out|, every row of a batch
   bitwise equal to the row alone, T grown to 2T with the lengths fixed
   bitwise equal, and a second launch on the same inputs bitwise equal
   to the first (the arrival counters reset).  Times the kernel, its
   plain version and one library call (``scaled_dot_product_attention``
   on the already-dequantized f32 cache, ``enable_gqa=True``, a length
   mask: its time leaves the dequant out) at the decode path's widest
   shape, L2 flushed, and prints the kernel's ratio to it.
6. The decode path at full width: ``DecodeEngine`` (max_batch 4) serves
   six prompts of 100-500 tokens, 32 new tokens each, arriving so that
   admission is continuous and the cache buckets span 256-1024; pinned at
   (b̂, b_kv) = (8, 8), (4, 4), (8, 16), then with ``auto=True`` under the
   CLI's two QoS classes.  The decode kernel's launch count, zeroed just
   before each run and read just after, must be 24 x the token steps run.
   Every response is held against ``greedy_decode_reference`` at batch 1,
   and a run whose prefill and decode attentions are both the plain
   versions (no launch at all) against the kernel run: tokens
   equal up to the first step whose top-2 logit margin in the reference
   run is below twice the logit difference measured on one step from the
   same state (batched against alone, or plain against kernel).  Prints
   the wall ms per token step at B = 4, tokens/s, the prefill wall per
   request and the kernel's device ms per step (CUDA events around each
   of one step's 24 launches).
7. Flash attention against its plain version at qwen2-0.5b's heads
   (H = 14 over KV = 2, dh = 64), operands in the model's [B, S, H, dh]
   layout: B in {1, 4} x S = T in {64, 100, 512, 1024} causal, the
   training shape B = 8 x S = 128, one sliding window of 128,
   bidirectional with ragged ``kv_len``, bf16 input, dh = 128.  f32
   within rtol = atol = FLASH_TOL (the reference's own,
   tests/test_flash.py, elementwise), bf16 within one bf16 ulp; every
   row of a batch bitwise equal to the row alone, and a sequence
   right-padded inside its bucket bitwise equal on its real positions.
   Times the kernel, its plain version and ``scaled_dot_product_attention
   (is_causal=True, enable_gqa=True)`` on f32 at the serve shape (B = 4,
   S = 64), the training shape (B = 8, S = 128) and S = 1024, B = 1,
   beside two bounds: the three TF32 passes the kernel issues at 495
   TFLOP/s (the JSON line's bound) and f32 outside the tensor cores.
   Phases 4 and 6 count its launches too: 24 per forward and per prefill,
   and phase 4's plain forward runs the plain attention through the
   model's ``attend`` hook.
8. Training at full width: ``Trainer.fit`` takes TRAIN_STEPS steps of
   qwen2-0.5b ``FULL`` at batch 8 x seq 128 (the CLI's defaults) with
   QAT at 8 bits and int8 error-feedback gradients; loss and grad norm
   finite at every step, flash launches exactly 2 x 24 per step (the
   forward and its recompute under remat).  Then one step from one state
   with the kernel and one with the plain attention: losses within 1e-4
   relative, grad norms within 1e-3, and at most 1e-3 of the updated
   parameters apart by more than 1e-3 lr (see ``train_path``).
9. Compiled batched serving at full width:
   ``BatchedCoInferenceEngine(path="kernel", compiled=True, max_batch=4)``
   over two QoS classes whose codesign picks b̂ = 4 and b̂ = 8
   (COMPILED_CLASSES); ``warmup(512)`` captures one CUDA graph per (class,
   sequence bucket 16..512), then 12 requests of 16-512 tokens are
   served.  Launch counters are zeroed before the engine is built and
   read after serving; a graph's kernels count once per replay (its
   capture launched nothing, its eager warm-up run counts as it ran).
   After warm-up no request may miss the cache; every response must equal
   the eager engine's at the same bucket bitwise and the request served
   alone, unpadded and eager, within E2E_TOL of its logits' scale (the
   count that is bitwise, the largest difference, and which server GEMM
   shapes change their rows with M are printed: ROADMAP C.6).  Then the
   4 x 64 forward's wall with and without the graph, and its device time
   and busy share under ``torch.profiler``.
10. Summary: one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``; the per-shape numbers are printed
   in phases 3, 5 and 7.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12           # float32 outside the tensor cores
BF16_FLOPS = 989e12         # bf16 tensor cores, dense
TF32_FLOPS = 495e12         # tf32 tensor cores, dense
QMM_PASSES = 3              # bf16 products per code on the wgmma route
QMM_M = (1, 64, 256, 1024)  # 64: the sequential engine, 256: the batch
KERNEL_TOL = 1e-4           # kernel vs plain: one matmul, the agent stage
E2E_TOL = 1e-2              # logits vs plain, relative to their max|.|
B, S = 4, 64
SLEEP_CYCLES = 4_000_000    # ~2 ms of device time at H100 clocks
DECODE_TOL = 1e-5           # decode attention vs plain, x max|out|: f32
                            # sums over <= 4096 positions in another order
DECODE_PROMPTS = (240, 100, 330, 180, 450, 500)   # buckets 512 256 512 256
DECODE_ARRIVE = (0, 0, 8, 8, 16, 4)               # 512 1024; x one step
DECODE_NEW = 32
DECODE_BUDGET = (6.0, 2.0)  # (T0, E0) of the auto run: both CLI classes
                            # feasible at full width
FLASH_TOL = 2e-5            # flash vs plain, f32: tests/test_flash.py's
FLASH_PASSES = 3            # tf32 products per f32 product in the kernel
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 10
# (name, T0, E0) of the compiled serving phase: the codesign's b̂ is 4 and
# 8 for qwen2-0.5b's weights at the 4 x 64 workload (mid-region budgets)
COMPILED_CLASSES = (("int4", 1.3, 0.675), ("int8", 1.5, 0.775))
COMPILED_REQUESTS, COMPILED_SEQ = 12, (16, 512)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 15) -> float:
    """Median device time of one call, L2 flushed before each launch.

    A device-side sleep between the flush and the start event keeps the
    card busy while the host enqueues the call, so the events bracket the
    call's device work, not the host's launch overhead."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, flops: float = F32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def agent_weight_shapes(cfg):
    """(name, K, N) of the seven matmuls of one agent layer."""
    d, f = cfg.d_model, cfg.d_ff
    return [("wq", d, cfg.q_dim), ("wk", d, cfg.kv_dim),
            ("wv", d, cfg.kv_dim), ("wo", cfg.q_dim, d),
            ("wi_gate", d, f), ("wi_up", d, f), ("ffn_wo", f, d)]


def check_kernels(cfg, dev, flush, detail):
    """Phase 3; returns {kernel: summary numbers per forward}."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref

    shapes = agent_weight_shapes(cfg)
    split = cfg.split_layer
    gen = torch.Generator(device=dev).manual_seed(1)
    summary = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                       max_abs_err=0.0, bound_by=set())
               for n in ("qmm", "qmm_int4")}
    seen = {}
    for name, k, n in shapes:
        key = (k, n)
        if key not in seen:
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            x_all = torch.randn((1024, k), generator=gen, device=dev)
            seen[key] = per_shape(cfg, w, x_all, flush, tk, ref, detail)
        # one forward = this matmul once in each of the split agent layers
        for kern, rec in seen[key].items():
            s = summary[kern]
            for f in ("ms", "plain_ms", "bound_ms", "library_ms",
                      "bound_f32_ms"):
                if rec.get(f) is not None:
                    s.setdefault(f, 0.0)
                    s[f] += split * rec[f]
            s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
            s["bound_by"].add(rec["bound_by"])
    for s in summary.values():
        s["bound_by"] = "/".join(sorted(s["bound_by"]))
    return summary


def per_shape(cfg, w, x_all, flush, tk, ref, detail):
    import torch
    k, n = w.shape
    g = 128
    out = {}
    for kern, bits in (("qmm", 8), ("qmm_int4", 4)):
        codes, scales = ref.group_quantize_ref(w, g, bits)
        if bits == 4:
            codes = ref.pack_int4_ref(codes)
        fn = getattr(tk, kern)
        plain = ref.qmm_ref if bits == 8 else ref.qmm_int4_ref
        w_deq = ref.dequantize_ref(ref.unpack_int4_ref(codes)
                                   if bits == 4 else codes, scales)
        assert qmm_module().route(k, n, g) == "wgmma"
        err = 0.0
        for m in QMM_M:
            x = x_all[:m]
            before = fn.route_launches["wgmma"]
            got, want = fn(x, codes, scales), plain(x, codes, scales)
            torch.cuda.synchronize()
            assert fn.route_launches["wgmma"] == before + 1, kern
            err = max(err, float((got - want).abs().max()))
            torch.testing.assert_close(got, want, rtol=KERNEL_TOL,
                                       atol=KERNEL_TOL)
            if m in (64, 256):
                for i in range(m):
                    assert torch.equal(fn(x[i:i + 1], codes, scales)[0],
                                       got[i]), f"{kern} row {i} {k}x{n}"
        for m in QMM_M:
            x = x_all[:m]
            n_bytes = m * k * 4 + codes.numel() + scales.numel() * 4 \
                + m * n * 4
            b, by = bound_ms(n_bytes, QMM_PASSES * 2.0 * m * n * k,
                             BF16_FLOPS)
            row = dict(ms=time_ms(lambda: fn(x, codes, scales), flush),
                       plain_ms=time_ms(lambda: plain(x, codes, scales),
                                        flush),
                       library_ms=time_ms(lambda: torch.matmul(x, w_deq),
                                          flush),
                       bound_ms=b, bound_by=by, max_abs_err=err,
                       bound_f32_ms=bound_ms(n_bytes, 2.0 * m * n * k)[0])
            detail.append(dict(kernel=kern, m=m, k=k, n=n, g=g, **row))
            if m == B * S:
                out[kern] = row
    return out


def configure_weights(cfg, dev, seed=1):
    """One configure's matrices: the seven of each agent layer, random
    weights at qwen2-0.5b's widths."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            for _ in range(cfg.split_layer)
            for _, k, n in agent_weight_shapes(cfg)]


def check_group_quantize(cfg, dev, flush):
    """Phase 3, ``group_quantize``: both routes bitwise against the plain
    version, then one configure's time; returns its summary numbers."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import ref

    def plain(w, g, bits, pack):
        codes, scales = ref.group_quantize_ref(w, g, bits)
        return (ref.pack_int4_ref(codes) if pack and bits <= 4 else codes,
                scales)

    gen = torch.Generator(device=dev).manual_seed(3)
    mats = [(torch.randn((k, n), generator=gen, device=dev), g)
            for k, n, g in [(k, n, 128)
                            for _, k, n in agent_weight_shapes(cfg)[:5]]
            + [(4864, 896, 128),          # down
               (640, 132, 64),            # odd: a ragged column tile
               (192, 896, 1),             # SIMT: per-element groups
               (130, 7, 1), (256, 127, 64)]]
    mats[0][0][:128] = 0.0                # an all-zero group
    n_vec = sum(q.route(w.shape[0], w.shape[1], g) == "vector"
                for w, g in mats)
    assert n_vec == 7, n_vec
    for bits, pack in ((8, False), (4, False), (4, True), (3, True)):
        before = dict(tk.group_quantize.route_launches)
        got = q.group_quantize_many([w for w, _ in mats],
                                    [g for _, g in mats],
                                    [bits] * len(mats), pack=pack)
        torch.cuda.synchronize()
        routes = tk.group_quantize.route_launches
        assert routes["vector"] == before["vector"] + 1, routes
        assert routes["simt"] == before["simt"] + len(mats) - n_vec, routes
        for (w, g), (codes, scales) in zip(mats, got):
            want = plain(w, g, bits, pack)
            what = f"group_quantize {tuple(w.shape)} G={g} bits={bits} " \
                f"pack={pack}"
            assert torch.equal(codes, want[0]), what + ": codes"
            assert torch.equal(scales, want[1]), what + ": scales"
    print(f"group_quantize vs plain: ok, {len(mats)} matrices ({n_vec} on "
          f"the vector route in one launch, {len(mats) - n_vec} SIMT) at "
          f"bits 8, 4, 4 packed, 3 packed: codes, scales and packed nibbles "
          f"equal")

    # one configure at b = 8 (42 matrices), and at b = 4 packed
    ws = configure_weights(cfg, dev)
    groups = [128] * len(ws)
    simt = q._entry("group_quantize_f32")

    def first_design(bits=8):
        # the first kernel (the SIMT route) on every matrix, one launch each
        stream = torch.cuda.current_stream().cuda_stream
        for w in ws:
            codes = torch.empty(w.shape, dtype=torch.int8, device=dev)
            scales = torch.empty((w.shape[0] // 128, w.shape[1]),
                                 device=dev)
            build.check(simt(w.data_ptr(), codes.data_ptr(),
                             scales.data_ptr(), w.shape[0], w.shape[1], 128,
                             bits, stream), "group_quantize_f32")

    def grouped(bits=8, pack=False):
        return q.group_quantize_many(ws, groups, [bits] * len(ws), pack=pack)

    def per_matrix(bits=8):
        for w in ws:
            q.group_quantize_many([w], [128], [bits])

    def plain_all(bits=8):
        for w in ws:
            ref.group_quantize_ref(w, 128, bits)

    for a, b in zip(grouped(), [plain(w, 128, 8, False) for w in ws]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    n_el = sum(w.numel() for w in ws)
    n_bytes = 4 * n_el + n_el + 4 * n_el // 128
    b8, by = bound_ms(n_bytes, 2.0 * n_el)
    b4, _ = bound_ms(4 * n_el + n_el // 2 + 4 * n_el // 128, 2.0 * n_el)
    row = dict(ms=time_ms(grouped, flush),
               plain_ms=time_ms(plain_all, flush, reps=5),
               bound_ms=b8, bound_by=by, library_ms=None, max_abs_err=0.0)
    per = time_ms(per_matrix, flush)
    first = time_ms(first_design, flush)
    packed = time_ms(lambda: grouped(4, True), flush)
    print(f"  group_quantize per configure ({len(ws)} matrices, "
          f"{n_el / 1e6:.1f} M weights, G=128): grouped launch "
          f"ms={row['ms']:.4f} (int4 packed {packed:.4f}, bound {b4:.4f}) "
          f"per-matrix launches {per:.4f} first design (SIMT, "
          f"{len(ws)} launches) {first:.4f} plain={row['plain_ms']:.4f} "
          f"bound={b8:.4f} ({by}); {b8 / row['ms']:.1%} of the bound")
    row["first_design_ms"] = first
    return row


def qmm_module():
    """``repro_torch.kernels.qmm`` (the package's ``qmm`` is the wrapper)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.qmm")


def check_qmm_simt(dev):
    """The SIMT route, held against the plain version at a per-element
    group layout (G = 1, as ``group_layout`` gives K = 192)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(2)
    k, n, g = 192, 896, 1
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    x = torch.randn((B * S, k), generator=gen, device=dev)
    err = 0.0
    for kern, bits in (("qmm", 8), ("qmm_int4", 4)):
        codes, scales = ref.group_quantize_ref(w, g, bits)
        if bits == 4:
            codes = ref.pack_int4_ref(codes)
        fn = getattr(tk, kern)
        plain = ref.qmm_ref if bits == 8 else ref.qmm_int4_ref
        assert qmm_module().route(k, n, g) == "simt"
        before = fn.route_launches["simt"]
        got = fn(x, codes, scales)
        torch.cuda.synchronize()
        assert fn.route_launches["simt"] == before + 1, kern
        want = plain(x, codes, scales)
        torch.testing.assert_close(got, want, rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)
        err = max(err, float((got - want).abs().max()))
    print(f"qmm SIMT route (M={B * S} K={k} N={n} G={g}, int8 and int4) "
          f"vs plain: ok, max|d|={err:.3e}")


def plain_attend(cfg):
    """A model's ``attend`` through the flash kernel's plain version."""
    from repro_torch.kernels import ref

    def attend(q, k, v):
        return ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=cfg.sliding_window).transpose(1, 2)
    return attend


def plain_lm(cfg):
    """``DecoderLM`` whose full-sequence attention is the plain version
    (differentiable: autograd runs through it)."""
    from repro_torch.models.lm import DecoderLM

    class PlainLM(DecoderLM):
        def attend(self, q, k, v):
            return plain_attend(self.cfg)(q, k, v)
    return PlainLM(cfg)


def plain_agent_stage(eng, params, tokens, layer_bits):
    """The agent stage with every kernel replaced by its plain version
    (weights quantized by the plain quantizer, the plain attention)."""
    from repro_torch.kernels import ref
    from repro_torch.models.lm import tree_map
    from repro_torch.runtime import fastpath as fp

    cfg = eng.cfg
    lp = params["layers"]
    x, pos = eng.model.embed(params, {"tokens": tokens})
    side = fp.layer_side_tree(lp, cfg)
    for i, bits in enumerate(layer_bits):
        def quant(leaf):
            codes, scales = ref.group_quantize_ref(leaf[i].contiguous(), 128,
                                                   bits)
            if bits <= 4:
                codes = ref.pack_int4_ref(codes)
            return {"codes": codes, "scales": scales}
        w = {"attn": {n: quant(lp["attn"][n]) for n in
                      ("wq", "wk", "wv", "wo")},
             "ffn": {n: quant(lp["ffn"][n]) for n in
                     ("wi_gate", "wi_up", "wo")}}
        mm = ref.qmm_int4_ref if bits <= 4 else ref.qmm_ref
        x = fp.quantized_block(cfg, lambda wd, h: mm(h, wd["codes"],
                                                    wd["scales"]),
                               w, tree_map(lambda a: a[i], side), x, pos,
                               plain_attend(cfg))
    return x, pos


def launches_per_forward(agent_path: str, split: int):
    """(int8, int4) qmm launches one forward makes on this agent path."""
    if agent_path == "fake":
        return 0, 0
    if agent_path.startswith("kernel-mixed["):
        bits = [int(b) for b in agent_path[len("kernel-mixed["):-1]
                .split("/")]
    else:
        bits = [int(agent_path[len("kernel-int"):])] * split
    return (7 * sum(4 < b <= 8 for b in bits),
            7 * sum(b <= 4 for b in bits))


def decode_case(dev, b, t, b_kv, seed, lens, h=14, kv=2, dh=64):
    """q, codes, scales and lengths on the card, at qwen2-0.5b's heads."""
    import torch
    from repro_torch.kernels.quantize import kv_quantize
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, h, dh), generator=gen, device=dev)
    k = torch.randn((b, t, kv, dh), generator=gen, device=dev)
    v = torch.randn((b, t, kv, dh), generator=gen, device=dev)
    if b_kv < 16:
        (kc, ks), (vc, vs) = kv_quantize(k, b_kv), kv_quantize(v, b_kv)
    else:
        kc, vc = k, v
        ks = vs = torch.ones(k.shape[:-1], device=dev)
    return q, kc, vc, ks, vs, torch.tensor(lens, dtype=torch.int32,
                                           device=dev)


def decode_bound(args, window: int = 0):
    """(ms, "bytes"|"operations") of one decode-attention call: q and the
    output once, and the codes and scales of every live position once
    (the kernel walks only tiles that hold one); 4 * G * dh f32 flops per
    live position and kv head."""
    q, kc, _, _, _, lens = args
    b, _, h, dh = q.shape
    t, kv = kc.shape[1], kc.shape[2]
    live = 0
    for n in lens.tolist():
        lo = max(n - window, 0) if window > 0 else 0
        live += max(min(n, t) - lo, 0)
    per_pos = kv * (2 * dh * kc.element_size() + 2 * 4)
    n_bytes = 2 * b * h * dh * 4 + b * 4 + live * per_pos
    return bound_ms(n_bytes, live * kv * 4.0 * (h // kv) * dh)


def check_decode_kernel(dev, flush):
    """Phase 5; returns the kernel's summary numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attn import CHUNK as c
    from repro_torch.kernels.quantize import kv_dequantize

    err = 0.0
    cases = [(b, t, b_kv, 0, [0, 1, t // 2 + 3, t] if b == 4 else [t - 5])
             for b in (1, 4) for t in (128, 1024, 4096) for b_kv in (4, 8, 16)]
    cases.append((4, 1024, 8, 100, [0, 1, 1024 // 2 + 3, 1024]))
    # lengths on and beside the chunk boundaries; the long cache windowed
    cases += [(6, t, b_kv, window, [0, 1, c - 1, c, c + 1, t])
              for t, window in ((1024, 0), (4096, 100), (4096, 1000))
              for b_kv in (4, 8, 16)]
    for b, t, b_kv, window, lens in cases:
        args = decode_case(dev, b, t, b_kv, seed=t + b_kv, lens=lens)
        out = tk.quantized_decode_attention(*args, window=window)
        want = ref.quantized_decode_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        diff = float((out - want).abs().max())
        assert diff <= DECODE_TOL * scale, \
            f"decode attention B={b} T={t} b_kv={b_kv} window={window}: " \
            f"{diff} of {scale}"
        err = max(err, diff)
        if b > 1:
            assert bool((out[0] == 0).all()), "cache_len 0 attended"
            for i in range(b):
                alone = tk.quantized_decode_attention(
                    *(a[i:i + 1] for a in args), window=window)
                assert torch.equal(alone[0], out[i]), \
                    f"decode attention row {i} alone != in batch (T={t})"
        q, kc, vc, ks, vs, ln = args
        pad = (0, 0, 0, 0, 0, t)
        grown = tk.quantized_decode_attention(
            q, F.pad(kc, pad), F.pad(vc, pad), F.pad(ks, pad[2:], value=1.0),
            F.pad(vs, pad[2:], value=1.0), ln, window=window)
        assert torch.equal(grown, out), \
            f"decode attention at 2T != at T={t} (B={b}, b_kv={b_kv})"
    # twice on the same inputs: the arrival counters were left at zero
    args = decode_case(dev, 4, 1024, 8, seed=8, lens=[1024, 800, 532, 300])
    before = tk.quantized_decode_attention.launches
    first = tk.quantized_decode_attention(*args)
    second = tk.quantized_decode_attention(*args)
    torch.cuda.synchronize()
    assert tk.quantized_decode_attention.launches == before + 2
    assert torch.equal(first, second), "decode attention: a second launch " \
        "on the same inputs changed bits"
    print(f"decode attention vs plain: ok over {len(cases)} cases (chunk "
          f"edges, windows 100 and 1000 at T=4096), max|d|={err:.3e}; rows "
          f"alone, T -> 2T and a second launch bitwise")

    # times at the decode path's widest shape: B = 4 slots of a 1024
    # bucket, int8 codes, lengths as the path gives them
    rows = {}
    for b_kv in (8, 4, 16):
        args = decode_case(dev, 4, 1024, b_kv, seed=b_kv,
                           lens=[1024, 800, 532, 300])
        q, kc, vc, ks, vs, lens = args
        qh = q.transpose(1, 2)                             # [B, H, 1, dh]
        kd = kv_dequantize(kc, ks).transpose(1, 2).contiguous()
        vd = kv_dequantize(vc, vs).transpose(1, 2).contiguous()
        mask = (torch.arange(1024, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)

        lib_out = library().transpose(1, 2)
        kern_out = tk.quantized_decode_attention(*args)
        torch.cuda.synchronize()
        lib_d = float((lib_out - kern_out).abs().max())
        b_ms, by = decode_bound(args)
        rows[b_kv] = dict(
            ms=time_ms(lambda: tk.quantized_decode_attention(*args), flush),
            plain_ms=time_ms(
                lambda: ref.quantized_decode_attention_ref(*args), flush),
            library_ms=time_ms(library, flush), bound_ms=b_ms, bound_by=by,
            max_abs_err=err)
        r = rows[b_kv]
        print(f"  quantized_decode_attention B=4 T=1024 b_kv={b_kv:2d} "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"sdpa={r['library_ms']:.4f} (f32 cache, dequant not "
              f"timed; max|d| vs kernel {lib_d:.2e}) kernel/sdpa="
              f"{r['ms'] / r['library_ms']:.3f} bound={b_ms:.6f} ({by})")
    return rows[8]


def flash_case(dev, b, s, seed, dh=64, dtype=None, h=14, kv=2):
    """q, k, v at qwen2-0.5b's heads in the model's [B, S, H, dh] layout,
    seen as [B, H, S, dh] (strided views, as the path passes them)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, s, n, dh), generator=gen, device=dev)
               for n in (h, kv, kv))
    if dtype is not None:
        q, k, v = (x.to(dtype) for x in (q, k, v))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def flash_bound(q, k, causal=True, passes=FLASH_PASSES):
    """(ms, "bytes"|"operations") of one flash call: q, k, v and the
    output once each against 4 * dh flops per visible (query, key) pair,
    issued as ``passes`` TF32 tensor-core products each (3 for f32
    inputs; ``passes=None``: f32 outside the tensor cores)."""
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    n_bytes = q.element_size() * (2 * b * h * s * dh + 2 * b * kv * t * dh)
    n_ops = 4.0 * dh * pairs * b * h
    if passes is None:
        return bound_ms(n_bytes, n_ops)
    return bound_ms(n_bytes, passes * n_ops, TF32_FLOPS)


def check_flash_kernel(dev, flush):
    """Phase 7; returns the kernel's summary numbers at the serve shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as tk
    from repro_torch.kernels import ref

    fwd = tk.flash_attention_fwd
    cases = [dict(b=b, s=s) for b in (1, 4) for s in (64, 100, 512, 1024)]
    cases += [dict(b=8, s=128),                      # the training shape
              dict(b=4, s=1024, window=128),
              dict(b=4, s=512, causal=False, kv_len=[512, 300, 77, 1]),
              dict(b=4, s=512, dtype=torch.bfloat16),
              dict(b=2, s=384, dh=128)]
    err = 0.0
    for c in cases:
        b, s = c["b"], c["s"]
        causal, window = c.get("causal", True), c.get("window", 0)
        lens = c.get("kv_len")
        lens = None if lens is None else torch.tensor(lens, device=dev)
        q, k, v = flash_case(dev, b, s, seed=b * s, dh=c.get("dh", 64),
                             dtype=c.get("dtype"))
        out = fwd(q, k, v, causal=causal, window=window, kv_len=lens)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, kv_len=lens)
        torch.cuda.synchronize()
        d = (out.float() - want.float()).abs()
        what = f"flash attention {c}"
        if out.dtype == torch.bfloat16:
            # both round f32 results that agree to ~1e-6: one bf16 ulp
            assert bool((d <= want.float().abs() * 2.0 ** -7
                         + FLASH_TOL).all()), what
        else:
            torch.testing.assert_close(out, want, rtol=FLASH_TOL,
                                       atol=FLASH_TOL, msg=what)
            err = max(err, float(d.max()))
        if b > 1:
            for i in range(b):
                alone = fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                            causal=causal, window=window,
                            kv_len=None if lens is None else lens[i:i + 1])
                assert torch.equal(alone[0], out[i]), f"{what}: row {i}"
    # right-padding inside the bucket: bitwise on the real positions
    for s, padded, causal in ((100, 128, True), (600, 1024, True),
                              (300, 512, False)):
        q, k, v = flash_case(dev, 2, padded, seed=s)
        short = fwd(q[:, :, :s], k[:, :, :s], v[:, :, :s], causal=causal)
        long = fwd(q, k, v, causal=causal, kv_len=None if causal else s)
        assert torch.equal(long[:, :, :s], short), \
            f"flash attention: padding {s} -> {padded} changed bits"
    print(f"flash attention vs plain: ok over {len(cases)} cases, "
          f"max|d|={err:.3e} (f32); rows alone and bucket padding bitwise")

    rows = {}
    for b, s in ((4, 64), (8, 128), (1, 1024)):
        q, k, v = flash_case(dev, b, s, seed=s)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        lib_d = float((library() - fwd(q, k, v)).abs().max())
        b_ms, by = flash_bound(q, k)
        simt_ms, simt_by = flash_bound(q, k, passes=None)
        rows[(b, s)] = r = dict(
            ms=time_ms(lambda: fwd(q, k, v), flush),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v),
                             flush),
            library_ms=time_ms(library, flush), bound_ms=b_ms, bound_by=by,
            max_abs_err=err)
        print(f"  flash_attention_fwd B={b} S=T={s} H=14 KV=2 dh=64 f32 "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"sdpa={r['library_ms']:.4f} (max|d| vs kernel {lib_d:.2e}) "
              f"bound={b_ms:.6f} ({by}, {FLASH_PASSES} tf32 passes) "
              f"f32-simt-bound={simt_ms:.6f} ({simt_by})")
    return rows[(B, S)]


def decode_path(cfg, params, dev, kernel_ms: float):
    """Phase 6; returns the decode and flash kernels' launches over the
    engine runs."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import decode_classes, decode_system_params
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import (DecodeEngine, QosClass,
                                     greedy_decode_reference)

    class RefLM(DecoderLM):
        """The model with each step's top-2 logit margins recorded, and
        with ``plain`` its attentions (prefill's and the decode step's)
        through the kernels' plain versions."""

        def __init__(self, cfg, plain=False):
            super().__init__(cfg)
            self.plain = plain
            self.margins = []

        def _note(self, logits):
            top2 = logits.topk(2, dim=-1).values
            self.margins.append(top2[:, 0] - top2[:, 1])

        def prefill(self, *a, **kw):
            logits, cache = super().prefill(*a, **kw)
            self._note(logits)
            return logits, cache

        def decode_step_q(self, *a, **kw):
            logits, cache = super().decode_step_q(*a, **kw)
            self._note(logits)
            return logits, cache

        def attend(self, q, k, v):
            if self.plain:
                return plain_attend(self.cfg)(q, k, v)
            return super().attend(q, k, v)

        def decode_attend(self, q, kc, vc, ks, vs, lens):
            if self.plain:
                return ref.quantized_decode_attention_ref(
                    q, kc, vc, ks, vs, lens, window=self.cfg.sliding_window)
            return super().decode_attend(q, kc, vc, ks, vs, lens)

    def held(got, want, margins, d, what):
        """Tokens equal up to the first step whose reference margin is
        below 2 d; returns that step or None."""
        close = np.flatnonzero(margins < 2.0 * d)
        upto = int(close[0]) if close.size else len(want)
        assert np.array_equal(got[:upto], want[:upto]), \
            f"{what}: tokens differ before step {upto}: {got} vs {want}"
        return upto if close.size else None

    model = DecoderLM(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in DECODE_PROMPTS]
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = decode_system_params(cfg, SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S), 4, S, DECODE_NEW)
    pin = QosClass("interactive", *DECODE_BUDGET)

    # one step from the same state, batched against alone and plain
    # against kernel: the logit differences the token rule allows for
    w8 = DecodeEngine(model, params, sysp, classes=[pin], auto=False,
                      device=dev).class_params(pin.name)
    states = [greedy_decode_reference(
        model, w8, p, 2, b_kv=8, reserve_tokens=1024 - p.size,
        return_state=True, device=dev)[1] for p in prompts[:4]]

    def step(lm, rows):
        qc = {k: torch.from_numpy(np.concatenate(
            [states[i][k] for i in rows], axis=1)).to(dev)
            for k in ("k_codes", "v_codes", "k_scales", "v_scales")}
        pos = torch.tensor([int(states[i]["pos"]) for i in rows],
                           dtype=torch.int32, device=dev)
        tok = torch.tensor([[int(states[i]["last_token"])] for i in rows],
                           dtype=torch.int32, device=dev)
        return lm.decode_step_q(w8, {**qc, "len": pos},
                                {"token": tok, "pos": pos}, b_kv=8)[0]

    with torch.no_grad():
        full = step(model, range(4))
        alone = torch.cat([step(model, [i]) for i in range(4)])
        plain = step(RefLM(cfg, plain=True), range(4))
        torch.cuda.synchronize()
        d_batch = float((full - alone).abs().max())
        d_plain = float((full - plain).abs().max())
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.argmax(step(model, range(4)), dim=-1)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(walls)
    print(f"decode step from one state (B=4, T=1024, b_kv=8): batched vs "
          f"alone max|d logits|={d_batch:.3e}, plain vs kernel "
          f"{d_plain:.3e}")

    class TimedLM(DecoderLM):
        """CUDA events around each decode-attention call of a step; a
        device-side sleep before each keeps the card busy while the host
        enqueues the call, so the events bracket its device work."""

        def __init__(self, cfg):
            super().__init__(cfg)
            self.events = []

        def decode_attend(self, *a):
            torch.cuda._sleep(SLEEP_CYCLES)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = super().decode_attend(*a)
            ev[1].record()
            self.events.append(ev)
            return out

    timed = TimedLM(cfg)
    with torch.no_grad():
        per_step = []
        for _ in range(3):
            timed.events.clear()
            step(timed, range(4))
            torch.cuda.synchronize()
            assert len(timed.events) == cfg.n_layers
            per_step.append(sum(a.elapsed_time(b) for a, b in timed.events))
    kernel_step_ms = statistics.median(per_step)
    prefill = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_decode_reference(model, w8, prompts[5], 1, b_kv=8,
                                device=dev)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
    print(f"decode wall: {step_ms:.2f} ms per token step at B=4 (median of "
          f"10), {4e3 / step_ms:.1f} tokens/s; prefill of "
          f"{prompts[5].size} tokens {statistics.median(prefill):.2f} ms "
          f"per request; kernel device {kernel_step_ms:.4f} ms per step "
          f"({cfg.n_layers} launches, CUDA events in the step, median of "
          f"3; {cfg.n_layers} x the L2-flushed launch "
          f"{cfg.n_layers * kernel_ms:.4f})")

    runs = [("pinned 8/8", [pin], (8, 8)), ("pinned 4/4", [pin], (4, 4)),
            ("pinned 8/16", [pin], (8, 16)),
            ("auto", decode_classes(*DECODE_BUDGET), None),
            ("plain 8/8", [pin], (8, 8))]
    launches, flash_launches, kernel_tokens = 0, 0, {}
    for name, classes, point in runs:
        plain_run = name.startswith("plain")
        lm = RefLM(cfg, plain=True) if plain_run else model
        eng = DecodeEngine(lm, params, sysp, classes=classes,
                           auto=point is None, max_batch=4,
                           max_new_tokens=DECODE_NEW, device=dev)
        if point is not None:
            eng.set_operating_point(pin.name, *point)
        t_round = eng.decode_round_cost(classes[0].name, 512)[0]
        rids = {}
        for i, p in enumerate(prompts):
            qos = classes[i % len(classes)].name
            rids[eng.submit(p, qos, arrival_s=DECODE_ARRIVE[i] * t_round)] \
                = i
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        responses = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = tk.launch_counts()
        rep = eng.report()
        # every prefill is one full-sequence pass: one flash launch a
        # layer; the plain run launches nothing
        want = 0 if plain_run else cfg.n_layers * rep.decode_rounds
        want_flash = 0 if plain_run else cfg.n_layers * rep.prefills
        assert counts == {"group_quantize": 0, "qmm": 0, "qmm_int4": 0,
                          "quantized_decode_attention": want,
                          "flash_attention_fwd": want_flash}, \
            f"{name}: launches {counts}, {rep.decode_rounds} token steps, " \
            f"{rep.prefills} prefills"
        assert rep.requests_served == len(prompts)
        assert rep.tokens_generated == len(prompts) * DECODE_NEW
        points = ", ".join(f"{c.qos} b_hat={c.b_hat} b_kv={c.b_kv}"
                           for c in rep.classes)
        print(f"  decode {name:11s} {points}: {rep.prefills} prefills, "
              f"{rep.decode_rounds} token steps, {rep.tokens_generated} "
              f"tokens in {wall:.2f}s wall, kernel launches "
              f"{counts['quantized_decode_attention']} decode, "
              f"{counts['flash_attention_fwd']} flash")
        if not plain_run:
            launches += counts["quantized_decode_attention"]
        flash_launches += counts["flash_attention_fwd"]
        for r in responses:
            i = rids[r.request_id]
            assert r.tokens.shape == (DECODE_NEW,)
            assert ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()
            if plain_run:
                want_toks, margins = kernel_tokens[i]
                at = held(r.tokens, want_toks, margins, d_plain,
                          f"plain run request {i}")
            else:
                rlm = RefLM(cfg)
                want_toks = greedy_decode_reference(
                    rlm, eng.class_params(r.qos), prompts[i], DECODE_NEW,
                    b_kv=r.b_kv, device=dev)
                margins = torch.cat(rlm.margins).cpu().numpy()
                at = held(r.tokens, want_toks, margins, d_batch,
                          f"{name} request {i}")
                if name == "pinned 8/8":
                    kernel_tokens[i] = (r.tokens, margins)
            if at is not None:
                print(f"    request {i}: reference margin below the "
                      f"measured noise at step {at}; compared up to it")
        print(f"    tokens held to the "
              f"{'kernel run' if plain_run else 'batch-1 reference'}: ok")
    return launches, flash_launches


def device_busy(fn, n: int = 3):
    """(wall ms, device ms, launches) per call of ``fn`` over ``n`` calls
    under ``torch.profiler``: device time is the kernels' own (None when
    the trace shows none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    dev_us, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            dev_us += us
            launches += e.count
    return wall, (dev_us / 1e3 / n if dev_us else None), launches // n


def server_gemm_rows(cfg, params, dev, m_batch: int, m_alone: int):
    """The server stage's GEMM shapes whose rows change with M: for each,
    rows [0, m_alone) of x [m_batch, K] @ W against x[:m_alone] @ W
    (ROADMAP C.6).  Returns {name: max|d|} of those that differ."""
    import torch
    lp = params["layers"]
    mats = {"wq": lp["attn"]["wq"][-1], "wk": lp["attn"]["wk"][-1],
            "wo": lp["attn"]["wo"][-1], "wi_gate": lp["ffn"]["wi_gate"][-1],
            "ffn_wo": lp["ffn"]["wo"][-1],
            "unembed": params["embed"]["tok"].T}
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for name, w in mats.items():
        x = torch.randn((m_batch, w.shape[0]), generator=gen, device=dev)
        d = float((torch.matmul(x, w)[:m_alone]
                   - torch.matmul(x[:m_alone], w)).abs().max())
        if d:
            out[name] = d
    return out


def compiled_serving(cfg, model, params, sysp, dev, tokens):
    """Phase 9; returns the kernel launches of its serving window (eager
    warm-up runs and graph replays).  ``tokens``: phase 4's B x S batch,
    whose forward is timed with and without the graph."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels.bucketing import seq_ladder
    from repro_torch.runtime import (BatchedCoInferenceEngine,
                                     CoInferenceEngine, QosClass)

    classes = [QosClass(n, t0, e0) for n, t0, e0 in COMPILED_CLASSES]
    rng = np.random.default_rng(6)
    lens = rng.integers(COMPILED_SEQ[0], COMPILED_SEQ[1] + 1,
                        size=COMPILED_REQUESTS)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
             classes[i % 2].name) for i, n in enumerate(lens)]

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    eng = BatchedCoInferenceEngine(model, params, sysp, classes=classes,
                                   max_batch=4, path="kernel", compiled=True,
                                   device=dev)
    assert [eng.solution_for(c.name).b_hat for c in classes] == [4, 8]
    n_graphs = eng.warmup(COMPILED_SEQ[1])
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    cc = eng.engine.compile_cache
    assert n_graphs == len(cc) == 2 * len(seq_ladder(COMPILED_SEQ[1]))
    misses = cc.misses
    sent = {eng.submit(t, q): (t, q) for t, q in reqs}
    t0 = time.perf_counter()
    batches = []
    while eng.pending():
        batches.append(eng.step())
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    counts = tk.launch_counts()
    for k, n in cc.kernel_launches().items():
        if k in counts:
            counts[k] += n
    assert cc.misses == misses, "a capture while serving after warmup"
    rep = eng.report()
    print(f"compiled batched serving: {n_graphs} CUDA graphs captured in "
          f"{t_warm:.1f}s (warmup({COMPILED_SEQ[1]}), 2 classes x "
          f"{len(seq_ladder(COMPILED_SEQ[1]))} buckets), "
          f"{rep.requests_served} requests of "
          f"{int(lens.min())}-{int(lens.max())} tokens in "
          f"{rep.batches_served} batches in {t_serve:.2f}s, "
          f"{cc.replays()} replays, 0 misses after warmup "
          f"(compile cache {rep.compile_hits} hits / {rep.compile_misses} "
          f"misses); launches {counts}")
    for b in eng.batch_history:
        print(f"  [{b.qos}] n={b.batch_size} ({b.agent_path}) "
              f"padded={b.padded_tokens} occupancy={b.occupancy:.2f}")
    for name in ("group_quantize", "qmm", "qmm_int4",
                 "flash_attention_fwd"):
        assert counts[name] > 0, f"{name} never launched while serving"

    # every response against the eager engine at the same bucket
    # (bitwise), and against the request served alone, unpadded, eager
    eager = CoInferenceEngine(model, params, sysp, path="kernel",
                              cache_weights=True, device=dev)
    worst, worst_rel, exact = 0.0, 0.0, 0
    for rs in batches:
        sol = eng.solution_for(sent[rs[0].request_id][1])
        eager.configure(sol.b_hat, sol.f, sol.f_server)
        toks = [sent[r.request_id][0] for r in rs]
        bp, sp = eng.engine.bucket_shape(len(rs), max(t.size for t in toks))
        padded = np.zeros((bp, sp), np.int32)
        real = [0] * bp
        for i, t in enumerate(toks):
            padded[i, :t.size], real[i] = t, t.size
        want, _ = eager.serve_batch({"tokens": padded}, lengths=real)
        for i, r in enumerate(rs):
            assert r.logits.shape == (real[i], cfg.vocab_size)
            assert torch.isfinite(r.logits).all()
            assert torch.equal(r.logits, want[i, :real[i]]), \
                f"request {r.request_id}: graph != eager at the bucket"
            alone, _ = eager.serve_batch({"tokens": toks[i][None]})
            d = float((r.logits - alone[0]).abs().max())
            scale = float(alone[0].abs().max())
            exact += d == 0.0
            worst, worst_rel = max(worst, d), max(worst_rel, d / scale)
            assert d <= E2E_TOL * scale, \
                f"request {r.request_id}: batched vs alone {d} of {scale}"
    bucket, alone_m = (4, COMPILED_SEQ[1]), int(lens.max())
    gemms = server_gemm_rows(cfg, params, dev, bucket[0] * bucket[1],
                             alone_m)
    print(f"  graph replay == eager at the bucket: bitwise for all "
          f"{len(sent)} requests; batched vs alone: {exact}/{len(sent)} "
          f"bitwise, max|d logits|={worst:.3e} ({worst_rel:.2e} of the "
          f"logits' max, limit {E2E_TOL}); server GEMMs whose rows change "
          f"between M={bucket[0] * bucket[1]} and M={alone_m}: "
          f"{gemms or 'none'}")

    # the 4 x 64 forward with and without the graph (after the counts
    # were read: these launches count nowhere)
    int8 = eng.solution_for(classes[1].name)
    eager.configure(int8.b_hat)
    eng.engine.configure(int8.b_hat)
    rows = {}
    for name, e in (("eager", eager), ("graph", eng.engine)):
        def serve(e=e):
            e.serve_batch({"tokens": tokens})
        serve()
        walls = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall, dev_ms, launched = device_busy(serve)
        rows[name] = statistics.median(walls)
        busy = "not measured" if dev_ms is None else \
            f"{dev_ms:.2f} device ms, {dev_ms / wall:.1%} busy"
        print(f"  serve_batch({B}x{S}) kernel-int8 {name}: wall "
              f"{rows[name]:.2f} ms (median of 7); traced 3: wall "
              f"{wall:.2f} ms, {busy}, {launched} launches per forward")
    print(f"  graph / eager wall: {rows['graph'] / rows['eager']:.3f}")
    return counts


def train_path(cfg, dev):
    """Phase 8; returns the flash launches of the ``fit`` run.

    The kernel-vs-plain step: both start from one state and see one batch,
    so their losses differ only by the attention's rounding (1e-4
    relative).  Adam's first step moves every element by lr * g / (|g| +
    eps) (+ decay), at most lr in size whatever g is, so no bound on
    max |dp| can fail; it is printed, not checked.  An element whose
    int8-coded gradient rounds to another code in the two runs (a gradient
    within the attention's rounding of a rounding edge) moves differently;
    every other element moves the same up to rounding.  So at most
    PARAM_FLIP_SHARE of the elements may differ by more than 1e-3 lr.
    """
    import math

    import torch
    from repro_torch import kernels as tk
    from repro_torch.data import (MarkovLMConfig, MarkovLMDataset,
                                  ShardedLoader)
    from repro_torch.models.lm import DecoderLM, tree_leaves
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainConfig, Trainer

    PARAM_FLIP_SHARE = 1e-3
    tc = TrainConfig(qat_bits=8, grad_compression="int8_ef", log_every=1)
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 20, TRAIN_STEPS))
    data = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH))
    tr = Trainer(DecoderLM(cfg), opt, dev, tc)
    state0 = tr.init_state(0)
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist = tr.fit(ShardedLoader(data, device=dev), TRAIN_STEPS,
                         state=state0)
    torch.cuda.synchronize()
    del final
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    per_step = 2 * cfg.n_layers          # forward + recompute under remat
    assert tc.remat
    assert counts == {"group_quantize": 0, "qmm": 0, "qmm_int4": 0,
                      "quantized_decode_attention": 0,
                      "flash_attention_fwd": per_step * TRAIN_STEPS}, \
        f"training launches {counts}"
    assert [h["step"] for h in hist] == list(range(1, TRAIN_STEPS + 1))
    for h in hist:
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]), h
    step_ms = [1e3 / h["steps_per_s"] for h in hist]
    print(f"training {cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ} qat_bits=8 "
          f"int8_ef remat: {TRAIN_STEPS} steps in {wall:.2f}s, loss "
          f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, grad norm "
          f"{hist[0]['grad_norm']:.3f} -> {hist[-1]['grad_norm']:.3f}; "
          f"{step_ms[0]:.1f} ms first step, "
          f"{statistics.median(step_ms[1:]):.1f} ms per step after "
          f"(median); flash launches {counts['flash_attention_fwd']} "
          f"({per_step} per step)")

    # one step from state0 with the kernel and with the plain attention
    batch = next(ShardedLoader(data, device=dev))
    outs = []
    for model in (DecoderLM(cfg), plain_lm(cfg)):
        t = Trainer(model, opt, dev, tc)
        outs.append(t._plain_step(*state0, batch))
        torch.cuda.synchronize()
    (pk, _, _, mk), (pp, _, _, mp) = outs
    lk, lp = float(mk["loss"]), float(mp["loss"])
    assert abs(lk - lp) <= 1e-4 * abs(lp), f"train loss {lk} vs {lp}"
    gk, gp = float(mk["grad_norm"]), float(mp["grad_norm"])
    assert abs(gk - gp) <= 1e-3 * gp, f"grad norm {gk} vs {gp}"
    lr = float(mk["lr"])
    worst, moved, n = 0.0, 0, 0
    for a, b in zip(tree_leaves(pk), tree_leaves(pp)):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        moved += int((d > 1e-3 * lr).sum())
        n += d.numel()
    print(f"train step kernel vs plain attention: loss {lk:.6f} vs "
          f"{lp:.6f}, grad norm {gk:.5f} vs {gp:.5f}; params max|d| "
          f"{worst:.3e} = {worst / lr:.3f} lr, {moved} of {n} elements "
          f"beyond 1e-3 lr")
    assert moved <= PARAM_FLIP_SHARE * n, f"{moved} of {n} params differ"
    return counts["flash_attention_fwd"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py needs a GPU",
              file=sys.stderr)
        return 1
    from repro_torch import kernels as tk
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.core.quantization import QuantPlan
    from repro_torch.data import MarkovLMConfig, MarkovLMDataset
    from repro_torch.device import set_float32_numerics
    from repro_torch.kernels import build
    from repro_torch.models.lm import DecoderLM
    from repro_torch.runtime import CoInferenceEngine, QosClass

    t_start = time.perf_counter()
    # 1. environment
    card = card_line()
    dev = torch.device("cuda")
    set_float32_numerics()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"peaks used for bounds: {HBM_BYTES_PER_S / 1e12} TB/s HBM, "
          f"{F32_FLOPS / 1e12} TFLOP/s non-tensor f32 (H100 SXM data "
          "sheet, 700 W)")

    # 2. build
    secs = build.build_all(verbose=True)
    print(f"build: {secs:.1f}s for {', '.join(build.SOURCES)}")

    # 3. kernels against their plain versions
    cfg = FULL
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)   # > 50 MB of L2
    detail = []
    t0 = time.perf_counter()
    summary = check_kernels(cfg, dev, flush, detail)
    check_qmm_simt(dev)
    summary["group_quantize"] = check_group_quantize(cfg, dev, flush)
    print(f"kernels vs plain: ok in {time.perf_counter() - t0:.1f}s")
    for name in ("qmm", "qmm_int4"):
        s = summary[name]
        print(f"  {name} per forward (M={B * S}, {7 * cfg.split_layer} "
              f"launches): ms={s['ms']:.4f} torch.matmul={s['library_ms']:.4f}"
              f" plain={s['plain_ms']:.4f} bound={s['bound_ms']:.4f} "
              f"({s['bound_by']}, {QMM_PASSES} bf16 passes) "
              f"f32-simt-bound={s['bound_f32_ms']:.4f}")
    for d in detail:
        shape = f"m={d.get('m', '-')} k={d['k']} n={d['n']}"
        print(f"  {d['kernel']:15s} {shape:22s} ms={d['ms']:.4f} "
              f"plain={d['plain_ms']:.4f} lib={d['library_ms']} "
              f"bound={d['bound_ms']:.4f} ({d['bound_by']}) "
              + (f"f32-simt-bound={d['bound_f32_ms']:.4f} "
                 if "bound_f32_ms" in d else "")
              + f"err={d['max_abs_err']:.2e}")

    # 4. the main path at full width
    t0 = time.perf_counter()
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    per_layer = cfg.active_param_count() / cfg.n_layers
    sysp = SystemParams(
        n_flop_agent=2.0 * per_layer * cfg.split_layer * B * S,
        n_flop_server=2.0 * per_layer * (cfg.n_layers - cfg.split_layer)
        * B * S)
    tokens = MarkovLMDataset(MarkovLMConfig(
        vocab_size=cfg.vocab_size, seq_len=S, batch_size=B)).batch_at(0)[
            "tokens"]
    torch.cuda.synchronize()
    print(f"model init: {time.perf_counter() - t0:.1f}s")

    plan = QuantPlan.from_layer_bits([4, 4, 4, 8, 8, 8])
    points = [(8, "kernel-int8"), (4, "kernel-int4"),
              (plan, "kernel-mixed[4/4/4/8/8/8]")]
    served = []
    want = {"group_quantize": 0, "qmm": 0, "qmm_int4": 0,
            "quantized_decode_attention": 0, "flash_attention_fwd": 0}
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    eng = CoInferenceEngine(model, params, sysp, path="kernel")
    want["group_quantize"] += 1       # one launch quantizes a configure
    for point, path in points:
        eng.configure(point)
        want["group_quantize"] += 1
        assert eng.agent_path == path, (eng.agent_path, path)
        logits, stats = eng.serve_batch({"tokens": tokens})
        alone = [eng.serve_batch({"tokens": tokens[i:i + 1]})[0]
                 for i in range(B)]
        n8, n4 = launches_per_forward(path, cfg.split_layer)
        want["qmm"] += n8 * (1 + B)
        want["qmm_int4"] += n4 * (1 + B)
        want["flash_attention_fwd"] += cfg.n_layers * (1 + B)
        served.append((point, path, logits, alone, stats))
    sol = eng.auto_configure(QosClass("interactive", t0=3.5, e0=2.0))
    assert sol is not None, "(P1) infeasible at T0=3.5s E0=2J"
    if eng.agent_path != "fake":
        want["group_quantize"] += 1
    auto_logits, _ = eng.serve_batch({"tokens": tokens})
    n8, n4 = launches_per_forward(eng.agent_path, cfg.split_layer)
    want["qmm"] += n8
    want["qmm_int4"] += n4
    want["flash_attention_fwd"] += cfg.n_layers
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    print(f"main path: {time.perf_counter() - t0:.1f}s, launches {counts}")
    assert counts == want, f"launch counts {counts} != expected {want}"
    for name, way in (("qmm", "wgmma"), ("qmm_int4", "wgmma"),
                      ("group_quantize", "vector")):
        routes = getattr(tk, name).route_launches
        assert routes == {way: counts[name], "simt": 0}, (name, routes)
    for name in ("group_quantize", "qmm", "qmm_int4", "flash_attention_fwd"):
        assert counts[name] > 0, f"{name} never launched on the main path"
    print(f"auto_configure: b_hat={sol.b_hat} f={sol.f / 1e9:.3f}GHz "
          f"f~={sol.f_server / 1e9:.3f}GHz agent_path={eng.agent_path}")
    assert torch.isfinite(auto_logits).all()

    # the served forward against the plain-version forward on the card
    # (plain quantizer and matmuls, plain attention through the model's
    # attend hook in both stages).  The boundary activation (agent stage
    # output) is held at the kernel tolerance, relative to its scale.  The
    # logits are held at E2E_TOL relative to theirs: the b_emb = 8 uplink
    # quantizer rounds, so a boundary element that sits within the
    # kernels' ~1e-6 relative error of a rounding edge moves by a whole
    # quantization step, and that step reaches the logits through 18
    # server layers.
    tok_dev = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    kernel_model, plain_model = eng.model, plain_lm(cfg)
    for point, path, logits, alone, stats in served:
        assert logits.shape == (B, S, cfg.vocab_size)
        assert torch.isfinite(logits).all(), f"{path}: non-finite logits"
        bits = point.layer_bit_list(cfg.split_layer) \
            if isinstance(point, QuantPlan) else [point] * cfg.split_layer
        eng.configure(point)
        emb, _ = eng.agent_stage({"tokens": tokens})
        emb_p, pos = plain_agent_stage(eng, eng.params, tok_dev, bits)
        emb_scale = float(emb_p.abs().max())
        emb_diff = float((emb - emb_p).abs().max())
        assert emb_diff <= KERNEL_TOL * emb_scale, \
            f"{path}: boundary activation differs by {emb_diff}"
        eng.model = plain_model
        try:
            ref_logits = eng.server_stage(eng.transport(emb_p)[0], pos)
        finally:
            eng.model = kernel_model
        scale = float(ref_logits.abs().max())
        diff = float((logits - ref_logits).abs().max())
        assert diff <= E2E_TOL * scale, f"{path}: logits differ by {diff}"
        # greedy tokens equal wherever the plain logits' top-2 margin
        # exceeds the measured error (a nearer tie is a coin flip)
        top2 = ref_logits.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * diff
        same = logits.argmax(-1) == ref_logits.argmax(-1)
        assert bool(same[clear].all()), f"{path}: greedy tokens differ"
        row = max(float((logits[i] - alone[i][0]).abs().max())
                  for i in range(B))
        print(f"  {path:26s} boundary max|d|={emb_diff:.3e} of "
              f"{emb_scale:.3e}; logits max|d|={diff:.3e} of {scale:.3e}; "
              f"greedy equal at {int(same.sum())}/{same.numel()} "
              f"({int(clear.sum())} clear); batch row vs alone "
              f"max|d|={row:.3e}; emb_bytes={stats.emb_bytes}")
        assert row <= E2E_TOL * scale, f"{path}: batched row != alone"

    # wall time of one served forward per operating point (after the
    # launch counts were read: these launches count nowhere)
    for point, path, *_ in served:
        eng.configure(point)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve_batch({"tokens": tokens})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"  {path:26s} serve_batch({B}x{S}) wall "
              f"{statistics.median(walls):.2f} ms (median of 5)")

    # 5. decode attention against its plain version
    t0 = time.perf_counter()
    summary["quantized_decode_attention"] = check_decode_kernel(dev, flush)
    print(f"decode kernel phase: {time.perf_counter() - t0:.1f}s")

    # 6. the decode path at full width
    t0 = time.perf_counter()
    counts["quantized_decode_attention"], flash_decode = decode_path(
        cfg, params, dev, summary["quantized_decode_attention"]["ms"])
    print(f"decode path: {time.perf_counter() - t0:.1f}s")

    # 7. flash attention against its plain version
    t0 = time.perf_counter()
    summary["flash_attention_fwd"] = check_flash_kernel(dev, flush)
    print(f"flash kernel phase: {time.perf_counter() - t0:.1f}s")

    # 8. training at full width
    t0 = time.perf_counter()
    flash_train = train_path(cfg, dev)
    print(f"train path: {time.perf_counter() - t0:.1f}s")
    counts["flash_attention_fwd"] += flash_decode + flash_train

    # 9. compiled batched serving at full width
    t0 = time.perf_counter()
    served = compiled_serving(cfg, model, params, sysp, dev, tokens)
    print(f"compiled serving: {time.perf_counter() - t0:.1f}s")
    for name in ("group_quantize", "qmm", "qmm_int4", "flash_attention_fwd"):
        counts[name] += served[name]

    # 10. summary
    names = {"group_quantize": ("csrc/group_quantize.cu",
                                "src/repro/kernels/quantize.py:35"),
             "qmm": ("csrc/qmm.cu", "src/repro/kernels/qmm.py:67"),
             "qmm_int4": ("csrc/qmm.cu", "src/repro/kernels/qmm.py:140"),
             "quantized_decode_attention": (
                 "csrc/decode_attn.cu",
                 "src/repro/kernels/decode_attn.py:129"),
             "flash_attention_fwd": ("csrc/flash_attn.cu",
                                     "src/repro/kernels/flash.py:93")}
    kernels = []
    for name, (src, replaces) in names.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/{src}", replaces=replaces,
            launches=counts[name], max_abs_err=s["max_abs_err"],
            ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"]))
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
