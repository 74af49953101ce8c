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
   agent matmuls: ``group_quantize`` codes and scales ``torch.equal``;
   ``qmm``/``qmm_int4`` at M in {1, 256, 1024} within rtol = atol = 1e-4
   (the tolerance of tests/test_kernels.py), and every row of M = 256
   bitwise equal to the row computed alone.  Times each kernel, its plain
   version and one library call (``torch.matmul`` on the dequantized
   weight), with CUDA events, L2 flushed before every launch.
4. The main path: qwen2-0.5b at full width (24 layers, seeded random
   weights) served through ``CoInferenceEngine(path="kernel")`` at
   b̂ = 8, b̂ = 4 and the plan [4, 4, 4, 8, 8, 8], 4 requests x 64 tokens
   as one batch and one at a time, then once more at the codesign's
   choice for T0 = 3.5 s, E0 = 2 J.  Launch counters are zeroed just
   before and read just after; every agent matmul must have gone through
   a kernel (7 per agent layer per forward).  The boundary activation and
   the logits are then held against a forward on the card that runs the
   plain versions (tolerances at E2E_TOL and KERNEL_TOL below).
5. Summary: one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``; the per-shape numbers are printed
   in phase 3.
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
KERNEL_TOL = 1e-4           # kernel vs plain: one matmul, the agent stage
E2E_TOL = 1e-2              # logits vs plain, relative to their max|.|
B, S = 4, 64
SLEEP_CYCLES = 4_000_000    # ~2 ms of device time at H100 clocks


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
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
               for n in ("group_quantize", "qmm", "qmm_int4")}
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
            for f in ("ms", "plain_ms", "bound_ms", "library_ms"):
                if rec[f] is not None:
                    s[f] += split * rec[f]
            s["max_abs_err"] = max(s["max_abs_err"], rec["max_abs_err"])
            s["bound_by"].add(rec["bound_by"])
    summary["group_quantize"]["library_ms"] = None
    for s in summary.values():
        s["bound_by"] = "/".join(sorted(s["bound_by"]))
    return summary


def per_shape(cfg, w, x_all, flush, tk, ref, detail):
    import torch
    k, n = w.shape
    g = 128
    out = {}
    # group_quantize at bits 8 and 4: bitwise equal to the plain version
    err = 0.0
    for bits in (8, 4):
        codes, scales = tk.group_quantize(w, group_size=g, bits=bits)
        codes_p, scales_p = ref.group_quantize_ref(w, g, bits)
        torch.cuda.synchronize()
        assert torch.equal(codes, codes_p), f"group_quantize codes {k}x{n}"
        assert torch.equal(scales, scales_p), f"group_quantize scales {k}x{n}"
        err = max(err, float((scales - scales_p).abs().max()))
    n_bytes = k * n * 4 + k * n + (k // g) * n * 4
    b, by = bound_ms(n_bytes, 2.0 * k * n)
    rec = dict(ms=time_ms(lambda: tk.group_quantize(w, group_size=g), flush),
               plain_ms=time_ms(lambda: ref.group_quantize_ref(w, g), flush),
               bound_ms=b, bound_by=by, library_ms=None, max_abs_err=err)
    out["group_quantize"] = rec
    detail.append(dict(kernel="group_quantize", k=k, n=n, g=g, **rec))

    for kern, bits in (("qmm", 8), ("qmm_int4", 4)):
        codes, scales = ref.group_quantize_ref(w, g, bits)
        if bits == 4:
            codes = ref.pack_int4_ref(codes)
        fn = getattr(tk, kern)
        plain = ref.qmm_ref if bits == 8 else ref.qmm_int4_ref
        w_deq = ref.dequantize_ref(ref.unpack_int4_ref(codes)
                                   if bits == 4 else codes, scales)
        err = 0.0
        for m in (1, 256, 1024):
            x = x_all[:m]
            got, want = fn(x, codes, scales), plain(x, codes, scales)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            torch.testing.assert_close(got, want, rtol=KERNEL_TOL,
                                       atol=KERNEL_TOL)
            if m == 256:
                for i in range(m):
                    assert torch.equal(fn(x[i:i + 1], codes, scales)[0],
                                       got[i]), f"{kern} row {i} {k}x{n}"
        for m in (1, B * S, 1024):
            x = x_all[:m]
            n_bytes = m * k * 4 + codes.numel() + scales.numel() * 4 \
                + m * n * 4
            b, by = bound_ms(n_bytes, 2.0 * m * n * k)
            row = dict(ms=time_ms(lambda: fn(x, codes, scales), flush),
                       plain_ms=time_ms(lambda: plain(x, codes, scales),
                                        flush),
                       library_ms=time_ms(lambda: torch.matmul(x, w_deq),
                                          flush),
                       bound_ms=b, bound_by=by, max_abs_err=err)
            detail.append(dict(kernel=kern, m=m, k=k, n=n, g=g, **row))
            if m == B * S:
                out[kern] = row
    return out


def plain_agent_stage(eng, params, tokens, layer_bits):
    """The agent stage with every kernel replaced by its plain version
    (weights quantized by the plain quantizer)."""
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
                               w, tree_map(lambda a: a[i], side), x, pos)
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
    print(f"kernels vs plain: ok in {time.perf_counter() - t0:.1f}s")
    for d in detail:
        shape = f"m={d.get('m', '-')} k={d['k']} n={d['n']}"
        print(f"  {d['kernel']:15s} {shape:22s} ms={d['ms']:.4f} "
              f"plain={d['plain_ms']:.4f} lib={d['library_ms']} "
              f"bound={d['bound_ms']:.4f} ({d['bound_by']}) "
              f"err={d['max_abs_err']:.2e}")

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
    want = {"group_quantize": 0, "qmm": 0, "qmm_int4": 0}
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    eng = CoInferenceEngine(model, params, sysp, path="kernel")
    want["group_quantize"] += 7 * cfg.split_layer
    for point, path in points:
        eng.configure(point)
        want["group_quantize"] += 7 * cfg.split_layer
        assert eng.agent_path == path, (eng.agent_path, path)
        logits, stats = eng.serve_batch({"tokens": tokens})
        alone = [eng.serve_batch({"tokens": tokens[i:i + 1]})[0]
                 for i in range(B)]
        n8, n4 = launches_per_forward(path, cfg.split_layer)
        want["qmm"] += n8 * (1 + B)
        want["qmm_int4"] += n4 * (1 + B)
        served.append((point, path, logits, alone, stats))
    sol = eng.auto_configure(QosClass("interactive", t0=3.5, e0=2.0))
    assert sol is not None, "(P1) infeasible at T0=3.5s E0=2J"
    if eng.agent_path != "fake":
        want["group_quantize"] += 7 * cfg.split_layer
    auto_logits, _ = eng.serve_batch({"tokens": tokens})
    n8, n4 = launches_per_forward(eng.agent_path, cfg.split_layer)
    want["qmm"] += n8
    want["qmm_int4"] += n4
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    print(f"main path: {time.perf_counter() - t0:.1f}s, launches {counts}")
    assert counts == want, f"launch counts {counts} != expected {want}"
    for name, c in counts.items():
        assert c > 0, f"{name} never launched on the main path"
    print(f"auto_configure: b_hat={sol.b_hat} f={sol.f / 1e9:.3f}GHz "
          f"f~={sol.f_server / 1e9:.3f}GHz agent_path={eng.agent_path}")
    assert torch.isfinite(auto_logits).all()

    # the served forward against the plain-version forward on the card.
    # The boundary activation (agent stage output) is held at the kernel
    # tolerance, relative to its scale.  The logits are held at E2E_TOL
    # relative to theirs: the b_emb = 8 uplink quantizer rounds, so a
    # boundary element that sits within the kernels' ~1e-6 relative error
    # of a rounding edge moves by a whole quantization step, and that
    # step reaches the logits through 18 server layers.
    tok_dev = torch.as_tensor(tokens, dtype=torch.long, device=dev)
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
        ref_logits = eng.server_stage(eng.transport(emb_p)[0], pos)
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

    # 5. summary
    names = {"group_quantize": ("csrc/group_quantize.cu",
                                "src/repro/kernels/quantize.py:35"),
             "qmm": ("csrc/qmm.cu", "src/repro/kernels/qmm.py:67"),
             "qmm_int4": ("csrc/qmm.cu", "src/repro/kernels/qmm.py:140")}
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
