#!/usr/bin/env python3
"""Device time of the port's two attention kernels at their timed shapes.

    python3 tools/attn_time.py [--src DIR] [--reps 25] [--outputs FILE]
        [--long] [--offset]
    python3 tools/attn_time.py --clock

Times ``quantized_decode_attention`` at B = 4 over a T = 1024 cache
(lengths [1024, 800, 532, 300], b_kv 8, 4 and 16) and
``flash_attention_fwd`` (causal, f32, qwen2-0.5b's heads: 14 over 2,
dh = 64) at B x S = 4 x 64, 8 x 128 and 1 x 1024, each beside one
``scaled_dot_product_attention`` call on the same inputs (the decode one
on the already-dequantized cache).  Medians of CUDA-event times with the
L2 flushed before every launch (``chip_smoke.time_ms``).  Then the floors
the same clock reads: one tiny torch op, a decode call with one live
chunk (one block, then its combine) and a flash call with one query and
one key (one block, one tile).  Prints one JSON line per shape and the
card line.

``--src`` imports ``repro_torch`` from another tree's ``src`` (its kernels
build into that tree's ``build/kernels``), so two versions of the kernels
can be timed in one call on one card: run it on each, in turns.
``--outputs FILE`` also runs decode attention at B = 4 over T = 1024,
4096 and 16384 (lengths [T, 0.8 T, 0.52 T, 300], b_kv 8, 4 and 16) and
times it, and flash attention (causal f32 at 4 x 64, 8 x 128 and 1 x
1024, bf16 at 4 x 512, windowed 128 at 4 x 1024); the first run (say on
the parent's tree) saves the outputs to FILE, a later run (on the
change) holds its outputs bitwise equal to them, so a change that must
keep the kernels' bits shows that it does.
``--long`` times decode attention past the shared-memory cap the combine
once had: qwen2-0.5b's heads at T = 524,288 (B = 1, the reference's
``LONG_500K``) and granite-34b's (48 over 1, dh = 128) at T = 32,768, the
longest combine walking 8,192 chunks, each beside one
``scaled_dot_product_attention`` call on the dequantized cache.
``--offset`` times flash on a sequence chunk's queries at an offset
(sequence-parallel attention: the second half of 8 x 128, qwen2-0.5b's
training shape over two ranks, and of 1 x 1024) beside the plain version
and one ``scaled_dot_product_attention`` call with the chunk's mask.

``--clock`` builds ``csrc/flash_attn.cu`` once more with
``-DFLASH_STAGE_CLOCK`` (into ``build/kernels/``, apart from the port's
library, and run in a process of its own: a second build of a kernel
loaded beside the first refuses to launch) and prints, for the block with
the longest causal walk at B x S = 1 x 1024 and 4 x 64, the clock64()
cycles per kv tile of each part of a tile step, averaged over its 4
warps: waiting for K, splitting it, q k^T, the barrier and the next K's
copies, the softmax, waiting for V, splitting and transposing it, the
next V's copies, and p V.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


PARTS = ("wait K", "split K", "q k^T", "K copies", "softmax", "wait V",
         "split V", "V copies", "p V")


def stage_clock() -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    so = build.BUILD_DIR / "flash-stage-clock.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DFLASH_STAGE_CLOCK",
                    "-o", str(so), str(build.CSRC / "flash_attn.cu")],
                   check=True)
    fn = ctypes.CDLL(str(so)).flash_attn_f32_clock
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    for b, s in ((1, 1024), (4, 64)):
        q, k, v = cs.flash_case(dev, b, s, seed=s)
        out = torch.empty_like(q)
        clock = torch.zeros(40, dtype=torch.int64, device=dev)
        strides = (ctypes.c_longlong * 12)(
            *(x.stride(i) for x in (q, k, v, out) for i in range(3)))
        for _ in range(3):
            status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), None, ctypes.addressof(strides), b,
                        14, 2, s, s, 64, 1, 0, 0, 64 ** -0.5, 1,
                        torch.cuda.current_stream().cuda_stream,
                        clock.data_ptr())
            assert status == 0, f"cudaError_t {status}"
        torch.cuda.synchronize()
        clk = clock.tolist()
        rows = [clk[10 * w:10 * w + 10] for w in range(4)]
        tiles = rows[0][9]
        per = [sum(r[i] for r in rows) / (4 * tiles) for i in range(9)]
        print(f"flash B={b} S={s} f32 dh=64, block of the longest walk "
              f"({tiles} kv tiles), cycles per tile step (mean of 4 warps): "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(PARTS, per))
              + f"; total {sum(per):.0f}", flush=True)
    print(cs.card_line())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--clock", action="store_true")
    ap.add_argument("--outputs", default=None)
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--offset", action="store_true")
    args = ap.parse_args(argv)
    import chip_smoke as cs               # puts this tree's src on the path
    if args.clock:
        stage_clock()
        return 0
    if args.src is not None:
        # chip_smoke imported this tree's repro_torch: forget it, so that
        # the other tree's is imported (and its kernels built) below
        sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
        for name in [m for m in sys.modules
                     if m == "repro_torch" or m.startswith("repro_torch.")]:
            del sys.modules[name]
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels as tk
    from repro_torch.kernels.quantize import kv_dequantize
    from repro_torch.device import set_float32_numerics

    set_float32_numerics()
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    where = pathlib.Path(tk.__file__).resolve().parents[2]

    def t(fn):
        return cs.time_ms(fn, flush, reps=args.reps)

    for b_kv in (8, 4, 16):
        d = cs.decode_case(dev, 4, 1024, b_kv, seed=b_kv,
                           lens=[1024, 800, 532, 300])
        q, kc, vc, ks, vs, lens = d
        qh = q.transpose(1, 2)
        kd = kv_dequantize(kc, ks).transpose(1, 2).contiguous()
        vd = kv_dequantize(vc, vs).transpose(1, 2).contiguous()
        mask = (torch.arange(1024, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
        ms = t(lambda: tk.quantized_decode_attention(*d))
        lib = t(lambda: F.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=mask, enable_gqa=True))
        print(json.dumps(dict(kernel="quantized_decode_attention", b=4,
                              t=1024, b_kv=b_kv, ms=ms, sdpa_ms=lib,
                              bound_ms=cs.decode_bound(d)[0],
                              src=str(where))))
    for b, s in ((4, 64), (8, 128), (1, 1024)):
        q, k, v = cs.flash_case(dev, b, s, seed=s)
        ms = t(lambda: tk.flash_attention_fwd(q, k, v))
        lib = t(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        print(json.dumps(dict(kernel="flash_attention_fwd", b=b, s=s, ms=ms,
                              sdpa_ms=lib, src=str(where))))
    if args.outputs is not None:
        outs = {}
        for t_len in (1024, 4096, 16384):
            for b_kv in (8, 4, 16):
                lens = [t_len, int(0.8 * t_len), int(0.52 * t_len), 300]
                d = cs.decode_case(dev, 4, t_len, b_kv, seed=t_len + b_kv,
                                   lens=lens)
                outs[f"{t_len}/{b_kv}"] = \
                    tk.quantized_decode_attention(*d).cpu()
                print(json.dumps(dict(
                    kernel="quantized_decode_attention", b=4, t=t_len,
                    b_kv=b_kv, lens=lens,
                    ms=t(lambda: tk.quantized_decode_attention(*d)),
                    bound_ms=cs.decode_bound(d)[0], src=str(where))))
        for b, s, dtype, window in ((4, 64, None, 0), (8, 128, None, 0),
                                    (1, 1024, None, 0),
                                    (4, 512, torch.bfloat16, 0),
                                    (4, 1024, None, 128)):
            q, k, v = cs.flash_case(dev, b, s, seed=b * s, dtype=dtype)
            outs[f"flash {b}x{s} {str(dtype)[6:] or 'f32'} w{window}"] = \
                tk.flash_attention_fwd(q, k, v, window=window).cpu()
        saved = pathlib.Path(args.outputs)
        if saved.is_file():
            want = torch.load(saved)
            same = [k for k in outs if torch.equal(outs[k], want[k])]
            print(f"decode and flash attention outputs bitwise equal to "
                  f"{saved}: {len(same)} of {len(outs)} "
                  f"({', '.join(same)})")
            if len(same) != len(outs):
                return 1
        else:
            torch.save(outs, saved)
            print(f"decode attention outputs saved to {saved}")
    if args.long:
        for b, t_len, h, kv, dh, lens in (
                (1, 524288, 14, 2, 64, [524288 - 77]),
                (2, 32768, 48, 1, 128, [32768, 20001])):
            d = cs.decode_case(dev, b, t_len, 8, seed=t_len, lens=lens,
                               h=h, kv=kv, dh=dh)
            q, kc, vc, ks, vs, ln = d
            kd = kv_dequantize(kc, ks).transpose(1, 2).contiguous()
            vd = kv_dequantize(vc, vs).transpose(1, 2).contiguous()
            mask = (torch.arange(t_len, device=dev)[None, :]
                    < ln[:, None].long())[:, None, None, :]
            print(json.dumps(dict(
                kernel="quantized_decode_attention", b=b, t=t_len, h=h,
                kv=kv, dh=dh, b_kv=8, lens=lens,
                ms=t(lambda: tk.quantized_decode_attention(*d)),
                sdpa_ms=t(lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kd, vd, attn_mask=mask,
                    enable_gqa=True)),
                bound_ms=cs.decode_bound(d)[0], src=str(where))))
            del d, kd, vd, q, kc, vc, ks, vs
    if args.offset:
        from repro_torch.kernels import ref
        for b, t_len in ((8, 128), (1, 1024)):
            q, k, v = cs.flash_case(dev, b, t_len, seed=t_len)
            off = t_len // 2
            qc = q[:, :, off:]
            mask = (torch.arange(off, t_len, device=dev)[:, None]
                    >= torch.arange(t_len, device=dev)[None, :])
            out = tk.flash_attention_fwd(qc, k, v, q_offset=off)
            whole = tk.flash_attention_fwd(q, k, v)
            print(json.dumps(dict(
                kernel="flash_attention_fwd", b=b, s=t_len - off, t=t_len,
                q_offset=off,
                ms=t(lambda: tk.flash_attention_fwd(qc, k, v,
                                                    q_offset=off)),
                plain_ms=t(lambda: ref.flash_attention_ref(
                    qc, k, v, q_offset=off)),
                sdpa_ms=t(lambda: F.scaled_dot_product_attention(
                    qc, k, v, attn_mask=mask, enable_gqa=True)),
                bound_ms=cs.flash_bound(qc, k, q_offset=off)[0],
                rows_equal_whole=bool(torch.equal(out,
                                                  whole[:, :, off:])),
                src=str(where))))
    one = torch.zeros(1, device=dev)
    d = cs.decode_case(dev, 1, 1024, 8, seed=1, lens=[64])
    q, k, v = cs.flash_case(dev, 1, 1, seed=1, h=1, kv=1)
    print(json.dumps(dict(
        floor_tiny_op_ms=t(lambda: one.add_(1.0)),
        floor_decode_one_chunk_ms=t(
            lambda: tk.quantized_decode_attention(*d)),
        floor_flash_one_tile_ms=t(lambda: tk.flash_attention_fwd(q, k, v)),
        src=str(where))))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
