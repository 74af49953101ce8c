#!/usr/bin/env python3
"""``row_gemm`` on the CUDA card: the kernel against the parent commit's
kernel and ``torch.matmul`` in one call, and a sweep of its schedule.

    python3 tools/row_gemm_tune.py [--parent FILE | --rev REV]
        [--shapes 128x64 256x64 128x128] [--stages 8 20]
        [--min-rows 64 128 256] [--head-bytes 32768 65536]
        [--head-ring 65536 98304 163840] [--reps 15]
    python3 tools/row_gemm_tune.py --slices

* The parent: ``csrc/row_gemm.cu`` as it was at REV (``git show``; default
  HEAD, i.e. before the working tree's change) or the file given, built
  into ``build/`` with the port's flags and called through its own C
  interface and schedule (the first design's: 128-column tiles, a split
  of K over about 264 blocks, an arrival counter and a workspace).
* At M = 4 (a B = 4 decode step), L2 flushed before every launch
  (``chip_smoke.time_ms``): each decode product of qwen2-0.5b and
  stablelm-3b (wq/wo, wk/wv, gate/up, down, the tied head) and the two
  grouped launches (q | k | v with biases, gate | up) by the kernel, the
  parent (a group as the sum of its separate launches) and one library
  call (``torch.matmul``; a group as one product on the concatenated
  weight, ``torch.addmm`` with the concatenated bias), beside the byte
  bound; then one token step summed: 24 x (q|k|v, wo, gate|up, down) +
  head for the kernel, 24 x 7 + head for the parent and the library.
  Every output is held to 1e-5 x max|y| of the plain version, the
  parent's too.  First, the floor the same clock reads for one tiny op.
* The sweep, per launch of the step on the row-major route (stablelm-3b's
  untied head included): the block shape (THREADSxTILE_N, each a build
  of its own with -DROW_GEMM_THREADS and -DROW_GEMM_TILE_N) x MAX_STAGES
  x MIN_ROWS (the ring and the split of K), then HEAD_TILE_BYTES x
  HEAD_RING_BYTES (the tied head's column tile and its ring).  The wrapper's constants are set for each point; the kernel
  takes them at run time.
* The server stage's three shapes (896 -> 896, 896 -> 128, 4864 -> 896)
  at M = 256 and 2048 against ``torch.matmul`` (cuBLAS): a measurement
  for ROADMAP C.3, which no path takes.
* ``--slices`` (alone): the decode step's row-major launches of both
  configs at M = 16, 32, 64 and 128 (1 to 8 slices of 16 rows), L2
  flushed and hot (weights left in L2 by the launch before).  Where a
  block's chunk of K does not fit its ring (``resident`` false), each
  slice streams the chunk through the ring again: the weight bytes a
  launch requests are slices x K x N x 4.  Printed beside them: that
  request's rate, and the time one pass over the weights takes at the
  HBM rate.  A request rate above the HBM rate, or a flushed time within
  about one HBM pass of the hot time, means the later slices' reads were
  served from L2.

Prints one JSON line per timed shape and the card's name and power limit.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCE = "src/repro_torch/kernels/csrc/row_gemm.cu"


def parent_library(build, path=None, rev="HEAD"):
    """Build the parent's kernel (the file at ``path``, else the source
    at git revision ``rev``); returns its bound entry point."""
    if path:
        text = pathlib.Path(path).read_text()
    else:
        text = subprocess.run(["git", "show", f"{rev}:{SOURCE}"],
                              cwd=ROOT, capture_output=True, text=True,
                              check=True).stdout
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "row_gemm_parent.cu"
    cu.write_text(text)
    lib = cu.with_suffix(".so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True)
    fn = ctypes.CDLL(str(lib)).row_gemm_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
        [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def parent_schedule(k: int, n: int):
    """The parent wrapper's (chunk, splits) of K for w [K, N]."""
    tiles = -(-n // 128)
    most = max(1, -(-k // 64))
    splits = min(max(1, -(-264 // tiles)), most)
    chunk = -(-k // splits)
    chunk = -(-chunk // 4) * 4
    return chunk, -(-k // chunk)


def parent_call(fn, x, w, build):
    """A closure launching the parent's kernel for x @ w; returns (call,
    output)."""
    import torch
    m, k = x.shape
    n = w.shape[1]
    transposed = int(w.stride(0) == 1 and w.stride(1) != 1)
    ld = w.stride(1) if transposed else w.stride(0)
    chunk, splits = (0, 1) if transposed else parent_schedule(k, n)
    out = torch.empty((m, n), device=x.device)
    ws = torch.empty(max(splits * m * n, 1), device=x.device)
    cnt = build.arrival_counters(x.device, -(-n // 128))

    def call():
        build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                       ws.data_ptr(), cnt.data_ptr(), m, k, n, ld,
                       transposed, chunk, splits,
                       torch.cuda.current_stream().cuda_stream),
                    "parent row_gemm")
    return call, out


def variant(build, threads: int, tile_n: int):
    """The kernel built with another row-major block shape; returns its
    entry point."""
    name = f"row_gemm_t{threads}_n{tile_n}"
    lib = build.BUILD_DIR / f"{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                    f"-DROW_GEMM_THREADS={threads}",
                    f"-DROW_GEMM_TILE_N={tile_n}", "-o", str(lib),
                    str(build.CSRC / "row_gemm.cu")], check=True)
    fn = ctypes.CDLL(str(lib)).row_gemm_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def slice_sweep(cs, rg, cfgs, gen, dev, flush, reps) -> None:
    """The step's row-major launches at 1 to 8 slices, flushed and hot."""
    import torch
    from repro_torch.kernels import ref
    hot = torch.empty(1, device=dev)       # zeroing it flushes nothing
    for cfg in cfgs:
        for name, k, ns, _, per, _, layout in cs.row_gemm_launches(cfg):
            if not per or layout != "kn":
                continue
            ws = [torch.randn((k, n), generator=gen, device=dev)
                  * k ** -0.5 for n in ns]
            s = rg.schedule(k, ns[0])
            resident = s.pieces <= s.stages
            w_bytes = 4.0 * k * sum(ns)
            for m in (16, 32, 64, 128):
                x = torch.randn((m, k), generator=gen, device=dev)
                fn = lambda x=x, ws=ws: rg.row_gemm_group(x, ws)  # noqa
                got = fn()
                for g, w in zip(got, ws):
                    want = ref.row_gemm_ref(x, w)
                    d = float((g - want).abs().max())
                    assert d <= 1e-5 * float(want.abs().max()), name
                slices = -(-m // rg.SLICE)
                requested = w_bytes * (1 if resident else slices)
                t_f = cs.time_ms(fn, flush, reps=reps)
                t_h = cs.time_ms(fn, hot, reps=reps)
                print(json.dumps(dict(
                    config=cfg.name, product=name, m=m, k=k, n=ns,
                    slices=slices, resident=resident, cluster=s.cluster,
                    pieces=s.pieces, stages=s.stages,
                    weight_mb=w_bytes / 1e6, requested_mb=requested / 1e6,
                    ms_flushed=t_f, ms_hot=t_h,
                    requested_tb_per_s=requested / t_f / 1e9,
                    one_hbm_pass_ms=w_bytes / cs.HBM_BYTES_PER_S * 1e3,
                    ops_bound_ms=2.0 * m * k * sum(ns) / cs.F32_FLOPS
                    * 1e3)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the parent's row_gemm.cu")
    ap.add_argument("--rev", default="HEAD")
    ap.add_argument("--shapes", nargs="+", default=["128x64"],
                    help="row-major block shapes THREADSxTILE_N to sweep")
    ap.add_argument("--stages", type=int, nargs="+", default=[8, 20])
    ap.add_argument("--min-rows", type=int, nargs="+",
                    default=[64, 128, 256])
    ap.add_argument("--head-bytes", type=int, nargs="+",
                    default=[32768, 65536])
    ap.add_argument("--head-ring", type=int, nargs="+",
                    default=[65536, 98304, 163840])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--slices", action="store_true",
                    help="only the slice sweep at M = 16..128")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.configs.stablelm_3b import FULL as SL_FULL
    from repro_torch.device import set_float32_numerics
    from repro_torch.kernels import build, ref
    rg = importlib.import_module("repro_torch.kernels.row_gemm")

    set_float32_numerics()
    build.build_all(("row_gemm",))
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.slices:
        slice_sweep(cs, rg, (FULL, SL_FULL), gen, dev, flush, args.reps)
        print(cs.card_line())
        return 0
    parent = parent_library(build, args.parent, args.rev)
    m = 4
    one = torch.zeros(1, device=dev)

    def ms(fn):
        return cs.time_ms(fn, flush, reps=args.reps)

    def held(got, want, what):
        d = float((got - want).abs().max())
        assert d <= 1e-5 * float(want.abs().max()), f"{what}: {d}"

    print(json.dumps(dict(floor_tiny_op_ms=ms(lambda: one.add_(1.0)))))
    for cfg in (FULL, SL_FULL):
        step = dict(kernel=0.0, parent=0.0, matmul=0.0, bound=0.0)
        cases = []
        for name, k, ns, bias, per, per_parent, layout in \
                cs.row_gemm_launches(cfg):
            ws = [(torch.randn((k, n), generator=gen, device=dev)
                   if layout == "kn" else
                   torch.randn((n, k), generator=gen, device=dev).T)
                  * k ** -0.5 for n in ns]
            bs = [torch.randn((n,), generator=gen, device=dev) * 0.1
                  for n in ns] if bias else None
            x = torch.randn((m, k), generator=gen, device=dev)
            if layout == "kn":
                kern = (lambda x=x, ws=ws, bs=bs:
                        rg.row_gemm_group(x, ws, bs))
            else:
                kern = lambda x=x, ws=ws: rg.row_gemm(x, ws[0])  # noqa
            cases.append((name, per, kern))
            got = kern()
            got = got if isinstance(got, list) else [got]
            want = ref.row_gemm_group_ref(x, ws, bs or [None] * len(ws))
            for g, w_ in zip(got, want):
                held(g, w_, f"{cfg.name} {name}")
            calls = []
            for w in ws:
                call, out = parent_call(parent, x, w, build)
                call()
                torch.cuda.synchronize()
                held(out, ref.row_gemm_ref(x, w), f"parent {name}")
                calls.append(call)
            # one library call for the same function: the product on the
            # concatenated weight, plus the concatenated bias when given
            wcat = torch.cat(ws, dim=1) if len(ws) > 1 else ws[0]
            if bias:
                bcat = torch.cat(bs)
                lib = lambda: torch.addmm(bcat, x, wcat)     # noqa: E731
            else:
                lib = lambda: torch.matmul(x, wcat)          # noqa: E731
            n_tot = sum(ns)
            r = dict(config=cfg.name, product=name, m=m, k=k, n=ns,
                     launches_per_step=per,
                     parent_launches_per_step=per_parent * len(ws),
                     ms=ms(kern),
                     parent_ms=sum(ms(c) for c in calls),
                     library_ms=ms(lib),
                     bound_ms=cs.bound_ms(
                         4.0 * (m * k + k * n_tot + m * n_tot),
                         2.0 * m * k * n_tot)[0])
            print(json.dumps(r))
            step["kernel"] += per * r["ms"]
            step["parent"] += per_parent * r["parent_ms"]
            step["matmul"] += per_parent * r["library_ms"]
            step["bound"] += per_parent * r["bound_ms"]
        print(json.dumps(dict(config=cfg.name, step_ms=step["kernel"],
                              parent_step_ms=step["parent"],
                              matmul_step_ms=step["matmul"],
                              bound_step_ms=step["bound"])))

        # the sweep, per launch of the step on the row-major route (the
        # singles that the step no longer launches are left out; an
        # untied head, stablelm-3b's, is in)
        names = ("MAX_STAGES", "MIN_ROWS", "HEAD_TILE_BYTES",
                 "HEAD_RING_BYTES", "THREADS", "TILE_N", "PARTS", "PIECE",
                 "_entry")
        defaults = {n_: getattr(rg, n_) for n_ in names}
        body = [c for c, e in zip(cases, cs.row_gemm_launches(cfg))
                if c[1] and e[6] == "kn"]
        try:
            for shape in args.shapes:
                threads, tile_n = (int(v) for v in shape.split("x"))
                fn = variant(build, threads, tile_n)
                rg._entry = lambda fn=fn: fn
                rg.THREADS, rg.TILE_N = threads, tile_n
                rg.PARTS = threads // (tile_n // 4)
                rg.PIECE = 4 * rg.PARTS
                for st in args.stages:
                    for mr in args.min_rows:
                        rg.MAX_STAGES, rg.MIN_ROWS = st, mr
                        per = {name: ms(kern) for name, _, kern in body}
                        tot = sum(p_ * per[n_] for n_, p_, _ in body)
                        print(json.dumps(dict(
                            config=cfg.name, threads=threads,
                            tile_n=tile_n, max_stages=st, min_rows=mr,
                            row_major_step_ms=tot, per_launch_ms=per)))
            for n_ in names:
                setattr(rg, n_, defaults[n_])
            tied = [c[2] for c, e in zip(cases, cs.row_gemm_launches(cfg))
                    if e[6] == "nk"]
            for tb in args.head_bytes:
                for ring in args.head_ring:
                    rg.HEAD_TILE_BYTES, rg.HEAD_RING_BYTES = tb, ring
                    for kern in tied:
                        print(json.dumps(dict(
                            config=cfg.name, head_tile_bytes=tb,
                            head_ring_bytes=ring, head_ms=ms(kern))))
        finally:
            for n_ in names:
                setattr(rg, n_, defaults[n_])

    # the server stage's shapes at serving M (ROADMAP C.3): a measurement
    d, f = FULL.d_model, FULL.d_ff
    for k, n in ((d, d), (d, FULL.kv_dim), (f, d)):
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        for mm in (256, 2048):
            x = torch.randn((mm, k), generator=gen, device=dev)
            held(rg.row_gemm(x, w), torch.matmul(x, w), f"server {k}x{n}")
            print(json.dumps(dict(
                product=f"server {k}->{n}", m=mm,
                ms=ms(lambda: rg.row_gemm(x, w)),
                matmul_ms=ms(lambda: torch.matmul(x, w)),
                bound_ms=cs.bound_ms(4.0 * (mm * k + k * n + mm * n),
                                     2.0 * mm * k * n)[0])))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
