"""Roofline analysis over the dry-run's records (``repro/launch/roofline.py``)
on one H100's constants.

Reads the JSON records ``launch/dryrun.py`` wrote and derives, per cell:

  compute term    = flops_per_device / peak FLOP/s   (989e12 bf16 tensor
                    cores; 67e12 for a float32 cell, which the decode
                    step's ``row_gemm`` runs outside the tensor cores)
  memory term     = hbm_bytes_per_device / HBM rate   (3.35e12 B/s)
  collective term = collective_bytes_per_device / NVLink rate (450e9 B/s
                    one direction, in the place of the TPU's ICI link)

(The accounted step is one rank's, so the per-card denominators apply
directly.)  Plus MODEL_FLOPS (6·N_active·D train / 2·N_active·tokens
prefill and decode), the useful-compute ratio MODEL_FLOPS / flops, the
dominant term, and the roofline fraction = ideal_time / max(term), where
ideal_time is the MODEL_FLOPS compute bound.  The formulas are the
reference's; a record without ``model_stats["dtype"]`` is read as
bfloat16, so the reference's own records give its terms scaled by the
constants.

Usage:
    python -m repro_torch.launch.roofline --in results/dryrun --md
    python -m repro_torch.launch.roofline --in results/dryrun \\
        --compare baseline flash
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

CHIPS = {"16x16": 256, "2x16x16": 512}


def peak_flops(rec: Dict[str, Any]) -> float:
    """The card's peak for the record's compute dtype."""
    dtype = rec.get("model_stats", {}).get("dtype", "bfloat16")
    return PEAK_FLOPS_F32 if dtype == "float32" else PEAK_FLOPS_BF16


def model_flops_per_device(rec: Dict[str, Any]) -> float:
    """MODEL_FLOPS (useful flops) per device for this cell."""
    ms = rec["model_stats"]
    chips = CHIPS[rec["mesh"]]
    n_active = ms["active_params"]
    tokens = ms["tokens"]
    if ms["kind"] == "train":
        total = 6.0 * n_active * tokens        # fwd 2ND + bwd 4ND
    else:                                       # prefill or one decode step
        total = 2.0 * n_active * tokens
    return total / chips


def _attention_flops_per_device(rec: Dict[str, Any]) -> float:
    """Analytic self-attention matmul FLOPs for the 'flash' variants (the
    fused accounting op's products are opaque to the census): 2 matmuls x
    2BS^2·H·dh x 1/2 (causal) per attention layer; x3.5 for train (the
    backward's dq/dk/dv and the in-kernel recompute)."""
    from ..configs import ALL_SHAPES, get_config
    cfg = get_config(rec["arch"])
    chips = CHIPS[rec["mesh"]]
    shape = next(s for s in ALL_SHAPES if s.name == rec["shape"])
    if shape.kind == "decode":
        return 0.0  # decode path never uses the fused prefill kernel
    per = getattr(cfg, "attn_period", 0)
    n_attn = (cfg.n_layers // per) if (cfg.family == "hybrid" and per) \
        else (0 if cfg.family == "ssm" else cfg.n_layers + cfg.n_enc_layers)
    b, s = shape.global_batch, shape.seq_len
    if cfg.n_enc_layers:
        s = s // 2  # enc-dec splits the budget (encdec.input_specs)
    fwd = n_attn * 2.0 * 2.0 * b * s * s * cfg.q_dim * 0.5
    mult = 3.5 if shape.kind == "train" else 1.0
    return fwd * mult / chips


def roofline_terms(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if rec.get("status") != "ok":
        return None
    hlo = dict(rec["hlo"])
    if "flash" in rec.get("variant", ""):
        hlo["flops_per_device"] = hlo["flops_per_device"] \
            + _attention_flops_per_device(rec)
    peak = peak_flops(rec)
    compute_s = hlo["flops_per_device"] / peak
    memory_s = hlo["hbm_bytes_per_device"] / HBM_BW
    collective_s = hlo["collective_bytes_per_device"] / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    ideal_s = mf / peak
    bound_s = max(terms.values())
    out = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "variant": rec.get("variant", "baseline"),
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_dev": mf,
        "useful_ratio": mf / max(hlo["flops_per_device"], 1e-30),
        "ideal_s": ideal_s,
        "bound_s": bound_s,
        "roofline_fraction": ideal_s / max(bound_s, 1e-30),
        "collective_breakdown": hlo.get("collective_breakdown", {}),
        "memory_analysis": rec.get("memory", {}),
    }
    return out


def load_records(directory: str, variant: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if variant and rec.get("variant") != variant:
            continue
        recs.append(rec)
    return recs


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    if x >= 1e-6:
        return f"{x * 1e6:.1f}us"
    return f"{x * 1e9:.1f}ns"


def markdown_table(rows: List[Dict[str, Any]]) -> str:
    hdr = ("| arch | shape | mesh | variant | compute | memory | collective "
           "| dominant | useful | roofline |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['variant']} "
            f"| {_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} "
            f"| {_fmt_s(r['collective_s'])} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.1%} |")
    return "\n".join(lines)


def compare_table(base: List[Dict[str, Any]], new: List[Dict[str, Any]]
                  ) -> str:
    """Before/after on the dominant term for matching cells."""
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    base_by = {key(r): r for r in base}
    lines = ["| cell | dominant (before) | before | after | delta |",
             "|---|---|---|---|---|"]
    for r in new:
        b = base_by.get(key(r))
        if b is None:
            continue
        dom = b["dominant"]
        before = b[f"{dom}_s"]
        after = r[f"{dom}_s"]
        delta = (after - before) / max(before, 1e-30)
        lines.append(
            f"| {r['arch']}/{r['shape']}/{r['mesh']} | {dom} "
            f"| {_fmt_s(before)} | {_fmt_s(after)} | {delta:+.1%} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="indir", default="results/dryrun")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--compare", nargs=2, metavar=("BASE", "NEW"),
                    default=None)
    ap.add_argument("--md", action="store_true", help="markdown output")
    ap.add_argument("--out", default=None, help="write table to file")
    args = ap.parse_args(argv)

    if args.compare:
        base = [t for r in load_records(args.indir, args.compare[0])
                if (t := roofline_terms(r))]
        new = [t for r in load_records(args.indir, args.compare[1])
               if (t := roofline_terms(r))]
        table = compare_table(base, new)
    else:
        rows = [t for r in load_records(args.indir, args.variant)
                if (t := roofline_terms(r))]
        rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
        table = markdown_table(rows)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
