"""The per-layer pieces of the serving forward (``repro/runtime/fastpath.py``).

The reference builds its compiled fast path from these; the port's eager
engine runs them directly, and the compiled path (CUDA graphs) is a later
slice:

* :func:`restack_segments` regroups the engine's per-layer
  ``QuantizedLinear`` records into layer-stacked segments, one per run of
  consecutive layers sharing a kernel container (int4-packed, int8, or
  fake-quantized full-precision matrices for > 8-bit plan layers);
* :func:`quantized_block` is the decoder block with quantized matmuls and
  :func:`scan_segment` loops it over a segment;
* :func:`transport_quantize` is the uplink quantizer, masked past each
  row's true length.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..core.quantization import QuantConfig, quantize_dequantize
from ..kernels import ops as kops
from ..models import layers as L
from ..models.lm import tree_map


@dataclasses.dataclass(frozen=True)
class SegmentDesc:
    """One homogeneous run of agent layers: ``length`` consecutive layers
    from ``start`` in one container (``int4``, ``int8`` or ``fake``)."""
    kind: str
    start: int
    length: int


def _container_kind(rec: dict) -> str:
    probe = next(iter(rec["attn"].values()))
    if isinstance(probe, kops.QuantizedLinear):
        return "int4" if probe.bits <= 4 else "int8"
    return "fake"


def restack_segments(qlinears: List[dict]):
    """Per-layer weight records -> (segment descriptors, stacked arrays).

    Quantized containers stack to ``{"codes": [L, ...], "scales": [L, ...]}``
    (dequantization is bits-independent, so int8 layers of different plan
    bits share a segment); ``fake`` layers stack the dense matrices.
    """
    groups: List[Tuple[str, int, List[dict]]] = []
    for i, rec in enumerate(qlinears):
        kind = _container_kind(rec)
        if groups and groups[-1][0] == kind:
            groups[-1][2].append(rec)
        else:
            groups.append((kind, i, [rec]))
    descs, arrays = [], []
    for kind, start, recs in groups:
        descs.append(SegmentDesc(kind=kind, start=start, length=len(recs)))
        stacked: Dict[str, Dict[str, Any]] = {}
        for part in ("attn", "ffn"):
            stacked[part] = {}
            for name in recs[0][part]:
                ws = [r[part][name] for r in recs]
                if kind == "fake":
                    stacked[part][name] = torch.stack(ws)
                else:
                    stacked[part][name] = {
                        "codes": torch.stack([w.codes for w in ws]),
                        "scales": torch.stack([w.scales for w in ws]),
                    }
        arrays.append(stacked)
    return tuple(descs), arrays


def _segment_apply(kind: str) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """The matmul a segment applies to its stacked slices: a quantized
    kernel for int4/int8 containers, a plain matmul for fake layers."""
    if kind == "int4":
        return lambda w, x: kops.quantized_matmul_int4(
            x, w["codes"], w["scales"])
    if kind == "int8":
        return lambda w, x: kops.quantized_matmul(x, w["codes"], w["scales"])
    return lambda w, x: x @ w.to(x.dtype)


def layer_side_tree(lp: dict, cfg) -> dict:
    """The non-matmul per-layer parameters of the block (norm gains and,
    where the family has them, QKV biases), still layer-stacked."""
    t = {"ln1": lp["ln1"], "ln2": lp["ln2"]}
    if cfg.qkv_bias:
        t["attn"] = {k: lp["attn"][k] for k in ("bq", "bk", "bv")}
    return t


def quantized_block(cfg, apply_w, w, lp_i, x, positions, attend):
    """One dense decoder block whose seven matmuls go through
    ``apply_w(w, x)`` and whose attention is ``attend(q, k, v)`` (the
    model's hook, ``DecoderLM.attend``); ``lp_i`` is this layer's
    :func:`layer_side_tree` slice."""
    h = L.apply_norm(cfg, x, lp_i["ln1"])
    q = apply_w(w["attn"]["wq"], h)
    k = apply_w(w["attn"]["wk"], h)
    v = apply_w(w["attn"]["wv"], h)
    if cfg.qkv_bias:
        q = q + lp_i["attn"]["bq"].to(x.dtype)
        k = k + lp_i["attn"]["bk"].to(x.dtype)
        v = v + lp_i["attn"]["bv"].to(x.dtype)
    q = q.reshape(q.shape[:-1] + (cfg.n_heads, cfg.head_dim))
    k = k.reshape(k.shape[:-1] + (cfg.n_kv_heads, cfg.head_dim))
    v = v.reshape(v.shape[:-1] + (cfg.n_kv_heads, cfg.head_dim))
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    attn = attend(q, k, v)
    x = x + apply_w(w["attn"]["wo"],
                    attn.reshape(x.shape[:2] + (cfg.q_dim,)))
    h2 = L.apply_norm(cfg, x, lp_i["ln2"])
    if cfg.act == "silu":
        y = L.activation(cfg, apply_w(w["ffn"]["wi_gate"], h2)) \
            * apply_w(w["ffn"]["wi_up"], h2)
    else:
        y = L.activation(cfg, apply_w(w["ffn"]["wi"], h2))
    return x + apply_w(w["ffn"]["wo"], y)


def scan_segment(cfg, desc: SegmentDesc, seg_arrays, side_tree, x,
                 positions, n_layers: int, attend):
    """Loop :func:`quantized_block` over the first ``n_layers`` layers of
    one homogeneous segment."""
    ap = _segment_apply(desc.kind)
    lp_slice = tree_map(lambda a: a[desc.start:desc.start + desc.length],
                        side_tree)
    for i in range(int(n_layers)):
        w = tree_map(lambda a: a[i], seg_arrays)
        lp_i = tree_map(lambda a: a[i], lp_slice)
        x = quantized_block(cfg, ap, w, lp_i, x, positions, attend)
    return x


def transport_quantize(emb, lengths, b_emb: int, n_rows: int):
    """The uplink fake-quantizer.

    Zeroes every position past a row's true length (so padding can never
    raise a row's absmax), then applies the per-request per-tensor absmax
    quantize-dequantize at ``b_emb`` row by row: each row is one request's
    own transmission and never shares a scale with another.
    """
    s = emb.shape[1]
    mask = torch.arange(s, device=emb.device)[None, :] < lengths[:, None]
    emb = emb * mask[..., None].to(emb.dtype)
    if b_emb >= 16:
        return emb
    qcfg = QuantConfig(bits=b_emb, scheme="uniform",
                       granularity="per-tensor")
    out = torch.zeros_like(emb)
    for i in range(int(n_rows)):
        out[i] = quantize_dequantize(emb[i], qcfg)
    return out
