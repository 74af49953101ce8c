"""The serving forward's pieces and its compiled form
(``repro/runtime/fastpath.py``).

* :func:`restack_segments` regroups the engine's per-layer
  ``QuantizedLinear`` records into layer-stacked segments, one per run of
  consecutive layers sharing a kernel container (int4-packed, int8, or
  fake-quantized full-precision matrices for > 8-bit plan layers);
* :func:`quantized_block` is the decoder block with quantized matmuls and
  :func:`scan_segment` loops it over a segment;
* :func:`transport_quantize` is the uplink quantizer, masked past each
  row's true length;
* :func:`build_forward` closes agent stage, transport and server stage
  into one ``forward(params, agent, tokens, lengths) -> logits``;
  :func:`compile_forward` makes it a :class:`CompiledForward` for one
  (B, S) bucket, and :class:`CompiledForwardCache` memoizes those.

The reference AOT-compiles the forward with XLA.  The port's counterpart
on the card is a CUDA graph: the closure runs once eagerly (so every
lazily allocated buffer, kernel attribute and cuBLAS workspace exists),
then is captured once over static token, length and output buffers, and
every later call copies the batch into the static inputs and replays the
graph, one launch for the ~1,600 kernels of a full-width forward.  The
reference ships its loop bounds (``forward_bounds``) as a runtime argument
only so that XLA cannot unroll its loops; a graph is shape-specific
anyway, so the port bakes the bounds in, with ``n_rows`` = the bucket's
batch as the reference passes it.  On a CPU engine ``compiled=True`` runs
the same closure uncaptured, through the same cache and keys: which code
runs follows from the tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.quantization import QuantConfig, _uniform_qdq
from ..kernels import build
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
    raise a row's absmax), then quantize-dequantizes each of the first
    ``n_rows`` rows at ``b_emb`` with its own per-tensor absmax (one
    request's own transmission never shares a scale with another); rows
    from ``n_rows`` on come out zero.

    The reference quantizes row by row inside a ``lax.while_loop``, where
    XLA forms the step as ``amax * fl(1/levels)``; so does this
    (``_uniform_qdq(compiled=True)``), bitwise equal to it.  It runs as one
    batched op: a per-row absmax over [S, D] (a max is exact in any order),
    then elementwise scale, round and clip, the same bits as the row loop
    in a fixed number of launches, with nothing read back to the host
    (``lengths`` is a device tensor), so a CUDA graph can capture it.
    """
    s = emb.shape[1]
    mask = torch.arange(s, device=emb.device)[None, :] < lengths[:, None]
    emb = emb * mask[..., None].to(emb.dtype)
    if b_emb >= 16:
        return emb
    qcfg = QuantConfig(bits=b_emb, scheme="uniform",
                       granularity="per-tensor")
    amax = torch.amax(torch.abs(emb), dim=(1, 2), keepdim=True)
    out = _uniform_qdq(emb, qcfg, compiled=True, amax=amax)
    if n_rows < emb.shape[0]:
        out[int(n_rows):] = 0.0
    return out


# ---------------------------------------------------------------------------
# the end-to-end forward
# ---------------------------------------------------------------------------

def build_forward(model, split: int, b_emb: int, descs, path: str,
                  n_rows: int):
    """Close agent stage + transport + server stage over ``model`` into one
    ``forward(params, agent, tokens, lengths) -> logits``.

    ``path`` is ``"kernel"`` (``agent`` = restacked segment arrays, looped
    per ``descs``) or ``"fake"`` (``agent`` = the fake-quantized parameter
    tree).  ``lengths`` [B] marks each row's true token count: the
    transport mask zeroes every bucket-padded position, so a row's
    per-request absmax cannot depend on the padding.  The ops are those the
    eager engine dispatches (``agent_stage``, ``transport``,
    ``server_stage``), in the same order.
    """
    cfg = model.cfg

    def forward(params, agent, tokens, lengths):
        batch = {"tokens": tokens}
        if path == "kernel":
            x, positions = model.embed(params, batch)
            side = layer_side_tree(params["layers"], cfg)
            for desc, seg in zip(descs, agent):
                x = scan_segment(cfg, desc, seg, side, x, positions,
                                 desc.length, model.attend)
        else:
            x, positions = model.embed(agent, batch)
            x, _ = model.run_layers_window(agent, x, positions, 0, split)
        x = transport_quantize(x, lengths, b_emb, n_rows)
        x, _ = model.run_layers_window(params, x, positions, split,
                                       cfg.n_layers)
        x = L.apply_norm(cfg, x, params["final_norm"])
        return L.unembed(cfg, params["embed"], x)

    return forward


class CompiledForward:
    """One (B, S) bucket's forward over static ``tokens`` [B, S] and
    ``lengths`` [B] buffers on the engine's device.

    On the card the forward is a captured CUDA graph: :meth:`__call__`
    replays it and returns its static output, which the next replay
    overwrites (copy out what must survive).  ``launches`` is what one
    replay launches of each kernel wrapper (``{name: n, "name.route":
    n}``, from the capture's record) and ``replays`` how often it ran.  On
    the CPU the closure runs as it stands at each call.  The entry keeps
    the parameter and agent tensors the graph reads in place alive.
    """

    def __init__(self, forward, params, agent, batch: int, seq: int,
                 device, pool=None):
        self.tokens = torch.zeros((batch, seq), dtype=torch.long,
                                  device=device)
        self.lengths = torch.zeros((batch,), dtype=torch.long,
                                   device=device)
        self._run = lambda: forward(params, agent, self.tokens,
                                    self.lengths)
        self.keep = (params, agent)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        if torch.device(device).type == "cuda":
            self._capture(device, pool)

    def _capture(self, device, pool) -> None:
        """Warm up on the capture stream, then capture.  A failure raises:
        there is no eager fallback on the card."""
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(stream):
            self._run()         # allocations, attributes, cuBLAS workspace
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), build.recording() as rec, \
                torch.cuda.graph(graph, pool=pool, stream=stream):
            self.out = self._run()
        self.graph, self.launches = graph, dict(rec)

    def __call__(self) -> torch.Tensor:
        self.replays += 1
        if self.graph is None:
            with torch.no_grad():
                return self._run()
        self.graph.replay()
        return self.out


def compile_forward(forward, params, agent, batch: int, seq: int, device,
                    pool=None) -> CompiledForward:
    """The forward for one (batch, seq) bucket: captured on a CUDA device
    (graphs sharing ``pool``), as it stands on the CPU."""
    return CompiledForward(forward, params, agent, batch, seq, device, pool)


# ---------------------------------------------------------------------------
# the compile cache
# ---------------------------------------------------------------------------

class CompiledForwardCache:
    """Memoizes compiled end-to-end forwards (:class:`CompiledForward`).

    Keys are the reference's ``(config, weight key, container signature,
    (B, S) bucket, split, b_emb)``: everything that changes the captured
    graph.  With the engine's shape bucketing the reachable keyspace is
    ``len(bucket ladder) x active plans`` per engine, so warm traffic never
    misses; ``hits``/``misses`` are surfaced in ``EngineReport`` (every
    miss is exactly one capture on the card).  One cache serves engines on
    one device; its graphs share one memory pool, so they must not replay
    concurrently (the engines replay on one stream, one at a time).
    """

    def __init__(self):
        self._exe: Dict[tuple, CompiledForward] = {}
        self.hits = 0
        self.misses = 0
        self._pool = None

    def __len__(self) -> int:
        return len(self._exe)

    def __contains__(self, key: tuple) -> bool:
        """Membership probe that does NOT touch the hit/miss counters, so
        an engine can trace an upcoming capture without double-counting."""
        return key in self._exe

    def pool(self):
        """The memory pool this cache's CUDA graphs share."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key: tuple, build: Callable[[], CompiledForward]):
        """The forward for ``key``, building (capturing) it on a miss."""
        if key in self._exe:
            self.hits += 1
        else:
            self.misses += 1
            self._exe[key] = build()
        return self._exe[key]

    def kernel_launches(self) -> Dict[str, int]:
        """Kernel launches the cache's graphs made in their replays:
        ``{name: n, "name.route": n}``, each graph's record times its
        replays (its capture launched nothing)."""
        out: Dict[str, int] = {}
        for cf in self._exe.values():
            for k, n in cf.launches.items():
                out[k] = out.get(k, 0) + n * cf.replays
        return out

    def replays(self) -> int:
        return sum(cf.replays for cf in self._exe.values())
