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
  (B, S) bucket, and :class:`CompiledForwardCache` memoizes those and the
  decode engine's captured prefill and token step (:class:`CapturedCall`).

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
import gc
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.quantization import QuantConfig, _uniform_qdq
from ..kernels import build
from ..kernels import ops as kops
from ..models import layers as L
from ..models.lm import tree_leaves, tree_map


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
    kernel for int4/int8 containers, the row-independent tensor-core GEMM
    (``layers.tc_matmul``) for fake layers."""
    if kind == "int4":
        return lambda w, x: kops.quantized_matmul_int4(
            x, w["codes"], w["scales"])
    if kind == "int8":
        return lambda w, x: kops.quantized_matmul(x, w["codes"], w["scales"])
    return lambda w, x: L.tc_matmul(x, w.to(x.dtype))


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
            x, _ = model.run_layers_window(agent, x, positions, 0, split,
                                           products=L.tc_matmul_group)
        x = transport_quantize(x, lengths, b_emb, n_rows)
        x, _ = model.run_layers_window(params, x, positions, split,
                                       cfg.n_layers,
                                       products=L.tc_matmul_group)
        x = L.apply_norm(cfg, x, params["final_norm"])
        return L.unembed(cfg, params["embed"], x, matmul=L.tc_matmul)

    return forward


def tree_key(tree) -> tuple:
    """The addresses of a weight tree's tensors: what a graph bakes in."""
    return tuple(t.data_ptr() for t in tree_leaves(tree))


class CapturedCall:
    """A closure over static buffers, captured as one CUDA graph on the card.

    ``run()`` must read and write only tensors whose addresses stay fixed
    (weights, static inputs and state the caller fills or keeps in place).
    On the card the closure runs once eagerly on the capture stream (so
    every lazily allocated buffer, kernel attribute and cuBLAS workspace
    exists), then is captured; :meth:`__call__` replays the graph and
    returns what the captured run returned, which the next replay
    overwrites.  A failed capture raises: there is no eager fallback on the
    card.  On the CPU the closure runs as it stands at each call.
    ``launches`` is what one replay launches of each kernel wrapper
    (``{name: n, "name.route": n}``, from the capture's record) and
    ``replays`` how often it ran; ``keep`` holds the tensors the graph
    reads and writes in place alive.
    """

    def __init__(self, run: Callable[[], Any], device, pool=None,
                 keep=()):
        self._run = run
        self.keep = keep
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        if torch.device(device).type == "cuda":
            self._capture(device, pool)

    def _capture(self, device, pool) -> None:
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(stream):
            self._run()         # allocations, attributes, cuBLAS workspace
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture (``torch.cuda.graph``
        # collects just before it): a finalizer that frees CUDA state there
        # invalidates the capture (seen on an H100: a generation-0 pass in a
        # stablelm-3b forward's capture)
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.no_grad(), build.recording() as rec, \
                    torch.cuda.graph(graph, pool=pool, stream=stream):
                self.out = self._run()
        finally:
            if collect:
                gc.enable()
        self.graph, self.launches = graph, dict(rec)

    def __call__(self):
        self.replays += 1
        if self.graph is None:
            with torch.no_grad():
                return self._run()
        self.graph.replay()
        return self.out


class CompiledForward(CapturedCall):
    """One (B, S) bucket's forward over static ``tokens`` [B, S] and
    ``lengths`` [B] buffers on the engine's device: a :class:`CapturedCall`
    whose replay returns the logits (copy out what must survive).  The
    entry keeps the parameter and agent tensors the graph reads alive.
    """

    def __init__(self, forward, params, agent, batch: int, seq: int,
                 device, pool=None):
        self.tokens = torch.zeros((batch, seq), dtype=torch.long,
                                  device=device)
        self.lengths = torch.zeros((batch,), dtype=torch.long,
                                   device=device)
        super().__init__(lambda: forward(params, agent, self.tokens,
                                         self.lengths),
                         device, pool, keep=(params, agent))


def compile_forward(forward, params, agent, batch: int, seq: int, device,
                    pool=None) -> CompiledForward:
    """The forward for one (batch, seq) bucket: captured on a CUDA device
    (graphs sharing ``pool``), as it stands on the CPU."""
    return CompiledForward(forward, params, agent, batch, seq, device, pool)


# ---------------------------------------------------------------------------
# the compile cache
# ---------------------------------------------------------------------------

class CompiledForwardCache:
    """Memoizes captured calls (:class:`CapturedCall`): the serving
    engines' forwards and the decode engine's prefill and token step.

    Forward keys are the reference's ``(config, weight key, container
    signature, (B, S) bucket, split, b_emb)`` followed by the addresses of
    the parameter and agent tensors the graph bakes in (:func:`tree_key`),
    which the reference's executables take as arguments.  Engines over one
    params object share the materialized agent weights through
    :meth:`buffers` (whose entry keeps those tensors alive, so a freed
    engine's addresses cannot come back under a live key), and so share
    graphs where (plan, bucket) match, as in the reference; engines with
    different weights capture their own.  The port's misses are therefore
    the reference's plus one capture per (plan, bucket) for every further
    weight set.  With the engine's shape bucketing the reachable keyspace
    is ``len(bucket ladder) x active plans`` per weight set, so warm
    traffic never misses.

    Decode keys are the reference's, ``("decode-prefill", config, S bucket,
    T bucket, batch, b_kv)`` and ``("decode-fused", config, batch, T
    bucket, b_kv)``, extended with what a graph bakes in and the
    reference's executables take as arguments: the model, the class's
    weight tree (its tensors' addresses) and the slot block's buffers.
    Slot blocks are per (class, T bucket), so the port captures per class
    where the reference compiles per b_kv: after a warm-up the two counts
    are equal when every class has its own b_kv (and plan), and the port's
    is the reference's times the classes sharing a b_kv otherwise.

    ``hits``/``misses`` are surfaced in the engines' reports (every miss is
    exactly one capture on the card).  One cache serves engines on one
    device; its graphs share one memory pool, so they must not replay
    concurrently (the engines replay on one stream, one at a time), and
    only a graph's intermediates live in the pool: what must survive a
    replay lives in buffers made outside the capture or is copied out.
    """

    def __init__(self):
        self._exe: Dict[tuple, CapturedCall] = {}
        self._buffers: Dict[tuple, Any] = {}
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

    def get(self, key: tuple, build: Callable[[], CapturedCall]):
        """The captured call for ``key``, building (capturing) it on a
        miss."""
        if key in self._exe:
            self.hits += 1
        else:
            self.misses += 1
            self._exe[key] = build()
        return self._exe[key]

    def buffers(self, key: tuple, make: Callable[[], Any]):
        """Tensors that this cache's graphs read or write in place (the
        decode oracle's batch-1 slot block, the serving engines' shared
        agent weights), made once per ``key`` and not counted among the
        variants."""
        if key not in self._buffers:
            self._buffers[key] = make()
        return self._buffers[key]

    def items(self):
        """(key, :class:`CapturedCall`) pairs, in capture order."""
        return list(self._exe.items())

    def buffer_keys(self) -> list:
        """The keys of the tensors made through :meth:`buffers`."""
        return list(self._buffers)

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
