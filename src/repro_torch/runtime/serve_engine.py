"""Co-inference serving (paper §II), sequential engine
(``repro/runtime/serve_engine.py``).

:class:`CoInferenceEngine` serves one batch tensor at a time through the
paper's pipeline: agent stage (embedding + layers ``[0, split)`` at
bit-width b̂) -> uplink quantization of the boundary activation at
``b_emb`` -> server stage (layers ``[split, L)`` at full precision + tied
head), with the (b̂, f, f̃) operating point chosen by ``core.codesign``.

Agent execution paths:

* ``kernel`` — weights are int8- or int4-resident (``group_quantize`` at
  configure time) and every agent matmul launches ``qmm``/``qmm_int4``;
  uniform b̂ ∈ {4, 8} or a per-layer :class:`QuantPlan` (container chosen
  per layer, > 8-bit layers fake-quantized);
* ``fake`` — quantize-dequantize at b̂, plain matmuls (and the fallback of
  the kernel path at other uniform widths, as in the reference).

The engine runs on the CUDA card unless ``device="cpu"`` is asked for; on
the CPU every kernel wrapper runs its plain version.  :class:`CodesignCache`
memoizes the codesign solves for the decode engine.  The batched engine,
the compiled fast path and the tracer/metrics hooks are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Literal, Optional

import numpy as np
import torch

from ..core import codesign as cd
from ..core.cost_model import (SystemParams, agent_delay, agent_energy,
                               server_delay, server_energy, transport_delay,
                               transport_energy)
from ..core.quantization import (QuantConfig, QuantPlan, quantize_dequantize,
                                 wire_bytes)
from ..device import resolve_device, set_float32_numerics
from ..kernels import ops as kops
from ..models import layers as L
from ..models.lm import tree_leaves, tree_map
from . import fastpath as fp
from .qat import fake_quantize_agent


@dataclasses.dataclass(frozen=True)
class ServeStats:
    b_hat: int                  # uniform b̂, or round(mean bits) of a plan
    f: float
    f_server: float
    agent_delay_s: float
    server_delay_s: float
    transport_delay_s: float
    total_delay_s: float
    energy_j: float             # compute + uplink tx energy (eqs. 6-7 + radio)
    transport_energy_j: float   # the uplink tx share of energy_j
    emb_bytes: int
    agent_flops: float
    server_flops: float
    # wire bytes per leading batch row (sums to emb_bytes)
    emb_row_bytes: tuple = ()
    # per-agent-layer bits when a mixed-precision plan is active (else ())
    plan_bits: tuple = ()


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One (T0, E0) service class; the engine solves (P1) per class."""
    name: str
    t0: float
    e0: float


def fit_lambda(params, split: int) -> float:
    """MLE λ over the agent-partition weight magnitudes (paper eq. (3)).

    Scans the stacked leaves of ``params["layers"]`` (ndim >= 3, floating)
    in the reference's leaf order (sorted keys) and fits the exponential
    rate over layers ``[0, split)``.
    """
    total, count = 0.0, 0
    for leaf in tree_leaves(params["layers"]):
        if leaf.ndim >= 3 and torch.is_floating_point(leaf):
            sl = leaf[: min(split, leaf.shape[0])]
            total += float(torch.sum(torch.abs(sl)))
            count += sl.numel()
    return count / max(total, 1e-30) if count else 100.0


class CodesignCache:
    """Memoizes ``(SystemParams, QosClass) -> solution``.

    Every decision input (the weight statistic ``lam``, the hardware
    constants, the class's (T0, E0)) is hashable, so one dict amortizes the
    host-side solve across every request of a class and across engines
    sharing the cache.  Infeasible classes are cached as ``None``.  The
    mixed-precision ``solve_mixed`` waits for its slice.
    """

    def __init__(self):
        self._store: Dict[tuple, Any] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(lam: float, sysp: SystemParams, qos: QosClass,
            b_max: int, b_emb: Optional[int] = None,
            env_key: Optional[tuple] = None) -> tuple:
        # keyed on the numbers, not qos.name: two classes with equal
        # (T0, E0) share one solve; ``env_key`` tags a solve made under an
        # environment-adjusted SystemParams (the adaptive engine's)
        return (round(float(lam), 12), sysp, float(qos.t0), float(qos.e0),
                int(b_max), b_emb, env_key)

    def _get(self, k: tuple, solve):
        if k in self._store:
            self.hits += 1
        else:
            self.misses += 1
            self._store[k] = solve()
        return self._store[k]

    def solve(self, lam: float, sysp: SystemParams, qos: QosClass,
              b_max: int, b_emb: Optional[int] = None,
              env_key: Optional[tuple] = None
              ) -> Optional[cd.CodesignSolution]:
        return self._get(
            self.key(lam, sysp, qos, b_max, b_emb, env_key),
            lambda: cd.solve_sca(lam, sysp, qos.t0, qos.e0, b_max=b_max,
                                 b_emb=b_emb))

    def solve_decode(self, lam: float, lam_kv: float, sysp: SystemParams,
                     qos: QosClass, b_max: int,
                     b_emb: Optional[int] = None,
                     kv_ladder: "tuple[int, ...]" = (4, 8, 16),
                     kv_weight: float = 1.0,
                     env_key: Optional[tuple] = None
                     ) -> Optional[cd.DecodeSolution]:
        """Memoized joint (b̂, f, f̃, b_kv) decode solve, in a "kv"-tagged
        keyspace beside :meth:`solve`'s, so decode and prefill engines
        share one memoizer."""
        k = ("kv", round(float(lam), 12), round(float(lam_kv), 12), sysp,
             float(qos.t0), float(qos.e0), int(b_max), b_emb,
             tuple(int(b) for b in kv_ladder), float(kv_weight), env_key)
        return self._get(k, lambda: cd.solve_decode(
            lam, lam_kv, sysp, qos.t0, qos.e0, b_max=b_max, b_emb=b_emb,
            kv_ladder=kv_ladder, kv_weight=kv_weight))


class CoInferenceEngine:
    """One agent/server pair serving a dense DecoderLM."""

    def __init__(self, model, params, sysp: SystemParams, *,
                 scheme: str = "uniform",
                 path: Literal["fake", "kernel"] = "fake",
                 b_emb: int = 8,
                 compiled: bool = False,
                 device=None):
        if compiled:
            raise NotImplementedError(
                "the compiled fast path is not yet ported to repro_torch")
        if not hasattr(model, "run_layers_window"):
            raise TypeError(
                f"{type(model).__name__} lacks run_layers_window; "
                "co-inference split execution needs the DecoderLM protocol")
        self.device = resolve_device(device)
        set_float32_numerics()
        self.model = model
        self.cfg = model.cfg
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.sysp = sysp
        self.scheme = scheme
        self.path = path
        self.b_emb = b_emb
        self.split = self.cfg.split_layer
        self._axes = model.logical_axes()
        self.lam = fit_lambda(self.params, self.split)
        self.b_hat: int = 8
        # the cost model's bit-width: b̂, or a plan's mean agent bits
        self.b_eff: float = 8.0
        self.plan: Optional[QuantPlan] = None
        self.f: float = sysp.f_max
        self.f_server: float = sysp.f_server_max
        # set by configure(): fake-quantized params, or the per-layer
        # quantized records and their layer-stacked segments
        self._agent_params = None
        self._qlinears = None
        self._segments = None
        self.configure(self.b_hat, self.f, self.f_server)

    def flop_split(self, tokens: int):
        """(agent_flops, server_flops) for one forward over ``tokens``."""
        per_layer = self.cfg.active_param_count() / max(self.cfg.n_layers, 1)
        n_agent = 2.0 * per_layer * self.split * tokens
        n_server = 2.0 * per_layer * (self.cfg.n_layers - self.split) * tokens
        return n_agent, n_server

    # ------------------------------------------------------------------
    # configuration (the paper's decision variables)
    # ------------------------------------------------------------------
    def configure(self, b_hat, f: Optional[float] = None,
                  f_server: Optional[float] = None) -> None:
        """Set the operating point and materialize the agent weights.

        ``b_hat`` is a uniform bit-width or a :class:`QuantPlan`.  A plan
        whose agent layers all resolve to one width degenerates to the
        uniform path when that path quantizes identically, exactly as in
        the reference, so ``agent_path`` strings match.
        """
        kernel_ok = self.path == "kernel" and not self.cfg.n_experts
        plan = None
        if isinstance(b_hat, QuantPlan):
            plan = b_hat
            ub = plan.uniform_layer_bits(self.split)
            same_quant = plan.scheme == self.scheme \
                and plan.granularity == "per-channel"
            plan_kernel = kernel_ok and plan.scheme == "uniform"
            if ub is not None and same_quant and \
                    (not plan_kernel or ub in (4, 8) or ub > 8):
                b_hat, plan = ub, None
        if f is not None:
            self.f = float(f)
        if f_server is not None:
            self.f_server = float(f_server)
        self.plan = plan
        if plan is None:
            self.b_hat = int(b_hat)
            self.b_eff = float(self.b_hat)
        else:
            self.b_eff = plan.mean_bits(self.split)
            self.b_hat = int(round(self.b_eff))
        if plan is not None:
            if kernel_ok and plan.scheme == "uniform":
                self._qlinears = self._quantize_kernel_weights(plan)
                self._agent_params = None
            else:
                self._agent_params = fake_quantize_agent(
                    self.params, self._axes, self.cfg, plan, ste=False)
                self._qlinears = None
        elif kernel_ok and self.b_hat in (4, 8):
            self._qlinears = self._quantize_kernel_weights(
                QuantPlan.uniform(self.b_hat, scheme=self.scheme))
            self._agent_params = None
        else:
            qcfg = QuantConfig(bits=self.b_hat, scheme=self.scheme,
                               granularity="per-channel")
            self._agent_params = fake_quantize_agent(
                self.params, self._axes, self.cfg, qcfg, ste=False)
            self._qlinears = None
        self._segments = fp.restack_segments(self._qlinears) \
            if self._qlinears is not None else None

    @property
    def agent_path(self) -> str:
        """What materialized at the current operating point:
        ``kernel-int8``/``kernel-int4``, ``kernel-mixed[b0/b1/...]`` or
        ``fake``."""
        if self._qlinears is not None:
            if self.plan is not None:
                bl = "/".join(str(r["bits"]) for r in self._qlinears)
                return f"kernel-mixed[{bl}]"
            return f"kernel-int{self.b_hat}"
        return "fake"

    def auto_configure(self, qos: QosClass) -> Optional[cd.CodesignSolution]:
        """Solve (P1) for this QoS class and apply the solution."""
        sol = cd.solve_sca(self.lam, self.sysp, qos.t0, qos.e0,
                           b_max=int(self.sysp.b_full), b_emb=self.b_emb)
        if sol is None:
            return None
        self.configure(sol.b_hat, sol.f, sol.f_server)
        return sol

    # ------------------------------------------------------------------
    # kernel-path weight prep (dense DecoderLM)
    # ------------------------------------------------------------------
    def _quantize_kernel_weights(self, plan: QuantPlan):
        """Per-layer weight records for wq/wk/wv/wo/mlp of layers [0,split).

        Layer i materializes at ``plan.layer_bits(i)``: bits <= 4 →
        int4-packed, 5..8 → int8, group size ``plan.group_size`` along the
        contraction axis (the ``group_quantize`` kernel).  Layers wider than
        8 bits keep fake-quantized full-precision matrices.
        """
        lp = self.params["layers"]
        mlp_names = [n for n in ("wi_gate", "wi_up", "wi", "wo")
                     if n in lp["ffn"]]
        out = []
        for i in range(self.split):
            bits = plan.layer_bits(i)
            rec = {"attn": {}, "ffn": {}, "bits": bits}

            def materialize(leaf):
                w = leaf.to(torch.float32).contiguous()
                if bits <= 8:
                    return kops.quantize_linear(w, bits=bits,
                                                group_size=plan.group_size)
                return quantize_dequantize(w, plan.config_for_layer(i))

            for n in ("wq", "wk", "wv", "wo"):
                rec["attn"][n] = materialize(lp["attn"][n][i])
            for n in mlp_names:
                rec["ffn"][n] = materialize(lp["ffn"][n][i])
            out.append(rec)
        return out

    def _agent_forward_kernel(self, x, positions):
        """Agent layers over the quantized weights, one loop per segment.
        ``x`` is [B, S, D] for any B: the matmul wrappers flatten every
        leading dim into the kernel's M axis."""
        descs, arrays = self._segments
        side = fp.layer_side_tree(self.params["layers"], self.cfg)
        for desc, seg in zip(descs, arrays):
            x = fp.scan_segment(self.cfg, desc, seg, side, x, positions,
                                desc.length, self.model.attend)
        return x

    # ------------------------------------------------------------------
    # the two inference stages + transport
    # ------------------------------------------------------------------
    def _batch_to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return {k: torch.as_tensor(v).to(
                    self.device, dtype=torch.long if k == "tokens" else None)
                for k, v in batch.items()}

    def agent_stage(self, batch: Dict[str, Any]):
        """Embedding + layers [0, split) at bit-width b̂."""
        batch = self._batch_to_device(batch)
        src = self._agent_params if self._agent_params is not None \
            else self.params
        x, positions = self.model._embed(src, batch)
        if self._qlinears is not None:
            x = self._agent_forward_kernel(x, positions)
        else:
            x, _ = self.model.run_layers_window(src, x, positions, 0,
                                                self.split)
        return x, positions

    def transport(self, emb: torch.Tensor, lengths=None):
        """Quantize the boundary activation for the uplink; returns
        (received embedding, per-row wire bytes).  The absmax scale is one
        per leading batch row (one request's own transmission); ``lengths``
        marks right-padding, which is zeroed and not billed."""
        if lengths is not None:
            real = np.asarray(lengths, np.int64)
        else:
            real = np.full((emb.shape[0],), emb.shape[1], np.int64)
        emb_q = fp.transport_quantize(
            emb, torch.as_tensor(real, device=emb.device), self.b_emb,
            emb.shape[0])
        return emb_q, self._row_wire_bytes(real)

    def _row_wire_bytes(self, real_lengths) -> tuple:
        """Per-request uplink wire bytes: the raw activation at
        b_emb >= 16, else the realizable code container plus one f32
        absmax scale per request."""
        d = int(self.cfg.d_model)
        if self.b_emb >= 16:
            itemsize = np.dtype(self.cfg.dtype).itemsize
            return tuple(int(s) * d * itemsize for s in real_lengths)
        return tuple(wire_bytes(int(s) * d, self.b_emb) + 4
                     for s in real_lengths)

    def server_stage(self, emb: torch.Tensor, positions):
        """Layers [split, L) at full precision + head."""
        x, _ = self.model.run_layers_window(self.params, emb, positions,
                                            self.split, self.cfg.n_layers)
        x = L.apply_norm(self.cfg, x, self.params["final_norm"])
        return L.unembed(self.cfg, self.params["embed"], x)

    # ------------------------------------------------------------------
    def serve_batch(self, batch: Dict[str, Any], lengths=None):
        """Full co-inference pass; returns (logits, ServeStats).

        ``lengths`` flags right-padded rows (see :meth:`transport`)."""
        with torch.no_grad():
            emb, positions = self.agent_stage(batch)
            emb_rx, row_bytes = self.transport(emb, lengths)
            logits = self.server_stage(emb_rx, positions)
        emb_bytes = sum(row_bytes)

        n_a, n_s = self.flop_split(positions.numel())
        p = dataclasses.replace(self.sysp, n_flop_agent=n_a,
                                n_flop_server=n_s,
                                emb_bytes_full=float(emb_bytes)
                                * 16.0 / self.b_emb)
        t_a = float(agent_delay(self.b_eff, self.f, p))
        t_s = float(server_delay(self.f_server, p))
        t_x = float(transport_delay(self.b_emb, p))
        e_x = float(transport_energy(self.b_emb, p))
        e = float(agent_energy(self.b_eff, self.f, p)
                  + server_energy(self.f_server, p)) + e_x
        stats = ServeStats(
            b_hat=self.b_hat, f=self.f, f_server=self.f_server,
            agent_delay_s=t_a, server_delay_s=t_s, transport_delay_s=t_x,
            total_delay_s=t_a + t_s + t_x, energy_j=e,
            transport_energy_j=e_x, emb_bytes=emb_bytes,
            agent_flops=n_a, server_flops=n_s, emb_row_bytes=row_bytes,
            plan_bits=(self.plan.layer_bit_list(self.split)
                       if self.plan is not None else ()))
        return logits, stats
