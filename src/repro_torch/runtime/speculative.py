"""Speculative co-inference: the quantized agent drafts, the server
verifies (``repro/runtime/speculative.py``).

The decode engine pays one full co-inference round per generated token.
Here the agent partition, fake-quantized at a draft bit-width
``b_draft`` below the class's operating point, greedily drafts ``k``
tokens a round; the verify chain checks them against the target weights
with longest-accepted-prefix semantics.  ``codesign.solve_speculative``
(or ``mixed_precision.allocate_bits_speculative``) picks (b_draft, k)
with (b̂, f, f̃, b_kv).

The reference's three commitments hold:

1.  **Bitwise parity, by construction (commit-on-verify).**  The draft
    chain runs on a scratch copy of the slot block, made once a round, so
    a draft never touches the canonical buffers; the verify chain steps
    the *target* ``decode_step_q`` from each active row's current token,
    so every entry it commits and every token it emits is what
    :func:`~.decode_engine.greedy_decode_reference` writes and emits, and
    an inactive row's writes are restored.  The draft changes how many
    verify steps run and what a round bills, never a delivered bit.
2.  **Billed at the paper's round model.**  The virtual clock charges
    ``cost_model.speculative_round_delay``: ``k`` drafts at ``f_max``, one
    batched verify forward, one uplink, ``k + 1`` cache reads and the
    rejected entries as rollback.  What the card executes is ``n_draft``
    draft steps and up to ``n_draft + 1`` verify steps, each a full decode
    step: the gain is in the billing, not in executed device time.
3.  **Rounds are atomic** between ``step()`` calls and ``generated`` only
    ever holds verified tokens; slots, admission, cancel and retirement are
    the decode engine's.

The reference fuses the draft and verify chains into one executable with
two data-dependent ``while_loop``s.  A CUDA graph cannot branch, so each
(class, cache bucket) captures two graphs over the block's static
buffers, one draft step (under the draft tree) and one verify step (under
the class's tree), and the host replays them: the draft step ``n_draft``
times, then the verify step until its counter passes ``n_draft`` or no row
is active (one flag read back per verify step: on the card about half
the wall per delivered token of a fixed ``n_draft + 1`` verify steps,
PERF.md).  ``k`` stays a runtime
value and is never a capture key; the draft graphs key on the draft
tree's addresses, so a class whose ``b_draft`` changes gets graphs of its
own.  On the CPU the same closures run uncaptured.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import mixed_precision as mp
from ..core.cost_model import (SystemParams, speculative_round_delay,
                               speculative_round_energy)
from ..core.quantization import QuantConfig
from ..kernels.bucketing import seq_ladder
from ..obs import ReportBase
from . import decode_engine as de
from .decode_engine import (_SPEC_MAX_K, DecodeEngine, DecodeResponse,
                            _ClassState, _Group)
from .qat import fake_quantize_agent
from .serve_engine import QosClass

__all__ = [
    "SpecRoundStats",
    "SpeculativeDecodeEngine",
    "SPEC_DRAFT_LADDER",
    "SPEC_LOOKAHEAD_MENU",
]

# the realizable draft and lookahead menus the codesign enumerates
SPEC_DRAFT_LADDER = (2, 4, 8)
SPEC_LOOKAHEAD_MENU = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class SpecRoundStats(ReportBase):
    """Whole-run draft/verify aggregates of a speculative engine."""
    rounds: int                 # verify rounds executed
    drafted: int                # draft tokens proposed (live rows x k)
    accepted: int               # drafts the verifier accepted
    delivered: int              # tokens delivered by verify rounds
    acceptance_rate: float      # accepted / drafted
    accepted_per_round: float   # mean accepted prefix length per row
    tokens_per_round: float     # mean delivered per row per round (τ̂)


@dataclasses.dataclass
class _SpecState:
    """One class's resolved draft schedule."""
    b_draft: int
    k: int
    plan_key: tuple             # draft weight tree key in ``_weights``


class SpeculativeDecodeEngine(DecodeEngine):
    """Draft-then-verify decode over the decode engine's slots.

    ``auto=True`` resolves each class through ``solve_speculative`` (or
    the mixed-precision analog), which picks (b̂ or plan, f, f̃, b_kv,
    b_draft, k) jointly; ``auto=False`` pins ``draft_bits``/``lookahead``,
    and :meth:`set_operating_point` takes ``b_draft``/``k``.  Admission,
    cancel and reporting are the decode engine's.  Runs on the CUDA card
    unless ``device="cpu"`` is asked for.
    """

    def __init__(self, model, params, sysp: SystemParams, *,
                 classes: Sequence[QosClass],
                 draft_bits: int = 4,
                 lookahead: int = 4,
                 draft_ladder: "tuple[int, ...]" = SPEC_DRAFT_LADDER,
                 lookahead_menu: "tuple[int, ...]" = SPEC_LOOKAHEAD_MENU,
                 **kwargs):
        if not (1 <= int(lookahead) <= _SPEC_MAX_K):
            raise ValueError(f"lookahead={lookahead} outside "
                             f"[1, {_SPEC_MAX_K}]")
        # set before super().__init__: the base constructor resolves the
        # classes through the overridden set_operating_point/_resolve_class
        self.draft_bits = int(draft_bits)
        self.lookahead = int(lookahead)
        self.draft_ladder = tuple(int(b) for b in draft_ladder)
        self.lookahead_menu = tuple(int(v) for v in lookahead_menu)
        self._spec: Dict[str, _SpecState] = {}
        self._spec_rounds = 0
        self._spec_row_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_delivered = 0
        super().__init__(model, params, sysp, classes=classes, **kwargs)

    # ------------------------------------------------------------------
    # operating points
    # ------------------------------------------------------------------
    def _resolve_class(self, c: QosClass) -> None:
        b_max = int(self.sysp.b_full)
        h0, m0 = self.codesign_cache.hits, self.codesign_cache.misses
        menus = dict(b_emb=self.b_emb, kv_ladder=self.kv_ladder,
                     kv_weight=self.kv_weight,
                     draft_ladder=self.draft_ladder,
                     lookahead=self.lookahead_menu)
        if self.mixed_precision:
            sol = self.codesign_cache.solve_speculative_mixed(
                self.layer_stats(), self.lam_kv, self.sysp, c, b_max,
                **menus)
        else:
            sol = self.codesign_cache.solve_speculative(
                self.lam, self.lam_kv, self.sysp, c, b_max, **menus)
        dh = self.codesign_cache.hits - h0
        dm = self.codesign_cache.misses - m0
        self._own_hits += dh
        self._own_misses += dm
        if dh:
            self.metrics.counter("codesign.cache_hits",
                                 engine="SpeculativeDecodeEngine",
                                 qos=c.name).inc(dh)
        if dm:
            self.metrics.counter("codesign.cache_misses",
                                 engine="SpeculativeDecodeEngine",
                                 qos=c.name).inc(dm)
        if sol is None:
            raise ValueError(
                f"QoS class {c.name!r} (T0={c.t0}, E0={c.e0}) is "
                "infeasible at every (b_kv, b_draft, k) in "
                f"{self.kv_ladder} x {self.draft_ladder} x "
                f"{self.lookahead_menu}")
        target = mp.plan_from_bits(sol.bits) if self.mixed_precision \
            else sol.b_hat
        self._classes[c.name] = None
        self.set_operating_point(c.name, target, sol.b_kv,
                                 f=sol.f, f_server=sol.f_server,
                                 qos=c, solution=sol,
                                 b_draft=sol.b_draft, k=sol.k)

    def set_operating_point(self, qos_name: str, target, b_kv: int, *,
                            b_draft: Optional[int] = None,
                            k: Optional[int] = None,
                            f: Optional[float] = None,
                            f_server: Optional[float] = None,
                            qos: Optional[QosClass] = None,
                            solution=None) -> None:
        """The decode engine's semantics plus the class's draft schedule
        (b_draft, k); an omitted value keeps the previous schedule (or the
        engine's defaults at first resolution)."""
        prev = self._spec.get(qos_name)
        b_draft = int(b_draft) if b_draft is not None \
            else (prev.b_draft if prev else self.draft_bits)
        k = int(k) if k is not None \
            else (prev.k if prev else self.lookahead)
        if b_draft < 2:
            raise ValueError(f"b_draft={b_draft} below the 2-bit floor")
        if not (1 <= k <= _SPEC_MAX_K):
            raise ValueError(f"lookahead k={k} outside [1, {_SPEC_MAX_K}]")
        super().set_operating_point(qos_name, target, b_kv, f=f,
                                    f_server=f_server, qos=qos,
                                    solution=solution)
        dk = ("uniform", b_draft)
        if dk not in self._weights:
            self._weights[dk] = fake_quantize_agent(
                self.params, self._axes, self.cfg,
                QuantConfig(bits=b_draft, scheme="uniform",
                            granularity="per-channel"), ste=False)
        self._spec[qos_name] = _SpecState(b_draft=b_draft, k=k,
                                          plan_key=dk)

    def spec_params(self, qos_name: str):
        """The class's materialized draft weight tree."""
        return self._weights[self._spec[qos_name].plan_key]

    def draft_schedule(self, qos_name: str) -> "tuple[int, int]":
        sp = self._spec[qos_name]
        return sp.b_draft, sp.k

    # ------------------------------------------------------------------
    # captured calls
    # ------------------------------------------------------------------
    def _spec_draft_exe(self, sp: _SpecState, c: _ClassState, g: _Group):
        w = self._weights[sp.plan_key]
        return self._cached(
            de._spec_key("spec-draft", self.model, w, g, c.b_kv),
            lambda: de._spec_draft_call(self.compile_cache, self.model,
                                        c.b_kv, w, g),
            plan=f"spec-draft/b{sp.b_draft}/bkv{c.b_kv}",
            bucket=f"{g.t_bucket}x{self.max_batch}")

    def _spec_verify_exe(self, c: _ClassState, g: _Group):
        w = self._weights[c.plan_key]
        return self._cached(
            de._spec_key("spec-verify", self.model, w, g, c.b_kv),
            lambda: de._spec_verify_call(self.compile_cache, self.model,
                                         c.b_kv, w, g),
            plan=f"spec-verify/bkv{c.b_kv}",
            bucket=f"{g.t_bucket}x{self.max_batch}")

    def warmup(self, max_prompt: int, max_new: Optional[int] = None) -> int:
        """Capture every reachable variant: the prefill (prompt, cache)
        bucket pairs as the decode engine does, and per class and cache
        bucket one draft step and one verify step (the reference compiles
        one fused round there; ``k`` is a runtime value either way).
        Returns the captures this made; after a warm-up covering the
        traffic's bounds, serving never captures."""
        m0 = self._own_compile_misses
        mn = int(max_new) if max_new is not None else self.max_new_tokens
        t_rungs = seq_ladder(max_prompt + mn, self.seq_bucket_base)
        for name, c in self._classes.items():
            sp = self._spec[name]
            for t in t_rungs:
                g = self._group(name, t)
                self._spec_draft_exe(sp, c, g)
                self._spec_verify_exe(c, g)
            for s in seq_ladder(max_prompt, self.seq_bucket_base):
                for t in t_rungs:
                    if t >= s:
                        self._prefill_exe(c, self._group(name, t), s)
        return self._own_compile_misses - m0

    # ------------------------------------------------------------------
    # the speculative round
    # ------------------------------------------------------------------
    def _decode_round(self, g: _Group, out: List[DecodeResponse],
                      max_steps: Optional[int] = None) -> None:
        c = self._classes[g.qos_name]
        sp = self._spec[g.qos_name]
        live_rows = [i for i, a in enumerate(g.slots) if a is not None]
        rem = np.zeros((self.max_batch,), np.int32)
        for i in live_rows:
            rem[i] = (g.slots[i].req.max_new_tokens
                      - len(g.slots[i].generated))
        # drafting past the largest remaining budget is waste (the
        # verifier stops at rem); max_steps caps the delivered tokens per
        # row, and max_steps=1 is plain decode (n_draft = 0)
        n_draft = min(sp.k, max(int(rem[live_rows].max()) - 1, 0))
        if max_steps is not None:
            n_draft = min(n_draft, max(int(max_steps) - 1, 0))
        live = np.zeros((self.max_batch,), np.int32)
        live[live_rows] = 1
        draft = self._spec_draft_exe(sp, c, g)
        verify = self._spec_verify_exe(c, g)
        with self.tracer.span("decode.spec_round", qos=g.qos_name,
                              live_rows=len(live_rows),
                              t_bucket=g.t_bucket, n_draft=n_draft):
            blk, cnt, acc, _ = de._spec_round(draft, verify, g, live, rem,
                                              n_draft)
        # the interface's traffic: masks and scalars in, the delivered
        # block out (drafts never leave the device)
        self._h2d += live.nbytes + rem.nbytes + 8
        self._d2h += blk.nbytes + cnt.nbytes + acc.nbytes
        n_live = len(live_rows)
        delivered = int(cnt[live_rows].sum())
        accepted = int(acc[live_rows].sum())
        tau_act = delivered / max(n_live, 1)
        t_round, e_round = self._spec_round_cost(c, sp, g.t_bucket,
                                                 n_draft, tau_act)
        self._clock += t_round
        self._energy += e_round
        self._rounds += 1
        self._spec_rounds += 1
        self._spec_row_rounds += n_live
        self._spec_drafted += n_draft * n_live
        self._spec_accepted += accepted
        self._spec_delivered += delivered
        m = self.metrics
        if m.enabled:
            m.counter("decode.spec_rounds",
                      engine="SpeculativeDecodeEngine",
                      qos=g.qos_name).inc()
            m.counter("decode.spec_drafted",
                      engine="SpeculativeDecodeEngine",
                      qos=g.qos_name).inc(n_draft * n_live)
            m.counter("decode.spec_accepted",
                      engine="SpeculativeDecodeEngine",
                      qos=g.qos_name).inc(accepted)
            m.counter("decode.h2d_bytes",
                      engine="SpeculativeDecodeEngine").inc(
                live.nbytes + rem.nbytes + 8)
            m.counter("decode.d2h_bytes",
                      engine="SpeculativeDecodeEngine").inc(
                blk.nbytes + cnt.nbytes + acc.nbytes)
            m.gauge("decode.live_rows",
                    engine="SpeculativeDecodeEngine",
                    qos=g.qos_name).set(n_live)
        # the round's tokens land together when the verify completes
        t_emit = self._clock
        finished: List[int] = []
        for i in live_rows:
            act = g.slots[i]
            for j in range(int(cnt[i])):
                tok_ij = int(blk[i, j])
                act.generated.append(tok_ij)
                act.itls.append(t_emit - act.last_emit_s)
                act.last_emit_s = t_emit
                if act.on_token is not None:
                    act.on_token(act.req.request_id, tok_ij, t_emit)
            last = act.generated[-1]
            if (self.eos_id is not None and last == self.eos_id) \
                    or len(act.generated) >= act.req.max_new_tokens:
                finished.append(i)
        for i in finished:
            out.append(self._retire(g, i))

    # ------------------------------------------------------------------
    # billing (float64 on the host)
    # ------------------------------------------------------------------
    def _spec_round_cost(self, c: _ClassState, sp: _SpecState,
                         t_bucket: int, n_draft: int, tau: float):
        """One round at the padded workload, as ``_round_cost`` pads a
        step: all ``max_batch`` rows and the full cache at ``b_kv``,
        through ``speculative_round_delay``/``_energy`` with ``n_draft``
        drafts and the realized tokens per row ``tau``."""
        n_a, n_s = self.flop_split(self.max_batch)
        kv_full = 2.0 * self.cfg.n_layers * self.max_batch * t_bucket \
            * self.cfg.n_kv_heads * self.cfg.head_dim \
            * (self.sysp.b_full / 8.0)
        p = dataclasses.replace(self.sysp, n_flop_agent=n_a,
                                n_flop_server=n_s, kv_bytes_full=kv_full)
        t = float(speculative_round_delay(
            c.b_eff, c.f, c.f_server, sp.b_draft, n_draft, tau, p,
            b_emb=self.b_emb, b_kv=c.b_kv))
        e = float(speculative_round_energy(
            c.b_eff, c.f, c.f_server, sp.b_draft, n_draft, tau, p,
            b_emb=self.b_emb, b_kv=c.b_kv))
        return t, e

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def spec_stats(self) -> SpecRoundStats:
        rr = max(self._spec_row_rounds, 1)
        drafted = max(self._spec_drafted, 1)
        return SpecRoundStats(
            rounds=self._spec_rounds,
            drafted=self._spec_drafted,
            accepted=self._spec_accepted,
            delivered=self._spec_delivered,
            acceptance_rate=self._spec_accepted / drafted,
            accepted_per_round=self._spec_accepted / rr,
            tokens_per_round=self._spec_delivered / rr)
