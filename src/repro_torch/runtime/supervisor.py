"""Resilient serving under injected faults
(``repro/runtime/supervisor.py``).

:class:`ServingSupervisor` wraps any of the serving engines —
:class:`~repro_torch.runtime.serve_engine.BatchedCoInferenceEngine`,
:class:`~repro_torch.runtime.adaptive.AdaptiveCoInferenceEngine`,
:class:`~repro_torch.runtime.decode_engine.DecodeEngine` (and its
speculative subclass), and
:class:`~repro_torch.runtime.fleet_engine.FleetCoInferenceEngine` — and
mediates a seeded :class:`~repro_torch.env.faults.ChaosTrace` between the
client and the engine, entirely on the engines' virtual clocks: fault
handling *bills time* (backoff sleeps, retransmits, repair windows,
degraded service) through the same clock the cost model bills serving
on, so a supervised run is deterministic and replayable.

The state machine per scheduling boundary (one ``step()``):

1. **shed** — a queued request whose deadline has already passed even
   under instantaneous service is dropped (``shed`` instant).  A
   feasible request is never shed.
2. **unreachable** (link outage or server preemption) — seeded
   exponential backoff with jitter probes until the path returns
   (``retry`` instants).  Past the retry budget, prefill-style engines
   **fail over to device-only serving**: the codesign re-solves with
   the split pinned fully on-agent
   (:func:`~repro_torch.core.codesign.solve_device_only`) and the batch
   is served and billed at that degraded operating point
   (``failover.local`` span; on the kernel path a new b̂ quantizes its
   weights, and under ``compiled=True`` captures its forward, while
   traffic waits).  A decode engine instead snapshots every in-flight
   request (:meth:`DecodeEngine.snapshot_request`), waits out the window,
   and resumes each through the batch-1 reference — the resumed stream is
   **bitwise identical** to an uninterrupted run (``recover.restore``
   instants).
3. **corruption** — the chaos trace marks which uplink payloads arrive
   bit-flipped; detection is the CRC-32 :func:`payload_checksum` over
   the payload bytes (any single flip changes it), and the supervisor
   bills one retransmit and serves clean.
4. **fleet churn** — a dropout/rejoin edge triggers exactly one
   re-water-filling of the server shares
   (:meth:`FleetCoInferenceEngine.reallocate`); churn is bounded by
   membership edges, never by steps.

On a fault-free trace (or with no trace at all) every ``step()`` is a
pure delegation — no rng draw, no fault lookup — so the supervised
engine is **bitwise identical** to the bare engine.

An *unsupervised* baseline (``supervised=False``) applies the same
physics with none of the defenses: requests touched by a fault fail,
in-flight decode state is lost on a crash.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import codesign as cd
from ..env.faults import ChaosTrace, FaultState
from ..obs import NULL_METRICS, NULL_TRACER, ReportBase
from .decode_engine import (DecodeEngine, DecodeResponse,
                            greedy_decode_reference)
from .fault_tolerance import StragglerMonitor
from .fleet_engine import FleetCoInferenceEngine

__all__ = ["ServingSupervisor", "ResilienceReport", "payload_checksum",
           "flip_bit"]


def _host_array(payload) -> np.ndarray:
    if isinstance(payload, torch.Tensor):
        payload = payload.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(payload))


def payload_checksum(payload) -> int:
    """CRC-32 over a payload's bytes (a tensor's or an array's): the
    uplink integrity check.  Cheap (one pass, no crypto), order-sensitive,
    and any single bit-flip changes it, which is all detect-and-retransmit
    needs; collisions only matter adversarially, and the link is not an
    adversary here.  Equal to the reference's for the same array."""
    return zlib.crc32(_host_array(payload).tobytes()) & 0xFFFFFFFF


def flip_bit(payload, bit_index: int):
    """Return a copy of ``payload`` with one bit flipped — the
    corruption model of :class:`~repro_torch.env.faults.PacketCorruption`,
    used to prove :func:`payload_checksum` detects every single-bit error.
    A tensor comes back as a tensor on its device, anything else as a
    numpy array."""
    arr = _host_array(payload)
    flat = np.frombuffer(arr.tobytes(), np.uint8).copy()
    flat[bit_index // 8] ^= np.uint8(1 << (bit_index % 8))
    out = np.frombuffer(flat.tobytes(), arr.dtype).reshape(arr.shape)
    if isinstance(payload, torch.Tensor):
        return torch.from_numpy(out.copy()).to(payload.device)
    return out


@dataclasses.dataclass(frozen=True)
class ResilienceReport(ReportBase):
    """What a supervised (or bare) run delivered, lost, and spent
    (the sibling of ``EngineReport``/``SupervisorReport``)."""

    mode: str                   # "supervised" | "bare"
    engine: str                 # wrapped engine class name
    clean: bool                 # fault-free trace -> pure pass-through
    requests_total: int         # submitted through the supervisor
    delivered: int              # responses handed to the client
    failed: int                 # lost to faults (bare mode, mostly)
    shed: int                   # dropped: deadline already unmeetable
    retries: int                # backoff probes while unreachable
    retransmits: int            # checksum-detected corrupt payloads
    failovers: int              # batches served device-only
    recoveries: int             # decode requests resumed after a crash
    reallocations: int          # fleet re-water-fillings (churn bound)
    faults_seen: int            # fault edges encountered
    stragglers_seen: int        # slow-batch flags (StragglerMonitor)
    tokens_delivered: int       # decode only (0 for prefill engines)
    tokens_lost: int            # must be 0 supervised (gated)
    tokens_duplicated: int      # must be 0 always (gated)
    clock_s: float              # final virtual clock / fleet makespan
    goodput: float              # delivered work per virtual second
    goodput_unit: str           # "tokens/s" (decode) | "requests/s"


_CLEAN = FaultState(t_s=0.0)


class ServingSupervisor:
    """Fault-mediating wrapper around one serving engine.

    Parameters
    ----------
    engine:
        A built Batched/Adaptive/Decode/Fleet engine.  The supervisor
        owns its stepping; submit and step through the supervisor.
    chaos:
        The :class:`ChaosTrace` to run under; ``None`` (or a clean
        trace) selects the pass-through fast path.
    supervised:
        ``False`` builds the unsupervised baseline: same fault physics,
        no retry/failover/recovery/shedding — faults lose work.
    seed:
        Seeds the backoff-jitter stream (``SeedSequence``-spawned, so
        runs are replayable).
    max_retries:
        Backoff probes before a prefill engine fails over to
        device-only serving.  Decode never fails over mid-stream (its
        KV split is pinned); it keeps probing at the capped delay.
    deadline_factor:
        A request's hard deadline is ``arrival + factor * T0`` — shed
        only when the deadline has passed (service time could not
        matter), never speculatively.
    """

    def __init__(self, engine, *, chaos: Optional[ChaosTrace] = None,
                 supervised: bool = True, seed: int = 0,
                 max_retries: int = 3, backoff_base_s: float = 0.05,
                 backoff_jitter: float = 0.5,
                 retransmit_penalty_s: float = 0.02,
                 deadline_factor: float = 8.0, shed: bool = True,
                 straggler_factor: float = 3.0,
                 max_decode_steps: Optional[int] = None,
                 tracer=None, metrics=None):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.engine = engine
        self.chaos = chaos
        self.supervised = bool(supervised)
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_jitter = float(backoff_jitter)
        self.retransmit_penalty_s = float(retransmit_penalty_s)
        self.deadline_factor = float(deadline_factor)
        self.shed_enabled = bool(shed)
        # fault-check cadence for decode: faults are observed at engine
        # scheduling boundaries, so the per-step chunk bounds how much
        # virtual time passes between trace lookups.  Under a faulty
        # trace the default is 1 — every inter-token boundary observes
        # the trace (an unbounded chunk could tunnel through a whole
        # outage); chunking does not change the tokens,
        # only where the supervisor may interrupt.  Clean traces keep
        # the engine's own chunking unless overridden.
        self.max_decode_steps = max_decode_steps
        self.tracer = tracer if tracer is not None else \
            getattr(engine, "tracer", NULL_TRACER)
        self.metrics = metrics if metrics is not None else \
            getattr(engine, "metrics", NULL_METRICS)
        self._rng = np.random.default_rng(np.random.SeedSequence(seed))
        self._is_decode = isinstance(engine, DecodeEngine)
        self._is_fleet = isinstance(engine, FleetCoInferenceEngine)
        # pass-through: decided ONCE, so the clean path never pays a
        # per-step fault lookup (the identity contract)
        self.clean = chaos is None or chaos.is_clean()
        # slow-batch detection: the training-era StragglerMonitor reused
        # verbatim — a "host" here is a QoS class / fleet agent, and a
        # "step" is one billed engine round
        self.straggler = StragglerMonitor(factor=straggler_factor)
        self._prev = _CLEAN
        self._expected: Dict[int, int] = {}   # rid -> generation budget
        self._failed_rids = set()
        # counters
        self._submitted = 0
        self._delivered = 0
        self._failed = 0
        self._shed = 0
        self._retries = 0
        self._retransmits = 0
        self._failovers = 0
        self._recoveries = 0
        self._faults = 0
        self._tokens_delivered = 0
        self._tokens_lost = 0
        self._tokens_dup = 0
        self._device_only: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # submit (records per-request expectations for loss accounting)
    # ------------------------------------------------------------------
    def submit(self, *args, **kwargs) -> int:
        """Delegates to the engine's ``submit`` (same signature per
        engine kind) and records the request's generation budget so the
        report can prove zero lost / zero duplicated tokens."""
        rid = self.engine.submit(*args, **kwargs)
        self._submitted += 1
        if self._is_decode:
            m = kwargs.get("max_new_tokens")
            if m is None and len(args) >= 3:
                m = args[2]
            self._expected[rid] = int(m) if m is not None \
                else self.engine.max_new_tokens
        return rid

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def step(self, *args, **kwargs):
        if self.clean:
            # pure delegation (the identity + overhead contract), with
            # counter-only accounting so the report stays meaningful
            if self._is_decode and not args and "max_decode_steps" \
                    not in kwargs:
                args = (self.max_decode_steps,)
            res = self.engine.step(*args, **kwargs)
            self._account_clean(res)
            return res
        if self._is_decode:
            return self._step_decode(*args, **kwargs)
        if self._is_fleet:
            return self._step_fleet()
        return self._step_batched()

    def drain(self, max_steps: int = 100_000):
        """Step until every queue is empty; ``max_steps`` is a safety
        net against a trace whose tail never recovers (the supervisor
        fails the stranded requests before giving up)."""
        out: List[Any] = []
        for _ in range(max_steps):
            if self._is_decode:
                if not (self.engine.pending or self.engine.in_flight):
                    break
                out.extend(self.step())
            elif self._is_fleet:
                if not self.engine.pending():
                    break
                name, responses = self.step()
                out.extend(responses)
            else:
                if not self.engine._queue:
                    break
                out.extend(self.step())
        return out

    def _account_clean(self, res) -> None:
        """Counters only — never touches the responses themselves."""
        if self._is_fleet:
            responses = res[1]
        else:
            responses = res
        for r in responses:
            if getattr(r, "cancelled", False):
                continue
            self._delivered += 1
            if self._is_decode:
                self._tokens_delivered += int(r.tokens.size)
                self._expected.pop(r.request_id, None)

    # ------------------------------------------------------------------
    # shared fault machinery
    # ------------------------------------------------------------------
    def _edge(self, f: FaultState, t_s: float) -> None:
        """Emit one ``fault.inject`` per rising fault edge (a 40-step
        outage is one fault, not 40)."""
        p = self._prev
        for kind, bad_now, bad_prev in (
                ("outage", not f.link_up, not p.link_up),
                ("corruption", f.corrupt, p.corrupt),
                ("preemption", not f.server_up, not p.server_up)):
            if bad_now and not bad_prev:
                self._faults += 1
                self.tracer.instant("fault.inject", kind=kind,
                                    t_s=round(t_s, 6))
                self.metrics.counter("chaos.faults", kind=kind).inc()
        if f.agents_up != p.agents_up and any(
                not a and b for a, b in zip(f.agents_up, p.agents_up)):
            self._faults += 1
            self.tracer.instant("fault.inject", kind="dropout",
                                t_s=round(t_s, 6))
            self.metrics.counter("chaos.faults", kind="dropout").inc()
        self._prev = f

    def _probe(self, t_s: float, check, budget: Optional[int]):
        """Seeded exponential backoff with jitter from ``t_s`` until
        ``check(fault_at(t))`` holds.  Returns the recovery time, or
        None when the budget runs out first or the trace's clamped tail
        never recovers.  Every probe costs virtual time and emits a
        ``retry`` instant."""
        tw, k = t_s, 0
        while True:
            f = self.chaos.fault_at(tw)
            if check(f):
                return tw
            if tw >= self.chaos.end_s:
                return None          # permanent within this trace
            if budget is not None and k >= budget:
                return None          # budget exhausted -> caller decides
            d = self.backoff_base_s * (2.0 ** min(k, self.max_retries))
            d *= 1.0 + self.backoff_jitter * float(self._rng.random())
            tw += d
            k += 1
            self._retries += 1
            self.tracer.instant("retry", attempt=k, t_s=round(tw, 6))

    def _t0(self, qos: str) -> float:
        if self._is_decode:
            return self.engine._classes[qos].qos.t0
        return self.engine.classes[qos].t0

    def _shed_pass(self, now_s: float) -> None:
        """Drop queued requests whose hard deadline has already passed:
        ``now > arrival + factor * T0`` means even zero-delay service
        would miss, so shedding can never sacrifice a feasible
        request."""
        eng = self.engine
        for r in list(eng._queue):
            if r.arrival_s > now_s:
                continue
            deadline = r.arrival_s + self.deadline_factor * self._t0(r.qos)
            if now_s > deadline:
                eng.cancel(r.request_id)
                self._shed += 1
                self._expected.pop(r.request_id, None)
                self.tracer.instant("shed", rid=r.request_id, qos=r.qos,
                                    deadline_s=round(deadline, 6),
                                    t_s=round(now_s, 6))
                self.metrics.counter("chaos.shed", qos=r.qos).inc()

    # ------------------------------------------------------------------
    # decode engine
    # ------------------------------------------------------------------
    def _live_rids(self) -> List[int]:
        return [a.req.request_id for g in self.engine._groups.values()
                for a in g.slots if a is not None]

    def _step_decode(self, max_decode_steps: Optional[int] = None
                     ) -> List[DecodeResponse]:
        if max_decode_steps is None:
            max_decode_steps = self.max_decode_steps \
                if self.max_decode_steps is not None else 1
        eng = self.engine
        out: List[DecodeResponse] = []
        # mirror the engine's idle fast-forward so the fault lookup sees
        # the time the engine will actually run at
        if eng.in_flight == 0 and eng.pending:
            nxt = min(r.arrival_s for r in eng._queue)
            eng.fast_forward(nxt)
        t = eng.clock_s
        f = self.chaos.fault_at(t)
        self._edge(f, t)

        if not f.server_up:
            # server crash: recover (supervised) or lose the in-flight
            # work (bare), then wait out the repair window
            if self.supervised:
                out.extend(self._recover_decode(t))
            else:
                self._crash_fail_inflight()
                eng.fast_forward(self.chaos.next_server_up(t))
            return out

        if not f.link_up:
            if self.supervised:
                t_up = self._probe(t, lambda fv: fv.link_up, budget=None)
                if t_up is None:
                    self._abandon_decode("link never recovered")
                    return out
                eng.fast_forward(t_up)
            else:
                # the bare engine pushes through a dark uplink: every
                # in-flight stream takes garbage into its cache
                for rid in self._live_rids():
                    self._failed_rids.add(rid)
                eng.fast_forward(self.chaos.next_link_up(t))
        elif f.corrupt:
            if self.supervised:
                # checksum mismatch on the boundary payload -> bill one
                # retransmit and serve the clean copy
                self._retransmits += 1
                self.tracer.instant("retry", kind="retransmit",
                                    t_s=round(t, 6))
                self.metrics.counter("chaos.retransmits").inc()
                eng.fast_forward(t + self.retransmit_penalty_s)
            else:
                for rid in self._live_rids():
                    self._failed_rids.add(rid)

        if self.supervised and self.shed_enabled:
            self._shed_pass(eng.clock_s)
        c0 = eng.clock_s
        responses = eng.step(max_decode_steps)
        if eng.clock_s > c0:
            self.straggler.report("decode", eng.clock_s - c0)
        for r in responses:
            self._account_decode(r, out)
        return out

    def _account_decode(self, r: DecodeResponse,
                        out: List[DecodeResponse]) -> None:
        if r.request_id in self._failed_rids:
            self._failed_rids.discard(r.request_id)
            self._failed += 1
            self._tokens_lost += int(r.tokens.size)
            self._expected.pop(r.request_id, None)
            return
        exp = self._expected.pop(r.request_id, None)
        self._delivered += 1
        self._tokens_delivered += int(r.tokens.size)
        if exp is not None:
            if r.tokens.size > exp:
                self._tokens_dup += int(r.tokens.size) - exp
            elif r.tokens.size < exp and self.engine.eos_id is None:
                # without EOS the only legitimate stop is the budget
                self._tokens_lost += exp - int(r.tokens.size)
        out.append(r)

    def _crash_fail_inflight(self) -> None:
        for rid in self._live_rids():
            resp = self.engine.cancel(rid)
            self._failed += 1
            if resp is not None:
                self._tokens_lost += int(resp.tokens.size)
            self._expected.pop(rid, None)

    def _abandon_decode(self, why: str) -> None:
        """The trace's clamped tail never recovers: fail whatever is
        stranded rather than spinning forever."""
        self._crash_fail_inflight()
        for r in list(self.engine._queue):
            self.engine.cancel(r.request_id)
            self._failed += 1
            self._expected.pop(r.request_id, None)
        self.tracer.instant("fault.inject", kind="abandon", reason=why)

    def _recover_decode(self, t_s: float) -> List[DecodeResponse]:
        """Crash-recoverable decode: snapshot -> wait -> restore.

        Each in-flight request's per-slot cache state is snapshot
        (host-side numpy, one device-to-host copy per tensor), its slot
        freed, the repair window waited out on the virtual clock, and the
        stream finished through ``greedy_decode_reference(state=...)``
        (its batch-1 graphs from the engine's compile cache) — billed per
        token at the class's round cost.  The stitched stream is bitwise the
        uninterrupted run: zero tokens lost, zero duplicated."""
        eng = self.engine
        out: List[DecodeResponse] = []
        t_up = self.chaos.next_server_up(t_s)
        snaps = []
        for rid in self._live_rids():
            snap = eng.snapshot_request(rid)
            if snap is not None:
                snaps.append(snap)
                eng.cancel(rid)   # frees the slot; partial not delivered
        if t_up >= self.chaos.end_s and not \
                self.chaos.fault_at(self.chaos.end_s).server_up:
            # the server never comes back within this trace
            for s in snaps:
                self._failed += 1
                self._tokens_lost += len(s["generated"])
                self._expected.pop(s["request"].request_id, None)
            self._abandon_decode("server never restarted")
            return out
        eng.fast_forward(t_up)
        for s in snaps:
            req = s["request"]
            remaining = req.max_new_tokens - len(s["generated"])
            toks = list(s["generated"])
            if remaining > 0:
                resumed = greedy_decode_reference(
                    eng.model, eng.class_params(s["qos"]), req.tokens,
                    remaining, b_kv=s["b_kv"],
                    seq_bucket_base=eng.seq_bucket_base,
                    compile_cache=eng.compile_cache, state=s["state"],
                    device=eng.device)
                toks.extend(int(x) for x in resumed)
                t_round, e_round = eng.decode_round_cost(s["qos"],
                                                         s["t_bucket"])
                eng.fast_forward(eng.clock_s + remaining * t_round)
                eng._energy += remaining * e_round
            self._recoveries += 1
            self.tracer.instant("recover.restore", rid=req.request_id,
                                resumed=max(0, remaining),
                                t_s=round(eng.clock_s, 6))
            self.metrics.counter("chaos.recoveries").inc()
            itl = float(np.mean(s["itls"])) if s["itls"] else 0.0
            self._account_decode(DecodeResponse(
                request_id=req.request_id, qos=s["qos"],
                tokens=np.asarray(toks, np.int32),
                prompt_len=req.tokens.size, b_kv=s["b_kv"],
                ttft_s=s["ttft_s"], itl_mean_s=itl,
                finished_s=eng.clock_s, cancelled=False), out)
        return out

    # ------------------------------------------------------------------
    # batched / adaptive engines
    # ------------------------------------------------------------------
    def _step_batched(self) -> List[Any]:
        eng = self.engine
        if not eng._queue:
            return []
        t = max(eng.clock_s, eng._queue[0].arrival_s)
        f = self.chaos.fault_at(t)
        self._edge(f, t)
        if self.supervised and self.shed_enabled:
            self._shed_pass(t)
            if not eng._queue:
                return []
            t = max(eng.clock_s, eng._queue[0].arrival_s)

        if not f.server_reachable:
            if not self.supervised:
                return self._deliver_batched(self._timed_step(), ok=False)
            t_up = self._probe(t, lambda fv: fv.server_reachable,
                               budget=self.max_retries)
            if t_up is not None:
                eng.fast_forward(t_up)
                return self._deliver_batched(self._timed_step(), ok=True)
            return self._failover_batched(t)

        if f.corrupt:
            if not self.supervised:
                return self._deliver_batched(self._timed_step(), ok=False)
            self._retransmits += 1
            self.tracer.instant("retry", kind="retransmit",
                                t_s=round(t, 6))
            self.metrics.counter("chaos.retransmits").inc()
            responses = self._timed_step()
            eng.fast_forward(eng.clock_s + self.retransmit_penalty_s)
            return self._deliver_batched(responses, ok=True)

        return self._deliver_batched(self._timed_step(), ok=True)

    def _timed_step(self):
        eng = self.engine
        c0 = eng.clock_s
        responses = eng.step()
        if responses and eng.clock_s > c0:
            self.straggler.report(responses[0].stats.qos,
                                  eng.clock_s - c0)
        return responses

    def _deliver_batched(self, responses, ok: bool) -> List[Any]:
        if ok:
            self._delivered += len(responses)
            return responses
        self._failed += len(responses)
        return []

    def _device_only_solution(self, qos: str):
        sol = self._device_only.get(qos)
        if sol is None:
            eng = self.engine
            c = eng.classes[qos]
            sol = cd.solve_device_only(eng.engine.lam, eng.sysp,
                                       c.t0, c.e0,
                                       b_max=int(eng.sysp.b_full))
            self._device_only[qos] = sol
        return sol

    def _failover_batched(self, t_s: float) -> List[Any]:
        """Degraded device-only service: the head batch is served and
        billed with the split pinned fully on-agent at the best
        feasible bit-width — the agent keeps acting
        instead of holding work for a server that is not coming back
        soon."""
        eng = self.engine
        qos = eng._queue[0].qos
        sol = self._device_only_solution(qos)
        saved = (eng.sysp, eng.engine.sysp,
                 eng._solutions[qos], eng._plans.pop(qos, None))
        pl = cd.device_only_params(eng.sysp)
        with self.tracer.span("failover.local", qos=qos,
                              b_hat=sol.b_hat,
                              feasible=bool(sol.feasible)):
            eng.sysp = pl
            eng.engine.sysp = pl
            eng._solutions[qos] = sol
            try:
                responses = self._timed_step()
            finally:
                eng.sysp, eng.engine.sysp = saved[0], saved[1]
                eng._solutions[qos] = saved[2]
                if saved[3] is not None:
                    eng._plans[qos] = saved[3]
        self._failovers += 1
        self.metrics.counter("chaos.failovers", qos=qos).inc()
        return self._deliver_batched(responses, ok=True)

    # ------------------------------------------------------------------
    # fleet engine
    # ------------------------------------------------------------------
    def _membership(self, f: FaultState) -> set:
        """Desired active set: agents_up index i maps to spec i; a trace
        built with fewer agents than the fleet leaves the rest up."""
        specs = self.engine.specs
        up = f.agents_up
        return {spec.name for i, spec in enumerate(specs)
                if i >= len(up) or up[i]}

    def _step_fleet(self):
        eng = self.engine
        frontier = max(e.clock_s for e in eng.engines.values())
        f = self.chaos.fault_at(frontier)
        self._edge(f, frontier)
        desired = self._membership(f)
        if self.supervised and desired and desired != eng._active:
            # one reallocation per membership edge — the churn bound
            eng.reallocate([s.name for s in eng.specs
                            if s.name in desired])
        if self.supervised:
            # nothing serveable now, but a dropped member holds work:
            # advance to its rejoin instead of spinning
            active_pending = sum(eng.engines[n].pending()
                                 for n in eng.active_agents)
            if active_pending == 0 and eng.pending():
                waiting = [i for i, s in enumerate(eng.specs)
                           if s.name not in eng._active
                           and eng.engines[s.name].pending()]
                t_next = min(self.chaos.next_agent_up(i, frontier)
                             for i in waiting)
                if t_next >= self.chaos.end_s:
                    for i in waiting:   # stranded: never rejoins
                        member = eng.engines[eng.specs[i].name]
                        for r in list(member._queue):
                            member.cancel(r.request_id)
                            self._failed += 1
                    return None, []
                for e in eng.engines.values():
                    e.fast_forward(t_next)
                return None, []
            name, responses = eng.step()
            if responses:
                self.straggler.report(name, max(
                    r.stats.batch_delay_s for r in responses))
            self._delivered += len(responses)
            return name, responses
        # bare fleet: scheduling ignores membership — a batch served on
        # an absent agent is work the clients never receive
        name, responses = eng.step()
        if name is None:
            return name, responses
        present = name in self._membership(
            self.chaos.fault_at(eng.engines[name].clock_s))
        if present:
            self._delivered += len(responses)
            return name, responses
        self._failed += len(responses)
        return name, []

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def report(self) -> ResilienceReport:
        if self._is_fleet:
            clock = max(e.clock_s for e in self.engine.engines.values())
        else:
            clock = self.engine.clock_s
        if self._is_decode:
            goodput = self._tokens_delivered / clock if clock > 0 else 0.0
            unit = "tokens/s"
        else:
            goodput = self._delivered / clock if clock > 0 else 0.0
            unit = "requests/s"
        return ResilienceReport(
            mode="supervised" if self.supervised else "bare",
            engine=type(self.engine).__name__,
            clean=self.clean,
            requests_total=self._submitted,
            delivered=self._delivered,
            failed=self._failed,
            shed=self._shed,
            retries=self._retries,
            retransmits=self._retransmits,
            failovers=self._failovers,
            recoveries=self._recoveries,
            reallocations=getattr(self.engine, "_reallocations", 0),
            faults_seen=self._faults,
            stragglers_seen=len(self.straggler.stragglers()),
            tokens_delivered=self._tokens_delivered,
            tokens_lost=self._tokens_lost,
            tokens_duplicated=self._tokens_dup,
            clock_s=float(clock),
            goodput=goodput,
            goodput_unit=unit)
