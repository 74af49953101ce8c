"""Tracing: nested spans + instant events -> Chrome trace-event JSON.

The observability substrate of DESIGN.md §14.  A :class:`Tracer` records
duration spans (``ph="B"``/``"E"`` pairs) and instant events (``ph="i"``)
into a thread-safe in-process buffer and exports them as Chrome
trace-event JSON — the format Perfetto and ``chrome://tracing`` load
directly.  Timestamps come from an injectable clock so tests can produce
byte-stable traces (:class:`TickClock`) while production uses the wall
clock (:class:`MonotonicClock`).

Disabled tracing must be *free*: :data:`NULL_TRACER` is a module-level
singleton whose ``span()`` returns one preallocated no-op context
manager — no dict lookup, no allocation, no branch on a flag — so every
engine can take ``tracer=NULL_TRACER`` as its default and pay nothing
when observability is off (gated by ``benchmarks/obs_overhead.py``).
"""

from __future__ import annotations

import json
import threading
import time


class MonotonicClock:
    """Wall clock: ``time.monotonic`` seconds (the production default)."""

    def __call__(self) -> float:
        return time.monotonic()


class TickClock:
    """Deterministic clock: starts at ``start`` and advances by a fixed
    ``tick`` on every read.  Traces stamped with it are byte-stable
    across runs — the test contract for trace golden files."""

    def __init__(self, start: float = 0.0, tick: float = 1e-3):
        self._now = float(start)
        self._tick = float(tick)

    def __call__(self) -> float:
        now = self._now
        self._now += self._tick
        return now


class _NullSpan:
    """Reusable no-op context manager handed out by :class:`NullTracer`."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled-tracing fast path: every method is a constant-time
    no-op returning preallocated objects.  ``enabled`` lets callers skip
    building expensive span *arguments* (string formatting, nbytes
    sums) when tracing is off."""

    enabled = False

    def span(self, name, tid=0, **args):
        return _NULL_SPAN

    def instant(self, name, tid=0, **args):
        return None

    @property
    def events(self):
        return ()


NULL_TRACER = NullTracer()


class _Span:
    """Context manager emitting a balanced B/E pair around a block."""

    __slots__ = ("_tracer", "_name", "_tid", "_args")

    def __init__(self, tracer, name, tid, args):
        self._tracer = tracer
        self._name = name
        self._tid = tid
        self._args = args

    def __enter__(self):
        self._tracer._emit("B", self._name, self._tid, self._args)
        return self

    def __exit__(self, *exc):
        self._tracer._emit("E", self._name, self._tid, None)
        return False


class Tracer:
    """In-process span/event buffer with Chrome trace-event export.

    ``clock`` is any zero-arg callable returning seconds; timestamps are
    stored as integer microseconds (the trace-event unit).  Appends are
    guarded by a lock so engines running threaded stages may share one
    tracer.
    """

    enabled = True

    def __init__(self, clock=None, pid: int = 1):
        self._clock = clock if clock is not None else MonotonicClock()
        self._pid = int(pid)
        self._events: list[dict] = []
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------

    def _emit(self, ph, name, tid, args) -> None:
        ev = {
            "name": name,
            "ph": ph,
            "pid": self._pid,
            "tid": int(tid),
        }
        if args:
            ev["args"] = args
        # clock read under the lock: stamping and appending atomically
        # keeps ts non-decreasing within every lane even when threads
        # share one tracer (and one TickClock)
        with self._lock:
            ev["ts"] = int(round(self._clock() * 1e6))
            self._events.append(ev)

    def span(self, name: str, tid: int = 0, **args) -> _Span:
        """Open a duration span; use as ``with tracer.span("x", k=v):``."""
        return _Span(self, name, tid, args or None)

    def instant(self, name: str, tid: int = 0, **args) -> None:
        """Record a zero-duration event (scope ``t`` = thread)."""
        ev = {
            "name": name,
            "ph": "i",
            "pid": self._pid,
            "tid": int(tid),
            "s": "t",
        }
        if args:
            ev["args"] = args
        with self._lock:
            ev["ts"] = int(round(self._clock() * 1e6))
            self._events.append(ev)

    # -- export -------------------------------------------------------

    @property
    def events(self) -> tuple:
        with self._lock:
            return tuple(self._events)

    def to_chrome_trace(self) -> dict:
        """The JSON-object form: Perfetto's preferred envelope."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f, indent=1, sort_keys=True)
            f.write("\n")


def validate_chrome_trace(obj) -> list:
    """Schema-check a Chrome trace-event object; returns a list of
    problems (empty == valid).  Checked: the ``traceEvents`` envelope,
    required keys per event, non-decreasing ``ts`` within each
    ``(pid, tid)`` lane, and balanced/properly-nested B/E spans.  This
    is the checker CI's trace-smoke step runs via
    ``tools/trace_summary.py --validate``."""
    problems = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    last_ts: dict = {}
    stacks: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing required key {key!r}")
        ph = ev.get("ph")
        if ph not in ("B", "E", "i", "X", "C", "M"):
            problems.append(f"event {i}: unknown phase {ph!r}")
        ts, lane = ev.get("ts"), (ev.get("pid"), ev.get("tid"))
        if isinstance(ts, (int, float)):
            if lane in last_ts and ts < last_ts[lane]:
                problems.append(
                    f"event {i}: ts {ts} decreases in lane {lane}")
            last_ts[lane] = ts
        elif ts is not None:
            problems.append(f"event {i}: ts must be a number")
        if ph == "B":
            stacks.setdefault(lane, []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.setdefault(lane, [])
            if not stack:
                problems.append(f"event {i}: E without matching B "
                                f"in lane {lane}")
            else:
                stack.pop()
    for lane, stack in stacks.items():
        if stack:
            problems.append(
                f"lane {lane}: {len(stack)} unclosed span(s): {stack}")
    return problems
