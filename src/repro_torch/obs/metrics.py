"""Metrics: counters, gauges, fixed-bucket histograms -> one JSON snapshot.

The second half of the DESIGN.md §14 observability substrate.  A
:class:`MetricsRegistry` hands out named instruments keyed by
``(name, sorted label items)`` — engines label by ``engine``, QoS
``qos``, and plan hash ``plan`` — and exports everything as a single
JSON-serializable snapshot (``--metrics-out`` in ``launch/serve.py``).

Histograms are fixed-bucket (cumulative-style counts per upper edge
plus overflow, running sum and count) so observation cost is one
bisect + two adds, and snapshots from different runs line up
bucket-for-bucket.  :data:`NULL_METRICS` mirrors :data:`~repro_torch.obs.trace.NULL_TRACER`:
the disabled path returns preallocated no-op instruments so
instrumented engines pay nothing by default.
"""

from __future__ import annotations

import bisect
import json
import threading

# shared bucket ladders (upper edges); seconds / bytes / dimensionless.
# Latency edges span 10 us .. 100 s in half-decade steps — wide enough
# for both the decode engine's per-token ITL and compile wall times.
LATENCY_BUCKETS_S = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                     1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0, 100.0)
BYTES_BUCKETS = (64, 256, 1024, 4096, 16384, 65536, 262144, 1048576,
                 4194304, 16777216, 67108864)
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed upper-edge buckets + overflow; tracks sum and count."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        edges = tuple(float(b) for b in buckets)
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError("histogram buckets must be strictly "
                             f"increasing, got {buckets!r}")
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)  # [-inf..e0], .., overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class _NullInstrument:
    """One object serving as no-op counter, gauge, and histogram."""

    __slots__ = ()
    value = 0
    sum = 0.0
    count = 0
    mean = 0.0

    def inc(self, n=1):
        return None

    def set(self, v):
        return None

    def observe(self, v):
        return None


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics:
    """Disabled-metrics fast path; mirror of ``NULL_TRACER``."""

    enabled = False

    def counter(self, name, **labels):
        return _NULL_INSTRUMENT

    def gauge(self, name, **labels):
        return _NULL_INSTRUMENT

    def histogram(self, name, buckets=None, **labels):
        return _NULL_INSTRUMENT

    def snapshot(self):
        return {}


NULL_METRICS = NullMetrics()


class MetricsRegistry:
    """Get-or-create instruments keyed ``(name, sorted labels)``.

    Label values are coerced to ``str`` so plan hashes, ints, and enums
    all key consistently; a name must keep one instrument kind (asking
    for ``counter("x")`` after ``gauge("x")`` raises).
    """

    enabled = True

    def __init__(self):
        self._instruments: dict = {}
        self._kinds: dict = {}
        self._lock = threading.Lock()

    def _get(self, kind, name, labels, factory):
        key = (name, tuple(sorted(
            (k, str(v)) for k, v in labels.items())))
        with self._lock:
            if self._kinds.setdefault(name, kind) != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._kinds[name]}, not {kind}")
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = factory()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        edges = LATENCY_BUCKETS_S if buckets is None else buckets
        return self._get("histogram", name, labels,
                         lambda: Histogram(edges))

    # -- export -------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-serializable dict: ``{name: [{labels, ...}, ...]}``
        with per-kind payloads (counter value / gauge value / histogram
        buckets+counts+sum+count)."""
        with self._lock:
            items = sorted(self._instruments.items())
        out: dict = {}
        for (name, labels), inst in items:
            row: dict = {"labels": dict(labels)}
            if isinstance(inst, Counter):
                row["value"] = inst.value
            elif isinstance(inst, Gauge):
                row["value"] = inst.value
            else:
                row.update(buckets=list(inst.buckets),
                           counts=list(inst.counts),
                           sum=inst.sum, count=inst.count)
            out.setdefault(name, {"kind": self._kinds[name],
                                  "series": []})["series"].append(row)
        return out

    def write(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")
