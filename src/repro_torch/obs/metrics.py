"""Typed metrics instruments: Counter / Gauge / Histogram in a registry
(counterpart of ``repro.obs.metrics``, a copy with the same arithmetic,
so snapshots of the two packages compare exactly).

Three instrument kinds:

* :class:`Counter` — monotonically non-decreasing float (``inc``);
* :class:`Gauge` — set/inc/dec to any value;
* :class:`Histogram` — fixed-bucket distribution with **bounded memory**
  (one int per bucket, never a sample list): ``observe`` is O(log B),
  ``percentile`` interpolates within the covering bucket, exact min/max
  are tracked separately.  Per-step serve telemetry aggregates into
  these instead of growing a list for the lifetime of the engine.

Instruments may be *labelled* (``registry.counter("expert_load",
labels=("expert",))``): ``.child(expert=3)`` gets or creates one child
per label value, Prometheus-style, and the registry snapshot lists the
children as ``name{expert=3}``.

``MetricsRegistry.stats()`` renders every unlabelled counter/gauge as a
plain ``{name: number}`` dict, the view behind ``ServeEngine.stats``
(integral values come back as ``int``).
"""
from __future__ import annotations

import bisect
import math


class MetricError(ValueError):
    """Instrument redeclared with a different type/labels, or misused."""


# Default histogram buckets: geometric, 1e-9 .. 1e6 at ~1.26x steps (ten
# per decade).  Wide enough for step wall times in seconds at the low end
# and token counts / latencies-in-steps at the high end, fine enough that
# an interpolated percentile sits within ~26% of the exact one; 151 ints
# of memory per histogram, forever.
DEFAULT_BUCKETS = tuple(10.0 ** (-9 + i / 10.0) for i in range(151))


class Counter:
    """Monotonic counter (float; negative increments are an error)."""

    __slots__ = ("name", "_v")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise MetricError(
                f"counter {self.name!r}: negative increment {n} "
                "(use a Gauge for values that go down)")
        self._v += n

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self._v}


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "_v")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._v += n

    def dec(self, n: float = 1.0) -> None:
        self._v -= n

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self._v}


class Histogram:
    """Fixed-bucket histogram: bounded memory, interpolated percentiles.

    ``buckets`` are ascending upper bounds; values past the last bound
    land in a +inf overflow bucket.  ``percentile`` walks the cumulative
    counts to the covering bucket and interpolates linearly inside it,
    clamped to the exact observed min/max (so p0/p100 are exact and a
    single-sample histogram reports that sample at every percentile).
    """

    __slots__ = ("name", "_bounds", "_counts", "_n", "_sum", "_min", "_max")
    kind = "histogram"

    def __init__(self, name: str, buckets=None):
        self.name = name
        bounds = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
        if list(bounds) != sorted(set(bounds)):
            raise MetricError(
                f"histogram {self.name!r}: bucket bounds must be strictly "
                f"ascending, got {bounds}")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1: overflow bucket
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self._counts[bisect.bisect_left(self._bounds, v)] += 1
        self._n += 1
        self._sum += v
        self._min = v if v < self._min else self._min
        self._max = v if v > self._max else self._max

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def percentile(self, p: float) -> float:
        """Interpolated percentile, ``p`` in [0, 100]."""
        if not 0.0 <= p <= 100.0:
            raise MetricError(f"percentile {p} outside [0, 100]")
        if self._n == 0:
            return 0.0
        rank = p / 100.0 * self._n
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i] if i < len(self._bounds) else self._max
                frac = (rank - cum) / c
                est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return min(max(est, self._min), self._max)
            cum += c
        return self._max

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "count": self._n, "sum": self._sum,
                "min": self._min if self._n else 0.0,
                "max": self._max if self._n else 0.0,
                "p50": self.p50, "p95": self.p95, "p99": self.p99}


class _Family:
    """A labelled instrument: one child per label-value tuple."""

    __slots__ = ("name", "labels", "child_kind", "_make", "_children")
    kind = "family"

    def __init__(self, name: str, label_names: tuple, make, child_kind):
        self.name = name
        self.labels = tuple(label_names)
        self.child_kind = child_kind
        self._make = make
        self._children = {}

    def child(self, **labels):
        if tuple(sorted(labels)) != tuple(sorted(self.labels)):
            raise MetricError(
                f"{self.name!r} declared with labels {self.labels}, "
                f"got {tuple(labels)}")
        key = tuple(labels[k] for k in self.labels)
        inst = self._children.get(key)
        if inst is None:
            tag = ",".join(f"{k}={labels[k]}" for k in self.labels)
            inst = self._make(f"{self.name}{{{tag}}}")
            self._children[key] = inst
        return inst

    def children(self) -> dict:
        return dict(self._children)

    def snapshot(self) -> dict:
        return {"kind": self.kind, "labels": list(self.labels),
                "children": {inst.name: inst.snapshot()
                             for inst in self._children.values()}}


class MetricsRegistry:
    """Declared, typed instruments under unique names.

    Re-requesting a name returns the existing instrument when the type
    (and labels / buckets) match, and raises :class:`MetricError`
    otherwise — typos cannot silently fork a second counter.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _declare(self, name: str, make, kind: str, labels=None):
        inst = self._metrics.get(name)
        if inst is None:
            inst = (_Family(name, tuple(labels), make, kind) if labels
                    else make(name))
            self._metrics[name] = inst
            return inst
        ok = ((inst.kind == "family" and labels
               and tuple(inst.labels) == tuple(labels)
               and inst.child_kind == kind)
              or (inst.kind == kind and not labels))
        if not ok:
            have = (f"family[{inst.child_kind}] labels={inst.labels}"
                    if inst.kind == "family" else inst.kind)
            raise MetricError(
                f"metric {name!r} already declared as {have}; cannot "
                f"redeclare as {kind} labels={tuple(labels or ())}")
        return inst

    def counter(self, name: str, labels=None):
        return self._declare(name, Counter, "counter", labels)

    def gauge(self, name: str, labels=None):
        return self._declare(name, Gauge, "gauge", labels)

    def histogram(self, name: str, buckets=None, labels=None):
        def make(n, _b=buckets):
            return Histogram(n, buckets=_b)
        return self._declare(name, make, "histogram", labels)

    def get(self, name: str):
        inst = self._metrics.get(name)
        if inst is None:
            raise MetricError(f"unknown metric {name!r}; declared: "
                              f"{sorted(self._metrics)}")
        return inst

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self):
        return iter(self._metrics.values())

    # -- views -------------------------------------------------------------
    def stats(self) -> dict:
        """Back-compat flat view: unlabelled counters/gauges as plain
        numbers (ints where integral, so old ``== 6`` asserts hold)."""
        out = {}
        for name, inst in self._metrics.items():
            if inst.kind in ("counter", "gauge"):
                v = inst.value
                out[name] = int(v) if float(v).is_integer() else v
        return out

    def snapshot(self) -> dict:
        """Full typed dump (JSON-ready), histograms with percentiles."""
        return {name: inst.snapshot()
                for name, inst in self._metrics.items()}
