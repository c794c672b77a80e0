"""Chrome-trace span capture for the serve engine, trainer and kernels
(counterpart of ``repro.obs.trace``, a copy: the port imports nothing of
the JAX package).

A :class:`Tracer` records *complete* span events (``ph="X"``), counter
series (``ph="C"``) and instants (``ph="i"``) in the chrome trace-event
format; the JSON it writes loads in Perfetto or ``chrome://tracing``.
Timestamps come from ``time.perf_counter_ns`` relative to the tracer's
epoch, in microseconds (the format's unit).

The *off* path is one attribute read plus a no-op context manager:

    tr = trace.current()            # module-level, defaults to NULL
    with tr.span("serve.decode", active=n):
        ...

``NULL.span`` returns a shared singleton whose ``__enter__`` /
``__exit__`` do nothing, so call sites need no ``if tracing:`` guards.
The *on* path is two ``perf_counter_ns`` reads and one tuple append per
span; the chrome event dicts are built by :attr:`Tracer.events` /
:meth:`Tracer.save`, never while the workload runs.

Instrumented code reads the ambient tracer via :func:`current`; owners
(``ServeEngine``, ``Trainer``) install theirs for the duration of a step
with :func:`use`.  The port's calls are eager, so a span measures the
host side of every call it wraps: CUDA launches return before the
device finishes, and the device time lands in the first span that waits
for a result (``ServeConfig.trace_sync`` puts that wait inside the
prefill and decode spans).

Attr values should be Python numbers, strings and tuples.  numpy and
torch scalars and arrays are coerced on save (a 0-dim one through
``.item()``, any other through ``.tolist()``); a CUDA tensor there would
hold device memory until then and wait for the device at ``save``.
"""
from __future__ import annotations

import json
import os
import threading
import time


class _NullSpan:
    """Shared no-op context manager: the entire cost of tracing-off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracer-shaped no-op; ``trace.NULL`` is the ambient default."""

    enabled = False

    def span(self, name, **attrs):
        return _NULL_SPAN

    def instant(self, name, **attrs):
        pass

    def counter(self, name, **values):
        pass

    def clear(self):
        pass

    def save(self, path=None):
        raise ValueError("NullTracer has nothing to save; construct a "
                         "Tracer(path=...) to capture spans")

    @property
    def events(self):
        return []


NULL = NullTracer()


_perf_ns = time.perf_counter_ns
_ident = threading.get_ident


class _Span:
    """One live span: appends a raw ``(name, t0, t1, tid, attrs)`` tuple
    on exit; the ``X`` (complete) event dict is built at save time."""

    __slots__ = ("_events", "_name", "_attrs", "_t0")

    def __init__(self, events, name, attrs):
        self._events = events
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = _perf_ns()
        return self

    def __exit__(self, et, ev, tb):
        self._events.append(
            (self._name, self._t0, _perf_ns(), _ident(), self._attrs))
        return False


def _jsonable(v):
    """Coerce numpy / torch scalars and arrays and other strays to JSON
    types (anything with ``item`` and ``ndim == 0`` is a scalar, anything
    with ``tolist`` an array)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 1) == 0:
        return item()
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return tolist()
    return str(v)


class Tracer:
    """Chrome-trace event recorder.

    ``path`` is where :meth:`save` writes by default (the owner decides
    when — e.g. ``ServeEngine.run`` saves at trace end).  Events
    accumulate across :meth:`save` calls; :meth:`clear` drops them (the
    serve benchmark replays a trace best-of-N and keeps every replay's
    spans — more samples for the cost fit).
    """

    enabled = True

    def __init__(self, path: str | None = None, *,
                 process_name: str = "repro"):
        self.path = path
        self.pid = os.getpid()
        self._epoch = time.perf_counter_ns()
        self._events: list[dict] = []
        self._meta = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": process_name},
        }]

    # -- recording --------------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        """Context manager timing one named span; ``attrs`` become the
        event's ``args`` (shapes, counts — what the cost model fits on)."""
        return _Span(self._events, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        self._events.append({
            "name": name, "ph": "i", "s": "t", "cat": "repro",
            "ts": (time.perf_counter_ns() - self._epoch) / 1e3,
            "pid": self.pid, "tid": threading.get_ident() & 0xFFFFFFFF,
            "args": attrs,
        })

    def counter(self, name: str, **values) -> None:
        """One sample of a counter track (Perfetto draws it as a graph)."""
        self._events.append({
            "name": name, "ph": "C", "cat": "repro",
            "ts": (time.perf_counter_ns() - self._epoch) / 1e3,
            "pid": self.pid, "tid": 0,
            "args": values,
        })

    # -- output -----------------------------------------------------------
    @property
    def events(self) -> list[dict]:
        """Recorded events as chrome-trace dicts (span tuples from the
        hot path are materialized here, off the timed path)."""
        epoch, pid = self._epoch, self.pid
        out = []
        for e in self._events:
            if type(e) is tuple:
                name, t0, t1, tid, attrs = e
                out.append({
                    "name": name, "ph": "X", "cat": "repro",
                    "ts": (t0 - epoch) / 1e3, "dur": (t1 - t0) / 1e3,
                    "pid": pid, "tid": tid & 0xFFFFFFFF, "args": attrs,
                })
            else:
                out.append(e)
        return out

    def clear(self) -> None:
        self._events.clear()

    def save(self, path: str | None = None) -> str:
        """Write ``{"traceEvents": [...]}`` JSON; returns the path."""
        path = path or self.path
        if path is None:
            raise ValueError("no trace path: pass save(path=...) or "
                             "construct Tracer(path=...)")
        payload = {
            "traceEvents": _jsonable(self._meta + self.events),
            "displayTimeUnit": "ms",
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


def load(path: str) -> list[dict]:
    """Read a trace file back as its event list (both the ``traceEvents``
    object form this module writes and a bare JSON array)."""
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


# ---------------------------------------------------------------------------
# ambient tracer (instrumented library code reads, owners install)
# ---------------------------------------------------------------------------

_STACK: list = [NULL]


def current():
    """The ambient tracer — ``NULL`` unless an owner installed one."""
    return _STACK[-1]


class _Use:
    """Context manager installing ``tracer`` as the ambient one."""

    __slots__ = ("_tracer",)

    def __init__(self, tracer):
        self._tracer = tracer

    def __enter__(self):
        _STACK.append(self._tracer)
        return self._tracer

    def __exit__(self, *exc):
        _STACK.pop()
        return False


def use(tracer) -> _Use:
    return _Use(tracer)
