"""Serve / train observability (counterpart of ``repro.obs``).

Three layers, each usable on its own:

* :mod:`repro_torch.obs.trace` — chrome-trace span capture (Perfetto /
  ``chrome://tracing`` loadable JSON) with a null tracer, so untraced
  hot paths pay one attribute read;
* :mod:`repro_torch.obs.metrics` — typed Counter / Gauge / Histogram
  instruments in a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  (bounded memory, p50 / p95 / p99 from fixed buckets);
* :mod:`repro_torch.obs.replay` — a cost model fitted from recorded
  traces and a replay simulator that re-runs the real scheduler against
  simulated step costs (it pulls in the serve stack, so it is imported
  explicitly: ``from repro_torch.obs import replay``).

Only the dependency-free layers are imported here, so low-level modules
(the kernel backend) can import ``repro_torch.obs.trace`` without
cycles.
"""
from repro_torch.obs import metrics, trace  # noqa: F401
