"""Cost-model replay: re-run the port's serve scheduler without a device
(counterpart of ``repro.obs.replay``).

Two pieces:

* :class:`CostModel` — per-op linear costs (``a·x + b`` seconds) fitted
  by least squares from the chrome-trace spans a real ``ServeEngine`` run
  recorded (``serve.prefill`` scales with bucketed tokens,
  ``serve.prefill_chunk`` with the padded ``Gp·C`` token count,
  ``serve.decode`` with active slots, ``serve.sample`` with rows; the
  rest fit as constants).  Fit it from a run with
  ``ServeConfig.trace_sync``: without it the prefill and decode spans
  end when their launches return, not when the card finishes.
* :func:`replay` — drives the port's own
  :class:`~repro_torch.serve.scheduler.Scheduler` /
  :class:`~repro_torch.serve.scheduler.RequestQueue` /
  :class:`~repro_torch.serve.kv_cache.PrefixCache` through the engine's
  host-side step structure (admission, chunk planning via the shared
  :func:`~repro_torch.serve.scheduler.chunk_rounds`, prefix
  probe/hit/pin, retire-time trie inserts) while charging fitted costs
  instead of running device work.  Pages are opaque sentinels and
  ``page_bytes`` a plain int, so hit/miss/eviction behaviour is the
  engine's by construction and nothing here touches torch.

Because the scheduling classes are shared rather than re-implemented,
the sim's :class:`~repro_torch.serve.scheduler.StepDecision` log is
directly comparable to a real engine run with
``ServeConfig.log_decisions``: the fidelity contract the tests and
``chip_smoke.py`` pin.  A cost model fitted on one card answers
scheduler-policy questions about that card (``admission="aware"`` vs
``"fcfs"``, budgets, chunk sizes, slot counts) on p50/p95/p99 request
latency over long request traces, with no device or parameters.

Semantics the sim does *not* model: EOS stops (token values are never
sampled, so every request runs to ``max_new_tokens``), device memory,
and capacity overflow inside the MoE.  Arrival injection assumes the
submit order of equal-arrival requests is rid order.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.serve.kv_cache import PrefixCache
from repro_torch.serve.scheduler import (Request, RequestQueue, Scheduler,
                                         chunk_rounds)

# x-extraction per op: which span attr the linear term scales with.
# Ops not listed fit (and predict) as constants.
OP_X = {
    "serve.prefill": "tokens",        # bucketed prompt length
    "serve.prefill_chunk": "tokens",  # padded Gp * C of the grouped call
    "serve.decode": "active",         # occupied decode slots
    "serve.sample": "rows",
}


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Fitted per-call cost of one span name: ``a·x + b`` seconds."""
    a: float
    b: float
    n: int = 0           # spans the fit saw

    def predict(self, x: float = 1.0) -> float:
        return max(self.a * x + self.b, 0.0)


class CostModel:
    """Per-op linear cost table fitted from recorded trace spans."""

    def __init__(self, ops: dict | None = None):
        self.ops: dict[str, OpCost] = dict(ops or {})

    def cost(self, op: str, x: float = 1.0) -> float:
        oc = self.ops.get(op)
        return oc.predict(x) if oc is not None else 0.0

    # -- fitting ------------------------------------------------------------
    @classmethod
    def fit(cls, events) -> "CostModel":
        """Least-squares fit from chrome-trace events (``ph == "X"``
        complete spans; ``dur`` is microseconds).  Ops in :data:`OP_X`
        fit ``dur ~ a·x + b`` on their scaling attr; everything else
        fits a constant (``a = 0``, ``b = mean``).  OLS with an
        intercept has zero-sum residuals, so replaying the *same*
        trace's op sequence reproduces its total recorded op time
        exactly — the calibration property the tests pin."""
        samples: dict[str, list] = collections.defaultdict(list)
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            name = ev["name"]
            attr = OP_X.get(name)
            x = float((ev.get("args") or {}).get(attr, 1.0)) if attr else 1.0
            samples[name].append((x, float(ev["dur"]) / 1e6))
        ops = {}
        for name, pts in samples.items():
            xs = np.asarray([p[0] for p in pts])
            ys = np.asarray([p[1] for p in pts])
            if np.ptp(xs) == 0.0:
                a, b = 0.0, float(ys.mean())
            else:
                design = np.stack([xs, np.ones_like(xs)], axis=1)
                (a, b), *_ = np.linalg.lstsq(design, ys, rcond=None)
            ops[name] = OpCost(float(a), float(b), n=len(pts))
        return cls(ops)

    @classmethod
    def fit_trace(cls, path: str) -> "CostModel":
        return cls.fit(trace_lib.load(path))

    # -- (de)serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return {name: {"a": oc.a, "b": oc.b, "n": oc.n}
                for name, oc in sorted(self.ops.items())}

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        return cls({name: OpCost(v["a"], v["b"], int(v.get("n", 0)))
                    for name, v in d.items()})


@dataclasses.dataclass
class ReplayConfig:
    """Scheduler-relevant slice of ``ServeConfig`` (no device fields).
    Field names match ``ServeConfig`` so configs translate one-to-one."""
    n_slots: int = 8
    policy: str = "continuous"
    admission: str = "fcfs"
    prefill_chunk: int = 0
    prefill_budget: int = 0
    prefix_cache: bool = False
    prefix_cache_bytes: int = 1 << 30
    page_bytes: int = 1          # per-page LRU charge (the engine's is
    #                              SlotKVCache.page_bytes; the sim has no
    #                              pages)
    prefill_buckets: bool = True
    min_bucket: int = 8
    max_len: int = 256


@dataclasses.dataclass
class ReplayResult:
    metrics: metrics_lib.MetricsRegistry
    decisions: tuple             # StepDecision log (fidelity contract)
    requests: list               # the replayed Request objects, mutated
    steps: int                   # engine steps simulated (incl. idle skips)
    predicted_wall_s: float      # sum of fitted per-step costs

    @property
    def stats(self) -> dict:
        return self.metrics.stats()


class _Simulator:
    """One replay run: the engine's host-side step loop, costs charged
    from the model instead of device calls.  Mirrors the port's
    ``repro_torch.serve.engine.ServeEngine`` branch for branch: ``step`` /
    ``_step_body``, ``_start`` (whole prompts), ``_run_chunk_rounds`` /
    ``_run_chunk_group`` (chunks), ``_prefix_probe`` / ``_on_admit``
    (the prefix cache's hooks) and ``_append_token`` (retirement); the
    comments below name the engine code each block shadows."""

    def __init__(self, cfg: ReplayConfig, model: CostModel):
        self.cfg = cfg
        self.model = model
        if cfg.prefix_cache and cfg.prefill_chunk <= 0:
            raise ValueError(
                "prefix_cache requires chunked prefill (prefill_chunk > 0)"
                " — same contract as ServeConfig")
        self.prefix = (PrefixCache(block=cfg.prefill_chunk,
                                   page_bytes=cfg.page_bytes,
                                   max_bytes=cfg.prefix_cache_bytes)
                       if cfg.prefix_cache else None)
        self._pins: dict[int, object] = {}
        self.queue = RequestQueue()
        self.sched = Scheduler(
            cfg.n_slots, policy=cfg.policy, admission=cfg.admission,
            prefill_chunk=cfg.prefill_chunk,
            prefill_budget=cfg.prefill_budget,
            prefix_probe=self._probe if self.prefix is not None else None,
            on_admit=self._on_admit if self.prefix is not None else None)
        self.sched.decision_log = []
        self.step_count = 0
        self.wall = 0.0
        self._t = 0.0                       # current step's charged cost
        self._arrival_wall: dict[int, float] = {}
        self._finish_wall: dict[int, float] = {}
        self._finished_this_step: list[int] = []
        self.metrics = metrics_lib.MetricsRegistry()
        self._c = {name: self.metrics.counter(name) for name in (
            "prefills", "decode_steps", "generated_tokens",
            "slot_steps_active", "slot_steps_total",
            "prefill_chunks", "prefill_tokens", "prefill_calls",
            "prefix_hits", "prefix_hit_tokens")}
        self._h_steps = self.metrics.histogram("request_latency_steps")
        self._h_secs = self.metrics.histogram("request_latency_s")

    def _charge(self, op: str, x: float = 1.0) -> None:
        self._t += self.model.cost(op, x)

    # -- prefix-cache hooks (ServeEngine._prefix_probe / ._on_admit) -------
    def _probe(self, req: Request) -> int:
        self._charge("serve.prefix_probe")
        return self.prefix.probe(req.prompt)

    def _on_admit(self, slot: int, req: Request) -> None:
        hit, _page, entry = self.prefix.lookup(req.prompt)
        if hit <= 0:
            return
        self._charge("serve.prefix_hit")
        self._pins[req.rid] = entry
        req.prefill_pos = hit
        self._c["prefix_hits"].inc()
        self._c["prefix_hit_tokens"].inc(hit)

    # -- per-request completion (ServeEngine._append_token) -----------------
    def _append(self, req: Request, slot: int) -> None:
        req.tokens.append(0)                # values are never sampled
        self._c["generated_tokens"].inc()
        if len(req.tokens) >= req.max_new_tokens:
            req.done_reason = "length"
            req.finished_step = self.step_count
            self._finished_this_step.append(req.rid)
            self._charge("serve.retire")
            self.sched.retire(slot)
            if self.prefix is not None and not self.prefix.covered(
                    req.prompt):
                self.prefix.insert(req.prompt, ("page", req.rid))

    def _finish_prefill(self, slot: int, req: Request) -> None:
        """A slot's prompt is fully ingested: unpin, count, first token."""
        self._c["prefills"].inc()
        req.first_token_step = self.step_count
        if self.prefix is not None:
            entry = self._pins.pop(req.rid, None)
            if entry is not None:
                self.prefix.unpin(entry)

    def _bucket_len(self, plen: int) -> int:
        if not self.cfg.prefill_buckets:
            return plen
        b = max(self.cfg.min_bucket, 1)
        while b < plen:
            b *= 2
        return min(b, self.cfg.max_len)

    # -- one engine step (ServeEngine.step) ---------------------------------
    def step(self) -> int:
        self._t = 0.0
        self._charge("serve.schedule")
        by_slot: dict[int, list] = {}
        work = self.sched.schedule_prefill(self.queue, self.step_count)
        prefix_on = self.prefix is not None
        for w in work:
            if (not prefix_on and w.start == 0
                    and w.length == w.req.prompt_len):
                # whole-prompt bucketed path (ServeEngine._start)
                blen = self._bucket_len(w.req.prompt_len)
                self._charge("serve.prefill", blen)
                self._charge("serve.kv_insert")
                self._charge("serve.sample", 1)
                self._c["prefill_calls"].inc()
                self._c["prefill_tokens"].inc(w.length)
                w.req.prefill_pos = w.length
                self._finish_prefill(w.slot, w.req)
                self._append(w.req, w.slot)
            else:
                by_slot.setdefault(w.slot, []).append(w)
        # chunk path (ServeEngine._run_chunk_rounds / _run_chunk_group) —
        # the grouping comes from the SAME chunk_rounds the engine runs.
        c = self.cfg.prefill_chunk
        for _off, group in chunk_rounds(by_slot):
            g = len(group)
            gp = 1 << (g - 1).bit_length()
            self._charge("serve.prefill_chunk", gp * c)
            self._c["prefill_calls"].inc()
            self._c["prefill_chunks"].inc(g)
            done = []
            for slot, w in group:
                req = w.req
                req.prefill_pos = w.start + w.length
                self._c["prefill_tokens"].inc(w.length)
                self._charge("serve.kv_insert")
                if not req.prefilling:
                    self._finish_prefill(slot, req)
                    done.append((slot, req))
            if done:
                self._charge("serve.sample", len(done))
                for slot, req in done:
                    self._append(req, slot)
        active = self.sched.decoding()
        if active:
            self._charge("serve.decode", len(active))
            self._charge("serve.sample", len(active))
            self._c["decode_steps"].inc()
            self._c["slot_steps_active"].inc(len(active))
            self._c["slot_steps_total"].inc(self.cfg.n_slots)
            for slot, req in active:
                self._append(req, slot)
        self.wall += self._t
        # A request finishing during step S pays all of step S: its
        # finish wall is the cumulative wall after this step's costs.
        for rid in self._finished_this_step:
            self._finish_wall[rid] = self.wall
        self._finished_this_step.clear()
        self.step_count += 1
        return len(active)

    def run(self, requests: list[Request],
            max_steps: int | None = None) -> ReplayResult:
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        steps = 0
        while pending or self.queue or self.sched.active():
            if (not self.queue and not self.sched.active()
                    and pending and pending[0].arrival > self.step_count):
                # idle fast-forward: nothing in flight, next arrival is
                # in the future — idle engine steps plan nothing and the
                # decision log skips them, so jumping is free.
                self.step_count = pending[0].arrival
            while pending and pending[0].arrival <= self.step_count:
                req = pending.popleft()
                self._arrival_wall[req.rid] = self.wall
                self.queue.push(req)
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        for req in requests:
            if req.finished_step is None:
                continue
            self._h_steps.observe(req.finished_step - req.arrival)
            self._h_secs.observe(
                self.wall_at_finish(req) - self._arrival_wall[req.rid])
        return ReplayResult(metrics=self.metrics,
                            decisions=tuple(self.sched.decision_log),
                            requests=requests, steps=self.step_count,
                            predicted_wall_s=self.wall)

    def wall_at_finish(self, req: Request) -> float:
        return self._finish_wall.get(req.rid, self.wall)


def replay(requests, cfg: ReplayConfig,
           cost_model: CostModel | None = None,
           max_steps: int | None = None) -> ReplayResult:
    """Replay ``requests`` through the real scheduler under ``cfg``.

    ``requests``: an iterable of ``(prompt, max_new_tokens, arrival)``
    tuples (prompt: int array / list) or prebuilt ``Request`` objects
    (rids must then be unique).  ``cost_model=None`` charges zero cost
    everywhere — scheduling decisions and step/latency *counts* are
    still exact; only the predicted wall needs a fitted model.
    """
    sim = _Simulator(cfg, cost_model or CostModel())
    reqs = []
    for i, spec in enumerate(requests):
        if isinstance(spec, Request):
            reqs.append(spec)
            continue
        prompt, max_new, arrival = spec
        reqs.append(Request(rid=i, prompt=np.asarray(prompt, np.int32),
                            max_new_tokens=int(max_new),
                            arrival=int(arrival)))
    return sim.run(reqs, max_steps=max_steps)


def synthetic_requests(n: int, *, prompt_lens=(16, 64), new_tokens=(4, 16),
                       arrival_every: float = 0.0, shared_prefix: int = 0,
                       vocab: int = 512, seed: int = 0) -> list:
    """Deterministic synthetic request trace for replay benchmarks/tests:
    prompt lengths and budgets uniform over the given inclusive ranges,
    arrivals every ``arrival_every`` steps (0 = all at step 0), the first
    ``shared_prefix`` tokens identical across requests (exercises the
    prefix cache)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, vocab, size=max(shared_prefix, 0))
    out = []
    for i in range(n):
        plen = int(rng.randint(prompt_lens[0], prompt_lens[1] + 1))
        tail = rng.randint(1, vocab, size=max(plen - shared.shape[0], 0))
        prompt = np.concatenate([shared[:plen], tail]).astype(np.int32)
        mnt = int(rng.randint(new_tokens[0], new_tokens[1] + 1))
        out.append((prompt, mnt, int(i * arrival_every)))
    return out
