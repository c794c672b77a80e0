"""Request admission and slot-pool scheduling for the serving engine.

A copy of ``repro.serve.scheduler`` (numpy-only host bookkeeping): the
port keeps its own so it never imports the JAX package.

The engine owns a fixed pool of ``n_slots`` sequence slots (static shapes:
the decode step is one jitted call over the whole pool every step).  The
scheduler's job is the part XLA cannot do — deciding *which* request
occupies which slot at which step, and *how much prefill work* a step may
carry:

* :class:`Request` — one generation job: prompt, budget, and (as the
  engine runs) the prefill progress, sampled tokens and completion state.
* :class:`RequestQueue` — FIFO admission with per-request ``arrival``
  steps, so staggered traffic can be replayed deterministically.
* :class:`Scheduler` — the slot pool.  ``policy="continuous"`` admits a
  queued request the moment any slot frees (continuous batching — no
  batch-drain stalls); ``policy="static"`` only admits into an *empty*
  pool (the classic static-batch baseline, kept for the serve benchmark's
  before/after comparison).

Prompt-length-aware admission (docs/serving.md): :meth:`Scheduler.
schedule_prefill` plans each engine step's prefill work as a list of
:class:`PrefillWork` chunk items.  With ``prefill_chunk > 0`` a long
prompt becomes a *sequence* of fixed-size chunk work-items spread over
consecutive steps (chunked prefill — decode keeps running between
chunks); with ``prefill_budget > 0`` no step ever plans more than that
many prompt tokens of prefill.  ``admission="fcfs"`` admits strictly in
arrival order — a head request whose next chunk does not fit the
remaining budget still claims its slot (its chunks start on the next
step's budget), and later arrivals may fill the leftover budget behind
it; ``admission="aware"`` (prompt-length-aware) instead skips such
requests entirely, leaving the slot to the earliest request that fits —
short prompts are never stuck behind a long head-of-line prompt.

All of this is host-side bookkeeping over numpy/python state; device work
(prefill, decode, KV writes) stays in ``engine.py`` / ``kv_cache.py``.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state."""

    rid: int
    prompt: np.ndarray                  # [S0] int32
    max_new_tokens: int
    arrival: int = 0                    # engine step at which it may admit
    # Filled in by the engine:
    tokens: list = dataclasses.field(default_factory=list)
    done_reason: str | None = None      # "eos" | "length"
    admitted_step: int | None = None
    finished_step: int | None = None
    prefill_pos: int = 0                # prompt tokens prefilled so far
    first_token_step: int | None = None  # step the first token sampled at

    @property
    def done(self) -> bool:
        return self.done_reason is not None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[-1])

    @property
    def prefilling(self) -> bool:
        """Admitted but the prompt is not fully ingested yet (a chunked
        prefill in flight across engine steps)."""
        return self.prefill_pos < self.prompt_len


@dataclasses.dataclass(frozen=True)
class PrefillWork:
    """One prefill work-item: ingest ``length`` prompt tokens of ``req``
    starting at prompt position ``start`` into ``slot``'s cache page.
    Whole-prompt prefill is the single item (0, prompt_len); chunked
    prefill emits one item per chunk."""
    slot: int
    req: Request
    start: int
    length: int


@dataclasses.dataclass(frozen=True)
class StepDecision:
    """Everything the scheduler decided in one ``schedule_prefill`` call —
    the record the replay simulator must reproduce exactly (the fidelity
    contract in docs/observability.md).  Comparable across a real
    ``ServeEngine`` run and a cost-model replay because both drive the
    *same* ``Scheduler``/``RequestQueue``/``PrefixCache`` classes.

    ``admitted``: rids in admission order (slot claim order);
    ``work``: the planned chunk items as ``(rid, slot, start, length)``;
    ``prefix_hits``: ``(rid, hit_tokens)`` for admissions that resumed
    from a cached prefix (``on_admit`` advanced ``prefill_pos``)."""
    step: int
    admitted: tuple
    work: tuple
    prefix_hits: tuple


def chunk_rounds(by_slot: dict) -> list:
    """Group per-slot ordered prefill work-items into execution rounds.

    Each slot's items are consecutive prompt ranges that must run in
    order (chunk N+1 resumes chunk N's page), but items of *different*
    slots are independent — so execution proceeds in rounds of every
    slot's head item, with same-offset heads grouped into one multi-row
    batched prefill call.  Returns ``[(offset, [(slot, work), ...]),
    ...]`` in execution order.

    Shared by ``ServeEngine`` (which runs each group as one device call)
    and the replay simulator (which charges each group one fitted
    prefill-chunk cost) — the grouping IS the scheduling decision, so
    both must compute it identically.
    """
    queues = {slot: list(items) for slot, items in by_slot.items()}
    rounds: list = []
    while queues:
        heads: dict[int, list] = {}
        for slot in sorted(queues):
            w = queues[slot][0]
            heads.setdefault(w.start, []).append((slot, w))
        for off in sorted(heads):
            rounds.append((off, heads[off]))
        for slot in list(queues):
            queues[slot].pop(0)
            if not queues[slot]:
                del queues[slot]
    return rounds


class RequestQueue:
    """FIFO queue with arrival times (for replaying staggered traffic).

    Indexed two-heap layout (the replay-sim bottleneck under sustained
    overload was the old linear scan over *every* queued request per
    pop): not-yet-arrived requests wait in an arrival-keyed ``_pending``
    heap and are admitted to the submission-ordered ``_ready`` heap the
    first time ``pop_ready`` sees their arrival step.  The common fcfs
    pop is then O(log n) off the ready head, and a ``fits`` scan only
    walks requests that are actually poppable this step — never the
    backlog of future arrivals.  ``pop_ready`` semantics are
    bit-identical to the linear scan (pinned by tests/test_serve_sched.py):
    earliest-*submitted* ready request wins, not earliest-arrived."""

    def __init__(self):
        self._seq = 0                    # submission order (FIFO tiebreak)
        self._pending: list = []         # heap of (arrival, seq, req)
        self._ready: list = []           # heap of (seq, req)

    def push(self, req: Request) -> None:
        heapq.heappush(self._pending, (req.arrival, self._seq, req))
        self._seq += 1

    def pop_ready(self, step: int, fits=None) -> Request | None:
        """Earliest-submitted request whose arrival step has passed.

        ``fits`` (optional predicate) restricts the pop to requests the
        caller can start right now — the prompt-length-aware admission
        policy passes a next-chunk-fits-the-budget check here, so a long
        head-of-line prompt is skipped (not starved: every step's budget
        resets, and a chunk never exceeds the budget by construction, so
        the head admits as soon as a slot is free at step start).
        Without ``fits`` (fcfs) the head is popped regardless — it
        claims its slot even when no budget is left for its chunks this
        step."""
        while self._pending and self._pending[0][0] <= step:
            _, seq, req = heapq.heappop(self._pending)
            heapq.heappush(self._ready, (seq, req))
        skipped = []
        found = None
        while self._ready:
            seq, req = heapq.heappop(self._ready)
            # Re-check arrival: a caller may legally probe an *earlier*
            # step than the one that admitted this request to ready.
            if req.arrival <= step and (fits is None or fits(req)):
                found = req
                break
            skipped.append((seq, req))
        for item in skipped:
            heapq.heappush(self._ready, item)
        return found

    def __len__(self) -> int:
        return len(self._pending) + len(self._ready)

    def __bool__(self) -> bool:
        return bool(self._pending) or bool(self._ready)


class Scheduler:
    """Fixed slot pool with continuous (default) or batch-drain admission.

    ``prefill_chunk``: chunk size in tokens (0 = whole-prompt prefill).
    ``prefill_budget``: max prompt tokens planned per engine step
    (0 = unlimited).  ``admission``: "fcfs" | "aware" (see module doc).

    Shared-prefix hooks (both optional — the engine wires them when its
    prefix cache is on):

    * ``prefix_probe(req) -> int`` — cached-prefix length (tokens) a new
      request would resume from.  Admission cost accounting uses it so
      the "aware" fits-predicate charges only the *uncached tail* against
      the budget: a long prompt whose prefix is cached competes like the
      short prompt it effectively is.
    * ``on_admit(slot, req)`` — called the moment a request claims a
      slot, *before* its chunks are planned.  The engine's hook performs
      the prefix-cache lookup, pins the entry, stages the cached page
      into the slot and advances ``req.prefill_pos`` to the hit length —
      so chunk planning (and the budget) naturally sees only the tail.
    """

    def __init__(self, n_slots: int, policy: str = "continuous", *,
                 admission: str = "fcfs", prefill_chunk: int = 0,
                 prefill_budget: int = 0, prefix_probe=None,
                 on_admit=None):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        if admission not in ("fcfs", "aware"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if prefill_chunk > 0 and prefill_budget > 0 \
                and prefill_chunk > prefill_budget:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) > prefill_budget "
                f"({prefill_budget}): no chunk could ever be scheduled")
        self.n_slots = n_slots
        self.policy = policy
        self.admission = admission
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget
        self.prefix_probe = prefix_probe
        self.on_admit = on_admit
        self.slots: list[Request | None] = [None] * n_slots
        self.admitted = 0
        self.retired = 0
        self.max_concurrent = 0
        # Optional decision capture: when a list is assigned here, every
        # schedule_prefill call that admitted or planned anything appends
        # a StepDecision — the fidelity contract the replay simulator is
        # tested against (docs/observability.md).  None (default) keeps
        # the hot path allocation-free.
        self.decision_log: list[StepDecision] | None = None

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active(self) -> list[tuple[int, Request]]:
        """Occupied slots (prefilling or decoding)."""
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def decoding(self) -> list[tuple[int, Request]]:
        """Occupied slots whose prompt is fully ingested — the slots the
        fused decode step feeds (a mid-prefill slot has no token to feed
        and must not decode garbage)."""
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and not r.prefilling]

    # -- per-step prefill planning ---------------------------------------
    def _next_cost(self, req: Request) -> int:
        """Prompt tokens the request's next work-item ingests.  For a
        not-yet-admitted request with a cached prefix, the first work-item
        starts at the hit position (``on_admit`` advances ``prefill_pos``
        there), so the cost is charged from the probe result — only the
        uncached tail counts against the budget."""
        pos = req.prefill_pos
        if self.prefix_probe is not None and req.admitted_step is None:
            pos = max(pos, self.prefix_probe(req))
        remaining = req.prompt_len - pos
        if self.prefill_chunk <= 0:
            return remaining
        return min(self.prefill_chunk, remaining)

    def _emit_chunks(self, slot: int, req: Request, planned: dict,
                     spent: int, budget: int | None
                     ) -> tuple[list[PrefillWork], int]:
        """Chunk work-items for one request, up to the remaining budget.
        ``planned`` tracks positions planned this step but not yet
        executed (the engine runs the items after planning finishes)."""
        items: list[PrefillWork] = []
        pos = planned.get(req.rid, req.prefill_pos)
        while pos < req.prompt_len:
            n = (req.prompt_len - pos if self.prefill_chunk <= 0
                 else min(self.prefill_chunk, req.prompt_len - pos))
            if budget is not None and spent + n > budget:
                break
            items.append(PrefillWork(slot, req, pos, n))
            spent += n
            pos += n
            if self.prefill_chunk <= 0:
                break
        planned[req.rid] = pos
        return items, spent

    def schedule_prefill(self, queue: RequestQueue | None, step: int
                         ) -> list[PrefillWork]:
        """Plan one engine step's prefill work.

        1. continue in-flight chunked prefills (slot order — deterministic);
        2. admit ready requests from the queue into free slots, each with
           as many chunk work-items as the remaining budget allows.

        The total token count of the returned items never exceeds
        ``prefill_budget`` (the hypothesis suite pins this invariant);
        continuous admission fills every free slot the budget can feed,
        static admission waits for the whole pool to drain.
        """
        budget = self.prefill_budget if self.prefill_budget > 0 else None
        planned: dict[int, int] = {}
        out: list[PrefillWork] = []
        spent = 0
        for slot, req in self.active():
            if req.prefilling:
                items, spent = self._emit_chunks(slot, req, planned,
                                                 spent, budget)
                out.extend(items)
        can_admit = queue is not None and not (
            self.policy == "static"
            and any(r is not None for r in self.slots))
        admitted_rids: list[int] = []
        prefix_hits: list[tuple[int, int]] = []
        if can_admit:
            fits = None
            if self.admission == "aware" and budget is not None:
                # Reads the *current* spent at each pop: prompt-length-
                # aware admission skips requests whose next chunk would
                # overflow what is left of this step's budget.
                fits = lambda r: self._next_cost(r) <= budget - spent  # noqa: E731
            for slot in self.free_slots():
                if budget is not None and spent >= budget:
                    break
                req = queue.pop_ready(step, fits)
                if req is None:
                    break
                req.admitted_step = step
                self.slots[slot] = req
                self.admitted += 1
                admitted_rids.append(req.rid)
                if self.on_admit is not None:
                    # Prefix-cache hook: may stage a cached page and
                    # advance req.prefill_pos past the hit, so the chunk
                    # plan below covers only the uncached tail.
                    self.on_admit(slot, req)
                    if req.prefill_pos > 0:
                        prefix_hits.append((req.rid, req.prefill_pos))
                items, spent = self._emit_chunks(slot, req, planned,
                                                 spent, budget)
                out.extend(items)
        self.max_concurrent = max(self.max_concurrent, len(self.active()))
        if self.decision_log is not None and (out or admitted_rids):
            self.decision_log.append(StepDecision(
                step=step, admitted=tuple(admitted_rids),
                work=tuple((w.req.rid, w.slot, w.start, w.length)
                           for w in out),
                prefix_hits=tuple(prefix_hits)))
        return out

    def admit(self, queue: RequestQueue, step: int
              ) -> list[tuple[int, Request]]:
        """Legacy whole-prompt admission (kept for scheduler-level tests):
        equivalent to ``schedule_prefill`` with no chunking or budget,
        returning the admitted (slot, request) pairs."""
        if self.prefill_chunk > 0 or self.prefill_budget > 0:
            # Calling the legacy entry point on a chunking/budget config
            # would silently drop both knobs — a real exception, not an
            # assert that `python -O` strips (same policy as retire below).
            raise ValueError(
                "Scheduler.admit() is whole-prompt only; use "
                "schedule_prefill when prefill_chunk/prefill_budget are "
                "configured")
        before = {id(r) for r in self.slots if r is not None}
        return [(w.slot, w.req)
                for w in self.schedule_prefill(queue, step)
                if id(w.req) not in before]

    def retire(self, slot: int) -> Request:
        req = self.slots[slot]
        if req is None:
            # A double retire desynchronizes admitted/retired accounting
            # and could free another request's slot — a real exception,
            # not an assert that `python -O` strips.
            raise ValueError(f"retire of empty slot {slot}")
        self.slots[slot] = None
        self.retired += 1
        return req
