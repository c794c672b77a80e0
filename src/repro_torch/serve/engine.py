"""Continuous-batching serving engine (counterpart of
``repro.serve.engine``), on the default path.

The engine owns ``n_slots`` sequence slots and runs a step loop of

    schedule (admission + chunk planning under the prefill-token budget)
    -> run this step's prefill work -> one decode step over every
    fully-prefilled slot -> sample -> retire

Requests are admitted and retired independently (``policy=
"continuous"``); ``policy="static"`` is the batch-drain baseline.
Whole prompts are right-padded to power-of-two length buckets with the
padded tail masked out of MoE routing, and dead slots are masked out of
routing at decode, exactly as in the reference, so the greedy token
streams match it.  A sliding-window model serves whole, unpadded
prompts into its ring-buffer caches, and a model with mamba mixers
into its scan and conv states: bucketing is off, and chunking and the
prefix cache warn and stay off, as in the reference.

Chunked prefill (``prefill_chunk``): a prompt longer than the chunk is
ingested as fixed-size chunk work-items over consecutive steps, each
resuming the slot's staged page where the previous chunk ended
(``lm_prefill(start_pos=...)``); ``prefill_budget`` bounds the prompt
tokens a step takes.  Same-offset chunks of different slots run as one
multi-row call (cross-slot batched prefill, rows padded to a power of
two).  The shared-prefix cache (``prefix_cache``) keeps retired pages in
a radix trie keyed by chunk-sized prompt blocks; a new request resumes
from a copy of the longest cached block-aligned prefix and prefills only
its tail.

The reference's ``jax.jit`` closures become eager calls, and its
immutable pages become tensors written in place, so a page that two
owners could write is copied (``kv_cache``'s docstring).
``fused_decode`` runs every MoE layer of a decode step (and each MoA
routed projection) as one kernel launch; prefill stays unfused.

Observability, as in the reference: ``trace_path`` records the
reference's spans (``serve.step``, ``serve.schedule``,
``serve.prefill``, ``serve.prefill_chunk``, ``serve.kv_insert``,
``serve.decode``, ``serve.sample``, ``serve.prefix_probe`` /
``serve.prefix_hit``, ``serve.retire``; the counters ``serve.queue`` and
``serve.slots``) with the kernel backend's ``kernel.*`` spans inside
them, and ``run()`` writes the chrome trace at its end.  There is no
``serve.reshard``: the port has no mesh.  The launches are
asynchronous, so without ``trace_sync`` a prefill or decode span ends
when its launches return and the device time lands in the
``serve.sample`` that copies the tokens to the host; ``trace_sync``
waits for the device inside those spans (what the replay cost model
fits on).  ``log_decisions`` keeps the scheduler's ``StepDecision`` log
on ``sched.decision_log``.  ``metrics`` is the reference's typed
registry (the stats counters, the per-step overflow and active-slot
histograms, per-expert load families); ``stats`` is its flat view.

``step_times`` holds the wall time (seconds, host clock) of each
whole-prompt prefill and each decode step, ending at the sampled
tokens' copy to the host (which waits for the device), and of each
chunk call, ending at that copy or, for a call that completes no
prompt, at a device sync.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.common import param as pm
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.models import lm
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.serve.kv_cache import PrefixCache, SlotKVCache
from repro_torch.serve.scheduler import (Request, RequestQueue, Scheduler,
                                         chunk_rounds)

@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256           # slot page length (prompt + new tokens)
    temperature: float = 0.0     # 0 => greedy
    eos_id: int = -1             # -1 => never stop early
    seed: int = 0
    n_slots: int = 8             # slot-pool size == decode batch width
    policy: str = "continuous"   # "continuous" | "static" (drain baseline)
    mask_dead_slots: bool = True
    prefill_buckets: bool = True
    min_bucket: int = 8
    # Chunked prefill: prompts longer than this many tokens are ingested
    # as chunk work-items over consecutive steps (0 = whole prompts).
    prefill_chunk: int = 0
    prefill_budget: int = 0      # max prompt tokens per step (0 = no cap)
    admission: str = "fcfs"      # "fcfs" | "aware"
    # Shared-prefix radix KV cache over retired pages (needs a chunk);
    # LRU byte budget for its pages (<= 0 = unlimited).
    prefix_cache: bool = False
    prefix_cache_bytes: int = 1 << 30
    telemetry_keep_last_n: int = 512
    # One fused launch per MoE / MoA layer at decode (prefill unfused).
    fused_decode: bool = False
    # Chrome-trace capture: None installs the null tracer (one no-op
    # context manager a span site); a path records spans, and run()
    # writes the trace there at its end.
    trace_path: str | None = None
    # Calibration tracing: wait for the device inside the prefill, chunk
    # and decode spans, so each span's duration is that op's wall time
    # (what the replay cost model fits on).  Off, those spans end when
    # the launches return and the untraced host/device overlap is kept.
    trace_sync: bool = False
    # Keep the scheduler's StepDecision records on sched.decision_log:
    # the fidelity contract the replay simulator reproduces.
    log_decisions: bool = False


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, sc: ServeConfig, *,
                 device: str | torch.device = "cuda"):
        if sc.fused_decode:
            # The model layer passes it to decode-shaped calls only.
            cfg = cfg.replace(fused_decode=True)
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.sc = sc
        self.tracer = (trace_lib.Tracer(sc.trace_path, process_name="serve")
                       if sc.trace_path else trace_lib.NULL)
        self._trace_sync = (self.tracer.enabled and sc.trace_sync
                            and self.device.type == "cuda")
        # Bucketing and chunking need caches a padded tail cannot stay in
        # and a prefix can be resumed from: a sliding-window ring buffer
        # or a mamba mixer's scan state is neither, so such a model
        # serves whole, unpadded prompts (a mamba prompt's length must be
        # a multiple of the scan chunk, or shorter than it).
        stateless = (not cfg.sliding_window
                     and all(k.mixer != "mamba" for k in layer_kinds(cfg)))
        self._can_bucket = sc.prefill_buckets and stateless
        self._chunk = 0
        if sc.prefill_chunk > 0 and not stateless:
            warnings.warn(
                "chunked prefill requires stateless attention caches; "
                "ssm/hybrid state scans and sliding-window ring buffers "
                "cannot resume mid-prompt — falling back to whole-prompt "
                "prefill", RuntimeWarning, stacklevel=2)
        elif sc.prefill_chunk > 0:
            c = sc.prefill_chunk
            if c % cfg.kv_block != 0 or (c > cfg.q_block
                                         and c % cfg.q_block != 0):
                raise ValueError(
                    f"prefill_chunk={c} must be a multiple of "
                    f"kv_block={cfg.kv_block} (and of q_block="
                    f"{cfg.q_block} when larger) so chunk boundaries "
                    "stay block-aligned with whole-prompt prefill")
            if c > sc.max_len:
                raise ValueError(
                    f"prefill_chunk={c} > max_len={sc.max_len}: even a "
                    "single chunk's cache write would not fit the slot "
                    "page")
            if cfg.param_dtype != cfg.compute_dtype:
                # A chunk attends the cached prefix at cache precision,
                # a whole-prompt prefill its fresh compute-dtype K/V.
                warnings.warn(
                    f"chunked prefill with cache dtype {cfg.param_dtype} "
                    f"!= compute dtype {cfg.compute_dtype}: chunk "
                    "attention reads the cached prefix at cache "
                    "precision, so outputs are not guaranteed "
                    "bit-identical to whole-prompt prefill",
                    RuntimeWarning, stacklevel=2)
            self._chunk = c
        if sc.prefix_cache and sc.prefill_chunk <= 0:
            raise ValueError(
                "prefix_cache requires chunked prefill (prefill_chunk > "
                "0): cache hits resume mid-prompt on the chunk grid, and "
                "whole-prompt prefill has no resume path")
        self._prefix_on = sc.prefix_cache and self._chunk > 0
        if sc.prefix_cache and not self._prefix_on:
            warnings.warn(
                "prefix cache disabled: this architecture refused chunked "
                "prefill (ssm/sliding-window), and prefix hits can only "
                "resume through the chunk path", RuntimeWarning,
                stacklevel=2)
        self.reset()

    # -- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """Fresh queue / pool / stats / request ids."""
        self._rid = 0
        self.kv = SlotKVCache(self.cfg, self.sc.n_slots, self.sc.max_len,
                              self.device)
        # Shared-prefix radix cache over retired pages, charged one
        # seq_defs page per entry.
        self.prefix: PrefixCache | None = None
        self._pins: dict[int, object] = {}   # rid -> pinned trie entry
        if self._prefix_on:
            self.prefix = PrefixCache(
                block=self._chunk, page_bytes=self.kv.page_bytes,
                max_bytes=self.sc.prefix_cache_bytes)
        self.queue = RequestQueue()
        self.sched = Scheduler(
            self.sc.n_slots, policy=self.sc.policy,
            admission=self.sc.admission, prefill_chunk=self._chunk,
            prefill_budget=self.sc.prefill_budget,
            prefix_probe=self._prefix_probe if self._prefix_on else None,
            on_admit=self._on_admit if self._prefix_on else None)
        if self.sc.log_decisions:
            self.sched.decision_log = []
        self.step_count = 0
        self.prefill_lengths: set[int] = set()
        self.chunk_offsets: set[int] = set()
        self._telemetry = collections.deque(
            maxlen=max(self.sc.telemetry_keep_last_n, 0) or None)
        # The reference's registry: the counters carry the stats keys
        # (prefill_calls counts model calls, fewer than prefill_chunks
        # when same-offset chunks share a call).
        self.metrics = metrics_lib.MetricsRegistry()
        self._c = {name: self.metrics.counter(name) for name in (
            "prefills", "decode_steps", "reshards", "generated_tokens",
            "slot_steps_active", "slot_steps_total", "overflow_total",
            "prefill_chunks", "prefill_tokens", "prefill_calls",
            "prefix_hits", "prefix_hit_tokens")}
        self._h_overflow = self.metrics.histogram("decode_overflow_per_step")
        self._h_active = self.metrics.histogram("decode_active_slots")
        self._c_expert_load = self.metrics.counter("decode_expert_load",
                                                   labels=("expert",))
        # MoA head groups get families of their own: head-group load is
        # not FFN-expert load.
        self._c_moa_overflow = self.metrics.counter("moa_overflow_total")
        self._h_moa_overflow = self.metrics.histogram(
            "decode_moa_overflow_per_step")
        self._c_moa_load = self.metrics.counter("decode_moa_load",
                                                labels=("expert",))
        self.step_times: dict[str, list[float]] = {
            "prefill": [], "chunk": [], "decode": []}

    def submit(self, prompt, max_new_tokens: int, arrival: int = 0
               ) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}: "
                "prefill always samples the first token")
        if prompt.shape[0] + max_new_tokens > self.sc.max_len:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.sc.max_len}")
        if (self._chunk == 0 and self.sc.prefill_budget > 0
                and prompt.shape[0] > self.sc.prefill_budget):
            raise ValueError(
                f"prompt ({prompt.shape[0]}) exceeds the per-step prefill "
                f"budget ({self.sc.prefill_budget}) and chunked prefill "
                "is off — enable ServeConfig.prefill_chunk to split it")
        if self._chunk and prompt.shape[0] > self._chunk:
            # Every chunk writes a full chunk of cache positions (the
            # last one padded), so the chunk-rounded prompt must fit.
            padded = -(-int(prompt.shape[0]) // self._chunk) * self._chunk
            if padded > self.sc.max_len:
                raise ValueError(
                    f"prompt ({prompt.shape[0]}) rounds up to {padded} "
                    f"chunk-padded tokens > max_len {self.sc.max_len}: "
                    "the final chunk's cache write would not fit the "
                    "page — raise max_len or lower prefill_chunk")
        req = Request(rid=self._rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, arrival=arrival)
        self._rid += 1
        self.queue.push(req)
        return req

    # -- sampling ---------------------------------------------------------
    def _sample_rows(self, logits: torch.Tensor,
                     reqs: list[Request | None]) -> np.ndarray:
        """logits: [B, V] -> [B] int32 (row i sampled for reqs[i]).
        Temperature sampling draws each row from a generator seeded by
        (seed, request id, tokens so far), so a request's stream does not
        depend on which batch it shares a step with."""
        if self.sc.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.float() / self.sc.temperature, dim=-1)
        out = np.zeros((logits.shape[0],), np.int32)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(hash((self.sc.seed, r.rid, len(r.tokens)))
                            & 0x7fffffffffffffff)
            out[i] = int(torch.multinomial(probs[i], 1, generator=gen))
        return out

    # -- the step loop ----------------------------------------------------
    def _append_token(self, req: Request, tok: int, slot: int) -> None:
        """Record a sampled token; retire on EOS (checked for every token,
        the last of the budget included) or length."""
        req.tokens.append(int(tok))
        self._c["generated_tokens"].inc()
        if self.sc.eos_id >= 0 and int(tok) == self.sc.eos_id:
            req.done_reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            req.done_reason = "length"
        if req.done:
            req.finished_step = self.step_count
            with self.tracer.span("serve.retire", rid=req.rid, slot=slot,
                                  reason=req.done_reason):
                self.sched.retire(slot)
                if self.prefix is not None and not self.prefix.covered(
                        req.prompt):
                    # The page's prompt span [0, prompt_len) is
                    # chunk-prefill output; decode K/V past it is never
                    # part of a hit.
                    self.prefix.insert(req.prompt, self.kv.extract(slot))
                self.kv.release(slot)

    def _bucket_len(self, plen: int) -> int:
        if not self._can_bucket:
            return plen
        b = max(self.sc.min_bucket, 1)
        while b < plen:
            b *= 2
        return min(b, self.sc.max_len)

    def _start(self, slot: int, req: Request) -> None:
        """Prefill a newly admitted request (right-padded to its bucket,
        the padding masked out of routing) and seed its slot."""
        t0 = time.perf_counter()
        plen = req.prompt_len
        blen = self._bucket_len(plen)
        padded = np.zeros((1, blen), np.int32)
        padded[0, :plen] = req.prompt
        valid = np.zeros((1, blen), np.float32)
        valid[0, :plen] = 1.0
        self.prefill_lengths.add(blen)
        tr = self.tracer
        with tr.span("serve.prefill", rid=req.rid, slot=slot, plen=plen,
                     tokens=blen):
            logits, page = lm.lm_prefill(
                self.params,
                {"tokens": torch.from_numpy(padded).to(self.device)},
                self.kv.new_page(), self.cfg, last_index=plen - 1,
                valid=torch.from_numpy(valid).to(self.device))
            if self._trace_sync:
                torch.cuda.synchronize(self.device)
        with tr.span("serve.kv_insert", slot=slot):
            self.kv.insert(slot, page, plen)
        self._c["prefills"].inc()
        self._c["prefill_calls"].inc()
        self._c["prefill_tokens"].inc(plen)
        req.prefill_pos = plen
        req.first_token_step = self.step_count
        with tr.span("serve.sample", rows=1):
            tok = self._sample_rows(logits, [req])[0]
        self.step_times["prefill"].append(time.perf_counter() - t0)
        self._append_token(req, tok, slot)

    # -- shared-prefix cache hooks ----------------------------------------
    def _prefix_probe(self, req: Request) -> int:
        """Scheduler hook: the cached-prefix length a new request would
        resume from (admission charges only the uncached tail)."""
        with self.tracer.span("serve.prefix_probe", rid=req.rid):
            return self.prefix.probe(req.prompt)

    def _on_admit(self, slot: int, req: Request) -> None:
        """Scheduler hook, when a request claims a slot: stage a copy of
        the longest cached block-aligned prefix page in the slot and
        advance ``prefill_pos`` so the chunks cover only the tail.  A
        copy, because the tail chunk writes its K/V into the page it
        resumes from.  The trie entry stays pinned until the prefill
        completes."""
        hit, page, entry = self.prefix.lookup(req.prompt)
        if hit <= 0:
            return
        with self.tracer.span("serve.prefix_hit", rid=req.rid, slot=slot,
                              hit_tokens=hit):
            self._pins[req.rid] = entry
            req.prefill_pos = hit
            self.kv.append(slot, pm.tree_map(torch.clone, page), hit,
                           last=False)
        self._c["prefix_hits"].inc()
        self._c["prefix_hit_tokens"].inc(hit)

    # -- chunked prefill ---------------------------------------------------
    def _resume_page(self, slot: int):
        """The page a slot's next chunk resumes from: its staged
        in-flight page, else a new blank one (never shared: the chunk
        writes into it)."""
        page = self.kv.staged(slot)
        return self.kv.new_page() if page is None else page

    def _run_chunk_rounds(self, by_slot: dict) -> None:
        """Run this step's chunk work-items in the rounds of
        ``scheduler.chunk_rounds``: same-offset chunks of different
        slots as one multi-row call."""
        for off, group in chunk_rounds(by_slot):
            self._run_chunk_group(off, group)

    def _run_chunk_group(self, off: int, group: list) -> None:
        """One multi-row prefill call for same-offset chunks of
        ``len(group)`` slots, rows padded to a power of two (pad rows: a
        blank page and all-zero validity, so they route nowhere).
        In-flight pages stay staged and join the pool only with the
        completing chunk; completing rows sample their first token."""
        t0 = time.perf_counter()
        c = self._chunk
        g = len(group)
        gp = 1 << (g - 1).bit_length()
        tokens = np.zeros((gp, c), np.int32)
        valid = np.zeros((gp, c), np.float32)
        li = np.full((gp,), c - 1, np.int64)   # pad rows: never read
        pages = []
        for i, (slot, w) in enumerate(group):
            req = w.req
            tokens[i, :w.length] = req.prompt[w.start:w.start + w.length]
            valid[i, :w.length] = 1.0
            # Chunk-local index of the final prompt token (read only on
            # a row's last chunk).
            li[i] = min(req.prompt_len - 1 - off, c - 1)
            pages.append(self._resume_page(slot))
        pages.extend(self.kv.new_page() for _ in range(gp - g))
        page_in = pages[0] if gp == 1 else self.kv.stack_pages(pages)
        self.chunk_offsets.add(off)
        dev = self.device
        tr = self.tracer
        with tr.span("serve.prefill_chunk", offset=off, G=g, Gp=gp, C=c,
                     tokens=gp * c):
            logits, page_out = lm.lm_prefill(
                self.params, {"tokens": torch.from_numpy(tokens).to(dev)},
                page_in, self.cfg, last_index=torch.from_numpy(li).to(dev),
                valid=torch.from_numpy(valid).to(dev), start_pos=off)
            if self._trace_sync:
                torch.cuda.synchronize(dev)
        self._c["prefill_calls"].inc()
        self._c["prefill_chunks"].inc(g)
        out_pages = ([page_out] if gp == 1
                     else self.kv.split_pages(page_out, g))
        rows: list[Request | None] = [None] * gp
        done_rows = []
        for i, (slot, w) in enumerate(group):
            req = w.req
            req.prefill_pos = w.start + w.length
            self._c["prefill_tokens"].inc(w.length)
            done = not req.prefilling
            with tr.span("serve.kv_insert", slot=slot):
                self.kv.append(slot, out_pages[i], req.prefill_pos,
                               last=done)
            if done:
                self._c["prefills"].inc()
                req.first_token_step = self.step_count
                entry = self._pins.pop(req.rid, None)
                if entry is not None:
                    # The tail no longer reads the cached page.
                    self.prefix.unpin(entry)
                rows[i] = req
                done_rows.append((i, slot, req))
        toks = None
        if done_rows:
            with tr.span("serve.sample", rows=len(done_rows)):
                toks = self._sample_rows(logits, rows)
        elif dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.step_times["chunk"].append(time.perf_counter() - t0)
        for i, slot, req in done_rows:
            self._append_token(req, toks[i], slot)

    def step(self) -> int:
        """One engine step: plan prefill work (admission + chunks under
        the per-step token budget), run it, then one decode over the
        fully-prefilled slots, sample, retire.  Returns the number of
        slots that were active in the decode."""
        tr = self.tracer
        with trace_lib.use(tr), tr.span("serve.step", step=self.step_count):
            return self._step_body(tr)

    def _step_body(self, tr) -> int:
        by_slot: dict[int, list] = {}
        with tr.span("serve.schedule", queued=len(self.queue)):
            work = self.sched.schedule_prefill(self.queue, self.step_count)
        for w in work:
            if (not self._prefix_on and w.start == 0
                    and w.length == w.req.prompt_len):
                self._start(w.slot, w.req)   # whole prompt: bucketed path
            else:
                # With the prefix cache on, every prompt takes the chunk
                # path, so every cached page comes from the same chunk
                # calls a resumed prefill replays.
                by_slot.setdefault(w.slot, []).append(w)
        self._run_chunk_rounds(by_slot)
        active = self.sched.decoding()
        if active:
            t0 = time.perf_counter()
            n = self.sc.n_slots
            toks = np.zeros((n,), np.int32)
            pos = np.zeros((n,), np.int32)
            occ = np.zeros((n,), np.float32)
            rows: list[Request | None] = [None] * n
            for slot, req in active:
                toks[slot] = req.tokens[-1]
                pos[slot] = req.prompt_len + len(req.tokens) - 1
                occ[slot] = 1.0
                rows[slot] = req
            if not self.sc.mask_dead_slots:
                occ[:] = 1.0
            dev = self.device
            with tr.span("serve.decode", active=len(active), slots=n):
                logits, _, telem = lm.lm_decode(
                    self.params, torch.from_numpy(toks).to(dev),
                    self.kv.cache, torch.from_numpy(pos).to(dev), self.cfg,
                    valid=torch.from_numpy(occ).to(dev),
                    return_telemetry=True)
                if self._trace_sync:
                    torch.cuda.synchronize(dev)
            with tr.span("serve.sample", rows=len(active)):
                nxt = self._sample_rows(logits, rows)
            self.step_times["decode"].append(time.perf_counter() - t0)
            self._record_telemetry(telem, len(active))
            self._c["decode_steps"].inc()
            self._c["slot_steps_active"].inc(len(active))
            self._c["slot_steps_total"].inc(n)
            for slot, req in active:
                self.kv.lengths[slot] = int(pos[slot]) + 1
                self._append_token(req, nxt[slot], slot)
        if tr.enabled:
            tr.counter("serve.queue", depth=len(self.queue))
            tr.counter("serve.slots", active=len(active))
        self.step_count += 1
        return len(active)

    def run(self, max_steps: int | None = None) -> None:
        """Drive the step loop until every submitted request completes;
        with tracing on, the trace file is (re)written at the end."""
        steps = 0
        while self.queue or self.sched.active():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        if self.tracer.enabled and self.tracer.path:
            self.tracer.save()

    # -- telemetry --------------------------------------------------------
    def _record_telemetry(self, telem, n_active: int) -> None:
        if telem is None:
            return
        entry = {"step": self.step_count, "active": n_active}
        # MoE FFN counters and MoA head-group counters are independent
        # families; a model may have either or both.
        for load, over, count, total, hist, fam in (
                ("expert_load", "overflow", "n_moe",
                 self._c["overflow_total"], self._h_overflow,
                 self._c_expert_load),
                ("moa_load", "moa_overflow", "n_moa", self._c_moa_overflow,
                 self._h_moa_overflow, self._c_moa_load)):
            if load in telem:
                entry.update({load: telem[load].cpu().numpy(),
                              over: telem[over].cpu().numpy(),
                              count: float(telem[count])})
                total.inc(float(entry[over].sum()))
                hist.observe(float(entry[over].sum()))
                for e, n in enumerate(entry[load].tolist()):
                    fam.child(expert=e).inc(float(n))
        self._h_active.observe(n_active)
        self._telemetry.append(entry)

    @property
    def telemetry(self) -> list:
        """Recent per-step MoE telemetry entries (the last
        ``telemetry_keep_last_n`` decode steps)."""
        return list(self._telemetry)

    @property
    def stats(self) -> dict:
        """The registry's flat view: the counters under the reference's
        stats keys (ints where integral)."""
        return self.metrics.stats()

    @property
    def slot_utilization(self) -> float:
        total = self._c["slot_steps_total"].value
        return self._c["slot_steps_active"].value / total if total else 0.0

    def generate(self, prompts: np.ndarray, max_new_tokens: int
                 ) -> np.ndarray:
        """prompts: [B, S0] int32 (same length) -> [B, new] tokens, on a
        freshly reset engine; rows ending early are padded with eos_id."""
        prompts = np.asarray(prompts)
        if prompts.shape[0] > self.sc.n_slots:
            raise ValueError(
                f"{prompts.shape[0]} prompts > n_slots={self.sc.n_slots}; "
                f"submit() + run() handles oversubscription")
        self.reset()
        reqs = [self.submit(p, max_new_tokens) for p in prompts]
        self.run()
        width = max(len(r.tokens) for r in reqs)
        pad = self.sc.eos_id if self.sc.eos_id >= 0 else 0
        out = np.full((len(reqs), width), pad, np.int32)
        for i, r in enumerate(reqs):
            out[i, :len(r.tokens)] = r.tokens
        return out
