"""Continuous-batching serving engine (counterpart of
``repro.serve.engine``), on the default path.

The engine owns ``n_slots`` sequence slots and runs a step loop of

    schedule (admission) -> prefill each admitted prompt -> one decode
    step over every fully-prefilled slot -> sample -> retire

Requests are admitted and retired independently (``policy=
"continuous"``); ``policy="static"`` is the batch-drain baseline.
Prompts are right-padded to power-of-two length buckets with the padded
tail masked out of MoE routing, and dead slots are masked out of routing
at decode, exactly as in the reference, so the greedy token streams
match it.

The reference's ``jax.jit`` closures become eager calls.  Chunked
prefill, the shared-prefix cache, chrome-trace capture, decision logging
and the fused decode kernel are not ported yet: setting them raises
NotImplementedError.

``stats`` is a plain dict with the reference's keys.  ``step_times``
holds each prefill's and each decode step's wall time (seconds, host
clock, ending at the sampled token's copy to the host, which waits for
the device).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig, layer_kinds
from repro_torch.models import lm
from repro_torch.serve.kv_cache import SlotKVCache
from repro_torch.serve.scheduler import Request, RequestQueue, Scheduler

STAT_KEYS = ("prefills", "decode_steps", "reshards", "generated_tokens",
             "slot_steps_active", "slot_steps_total", "overflow_total",
             "prefill_chunks", "prefill_tokens", "prefill_calls",
             "prefix_hits", "prefix_hit_tokens", "moa_overflow_total")


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
    prefill_budget: int = 0      # max prompt tokens per step (0 = no cap)
    admission: str = "fcfs"      # "fcfs" | "aware"
    telemetry_keep_last_n: int = 512
    # Not ported yet (NotImplementedError when set):
    prefill_chunk: int = 0
    prefix_cache: bool = False
    trace_path: str | None = None
    log_decisions: bool = False
    fused_decode: bool = False


def _check_ported(sc: ServeConfig) -> None:
    unported = {"prefill_chunk": sc.prefill_chunk > 0,
                "prefix_cache": sc.prefix_cache,
                "trace_path": sc.trace_path is not None,
                "log_decisions": sc.log_decisions,
                "fused_decode": sc.fused_decode}
    on = [name for name, set_ in unported.items() if set_]
    if on:
        raise NotImplementedError(
            f"ServeConfig {on}: not ported to repro_torch yet (chunked "
            "prefill, prefix cache, tracing, decision logs and fused "
            "decode come in later slices)")


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, sc: ServeConfig, *,
                 device: str | torch.device = "cuda"):
        _check_ported(sc)
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.sc = sc
        stateless = (not cfg.sliding_window
                     and all(k.mixer != "mamba" for k in layer_kinds(cfg)))
        self._can_bucket = sc.prefill_buckets and stateless
        self.reset()

    # -- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """Fresh queue / pool / stats / request ids."""
        self._rid = 0
        self.kv = SlotKVCache(self.cfg, self.sc.n_slots, self.sc.max_len,
                              self.device)
        self.queue = RequestQueue()
        self.sched = Scheduler(self.sc.n_slots, policy=self.sc.policy,
                               admission=self.sc.admission,
                               prefill_budget=self.sc.prefill_budget)
        self.step_count = 0
        self.prefill_lengths: set[int] = set()
        self._telemetry = collections.deque(
            maxlen=max(self.sc.telemetry_keep_last_n, 0) or None)
        self._stats = dict.fromkeys(STAT_KEYS, 0)
        self.step_times: dict[str, list[float]] = {"prefill": [],
                                                   "decode": []}

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
        if self.sc.prefill_budget > 0 and \
                prompt.shape[0] > self.sc.prefill_budget:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) exceeds the per-step prefill "
                f"budget ({self.sc.prefill_budget}) and chunked prefill "
                "is not ported")
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
        self._stats["generated_tokens"] += 1
        if self.sc.eos_id >= 0 and int(tok) == self.sc.eos_id:
            req.done_reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            req.done_reason = "length"
        if req.done:
            req.finished_step = self.step_count
            self.sched.retire(slot)
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
        logits, page = lm.lm_prefill(
            self.params, {"tokens": torch.from_numpy(padded).to(self.device)},
            self.kv.new_page(), self.cfg, last_index=plen - 1,
            valid=torch.from_numpy(valid).to(self.device))
        self.kv.insert(slot, page, plen)
        for key, n in (("prefills", 1), ("prefill_calls", 1),
                       ("prefill_tokens", plen)):
            self._stats[key] += n
        req.prefill_pos = plen
        req.first_token_step = self.step_count
        tok = self._sample_rows(logits, [req])[0]
        self.step_times["prefill"].append(time.perf_counter() - t0)
        self._append_token(req, tok, slot)

    def step(self) -> int:
        """One engine step: admit + prefill, then one decode over the
        fully-prefilled slots, sample, retire.  Returns the number of
        slots that were active in the decode."""
        for w in self.sched.schedule_prefill(self.queue, self.step_count):
            if w.start != 0 or w.length != w.req.prompt_len:
                raise RuntimeError("partial prefill work-item without "
                                   "chunked prefill")
            self._start(w.slot, w.req)
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
            logits, _, telem = lm.lm_decode(
                self.params, torch.from_numpy(toks).to(dev), self.kv.cache,
                torch.from_numpy(pos).to(dev), self.cfg,
                valid=torch.from_numpy(occ).to(dev), return_telemetry=True)
            nxt = self._sample_rows(logits, rows)
            self.step_times["decode"].append(time.perf_counter() - t0)
            self._record_telemetry(telem, len(active))
            self._stats["decode_steps"] += 1
            self._stats["slot_steps_active"] += len(active)
            self._stats["slot_steps_total"] += n
            for slot, req in active:
                self.kv.lengths[slot] = int(pos[slot]) + 1
                self._append_token(req, nxt[slot], slot)
        self.step_count += 1
        return len(active)

    def run(self, max_steps: int | None = None) -> None:
        """Drive the step loop until every submitted request completes."""
        steps = 0
        while self.queue or self.sched.active():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break

    # -- telemetry --------------------------------------------------------
    def _record_telemetry(self, telem, n_active: int) -> None:
        if telem is None:
            return
        entry = {"step": self.step_count, "active": n_active,
                 "expert_load": telem["expert_load"].cpu().numpy(),
                 "overflow": telem["overflow"].cpu().numpy(),
                 "n_moe": float(telem["n_moe"])}
        self._stats["overflow_total"] += float(entry["overflow"].sum())
        self._telemetry.append(entry)

    @property
    def telemetry(self) -> list:
        """Recent per-step MoE telemetry entries (the last
        ``telemetry_keep_last_n`` decode steps)."""
        return list(self._telemetry)

    @property
    def stats(self) -> dict:
        """Flat counters, with the reference's keys (ints where
        integral)."""
        return {k: int(v) if float(v).is_integer() else v
                for k, v in self._stats.items()}

    @property
    def slot_utilization(self) -> float:
        total = self._stats["slot_steps_total"]
        return self._stats["slot_steps_active"] / total if total else 0.0

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
