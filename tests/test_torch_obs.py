"""The port's observability (``repro_torch.obs`` and its hooks) against
the JAX package's ``repro.obs`` and the JAX serve engine, on the CPU.

* ``obs.trace``: event schema, nesting and the ambient ``use()`` stack
  event for event against ``repro.obs.trace`` (times and ids aside); a
  save / load round trip with numpy and torch attrs.
* ``obs.metrics``: both registries fed the same operations (seeded
  histogram samples, labelled families) give equal ``snapshot()``s.
* ``obs.replay``: ``CostModel.fit`` coefficients, ``synthetic_requests``
  and ``replay`` (decisions, stats, histograms, predicted wall) equal to
  the reference's, exactly.
* The engine, on the reference test's staggered shared-prefix traffic
  (kimi-k2 family, 2 layers, d_model 32, chunks of 16, the prefix cache
  on): greedy streams bitwise equal with tracing on and off; the
  ``(name, args)`` sequence of ``serve.*`` events, the metrics snapshot
  and the decision log equal to the JAX engine's (the reference's
  ``kernel.*`` spans are jit-trace time, so they are left out); the
  kernel backend's spans nested in the engine's; the fidelity contract:
  the port's own synced trace -> ``CostModel`` -> ``replay`` gives the
  engine's decisions and its recorded wall within 10 %.
* A traced ``Trainer`` against an untraced one (metrics and parameters
  bitwise), and both launchers with ``--trace``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import OPT, _cfgs, _dc, _params

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.obs import metrics as jmetrics
from repro.obs import replay as jreplay
from repro.obs import trace as jtrace
from repro.serve import engine as jengine
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.data import pipeline as tdata
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import paper_lm as tpl
from repro_torch.models import transformer as ttransformer
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import replay as treplay
from repro_torch.obs import trace as ttrace
from repro_torch.optim import optimizers as topt
from repro_torch.serve import engine as tengine
from repro_torch.train import trainer as ttrain

SMALL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             vocab_size=64, n_experts=4, moe_k=2, moe_d_ff=32,
             capacity_factor=2.0, q_block=16, kv_block=16)
# The reference test's engine settings (tests/test_obs.py).
SERVE_KW = dict(max_len=64, n_slots=4, prefill_chunk=16, prefill_budget=32,
                admission="aware", prefix_cache=True)
# The ops the replay charges (serve.step would count its children twice).
CHARGED = {"serve.schedule", "serve.prefix_probe", "serve.prefix_hit",
           "serve.retire", "serve.prefill", "serve.prefill_chunk",
           "serve.kv_insert", "serve.sample", "serve.decode"}
COUNTERS = ("prefills", "decode_steps", "generated_tokens",
            "slot_steps_active", "slot_steps_total", "prefill_chunks",
            "prefill_tokens", "prefill_calls", "prefix_hits",
            "prefix_hit_tokens")


def _timeless(events):
    """Events without their clock and process / thread ids."""
    drop = {"ts", "dur", "pid", "tid"}
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def _decisions(log):
    return [dataclasses.astuple(d) for d in log]


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def _record(trace_lib):
    """The same spans, counters and instants through one package's
    tracer and ambient stack; returns (tracer, what current() saw)."""
    tr = trace_lib.Tracer()
    seen = [trace_lib.current() is trace_lib.NULL]
    with trace_lib.use(tr):
        seen.append(trace_lib.current() is tr)
        with tr.span("outer", kind="test"):
            with trace_lib.current().span("inner", n=3, shape=(2, 4)):
                tr.counter("serve.queue", depth=4)
            tr.instant("evicted", page=7)
        inner = trace_lib.Tracer()
        with trace_lib.use(inner):
            seen.append(trace_lib.current() is inner)
        seen.append(trace_lib.current() is tr)
    with pytest.raises(RuntimeError):
        with trace_lib.use(tr):
            raise RuntimeError("boom")
    seen.append(trace_lib.current() is trace_lib.NULL)
    return tr, seen


def test_tracer_schema_nesting_and_stack_match_reference():
    tr, seen = _record(ttrace)
    jtr, jseen = _record(jtrace)
    assert seen == jseen == [True] * 5
    assert _timeless(tr.events) == _timeless(jtr.events)
    cnt, inner, inst, outer = tr.events      # spans land on exit
    assert [e["ph"] for e in tr.events] == ["C", "X", "i", "X"]
    for ev in (inner, outer):
        assert set(ev) >= {"name", "ph", "ts", "dur", "pid", "tid", "args"}
        assert ev["dur"] >= 0 and ev["pid"] == os.getpid()
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-9
    assert ttrace.NULL.span("a") is ttrace.NULL.span("b", n=1)
    assert ttrace.NULL.events == [] and ttrace.NULL.enabled is False
    with pytest.raises(ValueError):
        ttrace.NULL.save()


def test_save_load_roundtrip_coerces_numpy_and_torch(tmp_path):
    path = str(tmp_path / "t.json")
    tr = ttrace.Tracer(path, process_name="unit")
    with tr.span("op", n=np.int64(5), f=np.float32(0.5), arr=np.arange(2),
                 t0=torch.tensor(7), tf=torch.tensor(0.25),
                 t1=torch.arange(3), shape=torch.Size([2, 3])):
        pass
    with pytest.raises(ValueError, match="path"):
        ttrace.Tracer().save()
    assert tr.save() == path and not os.path.exists(path + ".tmp")
    events = ttrace.load(path)
    assert events[0] == {"name": "process_name", "ph": "M",
                         "pid": os.getpid(), "tid": 0,
                         "args": {"name": "unit"}}
    (ev,) = [e for e in events if e["ph"] == "X"]
    assert ev["args"] == {"n": 5, "f": 0.5, "arr": [0, 1], "t0": 7,
                          "tf": 0.25, "t1": [0, 1, 2], "shape": [2, 3]}
    assert isinstance(ev["args"]["t0"], int)
    with open(path) as f:
        assert json.load(f)["displayTimeUnit"] == "ms"
    bare = str(tmp_path / "bare.json")
    with open(bare, "w") as f:
        json.dump(events, f)
    assert ttrace.load(bare) == events == jtrace.load(path)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _feed(metrics_lib):
    """One sequence of operations on a registry of ``metrics_lib``."""
    reg = metrics_lib.MetricsRegistry()
    rs = np.random.RandomState(0)
    reg.counter("requests").inc(6)
    reg.counter("requests").inc(0.5)
    g = reg.gauge("frac")
    g.set(4)
    g.dec(0.75)
    g.inc()
    wide = reg.histogram("latency_s")
    for v in np.exp(rs.uniform(-12, 8, 3000)):
        wide.observe(v)
    narrow = reg.histogram("active", buckets=(1, 2, 4, 8))
    for v in rs.randint(0, 12, 500):
        narrow.observe(int(v))
    reg.histogram("empty")
    load = reg.counter("expert_load", labels=("expert",))
    for e, n in enumerate(rs.randint(0, 9, 16).tolist()):
        load.child(expert=e % 5).inc(float(n))
    per_layer = reg.histogram("overflow", labels=("layer", "kind"))
    for i, v in enumerate(rs.uniform(0, 20, 40)):
        per_layer.child(layer=i % 3, kind="moe").observe(v)
    errors = []
    for bad in (lambda: reg.gauge("requests"),
                lambda: reg.counter("requests", labels=("expert",)),
                lambda: reg.get("nope"),
                lambda: reg.counter("requests").inc(-1),
                lambda: load.child(layer=0),
                lambda: wide.percentile(101),
                lambda: metrics_lib.Histogram("h", buckets=(2.0, 1.0))):
        with pytest.raises(metrics_lib.MetricError) as err:
            bad()
        errors.append(str(err.value))
    return reg, errors


def test_metrics_registry_snapshots_match_reference():
    reg, errors = _feed(tmetrics)
    jreg, jerrors = _feed(jmetrics)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.stats() == jreg.stats() == {"requests": 6.5, "frac": 4.25}
    assert errors == jerrors
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    h, jh = reg.get("latency_s"), jreg.get("latency_s")
    for p in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert h.percentile(p) == jh.percentile(p)
    reg2 = tmetrics.MetricsRegistry()
    reg2.counter("n").inc(6)
    assert type(reg2.stats()["n"]) is int


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _synth_events():
    rs = np.random.RandomState(5)
    out = []
    for name, attr, a, b in (("serve.decode", "active", 2.0, 5.0),
                             ("serve.prefill_chunk", "tokens", 0.3, 40.0),
                             ("serve.sample", "rows", 0.7, 3.0),
                             ("serve.retire", "unused", 0.0, 3.0)):
        for _ in range(23):
            x = int(rs.randint(1, 64))
            out.append({"name": name, "ph": "X", "ts": 0.0,
                        "dur": float(a * x + b + rs.uniform(-1, 1)),
                        "args": {attr: x}})
    # one x value only: a constant fit; a counter event is skipped
    out += [{"name": "serve.prefill", "ph": "X", "ts": 0.0, "dur": d,
             "args": {"tokens": 32}} for d in (10.0, 12.0, 17.0)]
    out.append({"name": "serve.queue", "ph": "C", "ts": 0.0,
                "args": {"depth": 3}})
    return out


def test_cost_model_fit_matches_reference():
    events = _synth_events()
    model = treplay.CostModel.fit(events)
    jmodel = jreplay.CostModel.fit(events)
    assert model.to_dict() == jmodel.to_dict()
    assert set(model.ops) == {"serve.decode", "serve.prefill_chunk",
                              "serve.sample", "serve.retire",
                              "serve.prefill"}
    assert model.ops["serve.prefill"].a == 0.0
    assert model.ops["serve.decode"].n == 23
    for op in ("serve.decode", "serve.sample", "never.seen"):
        for x in (1, 7, 64):
            assert model.cost(op, x) == jmodel.cost(op, x)
    rt = treplay.CostModel.from_dict(model.to_dict())
    assert rt.ops == model.ops


REPLAY_CASES = {
    "chunked_prefix_aware": dict(
        requests=dict(prompt_lens=(8, 48), new_tokens=(2, 6),
                      arrival_every=0.5, shared_prefix=16, seed=4),
        cfg=dict(n_slots=4, admission="aware", prefill_chunk=16,
                 prefill_budget=32, prefix_cache=True, max_len=64,
                 page_bytes=3, prefix_cache_bytes=60)),
    "whole_fcfs": dict(
        requests=dict(prompt_lens=(4, 40), new_tokens=(1, 8),
                      arrival_every=0.8, seed=2),
        cfg=dict(n_slots=3, admission="fcfs", max_len=64)),
}


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_replay_matches_reference(case):
    spec = REPLAY_CASES[case]
    reqs = treplay.synthetic_requests(500, **spec["requests"])
    jreqs = jreplay.synthetic_requests(500, **spec["requests"])
    assert all(np.array_equal(p, jp) and (m, a) == (jm, ja)
               for (p, m, a), (jp, jm, ja) in zip(reqs, jreqs))
    table = treplay.CostModel.fit(_synth_events()).to_dict()
    res = treplay.replay(reqs, treplay.ReplayConfig(**spec["cfg"]),
                         treplay.CostModel.from_dict(table))
    jres = jreplay.replay(jreqs, jreplay.ReplayConfig(**spec["cfg"]),
                          jreplay.CostModel.from_dict(table))
    assert _decisions(res.decisions) == _decisions(jres.decisions)
    assert res.stats == jres.stats
    assert res.steps == jres.steps
    assert res.predicted_wall_s == jres.predicted_wall_s > 0
    assert res.metrics.snapshot() == jres.metrics.snapshot()
    assert res.metrics.get("request_latency_steps").count == 500
    if spec["cfg"].get("prefix_cache"):
        assert res.stats["prefix_hits"] > 0


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("kimi-k2-1t-a32b").replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32,
        kernel_backend="ref", **SMALL)
    tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.float32,
                       compute_dtype=torch.float32, **SMALL)
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    moe = tree["blocks"]["periods"]["pos0"]["moe"]
    moe["gate"]["wg"] = rs.randn(*moe["gate"]["wg"].shape).astype(np.float32)
    return jcfg, tcfg, tree, from_jax_tree(tree, device="cpu")


def _staggered_trace(vocab, n=6):
    """The reference test's traffic: a shared 32-token prefix; request 0
    retires and seeds the trie before the rest arrive."""
    rs = np.random.RandomState(3)
    shared = rs.randint(1, vocab, (32,)).astype(np.int32)
    return [(np.concatenate([shared,
                             rs.randint(1, vocab, (8,)).astype(np.int32)]),
             4, 0 if i == 0 else 12 + i) for i in range(n)]


def _serve(engine, trace):
    reqs = [engine.submit(p, m, arrival=a) for p, m, a in trace]
    engine.run()
    assert all(r.done for r in reqs)
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def served(models, tmp_path_factory):
    """One JAX and two port engine runs of the staggered traffic: the
    JAX engine and one port engine traced with decision logs, one port
    engine untraced."""
    jcfg, tcfg, tree, tparams = models
    trace = _staggered_trace(jcfg.vocab_size)
    tmp = tmp_path_factory.mktemp("obs")
    out = {"trace": trace}
    jeng = jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(
        **SERVE_KW, trace_path=str(tmp / "jax.json"), log_decisions=True))
    out["jax"] = (_serve(jeng, trace), jeng)
    teng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
        **SERVE_KW, trace_path=str(tmp / "port.json"), log_decisions=True),
        device="cpu")
    out["port"] = (_serve(teng, trace), teng)
    plain = tengine.ServeEngine(tparams, tcfg,
                                tengine.ServeConfig(**SERVE_KW), device="cpu")
    out["untraced"] = (_serve(plain, trace), plain)
    return out


def test_tracing_is_observation(served):
    streams, eng = served["port"]
    assert streams == served["untraced"][0] == served["jax"][0]
    assert eng.stats == served["untraced"][1].stats
    assert served["untraced"][1].tracer is ttrace.NULL
    assert served["untraced"][1].sched.decision_log is None
    events = ttrace.load(eng.tracer.path)           # run() saved it
    assert len(events) == len(eng.tracer.events) + 1
    chunk = next(e for e in events if e["name"] == "serve.prefill_chunk")
    assert chunk["args"]["tokens"] == chunk["args"]["Gp"] * chunk["args"]["C"]
    assert all(e["dur"] >= 0 for e in events if e["ph"] == "X")


def test_serve_events_match_jax_engine(served):
    def serve_events(eng):
        return [(e["name"], e["ph"], e["args"]) for e in
                ttrace.load(eng.tracer.path)
                if e["name"].startswith("serve.")]
    got, want = serve_events(served["port"][1]), serve_events(
        served["jax"][1])
    assert got == want
    assert {n for n, _, _ in got} >= {
        "serve.step", "serve.schedule", "serve.prefill_chunk",
        "serve.decode", "serve.sample", "serve.kv_insert", "serve.retire",
        "serve.prefix_probe", "serve.prefix_hit", "serve.queue",
        "serve.slots"}


def test_metrics_snapshot_matches_jax_engine(served):
    eng, jeng = served["port"][1], served["jax"][1]
    snap = eng.metrics.snapshot()
    assert snap == jeng.metrics.snapshot()
    assert eng.stats == jeng.stats
    assert snap["decode_overflow_per_step"]["count"] == \
        eng.stats["decode_steps"]
    load = np.sum([t["expert_load"] for t in eng.telemetry], axis=0)
    fam = eng.metrics.get("decode_expert_load").children()
    assert [fam[(e,)].value for e in range(len(load))] == load.tolist()
    assert eng.slot_utilization == jeng.slot_utilization


def test_decision_log_matches_jax_engine(served):
    log = served["port"][1].sched.decision_log
    assert log and _decisions(log) == _decisions(
        served["jax"][1].sched.decision_log)
    assert any(d.prefix_hits for d in log)


def test_kernel_spans_nest_in_serve_spans(served):
    """The port's kernel spans record every eager call (the reference's,
    a jit trace once): one dispatch, expert FFN and combine a MoE layer
    and model call, each inside its prefill or decode span."""
    eng = served["port"][1]
    events = [e for e in ttrace.load(eng.tracer.path) if e["ph"] == "X"]
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    outer = [e for e in events
             if e["name"] in ("serve.prefill_chunk", "serve.decode")]
    for name in ("kernel.dispatch", "kernel.gmm", "kernel.combine"):
        spans = [e for e in events if e["name"] == name]
        assert len(spans) == SMALL["n_layers"] * calls
        assert {e["args"]["backend"] for e in spans} == {"cuda"}
        for e in spans:
            assert any(o["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= o["ts"] + o["dur"] + 1e-6 for o in outer)


@pytest.mark.parametrize("backend,fused", [("cuda", False), ("ref", False),
                                           ("cuda", True)])
def test_kernel_spans_by_backend(models, backend, fused):
    _, tcfg, _, tparams = models
    cfg = tcfg.replace(kernel_backend=backend, fused_decode=fused)
    cache = tpm.zeros(ttransformer.cache_defs(cfg, 3, 16), "cpu")
    tr = ttrace.Tracer()
    with ttrace.use(tr):
        tlm.lm_decode(tparams, torch.tensor([3, 5, 7]), cache,
                      torch.tensor([0, 2, 4]), cfg,
                      valid=torch.tensor([1.0, 1.0, 0.0]))
    names = [e["name"] for e in tr.events]
    if fused and backend == "cuda":
        want = ["kernel.decode_step"] * 2
    else:
        want = ["kernel.dispatch", "kernel.gmm", "kernel.combine"] * 2
    assert names == want
    assert all(e["args"]["backend"] == backend for e in tr.events)
    tokens = [e["args"]["tokens"] for e in tr.events if "tokens" in e["args"]]
    assert tokens == [3] * len(tokens)


def test_replay_reproduces_the_port_engine(models, tmp_path):
    """The fidelity contract on the port: a synced trace of the engine
    fits a cost model; replaying the traffic through it gives the
    engine's decisions and counters, and predicts the recorded time of
    the ops it charges within 10 %; a zero-cost replay decides the
    same."""
    _, tcfg, _, tparams = models
    trace = _staggered_trace(tcfg.vocab_size, n=8)
    path = str(tmp_path / "fit.json")
    eng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
        **SERVE_KW, trace_path=path, log_decisions=True, trace_sync=True),
        device="cpu")
    assert eng._trace_sync is False            # no device to wait for
    _serve(eng, trace)                         # warm-up pass
    eng.reset()
    eng.tracer.clear()
    _serve(eng, trace)
    real = tuple(eng.sched.decision_log)
    model = treplay.CostModel.fit_trace(path)
    cfg = treplay.ReplayConfig(n_slots=4, admission="aware",
                               prefill_chunk=16, prefill_budget=32,
                               prefix_cache=True, max_len=64,
                               page_bytes=eng.kv.page_bytes)
    res = treplay.replay(trace, cfg, model)
    assert real and tuple(res.decisions) == real
    for key in COUNTERS:
        assert res.stats[key] == eng.stats[key], key
    recorded = sum(e["dur"] for e in ttrace.load(path)
                   if e["ph"] == "X" and e["name"] in CHARGED) / 1e6
    assert recorded > 0
    assert abs(res.predicted_wall_s - recorded) / recorded < 0.10
    zero = treplay.replay(trace, cfg, None)
    assert tuple(zero.decisions) == real and zero.predicted_wall_s == 0.0


# ---------------------------------------------------------------------------
# the trainer and the launchers
# ---------------------------------------------------------------------------

def _trainer(workdir, params, trace_path=None):
    _, tcfg = _cfgs()
    return ttrain.Trainer(
        loss_fn=lambda p, b, g: tpl.paper_lm_loss(p, b, tcfg, generator=g),
        params=from_jax_tree(params, device="cpu"),
        oc=topt.OptConfig(**OPT),
        loop=ttrain.TrainLoopConfig(total_steps=4, checkpoint_every=2,
                                    log_every=1),
        data_iter=tdata.DataIterator(tdata.DataConfig(**_dc()),
                                     device="cpu"),
        workdir=str(workdir), trace_path=trace_path, device="cpu")


def test_traced_trainer_is_bitwise_the_untraced(tmp_path):
    params = _params(_cfgs()[0])
    path = str(tmp_path / "train.json")
    traced = _trainer(tmp_path / "a", params, trace_path=path)
    plain = _trainer(tmp_path / "b", params)
    traced.run()
    plain.run()
    assert plain.tracer is ttrace.NULL

    def untimed(log):
        return [{k: v for k, v in m.items() if k != "step_time_s"}
                for m in log]
    assert untimed(traced.metrics_log) == untimed(plain.metrics_log)
    for a, b in zip(tpm.tree_leaves(traced.state),
                    tpm.tree_leaves(plain.state)):
        assert torch.equal(a, b)
    events = ttrace.load(path)
    assert events[0]["args"] == {"name": "train"}
    spans = [e for e in events if e["ph"] == "X"]
    count = {n: sum(e["name"] == n for e in spans)
             for n in ("train.data", "train.step", "train.checkpoint")}
    assert count == {"train.data": 4, "train.step": 4,
                     "train.checkpoint": 2}
    steps = [e for e in spans if e["name"] == "train.step"]
    assert [e["args"] for e in steps] == [
        {"step": s, "microbatches": 1} for s in range(4)]
    kernels = [e for e in spans if e["name"].startswith("kernel.")]
    assert {e["name"] for e in kernels} == {
        "kernel.dispatch", "kernel.gmm", "kernel.combine"}
    for e in kernels:
        assert any(s["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= s["ts"] + s["dur"] + 1e-6 for s in steps)


def test_serve_launcher_traces_and_logs_decisions(tmp_path, capsys):
    path = str(tmp_path / "serve.json")
    tserve.main(["--arch", "kimi-k2-1t-a32b", "--reduce", "--device", "cpu",
                 "--requests", "3", "--prompt-len", "8", "--new-tokens",
                 "3", "--stagger", "1", "--trace", path, "--trace-sync",
                 "--log-decisions"])
    out = capsys.readouterr().out
    events = ttrace.load(path)
    assert f"[serve] trace written: {path} ({len(events) - 1} events" in out
    assert "[serve] decision log: 3 scheduling steps recorded" in out
    names = {e["name"] for e in events}
    assert {"serve.step", "serve.prefill", "serve.decode",
            "kernel.dispatch"} <= names


def test_train_launcher_traces(tmp_path, capsys):
    path = str(tmp_path / "train.json")
    final = tlaunch.main(["--arch", "kimi-k2-1t-a32b", "--reduce", "--device",
                          "cpu", "--batch", "2", "--seq", "32", "--steps",
                          "2", "--checkpoint-every", "1", "--workdir",
                          str(tmp_path / "w"), "--trace", path])
    assert final["step"] == 2
    events = ttrace.load(path)
    assert f"[train] trace written: {path} ({len(events) - 1} events" in \
        capsys.readouterr().out
    steps = [e for e in events if e["name"] == "train.step"]
    assert len(steps) == 2
    assert sum(e["name"] == "train.checkpoint" for e in events) == 2
