"""The port's serving path against the JAX package, in f32 on the CPU.

* ``lm_prefill`` / ``lm_decode`` logits to atol 1e-4 (bucketed prefill
  with a padding mask, decode at per-row positions with a dead slot);
* the port's ``ServeEngine`` against the JAX ``ServeEngine`` (ref
  backend) on a staggered, mixed-length trace with oversubscribed slots:
  greedy token streams and ``stats`` equal, continuous and static;
  with ``trace_path`` and ``log_decisions``, a loadable trace and the
  JAX engine's decision log;
* ``repro_torch`` and ``chip_smoke.py`` import neither jax nor repro.

Both packages get the same parameters: a JAX ``pm.materialize`` tree with
random gate weights (zero gates would tie every routing decision), moved
across with ``from_jax_tree``.  The port runs its ``"cuda"`` backend,
whose wrappers take their plain versions on CPU tensors.
"""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.obs import trace as trace_lib
from repro_torch.serve import engine as tengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             vocab_size=64, n_experts=4, moe_k=2, moe_d_ff=32,
             capacity_factor=2.0)
# (prompt length, new tokens, arrival step): mixed lengths, staggered.
TRACE = [(8, 6, 0), (12, 4, 0), (16, 8, 1), (8, 5, 2), (12, 7, 3),
         (16, 3, 5)]


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("kimi-k2-1t-a32b").replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32, q_block=16,
        kv_block=16, **SMALL)
    tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.float32,
                       compute_dtype=torch.float32, **SMALL)
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    moe = tree["blocks"]["periods"]["pos0"]["moe"]
    moe["gate"]["wg"] = rs.randn(*moe["gate"]["wg"].shape).astype(np.float32)
    return jcfg, tcfg, tree, from_jax_tree(tree, device="cpu")


def test_prefill_and_decode_logits_match_jax(models):
    jcfg, tcfg, tree, tparams = models
    b, s, max_len = 2, 16, 24
    rs = np.random.RandomState(1)
    tokens = rs.randint(1, 64, (b, s)).astype(np.int32)
    valid = np.ones((b, s), np.float32)
    valid[1, 11:] = 0.0                       # row 1: bucket-padded tail
    last = np.array([s - 1, 10], np.int32)
    jcache = jpm.materialize(jtransformer.cache_defs(jcfg, b, max_len),
                             jax.random.PRNGKey(0))
    jl, jcache = jlm.lm_prefill(tree, {"tokens": jnp.asarray(tokens)},
                                jcache, jcfg, last_index=jnp.asarray(last),
                                valid=jnp.asarray(valid))
    tcache = tpm.zeros(ttransformer.cache_defs(tcfg, b, max_len), "cpu")
    tl, tcache = tlm.lm_prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                                tcache, tcfg, last_index=torch.from_numpy(last),
                                valid=torch.from_numpy(valid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)

    nxt = np.array([5, 9], np.int32)
    cur = np.array([s, 11], np.int32)
    occ = np.array([1.0, 0.0], np.float32)    # row 1 is a dead slot
    jd, _, jt = jlm.lm_decode(tree, jnp.asarray(nxt), jcache,
                              jnp.asarray(cur), jcfg, valid=jnp.asarray(occ),
                              return_telemetry=True)
    td, _, tt = tlm.lm_decode(tparams, torch.from_numpy(nxt), tcache,
                              torch.from_numpy(cur), tcfg,
                              valid=torch.from_numpy(occ),
                              return_telemetry=True)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4, rtol=0)
    for key in ("expert_load", "overflow", "n_moe"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]))


@pytest.mark.parametrize("q_offset,kv_len", [(0, 13), (4, None)])
def test_causal_attention_matches_blockwise(q_offset, kv_len):
    """GQA (4 query heads over 2 kv heads), causal, kv_len and offset
    masking, against the reference's ``blockwise_attention``."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rs = np.random.RandomState(q_offset)
    q = rs.randn(2, 16, 4, 8).astype(np.float32)
    k = rs.randn(2, 16 + q_offset, 2, 8).astype(np.float32)
    v = rs.randn(2, 16 + q_offset, 2, 8).astype(np.float32)
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_block=8,
        kv_block=4, q_offset=q_offset,
        kv_len=None if kv_len is None else jnp.int32(kv_len))
    got = tattn.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), kv_len=kv_len,
                                 q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_moe_plus_dense_prefill_matches_jax():
    """The ``moe+dense`` FFN (a parallel dense swiglu MLP beside the MoE,
    arctic-style) on the kimi family shape."""
    extra = dict(d_ff=48, dense_residual=True)
    jcfg = jget_config("kimi-k2-1t-a32b").replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32, q_block=16,
        kv_block=16, **SMALL, **extra)
    tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.float32,
                       compute_dtype=torch.float32, **SMALL, **extra)
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(2)))
    tokens = np.random.RandomState(2).randint(1, 64, (1, 8)).astype(np.int32)
    jl, _ = jlm.lm_prefill(tree, {"tokens": jnp.asarray(tokens)},
                           jpm.materialize(jtransformer.cache_defs(jcfg, 1, 8),
                                           jax.random.PRNGKey(0)), jcfg)
    tl, _ = tlm.lm_prefill(from_jax_tree(tree, device="cpu"),
                           {"tokens": torch.from_numpy(tokens)},
                           tpm.zeros(ttransformer.cache_defs(tcfg, 1, 8),
                                     "cpu"), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def _trace(vocab):
    rs = np.random.RandomState(1)
    return [(rs.randint(1, vocab, (plen,)).astype(np.int32), mnt, arr)
            for plen, mnt, arr in TRACE]


def _serve(engine, trace):
    reqs = [engine.submit(p, m, arrival=a) for p, m, a in trace]
    engine.run()
    return [r.tokens for r in reqs], engine.stats


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_streams_and_stats_match_jax(models, policy):
    jcfg, tcfg, tree, tparams = models
    trace = _trace(jcfg.vocab_size)
    kw = dict(max_len=32, n_slots=4, policy=policy)
    jeng = jengine.ServeEngine(tree, jcfg.replace(kernel_backend="ref"),
                               jengine.ServeConfig(**kw))
    teng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(**kw),
                               device="cpu")
    jtok, jstats = _serve(jeng, trace)
    ttok, tstats = _serve(teng, trace)
    assert ttok == jtok
    assert tstats == jstats
    assert tstats["prefills"] == len(TRACE)
    tload = np.sum([t["expert_load"] for t in teng.telemetry], axis=0)
    jload = np.sum([t["expert_load"] for t in jeng.telemetry], axis=0)
    np.testing.assert_array_equal(tload, jload)


def test_temperature_streams_do_not_depend_on_batching(models):
    """Each request samples from its own (seed, request, position)
    generator: the same trace gives the same streams on 1 or 4 slots."""
    _, tcfg, _, tparams = models
    trace = _trace(tcfg.vocab_size)[:2]
    streams = []
    for n_slots in (1, 2):
        eng = tengine.ServeEngine(
            tparams, tcfg, tengine.ServeConfig(max_len=32, n_slots=n_slots,
                                               temperature=1.0, seed=3),
            device="cpu")
        streams.append(_serve(eng, trace)[0])
    assert streams[0] == streams[1]
    assert len({tuple(t) for t in streams[0]}) == 2


def test_engine_refuses_unported_options(models, tmp_path):
    """Once refused, now ported: ``trace_path`` gives a loadable chrome
    trace of the reference's span names and ``log_decisions`` a decision
    log equal to the JAX engine's, on whole-prompt traffic."""
    jcfg, tcfg, tree, tparams = models
    trace = _trace(jcfg.vocab_size)
    kw = dict(max_len=32, n_slots=4, log_decisions=True)
    path = str(tmp_path / "serve.json")
    jeng = jengine.ServeEngine(tree, jcfg.replace(kernel_backend="ref"),
                               jengine.ServeConfig(**kw))
    teng = tengine.ServeEngine(
        tparams, tcfg, tengine.ServeConfig(trace_path=path, **kw),
        device="cpu")
    assert _serve(teng, trace) == _serve(jeng, trace)
    got, want = teng.sched.decision_log, jeng.sched.decision_log
    assert len(got) >= 4
    assert [dataclasses.astuple(d) for d in got] == \
        [dataclasses.astuple(d) for d in want]
    names = {e["name"] for e in trace_lib.load(path)}
    assert {"serve.step", "serve.schedule", "serve.prefill",
            "serve.kv_insert", "serve.decode", "serve.sample",
            "serve.retire", "serve.queue", "kernel.dispatch"} <= names


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_serve_launcher_runs_on_cpu_and_refuses_missing_cuda(capsys,
                                                             monkeypatch):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", "kimi-k2-1t-a32b", "--reduce", "--device", "cpu",
                 "--requests", "3", "--stagger", "1", "--prompt-len", "8",
                 "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "3 requests x 3 tokens" in out and "backend=cuda" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "kimi-k2-1t-a32b", "--reduce"])
