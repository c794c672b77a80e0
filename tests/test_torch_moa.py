"""The port's Mixture-of-Attention-Heads serving path against the JAX
package, in f32 on the CPU, at ``conftest.small_config("moa-demo")``.

* ``lm_prefill`` / ``lm_decode`` logits to atol 1e-4 (as
  ``test_torch_serve.py``), the shared K/V caches likewise, and the
  MoE and MoA telemetry exactly, with and without fused decode;
* the serving engine's greedy streams, stats and telemetry against the
  JAX engine's, fused and unfused;
* a fused MoA decode layer runs the fused op twice (Q and O) and the
  routing's top-k once;
* the parameter bridge carries MoA trees both ways; ``moa_apply``
  (the training forward) matches the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_config

from repro.common import param as jpm
from repro.core import moa as jmoa
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree, to_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import moa as tmoa
from repro_torch.kernels import ops as tops
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import engine as tengine

_SHARED = ("n_layers", "d_model", "vocab_size", "n_heads", "n_kv_heads",
           "head_dim", "d_ff", "n_experts", "moe_k", "moe_d_ff",
           "moa_experts", "moa_k", "moa_heads_per_expert")


def _gates(tree, rs):
    """Random gates (zero ones tie every routing decision)."""
    for node in (tree["blocks"]["periods"]["pos0"]["moe"],
                 tree["blocks"]["periods"]["pos1"]["moa"],
                 tree["blocks"]["tail"]["pos0"]["moe"]):
        node["gate"]["wg"] = rs.randn(*node["gate"]["wg"].shape).astype(
            np.float32)


@pytest.fixture(scope="module")
def moa():
    jcfg = small_config("moa-demo")
    tcfg = tget_config("moa-demo", param_dtype=torch.float32,
                       compute_dtype=torch.float32,
                       **{k: getattr(jcfg, k) for k in _SHARED})
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    _gates(tree, np.random.RandomState(0))
    return jcfg, tcfg, tree, from_jax_tree(tree, device="cpu")


def test_moa_config_and_bridge_round_trip(moa):
    jcfg, tcfg, tree, tparams = moa
    assert [k.mixer for k in ttransformer.layer_kinds(tcfg)] == ["attn",
                                                                 "moa"]
    back = to_jax_tree(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    assert any("moa" in jax.tree_util.keystr(p) for p, _ in flat_j)
    for (path, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert tpm.param_bytes(tparams) == sum(a.nbytes for _, a in flat_j)


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_and_decode_match_jax(moa, fused):
    jcfg, tcfg, tree, tparams = moa
    jcfg = jcfg.replace(fused_decode=fused)
    tcfg = tcfg.replace(fused_decode=fused)
    b, s, max_len = 2, 16, 24
    rs = np.random.RandomState(1)
    tokens = rs.randint(1, jcfg.vocab_size, (b, s)).astype(np.int32)
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
    jd, jcache, jt = jlm.lm_decode(tree, jnp.asarray(nxt), jcache,
                                   jnp.asarray(cur), jcfg,
                                   valid=jnp.asarray(occ),
                                   return_telemetry=True)
    td, tcache, tt = tlm.lm_decode(tparams, torch.from_numpy(nxt), tcache,
                                   torch.from_numpy(cur), tcfg,
                                   valid=torch.from_numpy(occ),
                                   return_telemetry=True)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4, rtol=0)
    assert set(tt) == set(jt) >= {"moa_load", "moa_overflow", "n_moa"}
    for key in jt:
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]))
    moa_cache = tcache["periods"]["pos1"]
    jmoa_cache = jcache["periods"]["pos1"]
    for key in ("k", "v"):
        np.testing.assert_allclose(moa_cache[key].numpy(),
                                   np.asarray(jmoa_cache[key]), atol=1e-4,
                                   rtol=0)


TRACE = [(8, 6, 0), (12, 4, 0), (16, 8, 1), (8, 5, 2), (12, 7, 3),
         (16, 3, 5)]


@pytest.mark.parametrize("fused", [False, True])
def test_engine_streams_match_jax(moa, fused):
    jcfg, tcfg, tree, tparams = moa
    rs = np.random.RandomState(2)
    trace = [(rs.randint(1, jcfg.vocab_size, (n,)).astype(np.int32), m, a)
             for n, m, a in TRACE]
    kw = dict(max_len=32, n_slots=4, fused_decode=fused)
    out = []
    for eng in (jengine.ServeEngine(tree, jcfg.replace(kernel_backend="ref"),
                                    jengine.ServeConfig(**kw)),
                tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(**kw),
                                    device="cpu")):
        reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
        eng.run()
        out.append(([r.tokens for r in reqs], eng.stats, eng.telemetry))
    (jtok, jstats, jtel), (ttok, tstats, ttel) = out
    assert ttok == jtok
    assert tstats == jstats
    assert len(ttel) == len(jtel) == tstats["decode_steps"]
    for a, b in zip(ttel, jtel):
        for key in ("expert_load", "overflow", "moa_load", "moa_overflow"):
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_fused_moa_decode_is_two_fused_ops(moa, monkeypatch):
    _, tcfg, _, tparams = moa
    fused = tcfg.replace(fused_decode=True)
    assert not ttransformer._moa_args(tcfg, decode=True).fused_decode
    assert not ttransformer._moa_args(fused).fused_decode     # prefill
    a = ttransformer._moa_args(fused, decode=True)
    assert a.fused_decode
    params = ttransformer._layer(tparams["blocks"]["periods"]["pos1"]["moa"],
                                 0)
    cache = tpm.zeros(tmoa.init_cache_defs(4, 8, a, dtype=torch.float32),
                      "cpu")
    calls: dict = {}
    for name in ("fused_routed_apply", "topk_gating", "dispatch", "combine",
                 "gmm"):
        real = getattr(tops, name)

        def wrapped(*args, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kw)
        monkeypatch.setattr(tops, name, wrapped)
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 1, tcfg.d_model)
                         .astype(np.float32))
    y, _, aux = tmoa.moa_decode(params, x, cache, torch.tensor([0, 1, 2, 3]),
                                a, mask=torch.tensor([1.0, 1.0, 0.0, 1.0]))
    assert calls == {"fused_routed_apply": 2, "topk_gating": 1}
    assert y.shape == x.shape
    assert float(aux["telemetry"]["expert_load"].sum()) == 3 * a.k


def test_moa_training_is_not_ported(moa):
    """Named for the check it replaced (``moa_apply`` raised): the
    training forward of a MoA layer without gate noise, output and aux,
    against the reference's at atol 1e-5 (the gradients are
    ``test_torch_moa_train.py``'s)."""
    jcfg, tcfg, tree, tparams = moa
    jparams = jax.tree_util.tree_map(
        lambda a: a[0], tree["blocks"]["periods"]["pos1"]["moa"])
    params = ttransformer._layer(tparams["blocks"]["periods"]["pos1"]["moa"],
                                 0)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 32, tcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(32)[None], (2, 32)).astype(np.int32)
    jy, jaux = jmoa.moa_apply(jparams, jnp.asarray(x),
                              jtransformer._moa_args(jcfg),
                              positions=jnp.asarray(pos), train=True)
    ty, taux = tmoa.moa_apply(params, torch.from_numpy(x),
                              ttransformer._moa_args(tcfg),
                              positions=torch.from_numpy(pos), train=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-5)
