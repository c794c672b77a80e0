"""The port's fused decode path against the JAX package, in f32 on the CPU.

* kernel 7 (``decode_step``, plain version on CPU tensors) against the
  JAX Pallas ``decode_step`` in interpret mode and against both
  packages' ``fused_decode_ref`` oracles: y within 1e-6, load and
  overflow exact, masked rows exactly 0 (relu and swiglu, dead slots,
  capacity 1, tied logits);
* kernel 8 (``routed_apply``) against the JAX ``routed_apply`` in both
  modes, over token-major and assignment-major plans, within 1e-6;
* the ``batchwise`` / ``threshold`` / ``expert_choice`` policies against
  the JAX policies (plans exact, weights and losses within 1e-6);
* ``moe_apply(train=False)`` with ``fused_decode`` under all five
  routing variants against the JAX ``moe_apply`` (Pallas backend, fused)
  and against the port's unfused path: y within 1e-5, telemetry exact;
* a fused MoE layer calls the fused op once and no other kernel op;
* the serving engine with ``fused_decode`` against the JAX engine's.

Inputs are drawn with numpy and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.core import dispatch as jdsp
from repro.core import moa as jmoa
from repro.core import moe as jmoe
from repro.core import router as jrouter
from repro.kernels import fused_decode as jfd
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import moe as tmoe
from repro_torch.core import router as trouter
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import fused_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serve import engine as tengine


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _np(t):
    return t.detach().numpy()


VALID = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)


def _problem(t=8, d=16, e=6, f=24, gated=False, tied=False, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(t, d).astype(np.float32)
    wg = (0.5 * rs.randn(d, e)).astype(np.float32)
    if tied:                    # experts 1 and 4 always tie: 1 must win
        wg[:, 4] = wg[:, 1]
    w1 = (0.1 * rs.randn(e, d, f)).astype(np.float32)
    w2 = (0.1 * rs.randn(e, f, d)).astype(np.float32)
    w3 = (0.1 * rs.randn(e, d, f)).astype(np.float32) if gated else None
    return x, wg, w1, w2, w3


# (activation, k, capacity, masked, tied[, tokens, experts]): the last
# cases put more than 8 filled cells on an expert (40 tokens x k over 4
# experts), as the card's kernel tiles them.
DECODE_CASES = [("relu", 2, 8, True, False), ("swiglu", 2, 8, True, False),
                ("swiglu", 3, 1, False, False),     # capacity 1: overflow
                ("relu", 2, 1, True, False),
                ("relu", 2, 8, False, True), ("swiglu", 1, 8, True, True),
                ("swiglu", 2, 17, True, False, 40, 4),
                ("relu", 3, 17, False, False, 40, 4),
                ("swiglu", 2, 24, False, False, 40, 4)]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_step_plain_matches_pallas_and_oracles(case):
    act, k, cap, masked, tied, *size = case
    t, e = size or (8, 6)
    x, wg, w1, w2, w3 = _problem(t=t, e=e, gated=act == "swiglu", tied=tied,
                                 seed=len(act) + 10 * k + cap)
    valid = np.resize(VALID, t) if masked else np.ones(t, np.float32)
    jy, jl, jo = jfd.decode_step(
        jnp.asarray(x), jnp.asarray(valid), jnp.asarray(wg), jnp.asarray(w1),
        jnp.asarray(w2), None if w3 is None else jnp.asarray(w3), k=k,
        capacity=cap, activation=act)
    w3t = None if w3 is None else _t(w3)
    y, load, over = tfd.decode_step(_t(x), _t(valid), _t(wg), _t(w1), _t(w2),
                                    w3t, k=k, capacity=cap, activation=act)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(load), np.asarray(jl))
    np.testing.assert_array_equal(_np(over), np.asarray(jo))
    assert (_np(y)[valid == 0] == 0.0).all()
    assert int(load.sum()) == int(valid.sum()) * k
    if cap == 1:
        assert float(over.sum()) > 0
    for ry, rl, ro in (
            jref.fused_decode_ref(jnp.asarray(x), jnp.asarray(wg),
                                  jnp.asarray(w1), jnp.asarray(w2),
                                  None if w3 is None else jnp.asarray(w3),
                                  jnp.asarray(valid), k=k, capacity=cap),
            tref.fused_decode_ref(_t(x), _t(wg), _t(w1), _t(w2), w3t,
                                  _t(valid), k=k, capacity=cap)):
        np.testing.assert_allclose(_np(y), np.asarray(ry), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(_np(load), np.asarray(rl))
        np.testing.assert_array_equal(_np(over), np.asarray(ro))


def test_decode_step_tied_logits_pick_the_lower_index():
    x, wg, w1, w2, _ = _problem(tied=True, seed=3)
    flat_e, _, _, _, _ = tfd.route_plain(_t(x), torch.ones(8), _t(wg), 2, 8)
    idx = flat_e.reshape(8, 2).numpy()
    assert (idx == 1).any()
    for row in idx.tolist():
        # Expert 4 always ties with 1: it is picked only after 1.
        assert 4 not in row or (1 in row and row.index(1) < row.index(4))


def test_decode_step_validates_arguments():
    x, wg, w1, w2, _ = _problem()
    args = (_t(x), torch.ones(8), _t(wg), _t(w1), _t(w2))
    with pytest.raises(ValueError, match="1 <= k <= E"):
        tfd.decode_step(*args, k=0, capacity=8)
    with pytest.raises(ValueError, match="1 <= k <= E"):
        tfd.decode_step(*args, k=7, capacity=8)
    with pytest.raises(ValueError, match="needs w3"):
        tfd.decode_step(*args, k=2, capacity=8, activation="swiglu")
    with pytest.raises(ValueError, match="activation"):
        tfd.decode_step(*args, k=2, capacity=8, activation="gelu")
    with pytest.raises(ValueError, match="capacity"):
        tfd.decode_step(*args, k=2, capacity=0)


def test_fused_wrappers_never_take_the_plain_path_off_cpu():
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(cuda_lib.KernelLaunchError):
        tfd.decode_step(torch.zeros(4, 8, **meta), torch.ones(4, **meta),
                        torch.zeros(8, 3, **meta), torch.zeros(3, 8, 5, **meta),
                        torch.zeros(3, 5, 8, **meta), k=2, capacity=8)
    with pytest.raises(cuda_lib.KernelLaunchError):
        tfd.routed_apply(torch.zeros(4, 8, **meta), torch.zeros(4, 2, **i32),
                         torch.zeros(4, 2, **i32), torch.zeros(4, 2, **i32),
                         torch.zeros(4, 2, **i32), torch.zeros(4, 2, **meta),
                         torch.zeros(3, 8, 5, **meta), n_experts=3,
                         capacity=8, mode="proj")
    cuda_lib.reset_launch_counts()
    x, wg, w1, w2, _ = _problem()
    tfd.decode_step(_t(x), torch.ones(8), _t(wg), _t(w1), _t(w2), k=2,
                    capacity=8)
    assert cuda_lib.launch_counts() == {}


def test_fused_ops_are_inference_only():
    x, wg, w1, w2, _ = _problem()
    w1t = _t(w1).requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        tops.fused_decode_step(_t(x), torch.ones(8), _t(wg), w1t, _t(w2),
                               k=2, capacity=8)
    with torch.no_grad():
        y, _, _ = tops.fused_decode_step(_t(x), torch.ones(8), _t(wg), w1t,
                                         _t(w2), k=2, capacity=8)
    assert y.grad_fn is None


# ---------------------------------------------------------------------------
# kernel 8: plan-mode fusion
# ---------------------------------------------------------------------------

def _plans(t=16, e=5, k=2, cap=4, seed=5):
    rs = np.random.RandomState(seed)
    eidx = np.argsort(-rs.randn(t, e), 1, kind="stable")[:, :k].astype(
        np.int32)
    w = rs.rand(t, k).astype(np.float32)
    w[rs.rand(t) < 0.2] = 0.0                       # masked tokens
    jp = jdsp.plan(jnp.asarray(eidx), jnp.asarray(w), e, cap)
    assert bool((np.asarray(jp.position) >= cap).any())     # drops
    return jp


def _tplan(p):
    from repro_torch.core import dispatch as tdsp
    return tdsp.DispatchPlan(
        expert_index=_t(p.expert_index), position=_t(p.position),
        weight=_t(p.weight), n_experts=p.n_experts, capacity=p.capacity,
        fraction_dropped=_t(p.fraction_dropped))


# (mode, activation, view[, tokens, capacity]): view "token" runs (plan,
# plan); "assign" runs MoA's (plan, assignment-major plan) for the Q
# projection and the reverse for the O projection.  The last cases fill
# more than 8 cells an expert (80 tokens x 2 over 5 experts, C = 20).
ROUTED_CASES = [("ffn", "relu", "token"), ("ffn", "swiglu", "token"),
                ("proj", "relu", "token"), ("proj", "relu", "q"),
                ("proj", "relu", "o"), ("ffn", "swiglu", "token", 80, 20),
                ("proj", "relu", "q", 80, 20), ("proj", "relu", "o", 80, 20)]


@pytest.mark.parametrize("case", ROUTED_CASES)
def test_routed_apply_plain_matches_pallas(case):
    mode, act, view, *size = case
    t, cap = size or (16, 4)
    e, k, d = 5, 2, 12
    jp = _plans(t, e, k, cap)
    ja = jmoa.assignment_plan(jp)
    p_in, p_out = {"token": (jp, jp), "q": (jp, ja), "o": (ja, jp)}[view]
    rs = np.random.RandomState(7)
    x = rs.randn(p_in.expert_index.shape[0], d).astype(np.float32)
    if mode == "ffn":
        f = 20
        ws = [(0.1 * rs.randn(*s)).astype(np.float32)
              for s in ((e, d, f), (e, f, d), (e, d, f))]
        if act == "relu":
            ws[2] = None
    else:
        ws = [(0.1 * rs.randn(e, d, 9)).astype(np.float32), None, None]
    want = jfd.routed_apply(
        jnp.asarray(x), p_in.expert_index, p_in.position,
        p_out.expert_index, p_out.position, p_out.weight,
        *[None if w is None else jnp.asarray(w) for w in ws],
        n_experts=e, capacity=cap, mode=mode, activation=act)
    got = tops.fused_routed_apply(_t(x), _tplan(p_in), _tplan(p_out),
                                  *[None if w is None else _t(w)
                                    for w in ws],
                                  mode=mode, activation=act)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the Appendix-F and expert-choice policies
# ---------------------------------------------------------------------------

T, E, K, D, F = 24, 6, 2, 16, 24


def _policy_setup(policy, seed=0, **kw):
    spec = dict(policy=policy, capacity_factor=1.0, **kw)
    common = dict(n_experts=E, k=K, d_model=D, d_ff=F, activation="swiglu")
    ja = jmoe.MoEArgs(dtype=jnp.float32, kernel_backend="pallas",
                      router=jrouter.RouterSpec(**spec), **common)
    ta = tmoe.MoEArgs(dtype=torch.float32, kernel_backend="cuda",
                      router=trouter.RouterSpec(**spec), **common)
    params = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jmoe.moe_defs(ja),
                                    jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    params["gate"]["wg"] = rs.randn(D, E).astype(np.float32)
    if "thresholds" in params:
        params["thresholds"]["t"] = (0.1 + 0.2 * rs.rand(E)).astype(
            np.float32)
    x = rs.randn(T, D).astype(np.float32)
    mask = (rs.rand(T) > 0.3).astype(np.float32)
    return ja, ta, params, x, mask


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("policy", ["batchwise", "threshold",
                                    "expert_choice"])
def test_policies_match_jax(policy, train):
    ja, ta, params, x, mask = _policy_setup(policy)
    jdec = jrouter.build(ja).route(params, jnp.asarray(x), train=train,
                                   mask=jnp.asarray(mask))
    tdec = trouter.build(ta).route(from_jax_tree(params, device="cpu"),
                                   _t(x), train=train, mask=_t(mask))
    np.testing.assert_array_equal(_np(tdec.plan.expert_index),
                                  np.asarray(jdec.plan.expert_index))
    np.testing.assert_array_equal(_np(tdec.plan.position),
                                  np.asarray(jdec.plan.position))
    assert tdec.plan.capacity == jdec.plan.capacity
    np.testing.assert_allclose(_np(tdec.plan.weight),
                               np.asarray(jdec.plan.weight), atol=1e-6)
    np.testing.assert_allclose(_np(tdec.gates), np.asarray(jdec.gates),
                               atol=1e-6)
    np.testing.assert_array_equal(_np(tdec.load), np.asarray(jdec.load))
    np.testing.assert_allclose(float(tdec.aux_loss), float(jdec.aux_loss),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tdec.plan.fraction_dropped),
                               float(jdec.plan.fraction_dropped), atol=1e-6)
    for key in ("expert_load", "overflow"):
        np.testing.assert_array_equal(_np(tdec.telemetry[key]),
                                      np.asarray(jdec.telemetry[key]))


def test_threshold_loss_matches_jax():
    from repro.core import gating as jgating
    from repro_torch.core import gating as tgating
    _, _, params, x, _ = _policy_setup("threshold", seed=1)
    want = jgating.batchwise_threshold_loss(params["gate"],
                                            params["thresholds"],
                                            jnp.asarray(x), K)
    tp = from_jax_tree(params, device="cpu")
    got = tgating.batchwise_threshold_loss(tp["gate"], tp["thresholds"],
                                           _t(x), K)
    assert float(want) != 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# moe_apply with fused decode
# ---------------------------------------------------------------------------

FUSED_VARIANTS = [("noisy_topk", False), ("noisy_topk", True),
                  ("expert_choice", False), ("batchwise", False),
                  ("threshold", False)]


@pytest.mark.parametrize("variant", FUSED_VARIANTS)
def test_moe_apply_fused_decode_matches_jax_and_unfused(variant):
    policy, priority = variant
    ja, ta, params, x, mask = _policy_setup(
        policy, seed=2, priority_dispatch=priority)
    ja = dataclasses.replace(ja, fused_decode=True)
    ta = dataclasses.replace(ta, fused_decode=True)
    tp = from_jax_tree(params, device="cpu")
    jy, jaux = jmoe.moe_apply(params, jnp.asarray(x), ja, train=False,
                              mask=jnp.asarray(mask))
    ty, taux = tmoe.moe_apply(tp, _t(x), ta, train=False, mask=_t(mask))
    uy, uaux = tmoe.moe_apply(tp, _t(x),
                              dataclasses.replace(ta, fused_decode=False),
                              train=False, mask=_t(mask))
    for want, want_aux in ((np.asarray(jy), jaux), (_np(uy), uaux)):
        np.testing.assert_allclose(_np(ty), want, rtol=0, atol=1e-5)
        for key in ("expert_load", "overflow"):
            np.testing.assert_array_equal(
                _np(taux["telemetry"][key]),
                np.asarray(want_aux["telemetry"][key]))
    assert float(taux["aux_loss"]) == 0.0


def test_fused_decode_ignored_under_train():
    _, ta, params, x, mask = _policy_setup("noisy_topk", seed=3)
    tp = from_jax_tree(params, device="cpu")
    y0, aux0 = tmoe.moe_apply(tp, _t(x), ta, train=True, mask=_t(mask))
    y1, aux1 = tmoe.moe_apply(tp, _t(x),
                              dataclasses.replace(ta, fused_decode=True),
                              train=True, mask=_t(mask))
    assert torch.equal(y0, y1) and torch.equal(aux0["aux_loss"],
                                               aux1["aux_loss"])


def _counting(monkeypatch):
    """Count calls of the backend's kernel ops (the CPU path launches
    nothing, so the launch counters cannot show it)."""
    calls: dict = {}
    for name in ("fused_decode_step", "fused_routed_apply", "topk_gating",
                 "dispatch", "combine", "gmm"):
        real = getattr(tops, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(tops, name, wrapped)
    return calls


@pytest.mark.parametrize("policy,op", [("noisy_topk", "fused_decode_step"),
                                       ("expert_choice",
                                        "fused_routed_apply")])
def test_fused_moe_layer_is_one_op(monkeypatch, policy, op):
    _, ta, params, x, mask = _policy_setup(policy, seed=4)
    tp = from_jax_tree(params, device="cpu")
    calls = _counting(monkeypatch)
    tmoe.moe_apply(tp, _t(x), dataclasses.replace(ta, fused_decode=True),
                   train=False, mask=_t(mask))
    assert calls == {op: 1}
    calls.clear()
    tmoe.moe_apply(tp, _t(x), ta, train=False, mask=_t(mask))
    assert calls["dispatch"] == calls["combine"] == 1 and calls["gmm"] == 3
    assert op not in calls


# ---------------------------------------------------------------------------
# the serving engine with fused decode
# ---------------------------------------------------------------------------

SMALL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             vocab_size=64, n_experts=4, moe_k=2, moe_d_ff=32,
             capacity_factor=2.0)
TRACE = [(8, 6, 0), (12, 4, 0), (16, 8, 1), (8, 5, 2), (12, 7, 3),
         (16, 3, 5)]


@pytest.fixture(scope="module")
def kimi():
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


def _trace(vocab):
    rs = np.random.RandomState(1)
    return [(rs.randint(1, vocab, (plen,)).astype(np.int32), mnt, arr)
            for plen, mnt, arr in TRACE]


def serve_both(jcfg, tcfg, tree, tparams, trace, **kw):
    """Serve ``trace`` on the JAX engine (ref backend) and the port's;
    returns ((tokens, stats, telemetry) of JAX, of the port)."""
    out = []
    for eng in (jengine.ServeEngine(tree, jcfg.replace(kernel_backend="ref"),
                                    jengine.ServeConfig(**kw)),
                tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(**kw),
                                    device="cpu")):
        reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
        eng.run()
        out.append(([r.tokens for r in reqs], eng.stats, eng.telemetry))
    return out


@pytest.mark.parametrize("policy", ["noisy_topk", "expert_choice"])
def test_fused_engine_matches_jax(kimi, policy):
    jcfg, tcfg, tree, tparams = kimi
    if policy != "noisy_topk":
        jcfg = jcfg.replace(router=jrouter.RouterSpec(
            policy=policy, capacity_factor=2.0))
        tcfg = tcfg.replace(router=trouter.RouterSpec(
            policy=policy, capacity_factor=2.0))
    (jtok, jstats, jtel), (ttok, tstats, ttel) = serve_both(
        jcfg, tcfg, tree, tparams, _trace(jcfg.vocab_size), max_len=32,
        n_slots=4, fused_decode=True)
    assert ttok == jtok
    assert tstats == jstats
    assert len(ttel) == len(jtel) == tstats["decode_steps"]
    for a, b in zip(ttel, jtel):
        for key in ("expert_load", "overflow"):
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_fused_flag_reaches_decode_calls_only(kimi, monkeypatch):
    """``cfg.fused_decode`` fuses the decode step's MoE layers (one op
    per layer) and leaves prefill on the unfused kernels."""
    from repro_torch.common import param as tpm
    from repro_torch.models import lm as tlm
    from repro_torch.models import transformer as ttransformer
    _, tcfg, _, tparams = kimi
    cfg = tcfg.replace(fused_decode=True)
    calls = _counting(monkeypatch)
    cache = tpm.zeros(ttransformer.cache_defs(cfg, 2, 12), "cpu")
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        1, cfg.vocab_size, (2, 8)).astype(np.int32))
    tlm.lm_prefill(tparams, {"tokens": tokens}, cache, cfg)
    assert "fused_decode_step" not in calls and calls["dispatch"] == 2
    calls.clear()
    tlm.lm_decode(tparams, tokens[:, 0], cache, torch.tensor([8, 8]), cfg)
    assert calls == {"fused_decode_step": cfg.n_layers}
