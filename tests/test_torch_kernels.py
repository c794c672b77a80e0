"""The port's four kernel modules against the JAX Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version (a CPU tensor never reaches a CUDA kernel), so these tests hold
the plain versions to the JAX kernels in interpret mode, on the same
numpy inputs: top-k indices exact, weights / values to 1e-6; dispatch
exact; combine to rtol 1e-6; GMM to 1e-5.  ``test_torch_cuda.py`` holds
the CUDA kernels to the plain versions on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdsp
from repro.kernels import ops as jops
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_gating as ttopk


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


# ---------------------------------------------------------------------------
# top-k gating
# ---------------------------------------------------------------------------

TOPK_CASES = [  # (T, E, k, extra, tied)
    (8, 384, 8, 1, False),      # kimi-k2 decode row shape
    (37, 16, 2, 1, False),      # ragged T
    (5, 8, 1, 0, False),
    (12, 10, 2, 1, True),       # heavy ties: lowest index must win
    (9, 33, 8, 1, True),        # E not a multiple of 32
]


def _logits(t, e, tied, seed):
    rs = np.random.RandomState(seed)
    if tied:
        return rs.randint(-2, 3, (t, e)).astype(np.float32)
    return rs.randn(t, e).astype(np.float32)


@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_plain_matches_pallas(case):
    t, e, k, extra, tied = case
    logits = _logits(t, e, tied, seed=t * 1000 + e)
    jw, jidx, jvals = jops.topk_gating_full(jnp.asarray(logits), k, extra)
    w, idx, vals = ttopk.topk_gating(_t(logits), k, k + extra)
    assert idx.dtype == torch.int32 and idx.shape == (t, k + extra)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6,
                               atol=1e-6)


def test_topk_oracle_agrees_with_plain_on_ties():
    logits = _logits(16, 12, True, seed=3)
    w, idx, _ = ttopk.topk_gating(_t(logits), 3, 3)
    rw, ridx, gates = tref.topk_gating_ref(_t(logits), 3)
    np.testing.assert_array_equal(idx.numpy(), ridx.numpy())
    np.testing.assert_allclose(w.numpy(), rw.numpy(), rtol=1e-6)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# dispatch / combine
# ---------------------------------------------------------------------------

PLAN_CASES = [  # (T, E, k, d, capacity_factor, masked)
    (13, 5, 1, 17, 0.5, False),      # ragged T / d, k = 1, drops
    (20, 4, 2, 8, 0.5, False),       # tight capacity: pos >= C drops
    (32, 8, 8, 40, 1.0, True),       # k = 8, masked rows
]


def _plan(case, seed):
    t, e, k, d, cf, masked = case
    rs = np.random.RandomState(seed)
    logits = rs.randn(t, e).astype(np.float32)
    x = rs.randn(t, d).astype(np.float32)
    vals, idx = np.asarray(-np.sort(-logits, 1)[:, :k]), \
        np.argsort(-logits, 1, kind="stable")[:, :k].astype(np.int32)
    w = np.exp(vals - vals[:, :1])
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    if masked:
        w[rs.rand(t) < 0.3] = 0.0
    cap = jdsp.capacity_for(t, e, k, cf)
    if cf < 1.0:
        cap = 2                       # force drops past capacity
    p = jdsp.plan(jnp.asarray(idx), jnp.asarray(w), e, cap)
    return (x, np.asarray(p.expert_index), np.asarray(p.position),
            np.asarray(p.weight), e, cap)


@pytest.mark.parametrize("case", [PLAN_CASES[0], PLAN_CASES[2]])
def test_dispatch_plain_matches_pallas(case):
    x, eidx, pos, _, e, cap = _plan(case, seed=case[0])
    if case[4] < 1.0 or case[5]:
        assert (pos >= cap).any()      # the drop path is exercised
    want = jops.dispatch(jnp.asarray(x), jnp.asarray(eidx), jnp.asarray(pos),
                         n_experts=e, capacity=cap)
    got = tdispatch.dispatch(_t(x), _t(eidx), _t(pos), n_experts=e,
                             capacity=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", PLAN_CASES)
def test_combine_plain_matches_pallas(case):
    x, eidx, pos, w, e, cap = _plan(case, seed=case[0] + 1)
    rs = np.random.RandomState(7)
    buf = rs.randn(e, cap, x.shape[1]).astype(np.float32)
    want = jops.combine(jnp.asarray(buf), jnp.asarray(w), jnp.asarray(eidx),
                        jnp.asarray(pos))
    got = tdispatch.combine(_t(buf), _t(w), _t(eidx), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_dispatch_scale_and_combine_roundtrip():
    """A unit-weight combine of a dispatch returns each token times the
    number of its kept assignments (the reference's dispatch VJP)."""
    from repro_torch.core import dispatch as tdsp
    rs = np.random.RandomState(5)
    t, e, k, cap = 16, 4, 2, 8
    x = rs.randn(t, 24).astype(np.float32)
    p = tdsp.plan(torch.from_numpy(rs.randint(0, e, (t, k)).astype(np.int32)),
                  torch.ones(t, k), e, cap)
    eidx, pos = p.expert_index.numpy(), p.position.numpy()
    assert (pos >= cap).any()
    buf = tdispatch.dispatch(_t(x), _t(eidx), _t(pos),
                             _t(np.full(eidx.shape, 2.0, np.float32)),
                             n_experts=e, capacity=cap)
    unit = np.ones(eidx.shape, np.float32)
    y = tdispatch.combine(buf, _t(unit), _t(eidx), _t(pos))
    kept = (pos < cap).sum(1, keepdims=True)
    np.testing.assert_allclose(y.numpy(), 2.0 * kept * x, rtol=1e-6)


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

GMM_CASES = [  # (E, C, K, N)
    (4, 8, 64, 48),
    (3, 5, 33, 17),       # ragged C / K / N
    (1, 9, 7, 130),
]


@pytest.mark.parametrize("shape", GMM_CASES)
@pytest.mark.parametrize("act", ["none", "relu", "silu"])
def test_gmm_plain_matches_pallas(shape, act):
    e, c, k, n = shape
    rs = np.random.RandomState(e * 100 + c)
    x = rs.randn(e, c, k).astype(np.float32)
    w = (rs.randn(e, k, n) / np.sqrt(k)).astype(np.float32)
    want = jops.gmm(jnp.asarray(x), jnp.asarray(w), activation=act)
    got = tgmm.gmm(_t(x), _t(w), activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tref.gmm_ref(_t(x), _t(w), activation=act)
                               .numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


def test_expert_ffn_swiglu_matches_pallas():
    rs = np.random.RandomState(0)
    e, c, d, f = 3, 8, 24, 40
    x = rs.randn(e, c, d).astype(np.float32)
    p = {n: (rs.randn(*s) / np.sqrt(s[1])).astype(np.float32)
         for n, s in (("w1", (e, d, f)), ("w3", (e, d, f)),
                      ("w2", (e, f, d)))}
    want = jops.expert_ffn({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), activation="swiglu")
    from repro_torch.kernels import ops as tops
    got = tops.expert_ffn({k: _t(v) for k, v in p.items()}, _t(x),
                          activation="swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tref.expert_ffn_ref(_t(x), _t(p["w1"]), _t(p["w2"]), _t(p["w3"]))
        .numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        tgmm.gmm(torch.zeros(2, 3, 4), torch.zeros(2, 5, 6))
    with pytest.raises(ValueError):
        tgmm.gmm(torch.zeros(1, 2, 2), torch.zeros(1, 2, 2),
                 activation="gelu")
    with pytest.raises(ValueError):
        ttopk.topk_gating(torch.zeros(4, 3), 2, 4)
    with pytest.raises(ValueError):
        tdispatch.dispatch(torch.zeros(4, 3), torch.zeros(4, 2).long(),
                           torch.zeros(4, 2, dtype=torch.int32),
                           n_experts=2, capacity=8)


def test_non_cpu_tensors_never_take_the_plain_path():
    """Only CPU tensors run the plain versions: any other device gets the
    kernel or an error (here the meta device, which has no kernel)."""
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(cuda_lib.KernelLaunchError):
        tgmm.gmm(torch.zeros(1, 2, 2, **meta), torch.zeros(1, 2, 2, **meta))
    with pytest.raises(cuda_lib.KernelLaunchError):
        ttopk.topk_gating(torch.zeros(4, 8, **meta), 2, 3)
    with pytest.raises(cuda_lib.KernelLaunchError):
        tdispatch.dispatch(torch.zeros(4, 3, **meta), torch.zeros(4, 2, **i32),
                           torch.zeros(4, 2, **i32), n_experts=2, capacity=8)
    with pytest.raises(cuda_lib.KernelLaunchError):
        tdispatch.combine(torch.zeros(2, 8, 3, **meta),
                          torch.zeros(4, 2, device="meta"),
                          torch.zeros(4, 2, **i32), torch.zeros(4, 2, **i32))


def test_launch_counts_untouched_by_cpu_path():
    cuda_lib.reset_launch_counts()
    tgmm.gmm(torch.zeros(1, 2, 2), torch.zeros(1, 2, 2))
    assert cuda_lib.launch_counts() == {}


# ---------------------------------------------------------------------------
# the backward passes: each autograd Function against the JAX custom VJP
# (jax.vjp of repro.kernels.ops, Pallas in interpret mode), rtol=atol=1e-5
# ---------------------------------------------------------------------------

def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_dvals", [True, False])
@pytest.mark.parametrize("case", [(24, 16, 4, 1), (9, 33, 2, 1),
                                  (7, 8, 1, 0)])
def test_topk_grads_match_jax_vjp(case, with_dvals):
    import jax
    t, e, k, extra = case
    kk = k + extra
    rs = np.random.RandomState(t + e)
    logits = rs.randn(t, e).astype(np.float32)
    dw = rs.randn(t, k).astype(np.float32)
    dvals = (rs.randn(t, kk) if with_dvals else np.zeros((t, kk))).astype(
        np.float32)
    _, vjp = jax.vjp(lambda l: (lambda w, _, v: (w, v))(
        *jops.topk_gating_full(l, k, extra)), jnp.asarray(logits))
    (want,) = vjp((jnp.asarray(dw), jnp.asarray(dvals)))
    tl = _t(logits).requires_grad_(True)
    w, idx, vals = ttopk.TopKGatingFn.apply(tl, k, kk)
    assert not idx.requires_grad
    outs, cts = [w], [_t(dw)]
    if with_dvals:
        outs.append(vals)
        cts.append(_t(dvals))
    (got,) = torch.autograd.grad(outs, tl, cts)
    _close(got, want)


REGIMES = [None, 2]          # resident, and a forced two-expert slab


@pytest.mark.parametrize("e_block", REGIMES)
@pytest.mark.parametrize("case", [PLAN_CASES[0], PLAN_CASES[2]])
def test_dispatch_combine_grads_match_jax_vjp(case, e_block):
    import jax
    x, eidx, pos, w, e, cap = _plan(case, seed=case[0] + 2)
    rs = np.random.RandomState(11)
    g_buf = rs.randn(e, cap, x.shape[1]).astype(np.float32)
    buf = rs.randn(e, cap, x.shape[1]).astype(np.float32)
    dy = rs.randn(x.shape[0], x.shape[1]).astype(np.float32)
    je, jp = jnp.asarray(eidx), jnp.asarray(pos)
    _, vjp = jax.vjp(lambda x_: jops.dispatch(
        x_, je, jp, n_experts=e, capacity=cap, e_block=e_block),
        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g_buf))
    _, vjp = jax.vjp(lambda b_, w_: jops.combine(b_, w_, je, jp,
                                                 e_block=e_block),
                     jnp.asarray(buf), jnp.asarray(w))
    want_dbuf, want_dw = vjp(jnp.asarray(dy))

    tx = _t(x).requires_grad_(True)
    out = tdispatch.DispatchFn.apply(tx, _t(eidx), _t(pos), e, cap, e_block)
    (dx,) = torch.autograd.grad(out, tx, _t(g_buf))
    _close(dx, want_dx)
    tb, tw = _t(buf).requires_grad_(True), _t(w).requires_grad_(True)
    y = tdispatch.CombineFn.apply(tb, tw, _t(eidx), _t(pos), torch.float32,
                                  e_block)
    dbuf, dw = torch.autograd.grad(y, (tb, tw), _t(dy))
    _close(dbuf, want_dbuf)
    _close(dw, want_dw)


@pytest.mark.parametrize("shape", GMM_CASES)
@pytest.mark.parametrize("act", ["none", "relu", "silu"])
def test_gmm_grads_match_jax_vjp(shape, act):
    import jax
    e, c, k, n = shape
    rs = np.random.RandomState(e * 10 + n)
    x = rs.randn(e, c, k).astype(np.float32)
    w = (rs.randn(e, k, n) / np.sqrt(k)).astype(np.float32)
    g = rs.randn(e, c, n).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_: jops.gmm(x_, w_, activation=act),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    out = tgmm.GMMFn.apply(tx, tw, act)
    dx, dw = torch.autograd.grad(out, (tx, tw), _t(g))
    _close(dx, want_dx)
    _close(dw, want_dw)


@pytest.mark.parametrize("trans", [(True, False), (False, True),
                                   (True, True)])
def test_gmm_transposed_layouts_match_pallas(trans):
    """The layout flags read an operand transposed in place: the same
    product as the Pallas kernel on explicitly swapped operands.  Both
    operands transposed at once is no layout of the backward pass, and
    raises."""
    tx_, tw_ = trans
    rs = np.random.RandomState(3)
    e, c, k, n = 3, 5, 33, 17
    x = rs.randn(e, c, k).astype(np.float32)
    w = rs.randn(e, k, n).astype(np.float32)
    xs = np.swapaxes(x, 1, 2).copy() if tx_ else x
    ws = np.swapaxes(w, 1, 2).copy() if tw_ else w
    if tx_ and tw_:
        with pytest.raises(ValueError, match="at most one operand"):
            tgmm.gmm(_t(xs), _t(ws), trans_x=True, trans_w=True)
        return
    want = jops.gmm(jnp.asarray(x), jnp.asarray(w))
    got = tgmm.gmm(_t(xs), _t(ws), trans_x=tx_, trans_w=tw_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tgmm.gmm(_t(x), _t(w), trans_w=True)


# ---------------------------------------------------------------------------
# the expert-blocked kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

EBLOCK_CASES = [  # (plan case, e_block)
    (PLAN_CASES[0], 2),          # E = 5: ragged last slab
    (PLAN_CASES[1], 1),
    (PLAN_CASES[2], 4),          # k = 8, masked rows
]


@pytest.mark.parametrize("case,e_block", EBLOCK_CASES)
def test_eblock_plain_versions_match_pallas(case, e_block):
    x, eidx, pos, w, e, cap = _plan(case, seed=case[0] + 3)
    je, jp = jnp.asarray(eidx), jnp.asarray(pos)
    want = jops.dispatch(jnp.asarray(x), je, jp, n_experts=e, capacity=cap,
                         e_block=e_block)
    got = tdispatch.dispatch_eblock(_t(x), _t(eidx), _t(pos), n_experts=e,
                                    capacity=cap, e_block=e_block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # bit-equal to the resident regime, as on the card
    assert torch.equal(got, tdispatch.dispatch(_t(x), _t(eidx), _t(pos),
                                               n_experts=e, capacity=cap))
    buf = np.random.RandomState(4).randn(e, cap, x.shape[1]).astype(
        np.float32)
    want = jops.combine(jnp.asarray(buf), jnp.asarray(w), je, jp,
                        e_block=e_block)
    got = tdispatch.combine_eblock(_t(buf), _t(w), _t(eidx), _t(pos),
                                   e_block=e_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_bucket_table_inverts_the_plan():
    x, eidx, pos, w, e, cap = _plan(PLAN_CASES[2], seed=9)
    btok, bscale = tdispatch.bucket_assignments(_t(eidx), _t(pos), _t(w), e,
                                                cap)
    kept = pos < cap
    assert int((btok >= 0).sum()) == int(kept.sum())
    tok = np.repeat(np.arange(eidx.shape[0]), eidx.shape[1]).reshape(
        eidx.shape)
    for t_, j in zip(*np.nonzero(kept)):
        slot = eidx[t_, j] * cap + pos[t_, j]
        assert int(btok[slot]) == tok[t_, j]
        assert float(bscale[slot]) == w[t_, j]


def test_new_wrappers_never_take_the_plain_path_off_cpu():
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(cuda_lib.KernelLaunchError):
        ttopk.topk_gating_bwd(torch.zeros(4, 2, **meta),
                              torch.zeros(4, 3, **i32),
                              torch.zeros(4, 2, **meta),
                              torch.zeros(4, 3, **meta), 8)
    with pytest.raises(cuda_lib.KernelLaunchError):
        tdispatch.dispatch_eblock(torch.zeros(4, 3, **meta),
                                  torch.zeros(4, 2, **i32),
                                  torch.zeros(4, 2, **i32), n_experts=2,
                                  capacity=8, e_block=1)
    with pytest.raises(cuda_lib.KernelLaunchError):
        tdispatch.combine_eblock(torch.zeros(2, 8, 3, **meta),
                                 torch.zeros(4, 2, **meta),
                                 torch.zeros(4, 2, **i32),
                                 torch.zeros(4, 2, **i32), e_block=1)
    with pytest.raises(cuda_lib.KernelLaunchError):
        tgmm.gmm(torch.zeros(1, 2, 3, **meta), torch.zeros(1, 4, 3, **meta),
                 trans_w=True)
