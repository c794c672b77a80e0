"""The GMM's ``rows`` (each expert's filled leading rows) against the JAX
package, in f32 on the CPU.

``rows`` lets the port's GMM kernels skip what holds no token.  On a
dispatch buffer the rows past ``rows[e]`` are zero, and act(0 · W) = 0
for relu, silu and none, so the masked product equals the reference's
``gmm`` on the whole buffer.  These tests hold that: the plain version
with ``rows`` against the Pallas kernel in interpret mode on a buffer
that the JAX dispatch built (to 1e-5, as ``test_torch_kernels.py``);
``filled_rows`` against the JAX plan's kept assignments (exactly);
``moe_apply`` with rows against the JAX ``moe_apply`` with experts left
empty (to atol 1e-5, as ``test_torch_moe.py``); ``GMMFn``'s gradients
with rows against the JAX VJP (to 1e-5).  ``test_torch_cuda.py`` holds
the CUDA kernels to the plain version on a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.core import dispatch as jdsp
from repro.core import moe as jmoe
from repro.kernels import ops as jops
from repro_torch.common.bridge import from_jax_tree
from repro_torch.core import dispatch as tdsp
from repro_torch.core import moe as tmoe
from repro_torch.core import router as trouter
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ops as tops


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# Expert 0 gets no token, expert 1 more than its capacity (full), expert
# 2 a partial buffer, expert 3 exactly its capacity; k = 2, C = 4.
E, CAP, D, F = 5, 4, 24, 40
IDX = np.array([[1, 2], [1, 3], [3, 1], [1, 4], [2, 3], [1, 3], [4, 1]],
               np.int32)


def _jax_plan(masked: bool = False, priority: bool = False):
    rs = np.random.RandomState(3)
    w = rs.rand(*IDX.shape).astype(np.float32) + 0.1
    if masked:
        w[5] = 0.0                    # a masked token takes no slot
    p = jdsp.plan(jnp.asarray(IDX), jnp.asarray(w), E, CAP,
                  priority=priority)
    return w, p


def _kept_counts(eidx, pos, cap, e):
    eidx, pos = np.asarray(eidx).reshape(-1), np.asarray(pos).reshape(-1)
    return np.bincount(eidx[pos < cap], minlength=e).astype(np.int32)


@pytest.mark.parametrize("masked,priority", [(False, False), (True, False),
                                             (False, True)])
def test_filled_rows_match_jax_plan(masked, priority):
    """The port's rows from its plan are the JAX plan's kept assignments
    per expert, and each expert's kept slots are exactly 0 .. rows-1."""
    w, jp = _jax_plan(masked, priority)
    tp = tdsp.plan(_t(IDX), _t(w), E, CAP, priority=priority)
    rows = tdsp.filled_rows(tp)
    assert rows.dtype == torch.int32 and rows.shape == (E,)
    want = _kept_counts(jp.expert_index, jp.position, CAP, E)
    np.testing.assert_array_equal(rows.numpy(), want)
    assert want[0] == 0 and want[1] == CAP and 0 < want[2] < CAP
    eidx, pos = np.asarray(jp.expert_index), np.asarray(jp.position)
    for ex in range(E):
        slots = np.sort(pos[(eidx == ex) & (pos < CAP)])
        np.testing.assert_array_equal(slots, np.arange(want[ex]))


@pytest.mark.parametrize("act", ["relu", "silu", "none"])
def test_gmm_plain_with_rows_matches_pallas_on_dispatched_buffer(act):
    """gmm_plain(buf, w, rows=r) equals the Pallas GMM on a buffer that
    the JAX dispatch built from the same plan, with experts at 0,
    partial and full rows; rows past r come out exactly 0."""
    w_gate, jp = _jax_plan()
    rs = np.random.RandomState(11)
    x = rs.randn(IDX.shape[0], D).astype(np.float32)
    w = (rs.randn(E, D, F) / np.sqrt(D)).astype(np.float32)
    buf = jdsp.dispatch(jnp.asarray(x), jp)
    want = jops.gmm(buf, jnp.asarray(w), activation=act)
    rows = _t(_kept_counts(jp.expert_index, jp.position, CAP, E))
    got = tgmm.gmm_plain(_t(buf), _t(w), act, rows=rows)
    _close(got, want)
    got_k = tgmm.gmm(_t(buf), _t(w), activation=act, rows=rows)
    np.testing.assert_array_equal(got_k.numpy(), got.numpy())
    for ex in range(E):
        assert (got[ex, int(rows[ex]):] == 0).all()


def test_gmm_rows_validation():
    x, w = torch.zeros(3, 4, 8), torch.zeros(3, 8, 5)
    with pytest.raises(ValueError, match="int32"):
        tgmm.gmm(x, w, rows=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\[3\] int32"):
        tgmm.gmm(x, w, rows=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="streaming kernel"):
        tgmm.gmm(x, w, kernel="stream")              # f32
    with pytest.raises(ValueError, match="unknown kernel"):
        tgmm.gmm(x, w, kernel="simt")
    assert tgmm.kernel_for(torch.bfloat16, tgmm.STREAM_MAX_C, False) == \
        "stream"
    assert tgmm.kernel_for(torch.bfloat16, tgmm.STREAM_MAX_C + 1, False) == \
        "tile"
    assert tgmm.kernel_for(torch.float32, 8, False) == "tile"
    assert tgmm.kernel_for(torch.bfloat16, 8, True) == "tile"


@pytest.mark.parametrize("trans", ["x", "w"])
def test_transposed_gmm_with_rows_matches_pallas_on_masked_operand(trans):
    """rows on the backward pass's layouts bounds x's stored rows: with
    trans_w (dx = dz w^T) the output rows past rows[e] are zeros, with
    trans_x (dw = x^T dz) the reduction stops there.  Both equal the
    Pallas GMM on operands whose rows past rows[e] are zeroed."""
    _, jp = _jax_plan()
    rows = _t(_kept_counts(jp.expert_index, jp.position, CAP, E))
    rs = np.random.RandomState(19)
    dz = rs.randn(E, CAP, F).astype(np.float32)      # rows past r not zero
    dz_masked = tgmm.mask_rows(_t(dz), rows).numpy()
    if trans == "w":
        w = rs.randn(E, D, F).astype(np.float32)     # stored [E, N, K]
        want = jops.gmm(jnp.asarray(dz_masked),
                        jnp.asarray(np.swapaxes(w, 1, 2).copy()))
        got = tgmm.gmm(_t(dz), _t(w), trans_w=True, rows=rows)
    else:
        x = rs.randn(E, CAP, D).astype(np.float32)   # stored [E, C, K]
        x_masked = tgmm.mask_rows(_t(x), rows).numpy()
        want = jops.gmm(jnp.asarray(np.swapaxes(x_masked, 1, 2).copy()),
                        jnp.asarray(dz))
        got = tgmm.gmm(_t(x), _t(dz), trans_x=True, rows=rows)
    _close(got, want)


@pytest.mark.parametrize("act", ["relu", "silu", "none"])
def test_gmm_fn_grads_with_rows_match_jax_vjp(act):
    """GMMFn with rows on a dispatched buffer: the output, dx and dw equal
    the JAX VJP of the reference's gmm.  The cotangent is zero past each
    expert's rows, as the combine's backward leaves it."""
    _, jp = _jax_plan()
    rs = np.random.RandomState(13)
    x = rs.randn(IDX.shape[0], D).astype(np.float32)
    w = (rs.randn(E, D, F) / np.sqrt(D)).astype(np.float32)
    buf = np.asarray(jdsp.dispatch(jnp.asarray(x), jp))
    rows = _t(_kept_counts(jp.expert_index, jp.position, CAP, E))
    g = tgmm.mask_rows(_t(rs.randn(E, CAP, F).astype(np.float32)),
                       rows).numpy()
    out, vjp = jax.vjp(lambda x_, w_: jops.gmm(x_, w_, activation=act),
                       jnp.asarray(buf), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx, tw = _t(buf).requires_grad_(True), _t(w).requires_grad_(True)
    got = tgmm.GMMFn.apply(tx, tw, act, rows)
    _close(got, out)
    dx, dw = torch.autograd.grad(got, (tx, tw), _t(g))
    _close(dx, want_dx)
    _close(dw, want_dw)


def test_expert_ffn_with_rows_matches_pallas_and_ref():
    """ops.expert_ffn (swiglu) with rows on a dispatched buffer equals the
    JAX expert FFN, and the "ref" backend masks alike."""
    from repro_torch.kernels import backend as bk_lib
    _, jp = _jax_plan()
    rs = np.random.RandomState(17)
    x = rs.randn(IDX.shape[0], D).astype(np.float32)
    p = {n: (rs.randn(*s) / np.sqrt(s[1])).astype(np.float32)
         for n, s in (("w1", (E, D, F)), ("w3", (E, D, F)),
                      ("w2", (E, F, D)))}
    buf = jdsp.dispatch(jnp.asarray(x), jp)
    want = jops.expert_ffn({k: jnp.asarray(v) for k, v in p.items()}, buf,
                           activation="swiglu")
    rows = _t(_kept_counts(jp.expert_index, jp.position, CAP, E))
    tp = {k: _t(v) for k, v in p.items()}
    got = tops.expert_ffn(tp, _t(buf), activation="swiglu", rows=rows)
    _close(got, want)
    a = tmoe.MoEArgs(n_experts=E, k=2, d_model=D, d_ff=F,
                     activation="swiglu", dtype=torch.float32,
                     kernel_backend="ref")
    ref = bk_lib.get("ref").expert_ffn(tp, _t(buf), a, rows=rows)
    _close(ref, want)


# moe_apply with rows wired in: few tokens over many experts, so some
# experts hold no token and the kernels skip them.
T_FEW, E_MANY, K_FEW, D_M, F_M = 5, 12, 2, 16, 24


def _moe_args(jax_backend, torch_backend, **kw):
    common = dict(n_experts=E_MANY, k=K_FEW, d_model=D_M, d_ff=F_M,
                  activation="swiglu", capacity_factor=1.0, **kw)
    return (jmoe.MoEArgs(dtype=jnp.float32, kernel_backend=jax_backend,
                         **common),
            tmoe.MoEArgs(dtype=torch.float32, kernel_backend=torch_backend,
                         **common))


def _moe_setup(ja, seed):
    params = jpm.materialize(jmoe.moe_defs(ja), jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["gate"]["wg"] = rs.randn(D_M, E_MANY).astype(np.float32)
    params["gate"]["wnoise"] = (0.3 * rs.randn(D_M, E_MANY)).astype(
        np.float32)
    return params, rs.randn(T_FEW, D_M).astype(np.float32)


@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("ref", "ref")])
def test_moe_apply_with_empty_experts_matches_jax(backends):
    """The router hands moe_apply the plan's rows; with experts left
    empty, the output and the gradients of x and every expert weight
    still match the JAX moe_apply."""
    ja, ta = _moe_args(*backends)
    params, x = _moe_setup(ja, seed=4)
    tp = from_jax_tree(params, device="cpu")
    dec = trouter.build(ta).route(tp, _t(x), train=False)
    assert dec.rows is not None
    np.testing.assert_array_equal(dec.rows.numpy(),
                                  tdsp.filled_rows(dec.plan).numpy())
    assert int((dec.rows == 0).sum()) > 0       # empty experts exist

    def jloss(p, x_):
        y, _ = jmoe.moe_apply(p, x_, ja, train=False)
        return jnp.sum(y * y), y
    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    leaves = {k: tp[k].requires_grad_(True) for k in ("w1", "w2", "w3")}
    tx = _t(x).requires_grad_(True)
    ty, _ = tmoe.moe_apply(tp, tx, ta, train=False)
    (ty * ty).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=0)
    _close(tx.grad, jgx)
    for k, v in leaves.items():
        _close(v.grad, jg[k])


def test_expert_choice_plan_takes_no_rows():
    """expert_choice's slots are column ranks, not a filled prefix: the
    router gives no rows, and moe_apply runs the GMMs without them."""
    _, ta = _moe_args("ref", "ref")
    ta = dataclasses.replace(ta, router=trouter.RouterSpec(
        policy="expert_choice", k=K_FEW, capacity_factor=1.0))
    ja, _ = _moe_args("ref", "ref")
    params, x = _moe_setup(ja, seed=5)
    tp = from_jax_tree(params, device="cpu")
    dec = trouter.build(ta).route(tp, _t(x), train=False)
    assert dec.rows is None
