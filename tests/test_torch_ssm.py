"""The port's Mamba-1 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), in f32 on the CPU.

Both get the same parameters: a JAX ``pm.materialize`` tree of
``mamba_defs`` (d 16, d_state 4, d_conv 4, expand 2) whose constant
leaves (``dt_bias``, ``a_log``, ``d_skip``, ``conv_b``) are redrawn
with numpy so that every term carries information, moved across with
``from_jax_tree``; inputs are numpy draws from a seed.

* ``mamba_defs``: shapes, dtypes and inits;
* ``_conv1d`` with and without a state, ``_ssm_inputs``;
* ``mamba`` with chunks of 8 over S = 32 (the Hillis–Steele scan inside
  a chunk, the state carried across four), its final state, and every
  parameter's and the input's gradient against ``jax.grad``;
* ``mamba_decode`` from a random state;
* the port's scan against its own step-by-step decode and the
  prefill-to-decode handoff (the reference's ``tests/test_models.py``
  checks), and prompts of 1 to 3 tokens handed to decode against the
  reference's whole-sequence ``mamba`` (where the reference's own conv
  state is short: ROADMAP C.4);
* the chunk-divisibility ``ValueError``.

Tolerances: outputs and states within 1e-5 of the reference's scale
(``atol = 1e-5 * max(1, max |ref|)``); gradients within 1e-4 normwise
(``||g - g_ref|| / ||g_ref||``), since JAX's associative scan and the
port's Hillis–Steele scan combine the chunk's products in different
orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.models import ssm as jssm
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.models import ssm as tssm

D, N, D_CONV, EXPAND = 16, 4, 4, 2
D_IN = EXPAND * D
B, S = 2, 32


def _close(got, want, what=""):
    want = np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                               err_msg=what)


def _norm_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= 1e-4, f"{what}: normwise rel err {err}"


def _tree(seed=0):
    """A JAX mamba_defs tree (numpy leaves), constants redrawn."""
    defs = jssm.mamba_defs(D, d_state=N, d_conv=D_CONV, expand=EXPAND,
                           dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jpm.materialize(defs, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    tree["dt_bias"] = (0.5 * rs.randn(D_IN)).astype(np.float32)
    tree["a_log"] = rs.uniform(-1.0, 1.5, (D_IN, N)).astype(np.float32)
    tree["d_skip"] = rs.randn(D_IN).astype(np.float32)
    tree["conv_b"] = (0.1 * rs.randn(D_IN)).astype(np.float32)
    return tree


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _x(shape, seed=1, scale=0.5):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _state(seed=3):
    rs = np.random.RandomState(seed)
    return {"ssm": rs.randn(B, D_IN, N).astype(np.float32),
            "conv": rs.randn(B, D_CONV - 1, D_IN).astype(np.float32)}


def test_mamba_defs_match_jax():
    from repro_torch.common.param import ParamDef
    got = tssm.mamba_defs(D, d_state=N, d_conv=D_CONV, expand=EXPAND,
                          dtype=torch.bfloat16)
    want = jssm.mamba_defs(D, d_state=N, d_conv=D_CONV, expand=EXPAND,
                           dtype=jnp.bfloat16)
    assert sorted(got) == sorted(want)
    dt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    for k, d in want.items():
        g: ParamDef = got[k]
        assert (g.shape, g.axes, g.init, g.fan_in) == (
            d.shape, d.axes, d.init, d.fan_in), k
        assert jnp.dtype(dt[g.dtype]) == jnp.dtype(d.dtype), k
    assert tssm._dt_rank(4096) == jssm._dt_rank(4096) == 256
    sdefs = tssm.init_state_defs(B, D, d_state=N, d_conv=D_CONV,
                                 expand=EXPAND, dtype=torch.bfloat16)
    jdefs = jssm.init_state_defs(B, D, d_state=N, d_conv=D_CONV,
                                 expand=EXPAND, dtype=jnp.bfloat16)
    for k in ("ssm", "conv"):
        assert (sdefs[k].shape, sdefs[k].axes) == (jdefs[k].shape,
                                                   jdefs[k].axes)
    assert sdefs["ssm"].dtype == torch.float32
    assert sdefs["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_jax(with_state):
    tree = _tree()
    x = _x((B, 7, D_IN))
    state = _state()["conv"] if with_state else None
    jy, jst = jssm._conv1d(_jparams(tree), jnp.asarray(x),
                           None if state is None else jnp.asarray(state))
    ty, tst = tssm._conv1d(from_jax_tree(tree, device="cpu"),
                           torch.from_numpy(x),
                           None if state is None else torch.from_numpy(state))
    _close(ty.numpy(), jy, "conv out")
    assert tuple(tst.shape) == (B, D_CONV - 1, D_IN)
    _close(tst.numpy(), jst, "conv state")


def test_ssm_inputs_match_jax():
    tree = _tree()
    u = _x((B, 8, D_IN), scale=1.0)
    want = jssm._ssm_inputs(_jparams(tree), jnp.asarray(u), N)
    got = tssm._ssm_inputs(from_jax_tree(tree, device="cpu"),
                           torch.from_numpy(u), N)
    for name, g, w in zip(("dA", "dBx", "C"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g.numpy(), w, name)


def test_mamba_forward_state_and_grads_match_jax():
    """Chunks of 8 over S = 32: output, final scan and conv state, and
    the gradients of every parameter and of the input for a random
    cotangent."""
    tree = _tree()
    x = _x((B, S, D))
    dy = _x((B, S, D), seed=2, scale=1.0)
    jy, jst = jssm.mamba(_jparams(tree), jnp.asarray(x), d_state=N, chunk=8,
                         return_state=True)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba(p, xx, d_state=N, chunk=8) * dy)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(_jparams(tree), jnp.asarray(x))
    tp = from_jax_tree(tree, device="cpu")
    for leaf in tpm.tree_leaves(tp):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, tst = tssm.mamba(tp, tx, d_state=N, chunk=8, return_state=True)
    _close(ty.detach().numpy(), jy, "mamba out")
    _close(tst["ssm"].detach().numpy(), jst["ssm"], "ssm state")
    _close(tst["conv"].detach().numpy(), jst["conv"], "conv state")
    (ty * torch.from_numpy(dy)).sum().backward()
    for k in sorted(tree):
        assert tp[k].grad is not None, k
        _norm_close(tp[k].grad.numpy(), jg[k], k)
    _norm_close(tx.grad.numpy(), jgx, "dx")


def test_mamba_decode_matches_jax():
    tree = _tree()
    x = _x((B, 1, D))
    state = _state()
    jy, jst = jssm.mamba_decode(_jparams(tree), jnp.asarray(x),
                                jax.tree_util.tree_map(jnp.asarray, state),
                                d_state=N)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    ty, tst = tssm.mamba_decode(from_jax_tree(tree, device="cpu"),
                                torch.from_numpy(x), tstate, d_state=N)
    _close(ty.numpy(), jy, "decode out")
    for k in ("ssm", "conv"):
        _close(tst[k].numpy(), jst[k], k)
    # the state handed in is read, not written
    np.testing.assert_array_equal(tstate["ssm"].numpy(), state["ssm"])


def test_scan_matches_step_by_step_decode():
    """The chunked scan equals the one-step recurrence from a zero state
    (the reference's ``test_mamba_scan_matches_sequential``), here to
    1e-5 of the output's scale."""
    tp = from_jax_tree(_tree(), device="cpu")
    x = torch.from_numpy(_x((B, S, D)))
    with torch.no_grad():
        y_scan = tssm.mamba(tp, x, d_state=N, chunk=8)
        state = tpm.zeros(tssm.init_state_defs(B, D, d_state=N, d_conv=D_CONV,
                                               expand=EXPAND), "cpu")
        ys = []
        for i in range(S):
            y, state = tssm.mamba_decode(tp, x[:, i:i + 1], state, d_state=N)
            ys.append(y)
    _close(torch.cat(ys, dim=1).numpy(), y_scan.numpy(), "scan vs decode")


@pytest.mark.parametrize("prompt", [1, 2, 3, 24])
def test_prefill_handoff_matches_whole_sequence(prompt):
    """A prompt prefilled with ``return_state``, then decoded token by
    token: every decode output against the reference's ``mamba`` over
    the whole sequence.  For prompts shorter than d_conv - 1 = 3 tokens
    the reference's own handoff state is short (``u_raw[:,
    -(d_conv-1):]``, ROADMAP C.4); the port's conv state keeps the
    zero padding rows."""
    tree = _tree()
    tp = from_jax_tree(tree, device="cpu")
    total = 32
    x = _x((B, total, D))
    want = jssm.mamba(_jparams(tree), jnp.asarray(x), d_state=N, chunk=total)
    with torch.no_grad():
        tx = torch.from_numpy(x)
        y, state = tssm.mamba(tp, tx[:, :prompt], d_state=N,
                              return_state=True)
        _close(y.numpy(), np.asarray(want)[:, :prompt], "prefill")
        assert tuple(state["conv"].shape) == (B, D_CONV - 1, D_IN)
        for i in range(prompt, total):
            y, state = tssm.mamba_decode(tp, tx[:, i:i + 1], state,
                                         d_state=N)
            _close(y.numpy(), np.asarray(want)[:, i:i + 1], f"step {i}")
    _, jst = jssm.mamba(_jparams(tree), jnp.asarray(x[:, :prompt]),
                        d_state=N, return_state=True)
    assert jst["conv"].shape[1] == min(prompt, D_CONV - 1)


def test_chunk_divisibility_raises():
    tp = from_jax_tree(_tree(), device="cpu")
    with pytest.raises(ValueError, match="scan chunk"):
        tssm.mamba(tp, torch.zeros(1, 5 * 2 + 1, D), d_state=N, chunk=2)
    with pytest.raises(ValueError, match="scan chunk"):
        tssm.mamba(tp, torch.zeros(1, 200, D), d_state=N)
    assert tuple(tssm.mamba(tp, torch.zeros(1, 100, D),
                            d_state=N).shape) == (1, 100, D)
