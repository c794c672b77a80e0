"""The port's MoE layer (routing, dispatch, expert FFN, combine) against
the JAX package's ``moe_apply``, in f32 on the CPU.

Both packages get the same parameters (a JAX ``pm.materialize`` tree with
random gate weights, moved across with ``from_jax_tree``) and the same
inputs.  The port's ``"cuda"`` backend runs its kernels' plain versions
here (CPU tensors) and is held to the JAX ``"pallas"`` backend (Pallas
kernels in interpret mode); the port's ``"ref"`` backend is held to the
JAX ``"ref"`` backend.  Output to atol 1e-5; routing indices, slot
positions, load and telemetry exactly; losses and metrics to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.core import moe as jmoe
from repro.core import router as jrouter
from repro_torch.common.bridge import from_jax_tree
from repro_torch.core import moe as tmoe
from repro_torch.core import router as trouter
from repro_torch.kernels.backend import KernelBackendError

T, E, K, D, F = 24, 6, 2, 16, 24


def _args(jax_backend, torch_backend, **kw):
    common = dict(n_experts=E, k=K, d_model=D, d_ff=F, activation="swiglu",
                  capacity_factor=kw.pop("capacity_factor", 1.0), **kw)
    return (jmoe.MoEArgs(dtype=jnp.float32, kernel_backend=jax_backend,
                         **common),
            tmoe.MoEArgs(dtype=torch.float32, kernel_backend=torch_backend,
                         **common))


def _setup(ja, seed=0):
    params = jpm.materialize(jmoe.moe_defs(ja), jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    # Zero-initialized gates (Appendix A) tie every logit; random gates
    # make the routing decision carry information.
    params["gate"]["wg"] = rs.randn(D, E).astype(np.float32)
    params["gate"]["wnoise"] = (0.3 * rs.randn(D, E)).astype(np.float32)
    x = rs.randn(T, D).astype(np.float32)
    mask = (rs.rand(T) > 0.3).astype(np.float32)
    return params, x, mask


PAIRS = [("pallas", "cuda"), ("ref", "ref")]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("backends", PAIRS)
def test_moe_apply_eval_matches_jax(backends, masked):
    ja, ta = _args(*backends)
    params, x, mask = _setup(ja)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    jy, jaux = jmoe.moe_apply(params, jnp.asarray(x), ja, train=False,
                              mask=jm)
    tp = from_jax_tree(params, device="cpu")
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), ta, train=False,
                              mask=tm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=0)
    for key in ("expert_load", "overflow"):
        np.testing.assert_array_equal(taux["telemetry"][key].numpy(),
                                      np.asarray(jaux["telemetry"][key]))
    jdec = jrouter.build(ja).route(params, jnp.asarray(x), train=False,
                                   mask=jm)
    tdec = trouter.build(ta).route(tp, torch.from_numpy(x), train=False,
                                   mask=tm)
    np.testing.assert_array_equal(tdec.plan.expert_index.numpy(),
                                  np.asarray(jdec.plan.expert_index))
    np.testing.assert_array_equal(tdec.plan.position.numpy(),
                                  np.asarray(jdec.plan.position))
    np.testing.assert_allclose(tdec.plan.weight.numpy(),
                               np.asarray(jdec.plan.weight), atol=1e-6)
    np.testing.assert_array_equal(tdec.load.numpy(), np.asarray(jdec.load))
    assert tdec.plan.capacity == jdec.plan.capacity
    if masked:
        assert (tdec.plan.position.numpy()[mask == 0] == tdec.plan.capacity
                ).all()


@pytest.mark.parametrize("backends", PAIRS)
def test_moe_apply_train_with_shared_noise_matches_jax(backends):
    ja, ta = _args(*backends, capacity_factor=2.0)
    params, x, mask = _setup(ja, seed=1)
    key = jax.random.PRNGKey(5)
    # moe_apply hands its rng to the gate, which draws normal(rng, [T, E]).
    noise = np.array(jax.random.normal(key, (T, E)))
    jy, jaux = jmoe.moe_apply(params, jnp.asarray(x), ja, train=True,
                              rng=key, mask=jnp.asarray(mask))
    ty, taux = tmoe.moe_apply(from_jax_tree(params, device="cpu"),
                              torch.from_numpy(x), ta, train=True,
                              noise=torch.from_numpy(noise),
                              mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-5)
    for key_ in jaux["metrics"]:
        np.testing.assert_allclose(float(taux["metrics"][key_]),
                                   float(jaux["metrics"][key_]), rtol=1e-5,
                                   atol=1e-6)


def test_einsum_dispatch_flavour_matches_sort():
    ja, ta = _args("ref", "ref")
    params, x, mask = _setup(ja, seed=2)
    tp = from_jax_tree(params, device="cpu")
    y_sort, _ = tmoe.moe_apply(tp, torch.from_numpy(x), ta, train=False)
    y_ein, _ = tmoe.moe_apply(
        tp, torch.from_numpy(x),
        dataclasses.replace(ta, dispatch_impl="einsum"),
        train=False)
    np.testing.assert_allclose(y_ein.numpy(), y_sort.numpy(), atol=1e-6)


def test_unported_and_unknown_options_raise():
    _, bad = _args("ref", "does_not_exist")
    with pytest.raises(KernelBackendError):
        tmoe.moe_apply({}, torch.zeros(2, D), bad, train=False)
    _, ta = _args("ref", "ref")
    for policy in trouter.NOT_YET_PORTED:
        with pytest.raises(trouter.RouterError, match="not ported"):
            trouter.resolve_spec(dataclasses.replace(
                ta, router=trouter.RouterSpec(policy=policy)))
    _, ta = _args("ref", "ref", fused_decode=True)
    with pytest.raises(NotImplementedError):
        tmoe.moe_apply({}, torch.zeros(2, D), ta, train=False)


@pytest.mark.parametrize("priority", [False, True])
def test_capacity_plan_matches_jax(priority):
    from repro.core import dispatch as jdsp
    from repro_torch.core import dispatch as tdsp
    rs = np.random.RandomState(3)
    t, e, k, cap = 40, 5, 2, 8
    idx = np.argsort(-rs.randn(t, e), 1, kind="stable")[:, :k].astype(
        np.int32)
    w = rs.rand(t, k).astype(np.float32)
    w[rs.rand(t) < 0.2] = 0.0            # masked tokens sort last
    jp = jdsp.plan(jnp.asarray(idx), jnp.asarray(w), e, cap,
                   priority=priority)
    tp = tdsp.plan(torch.from_numpy(idx), torch.from_numpy(w), e, cap,
                   priority=priority)
    np.testing.assert_array_equal(tp.position.numpy(),
                                  np.asarray(jp.position))
    np.testing.assert_array_equal(tp.weight.numpy(), np.asarray(jp.weight))
    assert float(tp.fraction_dropped) == float(jp.fraction_dropped) > 0
    assert tdsp.capacity_for(t, e, k, 1.25) == jdsp.capacity_for(t, e, k,
                                                                 1.25)


# ---------------------------------------------------------------------------
# training: moe_apply(train=True) values and every gradient
# ---------------------------------------------------------------------------

def _grad_names(root) -> set:
    """Names of the autograd nodes reachable from ``root``."""
    seen, names, stack = set(), set(), [root]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


TRAIN_PAIRS = [("pallas", "cuda", None), ("ref", "ref", None),
               ("pallas", "cuda", 2)]       # forced two-expert slab


@pytest.mark.parametrize("backends", TRAIN_PAIRS)
def test_moe_apply_train_grads_match_jax(backends):
    """Output, aux_loss and the gradient of every parameter and of x,
    with the JAX noise passed in, within 1e-5."""
    jb, tb, e_block = backends
    ja, ta = _args(jb, tb, capacity_factor=1.0, dispatch_e_block=e_block)
    ja = dataclasses.replace(ja, activation="relu", sigmoid_output=True)
    ta = dataclasses.replace(ta, activation="relu", sigmoid_output=True)
    params, x, _ = _setup(ja, seed=4)
    rs = np.random.RandomState(4)
    gy = rs.randn(T, D).astype(np.float32)
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, (T, E)))

    def jloss(p, x_):
        y, aux = jmoe.moe_apply(p, x_, ja, train=True, rng=key)
        return jnp.sum(y * gy) + aux["aux_loss"], (y, aux["aux_loss"])
    (jl, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    tp = from_jax_tree(params, device="cpu")
    for leaf in jax.tree_util.tree_leaves(tp):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_apply(tp, tx, ta, train=True,
                              noise=torch.from_numpy(noise))
    tl = torch.sum(ty * torch.from_numpy(gy)) + taux["aux_loss"]
    tl.backward()
    if tb == "cuda":
        assert {"TopKGatingFnBackward", "DispatchFnBackward",
                "CombineFnBackward", "GMMFnBackward"} <= _grad_names(
                    tl.grad_fn)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(taux["aux_loss"].detach()),
                               float(jaux), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
    flat_j = jax.tree_util.tree_leaves(jgp)
    assert len(flat_t) == len(flat_j) == 4
    for (path, leaf), want in zip(flat_t, flat_j):
        assert leaf.grad is not None, path
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


def test_cuda_backend_regime_selection():
    """Resident by default (the card has no VMEM); a forced slab wins;
    a named budget selects as the reference does."""
    from repro.kernels import dispatch as jdl
    from repro_torch.kernels.backend import plan_e_block
    _, ta = _args("pallas", "cuda")
    shape = (256, 128, 512, torch.float32, 4096)
    assert plan_e_block(ta, *shape) is None
    assert plan_e_block(dataclasses.replace(ta, dispatch_e_block=16),
                        *shape) == 16
    limited = dataclasses.replace(ta, dispatch_vmem_limit=16 * 2 ** 20)
    assert plan_e_block(limited, *shape) == jdl.select_e_block(
        256, 128, 512, jnp.float32, n_tokens=4096) == 16
    with pytest.raises(KernelBackendError):
        plan_e_block(dataclasses.replace(ta, dispatch_e_block=0), *shape)
