"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Marked ``cuda``; each test skips on a host without a GPU.  This
file imports no JAX, so it also runs on a GPU host without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import dispatch as dsp
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import fused_decode as tfd
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import topk_gating as ttopk


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
def test_topk_kernel_matches_plain(gen, tied):
    logits = torch.randn(37, 384, device="cuda", generator=gen)
    if tied:
        logits = torch.round(logits)
    w, idx, vals = ttopk.topk_gating(logits, 8, 9)
    pw, pidx, pvals = ttopk.topk_gating_plain(logits, 8, 9)
    assert torch.equal(idx, pidx) and torch.equal(vals, pvals)
    torch.testing.assert_close(w, pw, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 17])           # vector / scalar path
def test_dispatch_combine_kernels_match_plain(gen, dtype, d):
    t, e, k = 32, 8, 8
    logits = torch.randn(t, e, device="cuda", generator=gen)
    w, idx, _ = ttopk.topk_gating_plain(logits, k, k)
    w[::3] = 0.0                                  # masked tokens
    p = dsp.plan(idx, w, e, 8)
    assert bool((p.position >= 8).any())          # drops are exercised
    x = torch.randn(t, d, device="cuda", generator=gen).to(dtype)
    buf = tdispatch.dispatch(x, p.expert_index, p.position, n_experts=e,
                             capacity=8)
    assert torch.equal(buf, tdispatch.dispatch_plain(
        x, p.expert_index, p.position, None, e, 8))
    y = tdispatch.combine(buf, p.weight, p.expert_index, p.position)
    assert torch.equal(y, tdispatch.combine_plain(
        buf, p.weight, p.expert_index, p.position, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("act", sorted(tgmm.ACTIVATIONS))
def test_gmm_kernel_matches_plain(gen, dtype, tol, act):
    for e, c, k, n in ((3, 13, 300, 264), (2, 8, 65, 17)):
        x = torch.randn(e, c, k, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(e, k, n, device="cuda", generator=gen)
             / k ** 0.5).to(dtype)
        torch.testing.assert_close(tgmm.gmm(x, w, activation=act).float(),
                                   tgmm.gmm_plain(x, w, act).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
def test_wrappers_count_launches(gen):
    cuda_lib.reset_launch_counts()
    x = torch.randn(2, 8, 16, device="cuda", generator=gen)
    tgmm.gmm(x, torch.randn(2, 16, 8, device="cuda", generator=gen))
    tgmm.gmm_plain(x, torch.randn(2, 16, 8, device="cuda", generator=gen))
    assert cuda_lib.launch_counts() == {"gmm": 1}


# ---------------------------------------------------------------------------
# the training slice's kernels
# ---------------------------------------------------------------------------

def _plan(gen, t=96, e=8, k=4, cap=40):
    logits = torch.randn(t, e, device="cuda", generator=gen)
    w, idx, _ = ttopk.topk_gating_plain(logits, k, k)
    w[::5] = 0.0                                  # masked tokens
    return dsp.plan(idx, w, e, cap)


@pytest.mark.cuda
def test_topk_bwd_kernel_matches_plain(gen):
    t, e, k, kk = 37, 256, 4, 5
    logits = torch.randn(t, e, device="cuda", generator=gen)
    w, idx, _ = ttopk.topk_gating(logits, k, kk)
    dw = torch.randn(t, k, device="cuda", generator=gen)
    dvals = torch.randn(t, kk, device="cuda", generator=gen)
    assert torch.equal(ttopk.topk_gating_bwd(w, idx, dw, dvals, e),
                       ttopk.topk_gating_bwd_plain(w, idx, dw, dvals, e))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,e_block", [(40, 3), (17, 1)])
def test_eblock_kernels_match_plain(gen, dtype, d, e_block):
    p = _plan(gen)
    assert bool((p.position >= p.capacity).any())
    x = torch.randn(p.expert_index.shape[0], d, device="cuda",
                    generator=gen).to(dtype)
    args = (p.expert_index, p.position)
    kw = dict(n_experts=p.n_experts, capacity=p.capacity)
    buf = tdispatch.dispatch_eblock(x, *args, e_block=e_block, **kw)
    assert torch.equal(buf, tdispatch.dispatch(x, *args, **kw))
    assert torch.equal(buf, tdispatch.dispatch_eblock_plain(
        x, *args, None, p.n_experts, p.capacity, e_block))
    y = tdispatch.combine_eblock(buf, p.weight, *args, e_block=e_block)
    assert torch.equal(y, tdispatch.combine_eblock_plain(
        buf, p.weight, *args, dtype, e_block))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("trans", [(True, False), (False, True),
                                   (True, True)])
def test_transposed_gmm_kernel_matches_plain(gen, dtype, tol, trans):
    tx, tw = trans
    e, c, k, n = 3, 70, 130, 67
    x = torch.randn(*((e, k, c) if tx else (e, c, k)), device="cuda",
                    generator=gen).to(dtype)
    w = (torch.randn(*((e, n, k) if tw else (e, k, n)), device="cuda",
                     generator=gen) / k ** 0.5).to(dtype)
    if tx and tw:       # no layout of the backward pass
        with pytest.raises(ValueError, match="at most one operand"):
            tgmm.gmm(x, w, trans_x=True, trans_w=True)
        return
    for act in sorted(tgmm.ACTIVATIONS):
        torch.testing.assert_close(
            tgmm.gmm(x, w, activation=act, trans_x=tx, trans_w=tw).float(),
            tgmm.gmm_plain(x, w, act, tx, tw).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_functions_backward_on_the_card_matches_cpu(gen):
    """The autograd Functions' backward passes run their kernels on the
    card and agree with the same Functions on the CPU (plain versions)."""
    from repro_torch.kernels import ops
    p = _plan(gen)
    t, d, f = p.expert_index.shape[0], 24, 32
    x = torch.randn(t, d, device="cuda", generator=gen)
    w1 = torch.randn(p.n_experts, d, f, device="cuda", generator=gen) / 5
    logits = torch.randn(t, p.n_experts, device="cuda", generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [v.detach().to(dev).requires_grad_(True)
                  for v in (x, w1, logits)]
        xi, wi, li = leaves
        cw, _, vals = ops.topk_gating(li, 4, 5)
        pe, pp = p.expert_index.to(dev), p.position.to(dev)
        buf = ops.dispatch(xi, pe, pp, n_experts=p.n_experts,
                           capacity=p.capacity)
        h = ops.gmm(buf, wi, activation="relu")
        y = ops.combine(h, cw * p.weight.to(dev), pe, pp)
        (y.sum() + vals.sum()).backward()
        grads[dev] = [v.grad.cpu() for v in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the fused decode kernels (7 and 8)
# ---------------------------------------------------------------------------

def _close_to_plain(got, want, dtype):
    """f32: 1e-5 of the output's scale (sums in another order); bf16:
    two units in the last place at the output's largest binade."""
    scale = max(float(want.float().abs().max()), 1.0 if dtype ==
                torch.float32 else 1e-30)
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** -7 * scale
    assert float((got.float() - want.float()).abs().max()) <= tol


def _experts(gen, e, d, f, dtype):
    def r(*shape, scale):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)
    return (r(e, d, f, scale=d ** -0.5), r(e, f, d, scale=f ** -0.5),
            r(e, d, f, scale=d ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "swiglu"])
@pytest.mark.parametrize("capacity", [1, 8])
def test_fused_decode_kernel_matches_plain(gen, dtype, act, capacity):
    t, d, e, f, k = 13, 72, 10, 40, 3
    x = torch.randn(t, d, device="cuda", generator=gen).to(dtype)
    valid = (torch.arange(t, device="cuda") % 4 != 2).float()
    wg = torch.randn(d, e, device="cuda", generator=gen)
    wg[:, 7] = wg[:, 2]                           # experts 2 and 7 tie
    w1, w2, w3 = _experts(gen, e, d, f, dtype)
    w3 = w3 if act == "swiglu" else None
    cuda_lib.reset_launch_counts()
    y, load, over = tfd.decode_step(x, valid, wg, w1, w2, w3, k=k,
                                    capacity=capacity, activation=act)
    assert cuda_lib.launch_counts() == {"fused_decode": 1}
    py, pload, pover = tfd.decode_step_plain(x, valid, wg, w1, w2, w3, k=k,
                                             capacity=capacity,
                                             activation=act)
    assert torch.equal(load, pload) and torch.equal(over, pover)
    if capacity == 1:
        assert float(over.sum()) > 0
    assert bool((y[valid == 0] == 0).all())
    _close_to_plain(y, py, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,act", [("ffn", "relu"), ("ffn", "swiglu"),
                                      ("proj", "relu")])
@pytest.mark.parametrize("view", ["token", "assign"])
def test_fused_routed_kernel_matches_plain(gen, dtype, mode, act, view):
    from repro_torch.core.moa import assignment_plan
    p = _plan(gen, t=20, e=6, k=2, cap=6)
    assert bool((p.position >= p.capacity).any())
    p_in, p_out = (p, p) if view == "token" else (p, assignment_plan(p))
    d, f = 40, 24
    x = torch.randn(p_in.expert_index.shape[0], d, device="cuda",
                    generator=gen).to(dtype)
    w1, w2, w3 = _experts(gen, p.n_experts, d, f, dtype)
    if mode == "proj":
        w2 = w3 = None
    elif act == "relu":
        w3 = None
    args = (x, p_in.expert_index, p_in.position, p_out.expert_index,
            p_out.position, p_out.weight, w1, w2, w3)
    kw = dict(n_experts=p.n_experts, capacity=p.capacity, mode=mode,
              activation=act)
    cuda_lib.reset_launch_counts()
    got = tfd.routed_apply(*args, **kw)
    assert cuda_lib.launch_counts() == {"fused_routed": 1}
    _close_to_plain(got, tfd.routed_apply_plain(*args, **kw), dtype)
    got32 = tfd.routed_apply(*args, out_dtype=torch.float32, **kw)
    assert got32.dtype == torch.float32
    _close_to_plain(got32, tfd.routed_apply_plain(
        *args, out_dtype=torch.float32, **kw), dtype)
