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


def _kernels_for(dtype, c):
    """The GMM kernels a forward call of this type and C may run."""
    if dtype == torch.bfloat16 and c <= tgmm.STREAM_MAX_C:
        return ("stream", "tile")
    return ("tile",)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c", [1, 7, 8, 9, 16, 17, 128, 130])
@pytest.mark.parametrize("k,n", [(75, 46), (64, 136)])
def test_gmm_kernels_ragged_match_plain(gen, dtype, tol, c, k, n):
    """Both GMM kernels (the streaming one where it applies) against the
    plain version: C on both sides of the streaming / tiled threshold,
    K and N off the 8 / 16 multiples (element loads) and on them
    (16-byte cp.async); f32 runs 3xTF32 on the tiled kernel."""
    e = 3
    x = torch.randn(e, c, k, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(e, k, n, device="cuda", generator=gen)
         / k ** 0.5).to(dtype)
    for kernel in _kernels_for(dtype, c):
        for act in sorted(tgmm.ACTIVATIONS):
            torch.testing.assert_close(
                tgmm.gmm(x, w, activation=act, kernel=kernel).float(),
                tgmm.gmm_plain(x, w, act).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c", [8, 17, 130])
def test_gmm_rows_skip_exactly(gen, dtype, tol, c):
    """rows with an empty, a partial and a full expert: rows past
    rows[e] come out exactly 0, the rest as the plain version with the
    same rows; on a buffer whose skipped rows are zero, the result is
    bitwise that of the same kernel without rows."""
    e, k, n = 4, 72, 136
    rows = torch.tensor([0, c // 2, c, 1], dtype=torch.int32, device="cuda")
    x = tgmm.mask_rows(torch.randn(e, c, k, device="cuda", generator=gen)
                       .to(dtype), rows)
    w = (torch.randn(e, k, n, device="cuda", generator=gen)
         / k ** 0.5).to(dtype)
    for kernel in _kernels_for(dtype, c):
        for act in sorted(tgmm.ACTIVATIONS):
            got = tgmm.gmm(x, w, activation=act, rows=rows, kernel=kernel)
            for ex in range(e):
                assert bool((got[ex, int(rows[ex]):] == 0).all())
            torch.testing.assert_close(
                got.float(), tgmm.gmm_plain(x, w, act, rows=rows).float(),
                rtol=tol, atol=tol)
            assert torch.equal(got, tgmm.gmm(x, w, activation=act,
                                             kernel=kernel))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c", [8, 17, 130])
def test_transposed_gmm_rows_match_plain(gen, dtype, tol, c):
    """rows on the backward pass's layouts: dx = dz w^T (trans_w) has
    zero rows past rows[e]; dw = x^T dz (trans_x) sums only the rows
    before it.  Both against the plain version with the same rows, on
    operands whose rows past rows[e] are not zero."""
    e, k, n = 4, 72, 136
    rows = torch.tensor([0, c // 2, c, 1], dtype=torch.int32, device="cuda")
    dz = torch.randn(e, c, n, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(e, k, n, device="cuda", generator=gen)
         / n ** 0.5).to(dtype)
    x = (torch.randn(e, c, k, device="cuda", generator=gen)
         / c ** 0.5).to(dtype)
    dx = tgmm.gmm(dz, w, trans_w=True, rows=rows)
    for ex in range(e):
        assert bool((dx[ex, int(rows[ex]):] == 0).all())
    torch.testing.assert_close(
        dx.float(), tgmm.gmm_plain(dz, w, "none", False, True, rows).float(),
        rtol=tol, atol=tol)
    dw = tgmm.gmm(x, dz, trans_x=True, rows=rows)
    torch.testing.assert_close(
        dw.float(), tgmm.gmm_plain(x, dz, "none", True, False, rows).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_two_launches_bitwise_equal(gen, dtype):
    """No split-K and no atomics: every kernel and layout repeats bit for
    bit."""
    e, c, k, n = 4, 40, 200, 264
    x = torch.randn(e, c, k, device="cuda", generator=gen).to(dtype)
    w = torch.randn(e, k, n, device="cuda", generator=gen).to(dtype)
    g = torch.randn(e, c, n, device="cuda", generator=gen).to(dtype)
    for kernel in _kernels_for(dtype, c):
        assert torch.equal(tgmm.gmm(x, w, kernel=kernel),
                           tgmm.gmm(x, w, kernel=kernel))
    assert torch.equal(tgmm.gmm(g, w, trans_w=True),
                       tgmm.gmm(g, w, trans_w=True))
    assert torch.equal(tgmm.gmm(x, g, trans_x=True),
                       tgmm.gmm(x, g, trans_x=True))


@pytest.mark.cuda
def test_wrappers_count_launches(gen):
    cuda_lib.reset_launch_counts()
    x = torch.randn(2, 8, 16, device="cuda", generator=gen)
    tgmm.gmm(x, torch.randn(2, 16, 8, device="cuda", generator=gen))
    tgmm.gmm_plain(x, torch.randn(2, 16, 8, device="cuda", generator=gen))
    assert cuda_lib.launch_counts() == {"gmm": 1}


# ---------------------------------------------------------------------------
# combine (kernel 4) and top-k (kernel 1) over their grid and group choices
# ---------------------------------------------------------------------------

COMBINE_DTYPES = [(torch.float32, torch.float32),
                  (torch.float32, torch.bfloat16),
                  (torch.bfloat16, torch.float32),
                  (torch.bfloat16, torch.bfloat16)]


def _random_plan(gen, t, k, e=16, cap=64):
    """A [t, k] plan with kept, dropped (pos >= cap) and invalid (expert
    -1 or e) slots, and masked rows (zero weight).  Kept slots may
    repeat: combine only reads them."""
    eidx = torch.randint(0, e, (t, k), device="cuda", generator=gen,
                         dtype=torch.int32)
    pos = torch.randint(0, cap + cap // 4, (t, k), device="cuda",
                        generator=gen, dtype=torch.int32)
    bad = torch.rand(t, k, device="cuda", generator=gen) < 0.05
    eidx = torch.where(bad, torch.where(pos % 2 == 0, -1, e), eidx)
    w = torch.rand(t, k, device="cuda", generator=gen)
    w[::7] = 0.0
    return w, eidx.int(), pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", COMBINE_DTYPES)
@pytest.mark.parametrize("k", [1, 2, 4, 8, 12])     # 12: the runtime loop
@pytest.mark.parametrize("t", [0, 1, 8, 32, 4096])
def test_combine_kernel_bitwise_over_shapes(gen, t, k, dtypes):
    """Every group size, grid width and path (d = 17: scalar; 40, 512,
    7168: 16-byte vectors) is bit-identical to the plain version, and a
    second launch repeats the first bit for bit."""
    tin, tout = dtypes
    e, cap = 16, 64
    w, eidx, pos = _random_plan(gen, t, k, e, cap)
    for d in (17, 40, 512, 7168):
        buf = torch.randn(e, cap, d, device="cuda", generator=gen).to(tin)
        y = tdispatch.combine(buf, w, eidx, pos, out_dtype=tout)
        assert y.dtype == tout and y.shape == (t, d)
        assert torch.equal(y, tdispatch.combine_plain(buf, w, eidx, pos,
                                                      tout)), d
        assert torch.equal(y, tdispatch.combine(buf, w, eidx, pos,
                                                out_dtype=tout)), d


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", COMBINE_DTYPES)
def test_combine_kernel_unaligned_view(gen, dtypes):
    """A buffer viewed one element into its storage takes the scalar path
    (d % 8 == 0 but not 16-byte aligned) and still matches bit for bit."""
    tin, tout = dtypes
    t, k, e, cap, d = 8, 8, 16, 64, 512
    w, eidx, pos = _random_plan(gen, t, k, e, cap)
    flat = torch.randn(e * cap * d + 1, device="cuda", generator=gen).to(tin)
    buf = flat[1:].view(e, cap, d)
    assert buf.is_contiguous() and buf.data_ptr() % 16 != 0
    y = tdispatch.combine(buf, w, eidx, pos, out_dtype=tout)
    assert torch.equal(y, tdispatch.combine_plain(buf, w, eidx, pos, tout))
    assert torch.equal(y, tdispatch.combine(buf.clone(), w, eidx, pos,
                                            out_dtype=tout))


def _topk_logits(gen, t, e, k, kk, mode):
    logits = torch.randn(t, e, device="cuda", generator=gen)
    if mode == "tied":
        return torch.round(logits)
    if mode == "floor":
        # Between k and kk - 1 logits of a row above -1e30, the rest at
        # -1e31: the rounds past them re-pick a masked winner (-1e30).
        n = torch.randint(k, kk, (t, 1), device="cuda", generator=gen)
        rank = torch.rand(t, e, device="cuda", generator=gen).argsort(1) \
            .argsort(1)
        return torch.where(rank < n, logits, -1e31)
    return logits


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 31, 33, 384, 1024])
@pytest.mark.parametrize("t", [1, 8, 4096])
def test_topk_kernel_over_shapes(gen, t, e):
    """Indices equal to the plain version's and values within 1e-6, for
    kk = 1, 9, 32 and E (where E <= 32), on random, heavily tied and
    floored rows (fewer than kk logits above -1e30)."""
    kks = sorted({1, min(9, e), min(32, e)} | ({e} if e <= 32 else set()))
    for kk in kks:
        for k in sorted({1, max(1, kk - 1), kk}):
            for mode in ("random", "tied", "floor"):
                if mode == "floor" and k == kk:
                    continue
                logits = _topk_logits(gen, t, e, k, kk, mode)
                w, idx, vals = ttopk.topk_gating(logits, k, kk)
                pw, pidx, pvals = ttopk.topk_gating_plain(logits, k, kk)
                case = (t, e, k, kk, mode)
                assert torch.equal(idx, pidx), case
                assert float((w - pw).abs().max()) <= 1e-6, case
                assert float((vals - pvals).abs().max()) <= 1e-6, case
                assert bool(torch.isfinite(w).all()), case
                if mode == "floor":
                    assert bool((vals == -1e30).any()), case


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


def _repeat_logits(gen, t, e, n_finite):
    """n_finite logits of each row drawn, the rest at -1e31: the rounds
    past them re-pick a masked winner, so a row's indices repeat."""
    logits = torch.randn(t, e, device="cuda", generator=gen)
    rank = torch.rand(t, e, device="cuda", generator=gen).argsort(1) \
        .argsort(1)
    return torch.where(rank < n_finite, logits, -1e31)


def _topk_bwd_case(gen, logits, k, kk):
    w, idx, _ = ttopk.topk_gating(logits, k, kk)
    dw = torch.randn(w.shape, device="cuda", generator=gen)
    dvals = torch.randn(idx.shape, device="cuda", generator=gen)
    e = logits.shape[1]
    got = ttopk.topk_gating_bwd(w, idx, dw, dvals, e)
    assert torch.equal(got, ttopk.topk_gating_bwd_plain(w, idx, dw, dvals,
                                                        e))
    assert torch.equal(got, ttopk.topk_gating_bwd(w, idx, dw, dvals, e))
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("e", [33, 100, 256, 384])  # 33: rows not 16-byte aligned
@pytest.mark.parametrize("t", [1, 4096])
@pytest.mark.parametrize("k,kk,n_finite", [(2, 5, 1), (8, 9, 8)])
def test_topk_bwd_kernel_repeated_indices(gen, t, e, k, kk, n_finite):
    """Rows with fewer than kk logits above -1e30 repeat an index; the
    kernel sums such a column in ascending j from +0, bit for bit as the
    plain version does."""
    idx = _topk_bwd_case(gen, _repeat_logits(gen, t, e, n_finite), k, kk)
    assert bool((idx.sort(1).values.diff(1) == 0).any(1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 4, 31, 33, 100, 256, 384, 1000, 1024])
@pytest.mark.parametrize("t", [1, 4096])
def test_topk_bwd_kernel_over_shapes(gen, t, e):
    """Bit-equal to the plain version for kk = 1, 5, 9, 32 (at most E)
    and k = 1 or kk, on random and floored rows, on both store paths
    (E % 4 == 0: 16-byte stores) and over one or more column tiles."""
    for kk in sorted({min(n, e) for n in (1, 5, 9, 32)}):
        for k in sorted({1, kk}):
            _topk_bwd_case(gen, torch.randn(t, e, device="cuda",
                                            generator=gen), k, kk)
            if kk > 1:
                _topk_bwd_case(gen, _repeat_logits(gen, t, e, kk - 1),
                               min(k, kk - 1), kk)


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
@pytest.mark.parametrize("dtypes", COMBINE_DTYPES)
@pytest.mark.parametrize("k", [1, 2, 4, 8, 9])      # 9: two groups of 8
@pytest.mark.parametrize("t", [1, 8, 300])
def test_combine_eblock_kernel_bitwise_over_shapes(gen, t, k, dtypes):
    """Kernel 5 against its plain version bit for bit, over slabs that do
    not divide E (3, 5), one expert a slab and one slab (e_block >= E:
    also bit-equal to the resident combine), on plans with dropped and
    invalid slots, on the scalar (d = 17) and vector paths; a second
    launch repeats the first."""
    tin, tout = dtypes
    e, cap = 16, 64
    w, eidx, pos = _random_plan(gen, t, k, e, cap)
    if t == 300:
        assert bool((pos >= cap).any()) and bool((eidx < 0).any())
    for d in (17, 40, 512):
        buf = torch.randn(e, cap, d, device="cuda", generator=gen).to(tin)
        for e_block in (1, 3, 5, 16, 40):
            y = tdispatch.combine_eblock(buf, w, eidx, pos, out_dtype=tout,
                                         e_block=e_block)
            case = (d, e_block)
            assert y.dtype == tout and y.shape == (t, d)
            assert torch.equal(y, tdispatch.combine_eblock_plain(
                buf, w, eidx, pos, tout, e_block)), case
            assert torch.equal(y, tdispatch.combine_eblock(
                buf, w, eidx, pos, out_dtype=tout, e_block=e_block)), case
            if e_block >= e:
                assert torch.equal(y, tdispatch.combine(
                    buf, w, eidx, pos, out_dtype=tout)), case


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", COMBINE_DTYPES)
def test_combine_eblock_kernel_unaligned_view(gen, dtypes):
    """A buffer one element into its storage takes the scalar path and
    still matches bit for bit."""
    tin, tout = dtypes
    t, k, e, cap, d = 8, 8, 16, 64, 512
    w, eidx, pos = _random_plan(gen, t, k, e, cap)
    flat = torch.randn(e * cap * d + 1, device="cuda", generator=gen).to(tin)
    buf = flat[1:].view(e, cap, d)
    assert buf.is_contiguous() and buf.data_ptr() % 16 != 0
    for e_block in (3, 16):
        y = tdispatch.combine_eblock(buf, w, eidx, pos, out_dtype=tout,
                                     e_block=e_block)
        assert torch.equal(y, tdispatch.combine_eblock_plain(
            buf, w, eidx, pos, tout, e_block)), e_block


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 32])
def test_combine_eblock_kernel_decode_shape(gen, t):
    """kimi-k2's decode and prefill plans (d = 7168, E = 384, k = 8,
    bf16, the router's capacity) with the reference's slab of 64."""
    e, k, d = 384, 8, 7168
    logits = torch.randn(t, e, device="cuda", generator=gen)
    w, idx, _ = ttopk.topk_gating(logits, k, k)
    p = dsp.plan(idx, w, e, dsp.capacity_for(t, e, k, 1.25))
    buf = torch.randn(e, p.capacity, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    args = (buf, p.weight, p.expert_index, p.position)
    y = tdispatch.combine_eblock(*args, e_block=64)
    assert torch.equal(y, tdispatch.combine_eblock_plain(
        *args, torch.bfloat16, 64))


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
# the transformer training path's expert FFN: bf16, swiglu, C above the
# streaming kernel's range (arctic-480b trains at C = 80)
# ---------------------------------------------------------------------------

def _training_rows(c):
    return torch.tensor([0, 1, c // 2, c, c - 3, c], dtype=torch.int32,
                        device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [72, 80])
def test_bf16_tile_gmm_at_training_capacity(gen, c):
    """The bf16 tiled kernel at C above STREAM_MAX_C with rows: forward
    (silu, none), dx = dz w^T and dw = x^T dz, each within two bf16 ulps
    of the output's largest binade of the plain version; rows past
    rows[e] exactly zero."""
    bf = torch.bfloat16
    assert tgmm.kernel_for(bf, c, False) == "tile"
    e, k, n = 6, 136, 200
    rows = _training_rows(c)
    x = tgmm.mask_rows(torch.randn(e, c, k, device="cuda", generator=gen)
                       .to(bf), rows)
    w = (torch.randn(e, k, n, device="cuda", generator=gen) / k ** 0.5).to(bf)
    for act in ("silu", "none"):
        got = tgmm.gmm(x, w, activation=act, rows=rows)
        assert torch.equal(tgmm.mask_rows(got, rows), got)
        _close_to_plain(got, tgmm.gmm_plain(x, w, act, rows=rows), bf)
    dz = torch.randn(e, c, n, device="cuda", generator=gen).to(bf)
    _close_to_plain(tgmm.gmm(dz, w, trans_w=True, rows=rows),
                    tgmm.gmm_plain(dz, w, "none", False, True, rows), bf)
    _close_to_plain(tgmm.gmm(x, dz, trans_x=True, rows=rows),
                    tgmm.gmm_plain(x, dz, "none", True, False, rows), bf)


@pytest.mark.cuda
def test_gmmfn_silu_backward_bf16_matches_cpu(gen):
    """GMMFn with silu in bf16 (swiglu's up-projection) at C = 80 with
    rows: the forward and dx / dw on the card (the recomputed
    pre-activation, ``g * silu'(z)`` cast to bf16, two transposed GMMs)
    against the same Function on the CPU (plain versions), within two
    bf16 ulps of each output's largest binade."""
    from repro_torch.kernels import ops
    bf = torch.bfloat16
    e, c, k, n = 6, 80, 136, 200
    rows = _training_rows(c)
    x = tgmm.mask_rows(torch.randn(e, c, k, device="cuda", generator=gen)
                       .to(bf), rows)
    w = (torch.randn(e, k, n, device="cuda", generator=gen) / k ** 0.5).to(bf)
    g = torch.randn(e, c, n, device="cuda", generator=gen).to(bf)
    out = {}
    for dev in ("cuda", "cpu"):
        xi, wi = (t.detach().to(dev).requires_grad_(True) for t in (x, w))
        y = ops.gmm(xi, wi, activation="silu", rows=rows.to(dev))
        y.backward(g.to(dev))
        out[dev] = [t.detach().cuda() for t in (y, xi.grad, wi.grad)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.dtype == bf
        _close_to_plain(got, want, bf)


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


def _decode_problem(gen, t, d, e, f, dtype):
    x = torch.randn(t, d, device="cuda", generator=gen).to(dtype)
    valid = (torch.arange(t, device="cuda") % 7 != 3).float()
    wg = torch.randn(d, e, device="cuda", generator=gen)
    return (x, valid, wg, *_experts(gen, e, d, f, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "swiglu"])
@pytest.mark.parametrize("capacity", [17, 64, 65])
@pytest.mark.parametrize("d,f", [(72, 40),       # 16-byte loads
                                 (70, 36),       # d not a multiple of 8
                                 (264, 520)])    # column tails past 256
def test_fused_decode_kernel_many_cells(gen, dtype, act, capacity, d, f):
    """More than 8 filled cells an expert: several n8 tiles, and past 64
    a second row tile (160 tokens x k = 2 over 4 experts)."""
    t, e, k = 160, 4, 2
    x, valid, wg, w1, w2, w3 = _decode_problem(gen, t, d, e, f, dtype)
    w3 = w3 if act == "swiglu" else None
    y, load, over = tfd.decode_step(x, valid, wg, w1, w2, w3, k=k,
                                    capacity=capacity, activation=act)
    py, pload, pover = tfd.decode_step_plain(x, valid, wg, w1, w2, w3, k=k,
                                             capacity=capacity,
                                             activation=act)
    assert torch.equal(load, pload) and torch.equal(over, pover)
    assert float(load.max()) > 64          # past one row tile of cells
    assert bool((y[valid == 0] == 0).all())
    _close_to_plain(y, py, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,act", [("ffn", "swiglu"), ("proj", "relu")])
@pytest.mark.parametrize("view", ["token", "assign"])
@pytest.mark.parametrize("cap", [20, 72])
def test_fused_routed_kernel_many_cells(gen, dtype, mode, act, view, cap):
    """Plans with more than 8 cells an expert (and above 64: a second row
    tile), token-major and MoA's assignment-major view."""
    from repro_torch.core.moa import assignment_plan
    p = _plan(gen, t=200, e=4, k=2, cap=cap)
    assert int(p.position[p.position < cap].max()) >= min(cap - 1, 64)
    p_in, p_out = (p, p) if view == "token" else (p, assignment_plan(p))
    d, f = 264, 300
    x = torch.randn(p_in.expert_index.shape[0], d, device="cuda",
                    generator=gen).to(dtype)
    w1, w2, w3 = _experts(gen, p.n_experts, d, f, dtype)
    if mode == "proj":
        w2 = w3 = None
    args = (x, p_in.expert_index, p_in.position, p_out.expert_index,
            p_out.position, p_out.weight, w1, w2, w3)
    kw = dict(n_experts=p.n_experts, capacity=p.capacity, mode=mode,
              activation=act)
    _close_to_plain(tfd.routed_apply(*args, **kw),
                    tfd.routed_apply_plain(*args, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_two_launches_bitwise_equal(gen, dtype):
    """The work queue hands items to blocks in another order each run;
    no sum may depend on it."""
    t, d, e, f, k = 160, 264, 4, 520, 2
    x, valid, wg, w1, w2, w3 = _decode_problem(gen, t, d, e, f, dtype)
    a = tfd.decode_step(x, valid, wg, w1, w2, w3, k=k, capacity=72,
                        activation="swiglu")
    b = tfd.decode_step(x, valid, wg, w1, w2, w3, k=k, capacity=72,
                        activation="swiglu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    p = _plan(gen, t=t, e=e, k=k, cap=72)
    args = (x, p.expert_index, p.position, p.expert_index, p.position,
            p.weight, w1, w2, w3)
    kw = dict(n_experts=e, capacity=72, mode="ffn", activation="swiglu")
    assert torch.equal(tfd.routed_apply(*args, **kw),
                       tfd.routed_apply(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["noisy_topk", "expert_choice"])
def test_hmoe_cuda_matches_ref(gen, policy):
    """The hierarchical MoE under "cuda" against "ref" on the card,
    forward and backward, at a ragged shape (3 groups of 5 experts, d =
    40, f = 24, T = 50) with drops at both levels: output and every
    gradient within 1e-5 of their scale, the top-k (noisy_topk only),
    dispatch, combine and the two GMMs each launched once per level and
    pass, whatever the number of groups."""
    import dataclasses

    from repro_torch.common import param as pm
    from repro_torch.core import hierarchical as th
    from repro_torch.core.router import RouterSpec

    # Capacity factor 0.5: 100 assignments into 3 x 24 primary slots,
    # then 144 into 15 x 8 secondary ones, so both levels drop.
    a = th.HMoEArgs(n_groups=3, n_experts_per_group=5, k_primary=2,
                    k_secondary=2, d_model=40, d_ff=24, dtype=torch.float32,
                    router=RouterSpec(policy=policy, capacity_factor=0.5))
    params = pm.materialize(th.hmoe_defs(a), gen, "cuda")
    for gate in (params["gate_primary"], params["gate_secondary"]):
        gate["wg"].normal_(generator=gen)
        gate["wnoise"].normal_(0.0, 0.3, generator=gen)
    x = torch.randn(50, 40, device="cuda", generator=gen)
    gy = torch.randn(50, 40, device="cuda", generator=gen)
    noise = th.make_noise(a, 50, gen, "cuda")
    res = {}
    for backend in ("cuda", "ref"):
        p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_(True))
             for k, v in params.items()}
        xg = x.clone().requires_grad_(True)
        cuda_lib.reset_launch_counts()
        y, aux = th.hmoe_apply(p, xg, dataclasses.replace(
            a, kernel_backend=backend), train=True, noise=noise)
        ((y * gy).sum() + aux["aux_loss"]).backward()
        torch.cuda.synchronize()
        res[backend] = (cuda_lib.launch_counts(), y.detach(), aux,
                        [xg.grad] + [t.grad for t in pm.tree_leaves(p)])
    counts, y, aux, grads = res["cuda"]
    _, y_ref, aux_ref, grads_ref = res["ref"]
    assert float(aux["metrics"]["fraction_dropped"]) > 0
    if policy == "noisy_topk":
        assert float(aux["telemetry"]["overflow"].sum()) > 0
    want = {"dispatch": 4, "combine": 4, "gmm": 3, "gmm_bwd": 4}
    if policy == "noisy_topk":
        want.update(topk_gating=2, topk_gating_bwd=2)
    assert {k: v for k, v in counts.items() if v} == want
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux["aux_loss"], aux_ref["aux_loss"],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux["telemetry"]["expert_load"],
                               aux_ref["telemetry"]["expert_load"])
    # x and six leaves; expert_choice leaves both wnoise unused.
    present = [g is not None for g in grads]
    assert present == [r is not None for r in grads_ref]
    assert sum(present) == (7 if policy == "noisy_topk" else 5)
    for got, ref in zip(grads, grads_ref):
        if got is None:
            continue
        assert bool(torch.isfinite(got).all())
        assert float((got - ref).norm()) <= 1e-5 * max(float(ref.norm()),
                                                       1e-30)


@pytest.mark.cuda
def test_chunked_prefix_cached_engine_matches_ref(gen):
    """A chunked, prefix-cached engine (f32, a small kimi-k2 family
    model, fused decode) on the card under "cuda" against "ref": the
    same greedy streams and stats, prefix hits on every request after
    the first, and every kernel of the path launched."""
    import numpy as np

    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config("kimi-k2-1t-a32b", n_layers=2, d_model=32, n_heads=2,
                     n_kv_heads=2, head_dim=16, vocab_size=64, n_experts=4,
                     moe_k=2, moe_d_ff=32, capacity_factor=2.0, q_block=16,
                     kv_block=16, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    params["blocks"]["periods"]["pos0"]["moe"]["gate"]["wg"].normal_(
        generator=gen)
    rs = np.random.RandomState(3)
    shared = rs.randint(1, 64, (32,))
    trace = [(np.concatenate([shared, rs.randint(1, 64, (8,))]), 4,
              0 if i == 0 else 12 + i) for i in range(4)]
    sc = ServeConfig(max_len=64, n_slots=4, prefill_chunk=16,
                     prefill_budget=32, admission="aware", prefix_cache=True,
                     fused_decode=True)
    out = {}
    for backend in ("cuda", "ref"):
        eng = ServeEngine(params, cfg.replace(kernel_backend=backend), sc,
                          device="cuda")
        cuda_lib.reset_launch_counts()
        reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
        eng.run()
        torch.cuda.synchronize()
        out[backend] = ([r.tokens for r in reqs], eng.stats,
                        cuda_lib.launch_counts())
    (toks, stats, counts), (toks_ref, stats_ref, counts_ref) = (
        out["cuda"], out["ref"])
    assert toks == toks_ref
    assert stats == stats_ref
    assert stats["prefix_hits"] == 3
    assert stats["prefix_hit_tokens"] == 3 * 32
    assert not any(counts_ref.values())
    for name in ("topk_gating", "dispatch", "combine", "gmm",
                 "fused_decode"):
        assert counts[name] > 0, name


@pytest.mark.cuda
def test_moa_training_step_cuda_matches_ref(gen):
    """One lm_loss forward and backward of a small moa-demo (f32, two
    periods of attention + MoE FFN and MoA + dense FFN, remat) on the
    card under "cuda" against "ref" from the same draws: the loss and
    every gradient within 1e-5 of their scale, the MoA gates' nonzero,
    and each kernel launched as often as a step of the full model
    launches it (chip_smoke.py's MOA_TRAIN_LAUNCHES)."""
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import lm

    cfg = get_config("moa-demo", d_model=64, vocab_size=256, n_heads=4,
                     head_dim=16, d_ff=96, moe_d_ff=32, q_block=32,
                     kv_block=32, param_dtype=torch.float32,
                     compute_dtype=torch.float32)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    periods = params["blocks"]["periods"]
    for gate in (periods["pos0"]["moe"]["gate"], periods["pos1"]["moa"]
                 ["gate"]):
        gate["wg"].normal_(generator=gen)
    batch = batch_at(DataConfig(vocab_size=256, seq_len=64, batch_size=2,
                                n_clusters=4), 0, device="cuda")
    draws = lm.make_draws(cfg, 2, 64, gen, "cuda")
    res = {}
    for backend in ("cuda", "ref"):
        p = pm.tree_map(lambda t: t.clone().requires_grad_(True), params)
        cuda_lib.reset_launch_counts()
        loss, _ = lm.lm_loss(p, batch, cfg.replace(kernel_backend=backend),
                             draws=draws)
        loss.backward()
        torch.cuda.synchronize()
        res[backend] = (cuda_lib.launch_counts(), loss.detach(),
                        [t.grad for t in pm.tree_leaves(p)], p)
    counts, loss, grads, p = res["cuda"]
    counts_ref, loss_ref, grads_ref, _ = res["ref"]
    assert {k: v for k, v in counts.items() if v} == {
        "topk_gating": 8, "topk_gating_bwd": 4, "dispatch": 18,
        "combine": 18, "gmm": 22, "gmm_bwd": 20}
    assert not any(counts_ref.values())
    torch.testing.assert_close(loss, loss_ref, rtol=1e-5, atol=1e-6)
    for got, ref in zip(grads, grads_ref):
        assert got is not None and bool(torch.isfinite(got).all())
        assert float((got - ref).norm()) <= 1e-5 * max(float(ref.norm()),
                                                       1e-30)
    assert float(p["blocks"]["periods"]["pos1"]["moa"]["gate"]["wg"]
                 .grad.abs().max()) > 0


@pytest.mark.cuda
def test_windowed_engine_matches_full_forward(gen):
    """A small gemma3-family model (f32, 5 windowed layers of 16 and a
    global one) served on the card: prompts shorter and longer than the
    ring, decodes that wrap it; each prefill and decode logit row
    against the training forward (windowed FlashAttentionFn) over the
    prompt and its tokens, within 1e-4."""
    import numpy as np

    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers, lm, transformer
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config("gemma3-27b", n_layers=6, d_model=64, n_heads=4,
                     n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256,
                     sliding_window=16, q_block=16, kv_block=16,
                     param_dtype=torch.float32, compute_dtype=torch.float32)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    rs = np.random.RandomState(5)
    trace = [(rs.randint(1, 256, (n,)), m) for n, m in ((8, 20), (40, 12))]
    eng = ServeEngine(params, cfg, ServeConfig(max_len=64, n_slots=2),
                      device="cuda")
    rows: dict = {}
    real_prefill, real_decode = lm.lm_prefill, lm.lm_decode

    def prefill(p, batch, cache, c, **kw):
        out = real_prefill(p, batch, cache, c, **kw)
        n = batch["tokens"].shape[1]
        i = next(j for j, (pr, _) in enumerate(trace) if len(pr) == n)
        rows[(i, n - 1)] = out[0][0]
        return out

    def decode(p, tokens, cache, cur, c, **kw):
        out = real_decode(p, tokens, cache, cur, c, **kw)
        for i in np.nonzero(kw["valid"].cpu().numpy())[0]:
            rows[(int(i), int(cur[i]))] = out[0][i]
        return out

    lm.lm_prefill, lm.lm_decode = prefill, decode
    try:
        reqs = [eng.submit(pr, m) for pr, m in trace]
        eng.run()
    finally:
        lm.lm_prefill, lm.lm_decode = real_prefill, real_decode
    for i, (pr, m) in enumerate(trace):
        seq = np.concatenate([pr, reqs[i].tokens[:-1]])
        s = -(-len(seq) // 16) * 16
        tokens = torch.zeros((1, s), dtype=torch.int32, device="cuda")
        tokens[0, :len(seq)] = torch.as_tensor(seq)
        with torch.no_grad():
            x = layers.embed(params["embed"], tokens, cfg.compute_dtype)
            x, _ = transformer.stack_apply(
                params["blocks"], x, cfg,
                positions=torch.arange(s, device="cuda")[None], train=False)
            full = lm.logits_fn(params, layers.rmsnorm(
                params["ln_f"], x, cfg.norm_eps), cfg)[0]
        for pos in range(len(pr) - 1, len(seq)):
            torch.testing.assert_close(rows[(i, pos)], full[pos], rtol=1e-4,
                                       atol=1e-4)


def _mamba_case(dtype, b=2, s=256, d=64, n=16):
    """A mamba block's parameters (seeded on the CPU) and an input, two
    chunks of 128 long."""
    from repro_torch.common import param as pm
    from repro_torch.models import ssm
    g = torch.Generator().manual_seed(1)
    params = pm.materialize(ssm.mamba_defs(d, d_state=n, d_conv=4, expand=2,
                                           dtype=dtype), g, "cpu")
    params["dt_bias"].normal_(0.0, 0.5, generator=g)
    params["a_log"].uniform_(-1.0, 1.5, generator=g)
    x = (0.5 * torch.randn(b, s, d, generator=g)).to(dtype)
    return params, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_cuda_matches_cpu(gen, dtype):
    """``ssm.mamba`` on the card against the same call on the CPU: the
    output, the final scan and conv state and every gradient.  f32: max
    abs error within 1e-4 of each tensor's scale (sums in other orders);
    bf16: within 2^-6 normwise (||got - want|| / ||want||: the
    compute-dtype matmuls round sums taken in other orders, and the
    backward pass carries that rounding through)."""
    from repro_torch.common.param import tree_leaves, tree_map
    from repro_torch.models import ssm
    params, x = _mamba_case(dtype)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.detach().clone().to(dev).requires_grad_(
            True), params)
        xx = x.detach().clone().to(dev).requires_grad_(True)
        y, st = ssm.mamba(p, xx, d_state=16, return_state=True)
        (y.float() * dy.to(dev)).sum().backward()
        runs[dev] = [y, st["ssm"], st["conv"], xx.grad] + [
            t.grad for t in tree_leaves(p)]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        diff = got.cpu().float() - want.float()
        if dtype == torch.float32:
            scale = float(want.abs().max())
            assert float(diff.abs().max()) <= 1e-4 * max(scale, 1e-30)
        else:
            norm = float(torch.linalg.vector_norm(want.float()))
            assert float(torch.linalg.vector_norm(diff)) <= \
                2.0 ** -6 * max(norm, 1e-30)


@pytest.mark.cuda
def test_mamba_scan_matches_decode_on_card(gen):
    """The chunked scan against the one-step recurrence on the card, in
    f32, over two chunks."""
    from repro_torch.common import param as pm
    from repro_torch.models import ssm
    params, x = _mamba_case(torch.float32)
    params = pm.tree_map(lambda t: t.cuda(), params)
    x = x.cuda()
    with torch.no_grad():
        want = ssm.mamba(params, x, d_state=16)
        state = pm.zeros(ssm.init_state_defs(2, 64, d_state=16, d_conv=4,
                                             expand=2), "cuda")
        ys = []
        for i in range(x.shape[1]):
            y, state = ssm.mamba_decode(params, x[:, i:i + 1], state,
                                        d_state=16)
            ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
