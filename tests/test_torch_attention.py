"""The port's training attention against the JAX package, in f32 on the
CPU: ``flash_attention`` (the reference's custom VJP) forward and
backward, and ``attention`` with and without padded heads.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: outputs and gradients rtol 1e-5 / atol 1e-6 (both sum the
same f32 terms in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import param as jpm
from repro.models import attention as jattn
from repro_torch.common.bridge import from_jax_tree
from repro_torch.models import attention as tattn

S = 64


def _flash_case(b, kv, g, hd, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, kv, g, S, hd).astype(np.float32)
    k = rs.randn(b, kv, hd, S).astype(np.float32)
    v = rs.randn(b, kv, S, hd).astype(np.float32)
    dout = rs.randn(b, kv, g, S, hd).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("q_block,kv_block,window", [(16, 32, 0),
                                                     (32, 16, 0),
                                                     (16, 16, 24)])
def test_flash_attention_matches_jax(q_block, kv_block, window):
    """Output and dq / dk / dv, GQA with G = 3 query heads a kv head;
    q_block != kv_block both ways (the static diagonal ranges differ),
    and one sliding-window case (both ranges clipped below)."""
    q, k, v, dout = _flash_case(2, 2, 3, 16)

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, True, window, q_block,
                                             kv_block) * dout)
    jout = jattn.flash_attention(q, k, v, True, window, q_block, kv_block)
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = tattn.flash_attention(tq, tk, tv, True, window, q_block, kv_block)
    (tout * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for name, got, want in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"d{name}")


def test_flash_attention_keeps_no_score_matrix():
    """The forward saves only (q, k, v, out, lse): nothing of size
    [S, S] stays for the backward pass."""
    q, k, v, _ = _flash_case(1, 1, 2, 8)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        tattn.flash_attention(tq, tk, tv, True, 0, 16, 16)
    assert sorted(saved) == sorted([q.shape, k.shape, v.shape, q.shape,
                                    q.shape[:-1]])
    with pytest.raises(ValueError, match="divide the attention blocks"):
        tattn.flash_attention(tq, tk, tv, True, 0, 24, 16)


def _attn_params(d, h, kv, hd, qk_norm, seed=0):
    defs = jattn.attention_defs(d, h, kv, hd, qk_norm=qk_norm,
                                dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jpm.materialize(defs,
                                                  jax.random.PRNGKey(seed)))
    return tree, from_jax_tree(tree, device="cpu")


def test_attention_matches_jax():
    """The training attention (projections, qk-norm, rope, flash, output
    projection) and its parameter gradients against a fixed random
    cotangent; gradients rtol / atol 1e-5, as ``lm_loss``'s."""
    jp, tp = _attn_params(32, 4, 2, 8, True)
    rs = np.random.RandomState(1)
    x = rs.randn(2, S, 32).astype(np.float32)
    dy = rs.randn(2, S, 32).astype(np.float32)
    pos = np.arange(S)[None].repeat(2, 0)
    kw = dict(rope_theta=1e4, qk_norm=True, q_block=16, kv_block=32)

    def jloss(p):
        return jnp.sum(jattn.attention(p, x, pos, **kw) * dy)
    jy = jattn.attention(jp, x, pos, **kw)
    jg = jax.jit(jax.grad(jloss))(jp)
    for leaf in tp.values():
        for t in (leaf.values() if isinstance(leaf, dict) else [leaf]):
            t.requires_grad_(True)
    ty = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                         **kw)
    (ty * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jg[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for name in ("q_norm", "k_norm"):
        np.testing.assert_allclose(tp[name]["scale"].grad.numpy(),
                                   np.asarray(jg[name]["scale"]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_pad_attn_heads_numerically_identical():
    """Padded-group attention (7 heads padded to 16 over 7 kv heads: G
    1 -> 3) equals the unpadded computation, as the reference's test of
    the same name asserts; gradients flow only through the real heads."""
    _, tp = _attn_params(32, 7, 7, 8, False)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, S, 32).astype(
        np.float32))
    pos = torch.arange(S)[None].expand(2, S)
    kw = dict(rope_theta=1e4, qk_norm=False, q_block=32, kv_block=32)
    y0 = tattn.attention(tp, x, pos, **kw)
    tp["wq"].requires_grad_(True)
    y1 = tattn.attention(tp, x, pos, pad_heads=16, **kw)
    np.testing.assert_allclose(y0.numpy(), y1.detach().numpy(), rtol=2e-5,
                               atol=2e-6)
    (y1 ** 2).sum().backward()
    assert bool(torch.isfinite(tp["wq"].grad).all())


def test_sliding_window_attention_still_raises():
    """Named for the check it replaced (a window raised): the training
    attention with a window of 16, in blocks of 16 x 32, against the
    reference's (the gradients are ``test_torch_window.py``'s)."""
    jp, tp = _attn_params(32, 4, 2, 8, False)
    x = np.random.RandomState(3).randn(1, S, 32).astype(np.float32)
    pos = np.arange(S)[None]
    kw = dict(rope_theta=1e4, qk_norm=False, window=16, q_block=16,
              kv_block=32)
    want = jattn.attention(jp, x, pos, **kw)
    got = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                          **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
