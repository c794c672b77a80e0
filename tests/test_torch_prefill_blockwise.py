"""The port's blockwise prefill attention against the JAX package, in f32
on the CPU.

* ``blockwise_attention`` against the reference's over GQA (4 query
  heads on 2 kv heads), a query offset, a sliding window, ``kv_len``
  and ``q_block != kv_block`` both ways;
* ``prefill_attention`` and ``moa_prefill`` against the reference's,
  the returned caches included: a whole prompt, a windowed prompt both
  longer and shorter than its ring, and a prompt prefilled whole then
  continued in chunks at two offsets, in blocks of 8 and 16;
* the reference's ``ValueError`` where a length does not divide its
  block (the port raises too, it does not fall back);
* no op of the blockwise prefill makes a tensor with a ``[Sq, Skv]``
  plane in its shape, nor one as large as that plane of every head
  (``causal_attention``, the plain whole-matrix version, makes both:
  the check's positive control).

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: outputs and caches rtol / atol 1e-5 (both sum the same f32
terms, in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import _attn_params
from torch.utils._python_dispatch import TorchDispatchMode

from repro.common import param as jpm
from repro.core import moa as jmoa
from repro.core import router as jrouter
from repro.models import attention as jattn
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.core import moa as tmoa
from repro_torch.core import router as trouter
from repro_torch.models import attention as tattn

TOL = 1e-5
D, H, KV, HD = 32, 4, 2, 8


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# blockwise_attention
# ---------------------------------------------------------------------------

# (q_block, kv_block, window, q_offset, kv_len)
CASES = {
    "gqa": (8, 8, 0, 0, None),
    "q_block<kv_block,offset": (8, 16, 0, 16, None),
    "q_block>kv_block,offset": (16, 8, 0, 8, None),
    "window": (16, 8, 12, 0, None),
    "window,offset": (8, 16, 12, 16, None),
    "kv_len,offset": (8, 8, 0, 8, 29),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_blockwise_attention_matches_jax(case):
    q_block, kv_block, window, off, kv_len = CASES[case]
    rs = np.random.RandomState(sorted(CASES).index(case))
    q = rs.randn(2, 32, H, HD).astype(np.float32)
    k = rs.randn(2, 32 + off, KV, HD).astype(np.float32)
    v = rs.randn(2, 32 + off, KV, HD).astype(np.float32)
    kw = dict(causal=True, window=window, q_block=q_block,
              kv_block=kv_block, q_offset=off)
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=None if kv_len is None else jnp.int32(kv_len), **kw)
    got = tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), kv_len=kv_len, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, want, case)


# ---------------------------------------------------------------------------
# prefill_attention and moa_prefill, caches included
# ---------------------------------------------------------------------------

MAX_LEN = 48
KW = dict(rope_theta=1e4, qk_norm=True)

# name -> (window, [(offset or None, chunk length), ...])
PREFILLS = {
    "whole": (0, [(None, 32)]),
    "window,longer_than_ring": (16, [(None, 32)]),
    "window,shorter_than_ring": (24, [(None, 16)]),
    "chunked,two_offsets": (0, [(None, 16), (16, 16), (32, 16)]),
}


def _calls(name, seed):
    window, calls = PREFILLS[name]
    rs = np.random.RandomState(seed)
    total = sum(s for _, s in calls)
    x = rs.randn(2, total, D).astype(np.float32)
    return window, calls, x


@pytest.mark.parametrize("name", sorted(PREFILLS))
def test_prefill_attention_matches_jax(name):
    window, calls, x = _calls(name, 1)
    jp, tp = _attn_params(D, H, KV, HD, True, seed=2)
    length = min(window, MAX_LEN) if window else MAX_LEN
    jcache = {"k": jnp.zeros((2, length, KV, HD)),
              "v": jnp.zeros((2, length, KV, HD))}
    tcache = {"k": torch.zeros((2, length, KV, HD)),
              "v": torch.zeros((2, length, KV, HD))}
    start = 0
    for off, s in calls:
        xs = x[:, start:start + s]
        pos = np.broadcast_to(np.arange(start, start + s)[None], (2, s))
        kw = dict(KW, window=window, q_block=8, kv_block=16, offset=off)
        jy, jcache = jattn.prefill_attention(jp, jnp.asarray(xs),
                                             jnp.asarray(pos), cache=jcache,
                                             **kw)
        ty, tcache = tattn.prefill_attention(tp, torch.from_numpy(xs),
                                             torch.from_numpy(pos.copy()),
                                             cache=tcache, **kw)
        _close(ty, jy, f"{name} y at {start}")
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], f"{name} cache {key} at {start}")
        start += s


def _moa_args(q_block, kv_block):
    kw = dict(n_experts=4, k=2, d_model=D, n_heads_per_expert=2,
              head_dim=HD, n_kv_heads=KV, qk_norm=True, q_block=q_block,
              kv_block=kv_block)
    return (jmoa.MoAArgs(**kw, router=jrouter.RouterSpec(),
                         dtype=jnp.float32),
            tmoa.MoAArgs(**kw, router=trouter.RouterSpec(),
                         dtype=torch.float32))


@pytest.mark.parametrize("name", ["whole", "chunked,two_offsets"])
@pytest.mark.parametrize("blocks", [(8, 16), (12, 16)],
                         ids=["8x16", "12x16"])
def test_moa_prefill_matches_jax(name, blocks):
    """The routed Q / O and the shared K/V, whole and chunked; a
    ``q_block`` of 12 falls back to the whole chunk (``_block``)."""
    _, calls, x = _calls(name, 3)
    ja, ta = _moa_args(*blocks)
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jpm.materialize(jmoa.moa_defs(ja), jax.random.PRNGKey(4)))
    tree["gate"]["wg"] = np.random.RandomState(5).randn(
        *tree["gate"]["wg"].shape).astype(np.float32)
    tp = from_jax_tree(tree, device="cpu")
    jcache = jpm.materialize(jmoa.init_cache_defs(2, MAX_LEN, ja,
                                                  dtype=jnp.float32),
                             jax.random.PRNGKey(0))
    tcache = tpm.zeros(tmoa.init_cache_defs(2, MAX_LEN, ta,
                                            dtype=torch.float32), "cpu")
    start = 0
    for off, s in calls:
        xs = x[:, start:start + s]
        pos = np.broadcast_to(np.arange(start, start + s)[None],
                              (2, s)).astype(np.int32)
        mask = np.ones(2 * s, np.float32)
        mask[-3:] = 0.0                       # a padded tail routes nowhere
        jy, jcache = jmoa.moa_prefill(tree, jnp.asarray(xs), jnp.asarray(pos),
                                      ja, cache=jcache,
                                      mask=jnp.asarray(mask), start_pos=off)
        ty, tcache = tmoa.moa_prefill(tp, torch.from_numpy(xs),
                                      torch.from_numpy(pos.copy()), ta,
                                      cache=tcache,
                                      mask=torch.from_numpy(mask),
                                      start_pos=off)
        _close(ty, jy, f"{name} y at {start}")
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], f"{name} cache {key} at {start}")
        start += s


# ---------------------------------------------------------------------------
# lengths that do not divide their blocks
# ---------------------------------------------------------------------------

# (Sq, Skv, q_block, kv_block, q_offset): 24 % 16; 24 % 16 over the
# context of a chunk of 16 at offset 8.
REFUSED = {"query": (24, 24, 16, 16, 0), "chunk_context": (16, 24, 16, 16, 8)}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_non_dividing_length_raises_in_both(case):
    sq, skv, q_block, kv_block, off = REFUSED[case]
    rs = np.random.RandomState(6)
    q = rs.randn(1, sq, H, HD).astype(np.float32)
    k = rs.randn(1, skv, KV, HD).astype(np.float32)
    kw = dict(q_block=q_block, kv_block=kv_block, q_offset=off)
    with pytest.raises(ValueError, match="divide the attention blocks"):
        jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(k), **kw)
    with pytest.raises(ValueError, match="divide the attention blocks"):
        tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(k), **kw)
    # The same chunk through prefill_attention's chunk mode.
    _, tp = _attn_params(D, H, KV, HD, True)
    x = torch.from_numpy(rs.randn(1, sq, D).astype(np.float32))
    pos = (off + torch.arange(sq))[None]
    cache = {"k": torch.zeros((1, MAX_LEN, KV, HD)),
             "v": torch.zeros((1, MAX_LEN, KV, HD))}
    with pytest.raises(ValueError, match="divide the attention blocks"):
        tattn.prefill_attention(tp, x, pos, cache=cache, q_block=q_block,
                                kv_block=kv_block, offset=off or None, **KW)


# ---------------------------------------------------------------------------
# no score plane
# ---------------------------------------------------------------------------

class _Largest(TorchDispatchMode):
    """The largest tensor (in elements) any op makes inside the mode, and
    whether one has two dims of ``s`` (a score plane of some heads)."""

    def __init__(self, s: int):
        super().__init__()
        self.s, self.largest, self.plane_dims = s, 0, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
                self.plane_dims |= list(t.shape).count(self.s) >= 2
        return out


def test_blockwise_prefill_makes_no_score_plane():
    """S = 64 in blocks of 16: whole, windowed and chunked prefill and
    MoA's prefill make no tensor with a ``[Sq, Skv]`` plane in its shape
    and none as large as that plane of every head (B·H·Sq·Skv elements;
    MoA's largest is its ``[E, C, d]`` dispatch buffer, half that);
    causal_attention makes both."""
    b, s = 2, 64
    plane = b * H * s * s
    _, tp = _attn_params(D, H, KV, HD, True)
    x = torch.from_numpy(np.random.RandomState(7).randn(b, s, D).astype(
        np.float32))
    pos = torch.arange(s)[None].expand(b, s)

    def cache(length=s):
        return {"k": torch.zeros((b, length, KV, HD)),
                "v": torch.zeros((b, length, KV, HD))}
    kw = dict(KW, q_block=16, kv_block=16)
    _, ta = _moa_args(16, 16)
    moa_params = tpm.materialize(tmoa.moa_defs(ta),
                                 torch.Generator().manual_seed(0), "cpu")
    runs = {
        "whole": lambda: tattn.prefill_attention(tp, x, pos, cache=cache(),
                                                 **kw),
        "window": lambda: tattn.prefill_attention(
            tp, x, pos, cache=cache(16), window=16, **kw),
        "chunk": lambda: tattn.prefill_attention(
            tp, x[:, 32:], pos[:, 32:], cache=cache(), offset=32, **kw),
        "moa": lambda: tmoa.moa_prefill(moa_params, x, pos, ta,
                                        cache=cache()),
    }
    for name, run in runs.items():
        with _Largest(s) as mode:
            run()
        assert 0 < mode.largest < plane, (name, mode.largest, plane)
        assert not mode.plane_dims, name
    q = torch.randn(b, s, H, HD)
    k = torch.randn(b, s, KV, HD)
    with _Largest(s) as mode:
        tattn.causal_attention(q, k, k)
    assert mode.largest >= plane and mode.plane_dims
