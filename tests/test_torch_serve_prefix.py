"""Chunked prefill, cross-slot batched prefill and the shared-prefix KV
cache of the port, against the JAX package in f32 on the CPU, at the
reference tests' size (kimi-k2 family, 2 layers, d_model 32, 4 experts
top-2, q_block = kv_block = 16, capacity_factor 2.0).

* ``prefill_attention(offset=)`` and ``moa_prefill(start_pos=)``: outputs
  and caches within 1e-5 of the JAX functions;
* ``lm_prefill`` chunk by chunk: logits within 1e-4 (the whole-prompt
  prefill test's tolerance), caches within 1e-5;
* the ``SlotKVCache`` page operations, the port's own ``PrefixCache``
  against the reference's over random op sequences (every return value
  and ``stats`` equal) and its host-only semantics;
* the port's ``ServeEngine`` with chunks and the prefix cache against
  the JAX ``ServeEngine``: greedy streams and ``stats`` equal, the
  trie's pages within 1e-5 and never written after they are cached;
* construction and ``submit`` errors, and the launcher's prefix stats.

Both packages get the same parameters (a JAX ``pm.materialize`` tree with
random gates, moved across with ``from_jax_tree``).  At 4 experts top-2
and capacity factor 2.0 the capacity equals the call's token count, so
no call drops a token and chunked streams equal whole-prompt ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import small_config

from repro.common import param as jpm
from repro.configs.base import get_config as jget_config
from repro.core import moa as jmoa
from repro.core.router import RouterSpec as JRouterSpec
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro.serve.kv_cache import PrefixCache as JPrefixCache
from repro_torch.common import param as tpm
from repro_torch.common.bridge import from_jax_tree
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import moa as tmoa
from repro_torch.core.router import RouterSpec as TRouterSpec
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import engine as tengine
from repro_torch.serve.kv_cache import PrefixCache, SlotKVCache

SMALL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             vocab_size=64, n_experts=4, moe_k=2, moe_d_ff=32,
             capacity_factor=2.0)
# The reference's serving matrix trace: 40 / 33 force multi-chunk
# prefill at chunk 16.  (prompt length, new tokens, arrival step).
MATRIX_TRACE = [(40, 4, 0), (8, 3, 0), (33, 5, 1), (12, 4, 2)]
CHUNK_KW = dict(prefill_chunk=16, prefill_budget=32, admission="aware")
# The reference's PrefixCache property grid: (block, page_bytes,
# max_bytes, seed).
PREFIX_GRID = [(4, 10, 0, 0), (4, 10, 20, 1), (2, 7, 7, 2), (8, 100, 300, 3),
               (4, 10, 10, 4)]


def _configs(policy="noisy_topk"):
    jcfg = jget_config("kimi-k2-1t-a32b").replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32, q_block=16,
        kv_block=16, **SMALL,
        router=JRouterSpec(policy=policy, capacity_factor=2.0))
    tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.float32,
                       compute_dtype=torch.float32, q_block=16, kv_block=16,
                       **SMALL, router=TRouterSpec(policy=policy,
                                          capacity_factor=2.0))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    moe = tree["blocks"]["periods"]["pos0"]["moe"]
    moe["gate"]["wg"] = rs.randn(*moe["gate"]["wg"].shape).astype(np.float32)
    return jcfg, tcfg, tree, from_jax_tree(tree, device="cpu")


def _assert_trees_close(tree_t, tree_j, atol):
    leaves_t = tpm.tree_leaves(tree_t)
    leaves_j = jax.tree_util.tree_leaves(tree_j)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the model layers with an offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [False, True])
def test_prefill_attention_offset_matches_jax(qk_norm):
    """Two chunks of 16 into a 48-position cache (GQA, 4 heads over 2):
    the chunk at offset 16 attends over the first chunk's cached K/V."""
    defs = jattn.attention_defs(32, 4, 2, 8, qk_norm=qk_norm,
                                dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray,
                                jpm.materialize(defs, jax.random.PRNGKey(3)))
    tp = from_jax_tree(jp, device="cpu")
    rs = np.random.RandomState(4)
    x = rs.randn(2, 32, 32).astype(np.float32)
    jcache = {"k": jnp.zeros((2, 48, 2, 8)), "v": jnp.zeros((2, 48, 2, 8))}
    tcache = {"k": torch.zeros(2, 48, 2, 8), "v": torch.zeros(2, 48, 2, 8)}
    kw = dict(rope_theta=1e4, qk_norm=qk_norm)
    for off in (0, 16):
        xs = x[:, off:off + 16]
        pos = np.broadcast_to(off + np.arange(16), (2, 16))
        jy, jcache = jattn.prefill_attention(
            jp, jnp.asarray(xs), jnp.asarray(pos), cache=jcache,
            q_block=16, kv_block=16, offset=off, **kw)
        ty, tcache = tattn.prefill_attention(
            tp, torch.from_numpy(xs), torch.from_numpy(pos.copy()),
            cache=tcache, offset=off, **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)
        _assert_trees_close(tcache, jcache, 1e-5)
    with pytest.raises(ValueError, match="sliding-window"):
        tattn.prefill_attention(tp, torch.from_numpy(x[:, :16]),
                                torch.arange(16)[None], cache=tcache,
                                window=8, offset=16, **kw)


@pytest.fixture(scope="module")
def moa():
    jcfg = small_config("moa-demo")
    shared = ("n_layers", "d_model", "vocab_size", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "n_experts", "moe_k", "moe_d_ff",
              "moa_experts", "moa_k", "moa_heads_per_expert", "q_block",
              "kv_block")
    tcfg = tget_config("moa-demo", param_dtype=torch.float32,
                       compute_dtype=torch.float32,
                       **{k: getattr(jcfg, k) for k in shared})
    tree = jax.tree_util.tree_map(
        np.asarray, jpm.materialize(jlm.lm_defs(jcfg), jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    for node in (tree["blocks"]["periods"]["pos0"]["moe"],
                 tree["blocks"]["periods"]["pos1"]["moa"],
                 tree["blocks"]["tail"]["pos0"]["moe"]):
        node["gate"]["wg"] = rs.randn(*node["gate"]["wg"].shape).astype(
            np.float32)
    return jcfg, tcfg, tree, from_jax_tree(tree, device="cpu")


def test_moa_prefill_start_pos_matches_jax(moa):
    """MoA's shared K/V cache at offsets 0 and 32 (two chunks of the
    config's kv_block), a padded tail masked out of routing."""
    jcfg, tcfg, tree, tparams = moa
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                tree["blocks"]["periods"]["pos1"]["moa"])
    tp = from_jax_tree(jp, device="cpu")
    ja = jtransformer._moa_args(jcfg.replace(kernel_backend="ref"))
    ta = ttransformer._moa_args(tcfg)
    d = jcfg.d_model
    rs = np.random.RandomState(5)
    x = rs.randn(2, 64, d).astype(np.float32)
    mask = np.ones((2, 64), np.float32)
    mask[1, 50:] = 0.0
    shape = (2, 96, ta.n_kv_heads, ta.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for off in (0, 32):
        xs = x[:, off:off + 32]
        pos = np.broadcast_to(off + np.arange(32), (2, 32)).copy()
        m = mask[:, off:off + 32].reshape(-1)
        jy, jcache = jmoa.moa_prefill(jp, jnp.asarray(xs), jnp.asarray(pos),
                                      ja, cache=jcache, mask=jnp.asarray(m),
                                      start_pos=off)
        ty, tcache = tmoa.moa_prefill(tp, torch.from_numpy(xs),
                                      torch.from_numpy(pos), ta,
                                      cache=tcache, mask=torch.from_numpy(m),
                                      start_pos=off)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)
        _assert_trees_close(tcache, jcache, 1e-5)


def test_lm_prefill_chunks_match_jax(models):
    """A 48-token prompt pair as three 16-token chunks (row 1 ends at
    position 41: its last chunk is padded and masked), logits at each
    row's last index."""
    jcfg, tcfg, tree, tparams = models
    b, c, max_len = 2, 16, 64
    rs = np.random.RandomState(1)
    tokens = rs.randint(1, 64, (b, 48)).astype(np.int32)
    plen = np.array([48, 42])
    jcache = jpm.materialize(jtransformer.cache_defs(jcfg, b, max_len),
                             jax.random.PRNGKey(0))
    tcache = tpm.zeros(ttransformer.cache_defs(tcfg, b, max_len), "cpu")
    for off in (0, 16, 32):
        chunk = tokens[:, off:off + c]
        valid = (off + np.arange(c)[None, :] < plen[:, None]).astype(
            np.float32)
        li = np.minimum(plen - 1 - off, c - 1).astype(np.int32)
        jl, jcache = jlm.lm_prefill(tree, {"tokens": jnp.asarray(chunk)},
                                    jcache, jcfg, last_index=jnp.asarray(li),
                                    valid=jnp.asarray(valid), start_pos=off)
        tl, tcache = tlm.lm_prefill(
            tparams, {"tokens": torch.from_numpy(chunk)}, tcache, tcfg,
            last_index=torch.from_numpy(li), valid=torch.from_numpy(valid),
            start_pos=off)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        _assert_trees_close(tcache, jcache, 1e-5)


# ---------------------------------------------------------------------------
# SlotKVCache page operations
# ---------------------------------------------------------------------------

def _kv(tcfg, n_slots=3):
    return SlotKVCache(tcfg, n_slots=n_slots, max_len=32, device="cpu")


def _page(kv, value):
    return tpm.tree_map(lambda t: t.fill_(value), kv.new_page())


def _slot_vals(kv, slot):
    return [torch.unique(pool.select(ax, slot)).tolist()
            for ax, pool in zip(kv._axes, tpm.tree_leaves(kv.cache))]


def test_kv_cache_slot_ops(models):
    tcfg = models[1]
    kv = _kv(tcfg)
    for slot in range(3):
        kv.insert(slot, _page(kv, float(slot + 1)), length=8 + slot)
    for slot in range(3):
        assert all(v == [slot + 1] for v in _slot_vals(kv, slot))
    assert kv.lengths.tolist() == [8, 9, 10]
    kv.evict(1)
    assert all(v == [0] for v in _slot_vals(kv, 1))
    assert kv.lengths[1] == 0
    assert all(v == [1] for v in _slot_vals(kv, 0))
    kv.compact([2, 0, 1])
    assert all(v == [3] for v in _slot_vals(kv, 0))
    assert all(v == [1] for v in _slot_vals(kv, 1))
    assert kv.lengths.tolist() == [10, 8, 0]
    with pytest.raises(ValueError, match="permutation"):
        kv.compact([0, 0, 1])


def test_kv_cache_append_stages_partial_pages(models):
    """Intermediate appends stage (the pool is untouched), the last one
    copies into the pool, lengths only grow, release drops the stage."""
    tcfg = models[1]
    kv = _kv(tcfg, n_slots=2)
    before = [t.clone() for t in tpm.tree_leaves(kv.cache)]
    kv.append(0, _page(kv, 1.0), length=8, last=False)
    assert kv.staged(0) is not None and kv.lengths[0] == 8
    for a, b in zip(before, tpm.tree_leaves(kv.cache)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shrank"):
        kv.append(0, _page(kv, 2.0), length=4, last=False)
    kv.append(0, _page(kv, 2.0), length=16, last=True)
    assert kv.staged(0) is None and kv.lengths[0] == 16
    assert all(v == [2] for v in _slot_vals(kv, 0))
    kv.append(1, _page(kv, 3.0), length=8, last=False)
    kv.release(1)
    assert kv.lengths[1] == 0 and kv.staged(1) is None


def test_kv_cache_extract_is_a_copy_and_pages_stack(models):
    """``extract`` survives the next tenant's ``insert`` unchanged;
    ``stack_pages`` / ``split_pages`` round-trip, the stack a new
    tensor."""
    tcfg = models[1]
    kv = _kv(tcfg)
    kv.insert(0, _page(kv, 5.0), length=8)
    out = kv.extract(0)
    kv.insert(0, _page(kv, 7.0), length=8)
    assert all(torch.unique(t).tolist() == [5.0]
               for t in tpm.tree_leaves(out))
    pages = [_page(kv, float(i)) for i in range(3)]
    stacked = kv.stack_pages(pages)
    for d, t in zip(tpm.tree_leaves(kv.seq_defs), tpm.tree_leaves(stacked)):
        assert t.shape[d.axes.index("batch")] == 3
    parts = kv.split_pages(stacked, 2)
    assert len(parts) == 2
    for i, part in enumerate(parts):
        for a, b in zip(tpm.tree_leaves(part), tpm.tree_leaves(pages[i])):
            assert torch.equal(a, b)
    tpm.tree_leaves(pages[0])[0].fill_(9.0)        # the stack is a copy
    assert torch.unique(tpm.tree_leaves(parts[0])[0]).tolist() == [0.0]


# ---------------------------------------------------------------------------
# PrefixCache
# ---------------------------------------------------------------------------

def test_prefix_trie_hit_cap_alignment_and_covered():
    pc = PrefixCache(block=4, page_bytes=10)
    prompt = np.arange(14, dtype=np.int32)
    assert pc.probe(prompt) == 0
    assert pc.insert(prompt, "page0") == 3
    assert pc.n_pages == 1 and pc.bytes == 10
    hit, page, entry = pc.lookup(np.arange(12, dtype=np.int32))
    assert (hit, page) == (8, "page0")          # the tail keeps a token
    pc.unpin(entry)
    longer = np.concatenate([np.arange(12), [99, 98]]).astype(np.int32)
    assert pc.lookup(longer)[:2] == (12, "page0")
    div = np.concatenate([np.arange(8), [77, 77, 77, 77, 1]]).astype(np.int32)
    assert pc.probe(div) == 8
    assert pc.lookup(np.full(9, 55, np.int32)) == (0, None, None)
    assert pc.insert(np.arange(3, dtype=np.int32), "tiny") == 0
    assert pc.covered(np.arange(12, dtype=np.int32))
    assert not pc.covered(np.arange(16, dtype=np.int32))
    assert pc.insert(np.arange(16, dtype=np.int32), "p16") == 1
    assert pc.insert(np.arange(16, dtype=np.int32), "dup") == 0
    assert pc.covered(np.zeros(0, np.int32))


def test_prefix_pins_block_eviction_lru_order():
    pc = PrefixCache(block=4, page_bytes=10, max_bytes=20)
    pa, pb = np.arange(0, 8, dtype=np.int32), np.arange(8, 16, dtype=np.int32)
    pc.insert(pa, "A")
    pc.insert(pb, "B")
    hit, _, ea = pc.lookup(np.concatenate([pa, [1]]).astype(np.int32))
    assert hit == 8 and ea.pins == 1
    pc.insert(np.arange(16, 24, dtype=np.int32), "C")   # evicts B, not A
    assert pc.stats["evictions"] == 1 and ea.page == "A"
    assert pc.probe(np.concatenate([pb, [1]]).astype(np.int32)) == 0
    pc.unpin(ea)
    with pytest.raises(ValueError, match="refcount"):
        pc.unpin(ea)
    pc.insert(np.arange(24, 32, dtype=np.int32), "D")    # now A goes
    assert pc.n_pages == 2 and pc.bytes == 20
    assert len(pc.root.children) == 2                   # pruned
    pc.max_bytes = 5
    _, _, ec = pc.lookup(np.arange(16, 25, dtype=np.int32))
    _, _, ed = pc.lookup(np.arange(24, 33, dtype=np.int32))
    pc.insert(np.arange(100, 104, dtype=np.int32), "Q")  # all pinned
    assert pc.n_pages == 2 and ec.page == "C" and ed.page == "D"


@pytest.mark.parametrize("block,page_bytes,max_bytes,seed", PREFIX_GRID)
def test_prefix_cache_matches_reference(block, page_bytes, max_bytes, seed):
    """The same random insert / probe / lookup / covered / unpin trace
    through the reference's PrefixCache and the port's: every return
    value, the pins and ticks of returned entries, ``stats``, pages and
    bytes equal after every op."""
    rng = np.random.RandomState(seed)
    caches = (JPrefixCache(block, page_bytes, max_bytes),
              PrefixCache(block, page_bytes, max_bytes))
    alphabet = [rng.randint(0, 5, (block,)).astype(np.int32)
                for _ in range(4)]
    pinned = ([], [])

    def rand_prompt():
        parts = [alphabet[rng.randint(len(alphabet))]
                 for _ in range(rng.randint(0, 6))]
        parts.append(rng.randint(0, 5, (rng.randint(1, block + 1),)).astype(
            np.int32))
        return np.concatenate(parts)

    for n in range(150):
        op = rng.randint(4)
        if op == 0:
            prompt = rand_prompt()
            got = [pc.insert(prompt, n) for pc in caches]
        elif op == 1:
            prompt = rand_prompt()
            got = []
            for pc, pins in zip(caches, pinned):
                probe = pc.probe(prompt)
                hit, page, entry = pc.lookup(prompt)
                got.append((probe, hit, page, entry is None,
                            None if entry is None else (entry.pins,
                                                        entry.tick)))
                if entry is not None:
                    pins.append(entry)
        elif op == 2:
            prompt = rand_prompt()
            got = [pc.covered(prompt) for pc in caches]
        elif pinned[0]:
            i = rng.randint(len(pinned[0]))
            got = [pc.unpin(pins.pop(i)) for pc, pins in zip(caches, pinned)]
        else:
            continue
        assert got[0] == got[1], (n, op, got)
        want, have = caches
        assert have.stats == want.stats
        assert (have.n_pages, have.bytes) == (want.n_pages, want.bytes)
        assert [e.pins for e in pinned[1]] == [e.pins for e in pinned[0]]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _matrix_trace(vocab):
    rs = np.random.RandomState(2)
    return [(rs.randint(1, vocab, (n,)).astype(np.int32), m, a)
            for n, m, a in MATRIX_TRACE]


def _serve(engine, trace):
    reqs = [engine.submit(p, m, arrival=a) for p, m, a in trace]
    engine.run()
    assert all(r.done for r in reqs)
    return [r.tokens for r in reqs], engine.stats


def _engines(jcfg, tcfg, tree, tparams, **kw):
    return (jengine.ServeEngine(tree, jcfg.replace(kernel_backend="ref"),
                                jengine.ServeConfig(**kw)),
            tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(**kw),
                                device="cpu"))


@pytest.mark.parametrize("policy", ["noisy_topk", "expert_choice"])
def test_chunked_engine_matches_jax(models, policy):
    """The reference's serving matrix trace under CHUNK_KW: greedy
    streams and every stat equal; the long prompts went through several
    chunk offsets."""
    _, _, tree, tparams = models
    jcfg, tcfg = _configs(policy)
    trace = _matrix_trace(jcfg.vocab_size)
    jeng, teng = _engines(jcfg, tcfg, tree, tparams, max_len=64, n_slots=3,
                          **CHUNK_KW)
    jtok, jstats = _serve(jeng, trace)
    ttok, tstats = _serve(teng, trace)
    assert ttok == jtok
    assert tstats == jstats
    assert tstats["prefill_chunks"] >= 5
    assert teng.chunk_offsets == jeng.chunk_offsets >= {0, 16, 32}
    # every call is timed, the short prompts' whole-prompt ones apart
    assert len(teng.step_times["chunk"]) + len(teng.step_times["prefill"]) \
        == tstats["prefill_calls"] > len(teng.step_times["chunk"])


def test_chunked_engine_matches_whole_prompt_engine(models):
    """No call overflows at this capacity, so chunking leaves the
    streams as whole-prompt prefill gives them."""
    _, tcfg, _, tparams = models
    trace = _matrix_trace(tcfg.vocab_size)
    out = []
    for kw in (CHUNK_KW, {}):
        eng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
            max_len=64, n_slots=3, **kw), device="cpu")
        out.append(_serve(eng, trace))
    (ctok, cstats), (wtok, wstats) = out
    assert ctok == wtok
    assert cstats["prefill_chunks"] >= 5 and wstats["prefill_chunks"] == 0
    assert cstats["prefill_tokens"] == wstats["prefill_tokens"]


def _shared_prefix_trace(vocab, n=5):
    """The reference's: request 0 retires before the rest arrive, so its
    page seeds the trie for every later request."""
    rs = np.random.RandomState(3)
    shared = rs.randint(1, vocab, (32,)).astype(np.int32)
    return [(np.concatenate([shared,
                             rs.randint(1, vocab, (8,)).astype(np.int32)]),
             4, 0 if i == 0 else 12 + i) for i in range(n)]


def _leaves_np(page):
    return [t.detach().clone().numpy() for t in tpm.tree_leaves(page)]


@pytest.mark.parametrize("mode", ["off", "on", "tiny"])
def test_prefix_cache_engine_matches_jax(models, mode):
    """The shared-prefix trace with the cache off, on, and on with a
    one-page budget: streams and stats equal the JAX engine's (hits,
    hit tokens, calls, chunks), the pins all released, the trie's pages
    equal the reference's, and the shared prefix's page is bit for bit
    the page retirement stored, after every later hit's tail chunk."""
    jcfg, tcfg, tree, tparams = models
    trace = _shared_prefix_trace(jcfg.vocab_size)
    kw = dict(max_len=64, n_slots=4, **CHUNK_KW)
    if mode != "off":
        page_bytes = tpm.param_bytes(ttransformer.cache_defs(tcfg, 1, 64))
        kw.update(prefix_cache=True,
                  prefix_cache_bytes=page_bytes if mode == "tiny" else 1 << 30)
    jeng, teng = _engines(jcfg, tcfg, tree, tparams, **kw)
    jtok, jstats = _serve(jeng, trace)
    reqs = [teng.submit(p, m, arrival=a) for p, m, a in trace]
    stored = None
    while teng.queue or teng.sched.active():
        teng.step()
        if stored is None and teng.prefix is not None and teng.prefix.n_pages:
            first = teng.prefix._entries[0]
            stored = _leaves_np(first.page)
    assert [r.tokens for r in reqs] == jtok
    assert teng.stats == jstats
    if mode == "off":
        assert teng.prefix is None and jstats["prefix_hits"] == 0
        return
    assert jstats["prefix_hits"] == len(trace) - 1
    assert jstats["prefix_hit_tokens"] == 32 * (len(trace) - 1)
    assert teng._pins == {}
    assert all(e.pins == 0 for e in teng.prefix._entries)
    assert teng.prefix.stats == jeng.prefix.stats
    assert teng.prefix.bytes == jeng.prefix.bytes
    if mode == "tiny":
        assert teng.prefix.bytes <= teng.prefix.page_bytes
    assert first.page is not None
    for a, b in zip(_leaves_np(first.page), stored):
        np.testing.assert_array_equal(a, b)
    for te, je in zip(teng.prefix._entries, jeng.prefix._entries):
        _assert_trees_close(te.page, je.page, 1e-5)


def test_cross_slot_batched_prefill(models):
    """Four 32-token prompts admitted together march through the chunk
    offsets in lockstep: 8 chunks in 2 calls of 4 rows, the streams
    those of one-slot whole-prompt serving."""
    _, tcfg, _, tparams = models
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, tcfg.vocab_size, (32,)).astype(np.int32)
               for _ in range(4)]
    eng = tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(
        max_len=64, n_slots=4, prefill_chunk=16), device="cpu")
    reqs = [eng.submit(p, 3) for p in prompts]
    eng.run()
    assert eng.stats["prefill_chunks"] == 8
    assert eng.stats["prefill_calls"] == 2
    assert eng.chunk_offsets == {0, 16}
    oracle = tengine.ServeEngine(tparams, tcfg,
                                 tengine.ServeConfig(max_len=64, n_slots=1),
                                 device="cpu")
    for p, req in zip(prompts, reqs):
        oracle.reset()
        ref = oracle.submit(p, 3)
        oracle.run()
        assert ref.tokens == req.tokens


def test_moa_demo_chunked_engine_matches_jax(moa):
    """moa-demo (MoA mixers) with chunks of its kv_block (32) and the
    prefix cache: streams and stats equal the JAX engine's."""
    jcfg, tcfg, tree, tparams = moa
    rs = np.random.RandomState(6)
    shared = rs.randint(1, jcfg.vocab_size, (32,))
    trace = [(np.concatenate([shared, rs.randint(1, jcfg.vocab_size, (n,))]
                             ).astype(np.int32), m, a)
             for n, m, a in ((40, 3, 0), (8, 3, 0), (20, 4, 8))]
    jeng, teng = _engines(jcfg, tcfg, tree, tparams, max_len=96, n_slots=2,
                          prefill_chunk=32, prefill_budget=64,
                          admission="aware", prefix_cache=True)
    jtok, jstats = _serve(jeng, trace)
    ttok, tstats = _serve(teng, trace)
    assert ttok == jtok
    assert tstats == jstats
    assert tstats["prefill_chunks"] >= 4 and tstats["prefix_hits"] >= 1


# ---------------------------------------------------------------------------
# construction and submit errors, the launcher
# ---------------------------------------------------------------------------

def test_construction_and_submit_errors(models):
    _, tcfg, _, tparams = models

    def engine(**kw):
        return tengine.ServeEngine(tparams, tcfg, tengine.ServeConfig(**kw),
                                   device="cpu")
    with pytest.raises(ValueError, match="multiple of kv_block"):
        engine(max_len=64, prefill_chunk=8)
    with pytest.raises(ValueError, match="max_len"):
        engine(max_len=16, n_slots=2, prefill_chunk=32)
    with pytest.raises(ValueError, match="prefix_cache"):
        engine(max_len=32, n_slots=2, prefix_cache=True)
    # the chunk-rounded prompt must fit the page
    eng = engine(max_len=56, n_slots=2, prefill_chunk=16)
    eng.submit(np.full((48,), 1, np.int32), 4)
    with pytest.raises(ValueError, match="chunk-padded"):
        eng.submit(np.full((50,), 1, np.int32), 4)
    assert eng.submit(np.full((12,), 1, np.int32), 40).prompt_len == 12
    for bad in (0, -3):
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit(np.arange(1, 9, dtype=np.int32), bad)
    # without chunks a prompt over the budget is refused at submit
    eng = engine(max_len=64, n_slots=2, prefill_budget=32)
    with pytest.raises(ValueError, match="prefill budget"):
        eng.submit(np.arange(1, 40, dtype=np.int32), 2)
    # with them it is split
    eng = engine(max_len=64, n_slots=2, prefill_budget=32, prefill_chunk=16)
    req = eng.submit(np.arange(1, 40, dtype=np.int32), 2)
    eng.run()
    assert req.done and eng.stats["prefill_chunks"] == 3


def test_chunked_cache_dtype_warning_and_unported_architectures():
    tcfg = tget_config("kimi-k2-1t-a32b", param_dtype=torch.bfloat16,
                       compute_dtype=torch.float32, q_block=16, kv_block=16,
                       **SMALL)
    params = tpm.zeros(tlm.lm_defs(tcfg), "cpu")
    with pytest.warns(RuntimeWarning, match="cache precision"):
        tengine.ServeEngine(params, tcfg, tengine.ServeConfig(
            max_len=32, n_slots=2, prefill_chunk=16), device="cpu")
    # mamba mixers: both engines refuse chunking with a warning, fall
    # back to whole prompts and serve the same greedy streams
    jcfg, tcfg = (c.replace(family="ssm", ssm_d_state=4) for c in _configs())
    tree = jax.tree_util.tree_map(np.asarray, jpm.materialize(
        jlm.lm_defs(jcfg), jax.random.PRNGKey(1)))
    kw = dict(max_len=48, n_slots=2, prefill_chunk=16)
    with pytest.warns(RuntimeWarning, match="chunked prefill"):
        teng = tengine.ServeEngine(from_jax_tree(tree, device="cpu"), tcfg,
                                   tengine.ServeConfig(**kw), device="cpu")
    with pytest.warns(RuntimeWarning, match="chunked prefill"):
        jeng = jengine.ServeEngine(tree, jcfg, jengine.ServeConfig(**kw))
    assert teng._chunk == jeng._chunk == 0
    rs = np.random.RandomState(7)
    trace = [(rs.randint(1, jcfg.vocab_size, (n,)), m, a)
             for n, m, a in MATRIX_TRACE]
    streams = []
    for eng in (teng, jeng):
        reqs = [eng.submit(p, m, arrival=a) for p, m, a in trace]
        eng.run()
        streams.append([list(r.tokens) for r in reqs])
    assert streams[0] == streams[1]
    assert teng.stats["prefill_chunks"] == 0
    with pytest.raises(ValueError, match="attention mixers"):
        ttransformer.block_prefill(
            {"ln1": {"scale": torch.ones(4)}}, torch.zeros(1, 2, 4),
            ttransformer.LayerKind("mamba", "dense"), tcfg, {},
            torch.arange(2)[None], start_pos=2)


def test_serve_launcher_prints_prefix_hits(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", "kimi-k2-1t-a32b", "--reduce", "--device", "cpu",
                 "--requests", "3", "--new-tokens", "4", "--stagger", "6",
                 "--prompt-len", "48", "--prefill-chunk", "32",
                 "--prefill-budget", "64", "--admission", "aware",
                 "--prefix-cache", "--shared-prefix", "32"])
    out = capsys.readouterr().out
    assert "chunked prefill: chunk=32" in out
    assert "prefix cache: 2 hits / 3 lookups, 64 prompt tokens reused" in out
