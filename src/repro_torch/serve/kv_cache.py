"""SlotKVCache and PrefixCache: the per-slot decode-cache pool behind
continuous batching and the shared-prefix radix cache of finished pages
(counterparts of ``repro.serve.kv_cache``).

``transformer.cache_defs(cfg, n_slots, max_len)`` declares one cache page
per slot, stacked on the batch axis; the batch axis of each leaf is
found from its ParamDef axes (stacked leaves carry a leading "layers"
axis).  A page is a tree of tensors in ``seq_defs``' (batch-1) layout.

The reference's pages are immutable jax arrays, so it hands pages around
by reference.  Here slot operations and prefill write their tensors in
place, so every hand-over that the reference makes by aliasing is a copy
where a later in-place write could reach it: ``extract`` returns a copy
(the slot is overwritten by its next tenant), ``insert`` copies into the
pool, and the serving engine stages a copy of a prefix hit's page (the
tail chunk writes into the page it resumes from).

On a mesh (``ctx``, the serving decode plan fitted to the pool by
:func:`fit_decode_plan`) the pool lives on that plan: each rank holds
the slots its ``batch`` axes give it (slots ``[i * n_local, (i + 1) *
n_local)`` on the rank at coordinate i) and, of each page, the
positions its ``kv_seq`` axes give it, of a sliding-window ring the
slots its ``kv_ring`` axes give it (none where its length does not
divide); a mamba mixer's scan and conv state has no positions and stays
whole.  Pages handed
around outside the pool (prefill's, staged chunk pages, the prefix
cache's) are whole: ``insert`` and ``append(last=True)`` take a page
already resharded onto the decode plan (the engine's ``serve.reshard``),
only the rank that owns the slot stores it, and ``extract`` gathers a
slot's page back to whole on every rank.

``PrefixCache`` is pure host code, a line-for-line copy of the
reference's (whose module imports jax, so the port keeps its own).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import param as pm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def fit_decode_plan(ctx, defs):
    """The decode plan of ``ctx`` fitted to a pool whose cache ParamDefs
    are ``defs``, the one place that decides the pool's layout:
    ``batch`` (the slots), ``kv_seq`` (the pages' positions) and
    ``kv_ring`` (a sliding-window ring's slots, which resolves as a page
    of its length would) each mapped to the mesh axes that hold for
    every leaf that has it, as the reference's per-leaf resolution falls
    back where a length does not divide; the mamba state's
    ``ssm_inner``, ``ssm_state`` and ``conv`` whole, so every rank steps
    its slots' whole state, where the reference's ``decode_std`` splits
    ``ssm_inner`` over ``model``.  The model's decode and the pool read
    their layout from the fitted plan."""
    leaves = pm.tree_leaves(defs)
    table = dict(ctx.rules.table, ssm_inner=(), ssm_state=(), conv=())
    for name, like in (("batch", "batch"), ("kv_seq", "kv_seq"),
                       ("kv_ring", "kv_seq")):
        # Each resolution is a prefix of the plan's axes for ``like``:
        # the shortest holds for every leaf.
        table[name] = min((ctx.resolve(d.shape, tuple(
            like if a == name else a for a in d.axes))[d.axes.index(name)]
            for d in leaves if name in d.axes), key=len, default=())
    return ctx.with_plan(dataclasses.replace(ctx.rules, table=table))


class SlotKVCache:
    """Fixed pool of per-sequence cache pages with slot-indexed updates."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 device: torch.device, ctx=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = device
        self.defs = transformer.cache_defs(cfg, n_slots, max_len)
        # Per-sequence (batch-1) layout: what prefill fills and insert
        # consumes.
        self.seq_defs = transformer.cache_defs(cfg, 1, max_len)
        self._axes = [d.axes.index("batch")
                      for d in pm.tree_leaves(self.defs)]
        self._seq = [next((d.axes.index(a) for a in ("kv_seq", "kv_ring")
                           if a in d.axes), None)
                     for d in pm.tree_leaves(self.defs)]
        self.ctx = ctx if ctx is not None and ctx.mesh is not None else None
        # The mesh axes that split the slots and the pages' positions
        # (each leaf's own in _seq_axes: a ring's may be fewer), this
        # rank's slot count and its first slot.
        self.slot_axes: tuple[str, ...] = ()
        self.seq_axes: tuple[str, ...] = ()
        self._seq_axes = [()] * len(self._seq)
        self.n_local, self.first_slot = n_slots, 0
        defs = self.defs
        if self.ctx is not None:
            specs = [self.ctx.resolve(d.shape, d.axes)
                     for d in pm.tree_leaves(self.defs)]
            self.slot_axes = specs[0][self._axes[0]]
            self._seq_axes = [() if seq is None else spec[seq]
                              for seq, spec in zip(self._seq, specs)]
            self.seq_axes = self.ctx.axes_of("kv_seq")
            self.n_local = n_slots // self.ctx.size(self.slot_axes)
            self.first_slot = self.ctx.index(self.slot_axes) * self.n_local
            defs = pm.tree_map(self._local_def, self.defs)
        self.cache = pm.zeros(defs, device)
        self.lengths = np.zeros((n_slots,), np.int64)
        # In-flight partial pages (chunked prefill), staged per slot and
        # copied into the pool only when the prompt completes.
        self._staged: dict[int, object] = {}

    def _local_def(self, d: pm.ParamDef) -> pm.ParamDef:
        """A pool leaf's def cut to this rank's slice by the plan."""
        spec = self.ctx.resolve(d.shape, d.axes)
        shape = tuple(n // self.ctx.size(axes)
                      for n, axes in zip(d.shape, spec))
        return pm.ParamDef(shape, d.axes, init=d.init, dtype=d.dtype)

    def _local_slot(self, slot: int) -> int | None:
        """The slot's index in this rank's pool, None if another rank
        holds it."""
        i = slot - self.first_slot
        return i if 0 <= i < self.n_local else None

    def new_page(self):
        """A blank batch-1 page for one prefill (whole, on a mesh too)."""
        return pm.zeros(self.seq_defs, self.device)

    @property
    def page_bytes(self) -> int:
        """Bytes of one whole batch-1 page (every leaf of ``seq_defs``)."""
        return pm.param_bytes(self.seq_defs)

    def _unflatten(self, leaves):
        it = iter(leaves)
        return pm.tree_map(lambda _: next(it), self.seq_defs)

    def _pairs(self, tree):
        return zip(self._axes, pm.tree_leaves(self.cache),
                   pm.tree_leaves(tree))

    def reshard(self, page):
        """A whole page relaid onto the decode plan (each rank keeps its
        positions of it); off a mesh the page itself."""
        if self.ctx is None:
            return page
        return self.ctx.reshard(page, self.seq_defs)

    def insert(self, slot: int, seq_cache, length: int) -> None:
        """Copy a prefilled batch-1 page into ``slot`` (the whole page, so
        stale data from the previous tenant cannot leak).  On a mesh the
        page is already resharded onto the decode plan, and only the
        rank that holds the slot stores it."""
        i = self._local_slot(slot)
        if i is not None:
            for ax, pool, page in self._pairs(seq_cache):
                pool.select(ax, i).copy_(page.select(ax, 0))
        self.lengths[slot] = length
        self._staged.pop(slot, None)

    def append(self, slot: int, seq_cache, length: int, *,
               last: bool = True) -> None:
        """Deliver a partial-prompt batch-1 page for ``slot`` (chunked
        prefill: each page holds the prompt prefix [0, length)).
        Intermediate pages are staged (whole, on a mesh too), and the
        next chunk resumes from :meth:`staged`; ``last=True`` copies the
        finished page, resharded on a mesh, into the pool.  A shrinking
        ``length`` means an earlier chunk was replayed over a later page,
        so it raises (a real exception, which ``python -O`` keeps)."""
        if length < self.lengths[slot]:
            raise ValueError(
                f"append shrank slot {slot}: {length} < "
                f"{self.lengths[slot]} (chunk replayed over a later page)")
        if last:
            self.insert(slot, seq_cache, length)
        else:
            self._staged[slot] = seq_cache
            self.lengths[slot] = length

    def staged(self, slot: int):
        """The slot's in-flight partial page (None when no chunked
        prefill is in flight)."""
        return self._staged.get(slot)

    def release(self, slot: int) -> None:
        """Logical free: the next insert overwrites the page in full."""
        self.lengths[slot] = 0
        self._staged.pop(slot, None)

    def evict(self, slot: int) -> None:
        """Zero a slot's page (release plus hygiene)."""
        i = self._local_slot(slot)
        if i is not None:
            for ax, pool in zip(self._axes, pm.tree_leaves(self.cache)):
                pool.select(ax, i).zero_()
        self.release(slot)

    def compact(self, perm) -> None:
        """Permute slots: page i of the new pool is page perm[i] of the
        old one (one process, or slots that no mesh axis splits)."""
        perm = np.asarray(perm)
        if sorted(perm.tolist()) != list(range(self.n_slots)):
            # A gather by a non-permutation would duplicate one page and
            # drop another.
            raise ValueError(f"compact perm {perm} is not a permutation "
                             f"of range({self.n_slots})")
        if self.n_local != self.n_slots:
            raise NotImplementedError(
                "compact across ranks: the slots are split over "
                f"{self.slot_axes}")
        idx = torch.as_tensor(perm, dtype=torch.long, device=self.device)
        leaves = [pool.index_select(ax, idx) for ax, pool in
                  zip(self._axes, pm.tree_leaves(self.cache))]
        it = iter(leaves)
        self.cache = pm.tree_map(lambda _: next(it), self.cache)
        self.lengths = self.lengths[perm]
        self._staged = {i: self._staged[int(p)] for i, p in enumerate(perm)
                        if int(p) in self._staged}

    def extract(self, slot: int):
        """A copy of one slot's page as a whole batch-1 page (the
        retirement path of the shared-prefix cache).  A copy, not a
        view: the next tenant's ``insert`` overwrites the slot in place.
        On a mesh every rank calls it and gets the whole page: the
        holder's over the slot axes, the positions gathered over the
        sequence axes."""
        if self.ctx is None:
            return self._unflatten(
                pool.narrow(ax, slot, 1).clone()
                for ax, pool in zip(self._axes, pm.tree_leaves(self.cache)))
        owner, i = divmod(slot, self.n_local)
        leaves = []
        for ax, seq, seq_axes, pool in zip(self._axes, self._seq,
                                           self._seq_axes,
                                           pm.tree_leaves(self.cache)):
            page = pool.narrow(ax, i, 1).clone()
            if self.slot_axes:
                page = self.ctx.all_gather(page, self.slot_axes, ax).narrow(
                    ax, owner, 1)
            if seq_axes:
                page = self.ctx.all_gather(page, seq_axes, seq)
            leaves.append(page.contiguous())
        return self._unflatten(leaves)

    def stack_pages(self, pages: list):
        """Concatenate G batch-1 pages into one batch-G page (a new
        tensor per leaf): the input of a cross-slot batched chunk call."""
        per_page = [pm.tree_leaves(p) for p in pages]
        return self._unflatten(
            torch.cat([leaves[i] for leaves in per_page], dim=ax)
            for i, ax in enumerate(self._axes))

    def split_pages(self, batched, g: int) -> list:
        """The first ``g`` rows of a batch-G page as batch-1 pages.  They
        are views of ``batched``; as staged pages they are safe, since
        the next round either stacks them into a new tensor or resumes a
        single row by writing into that row's view alone."""
        leaves = pm.tree_leaves(batched)
        return [self._unflatten(leaf.narrow(ax, i, 1)
                                for ax, leaf in zip(self._axes, leaves))
                for i in range(g)]


# ---------------------------------------------------------------------------
# Shared-prefix radix cache
# ---------------------------------------------------------------------------

class _TrieNode:
    """One prompt block (``block`` tokens) on a radix path.  ``entry`` is
    the cached page covering the prompt prefix [0, depth*block); nodes on
    one path may share an entry (a deep page covers every shallower
    prefix on its own path)."""

    __slots__ = ("key", "parent", "children", "entry", "depth")

    def __init__(self, key: bytes | None, parent: "_TrieNode | None"):
        self.key = key
        self.parent = parent
        self.children: dict[bytes, _TrieNode] = {}
        self.entry: _PageEntry | None = None
        self.depth = 0 if parent is None else parent.depth + 1


class _PageEntry:
    """One cached page and its bookkeeping: the trie nodes that point at
    it, the pin refcount (in-flight prefills that resumed from it) and
    the LRU tick.  Pinned entries are never evicted."""

    __slots__ = ("page", "nodes", "pins", "tick")

    def __init__(self, page, nodes: list, tick: int):
        self.page = page
        self.nodes = nodes
        self.pins = 0
        self.tick = tick


class PrefixCache:
    """Refcounted, block-aligned radix cache of finished KV pages.

    The trie is keyed by ``block``-token prompt blocks (the engine passes
    its chunk size, so hits land on the chunk grid and a resumed prefill
    replays the chunk calls a cold one would).  ``lookup`` pins the
    longest cached block-aligned prefix strictly shorter than the
    prompt: the tail keeps at least one token, whose logits sample the
    first token.

    The cache hands out its stored page; a caller that writes into what
    it resumes from must copy it first (the engine does).  Pins are the
    accounting that keeps an entry alive while a prefill that resumed
    from it is in flight.

    Eviction: LRU over entries under ``max_bytes`` (``<= 0`` =
    unlimited), ``page_bytes`` charged per stored page.  Freeing an
    entry detaches it from its nodes and prunes childless, entryless
    nodes.  Pages are opaque objects.
    """

    def __init__(self, block: int, page_bytes: int, max_bytes: int = 0):
        if block <= 0:
            raise ValueError(f"block must be positive, got {block}")
        self.block = block
        self.page_bytes = int(page_bytes)
        self.max_bytes = int(max_bytes)
        self.root = _TrieNode(None, None)
        self._entries: list[_PageEntry] = []
        self._tick = 0
        self.stats = {"hits": 0, "misses": 0, "hit_tokens": 0,
                      "inserts": 0, "evictions": 0}

    # -- bookkeeping ------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return len(self._entries)

    @property
    def bytes(self) -> int:
        return len(self._entries) * self.page_bytes

    def _keys(self, prompt, n_blocks: int) -> list[bytes]:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        b = self.block
        return [prompt[i * b:(i + 1) * b].tobytes()
                for i in range(n_blocks)]

    def _walk(self, prompt, n_blocks: int):
        """Deepest entry on the prompt's path within ``n_blocks`` blocks:
        ``(entry, depth_in_blocks)``, ``(None, 0)`` when none."""
        node, best, depth = self.root, None, 0
        for key in self._keys(prompt, n_blocks):
            node = node.children.get(key)
            if node is None:
                break
            if node.entry is not None:
                best, depth = node.entry, node.depth
        return best, depth

    # -- read path --------------------------------------------------------
    def probe(self, prompt) -> int:
        """Hit length (tokens) a :meth:`lookup` would return, without
        pinning (prefix-aware admission charges only the tail)."""
        plen = int(np.asarray(prompt).shape[-1])
        _, depth = self._walk(prompt, (plen - 1) // self.block)
        return depth * self.block

    def lookup(self, prompt):
        """Longest cached block-aligned strict prefix of ``prompt``:
        ``(hit_tokens, page, entry)``, ``(0, None, None)`` on a miss.  The
        entry is pinned; the caller unpins it once its prefill no longer
        reads the page.  The hit is capped at ``((plen - 1) // block) *
        block``."""
        plen = int(np.asarray(prompt).shape[-1])
        best, depth = self._walk(prompt, (plen - 1) // self.block)
        if best is None:
            self.stats["misses"] += 1
            return 0, None, None
        self._tick += 1
        best.tick = self._tick
        best.pins += 1
        hit = depth * self.block
        self.stats["hits"] += 1
        self.stats["hit_tokens"] += hit
        return hit, best.page, best

    def unpin(self, entry: _PageEntry) -> None:
        if entry.pins <= 0:
            raise ValueError("unpin would drive a refcount negative "
                             "(double unpin of a prefix-cache entry)")
        entry.pins -= 1

    # -- write path -------------------------------------------------------
    def covered(self, prompt) -> bool:
        """True when every block of the prompt's aligned prefix has a
        cached entry (retirement skips the page copy then)."""
        plen = int(np.asarray(prompt).shape[-1])
        n_blocks = plen // self.block
        if n_blocks == 0:
            return True
        node = self.root
        for key in self._keys(prompt, n_blocks):
            node = node.children.get(key)
            if node is None or node.entry is None:
                return False
        return True

    def insert(self, prompt, page) -> int:
        """Cache ``page`` (K/V of prompt positions [0, plen); decode
        positions past the prompt ride along unread) under the prompt's
        block-aligned prefix.  Only nodes without an entry adopt it;
        a fully covered prefix stores nothing.  Returns the number of
        newly covered blocks."""
        plen = int(np.asarray(prompt).shape[-1])
        n_blocks = plen // self.block
        if n_blocks == 0:
            return 0
        node, missing = self.root, []
        self._tick += 1
        for key in self._keys(prompt, n_blocks):
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(key, node)
                node.children[key] = child
            if child.entry is None:
                missing.append(child)
            else:
                child.entry.tick = self._tick   # touch: the path is hot
            node = child
        if not missing:
            return 0
        entry = _PageEntry(page, missing, self._tick)
        for n in missing:
            n.entry = entry
        self._entries.append(entry)
        self.stats["inserts"] += 1
        self._evict_to_budget()
        return len(missing)

    # -- eviction ---------------------------------------------------------
    def _evict_to_budget(self) -> None:
        if self.max_bytes <= 0:
            return
        while self.bytes > self.max_bytes:
            victims = [e for e in self._entries if e.pins == 0]
            if not victims:
                return      # everything pinned: overshoot, never corrupt
            self._free(min(victims, key=lambda e: e.tick))
            self.stats["evictions"] += 1

    def _free(self, entry: _PageEntry) -> None:
        self._entries.remove(entry)
        for node in entry.nodes:
            node.entry = None
            self._prune(node)
        entry.nodes = []
        entry.page = None

    def _prune(self, node: _TrieNode) -> None:
        """Drop childless, entryless nodes bottom-up."""
        while (node is not None and node.parent is not None
               and not node.children and node.entry is None):
            parent = node.parent
            del parent.children[node.key]
            node = parent
