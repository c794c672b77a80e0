"""SlotKVCache: the per-slot decode-cache pool behind continuous batching
(counterpart of ``repro.serve.kv_cache.SlotKVCache``).

``transformer.cache_defs(cfg, n_slots, max_len)`` declares one cache page
per slot, stacked on the batch axis; the batch axis of each leaf is
found from its ParamDef axes (stacked leaves carry a leading "layers"
axis).  Slot operations write the pool in place.  The shared-prefix
``PrefixCache`` and the slot operations only it needs (evict, compact,
extract, page stacking) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import param as pm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class SlotKVCache:
    """Fixed pool of per-sequence cache pages with slot-indexed updates."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 device: torch.device):
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
        self.cache = pm.zeros(self.defs, device)
        self.lengths = np.zeros((n_slots,), np.int64)

    def new_page(self):
        """A blank batch-1 page for one prefill."""
        return pm.zeros(self.seq_defs, self.device)

    def _pairs(self, tree):
        return zip(self._axes, pm.tree_leaves(self.cache),
                   pm.tree_leaves(tree))

    def insert(self, slot: int, seq_cache, length: int) -> None:
        """Copy a prefilled batch-1 page into ``slot`` (the whole page, so
        stale data from the previous tenant cannot leak)."""
        for ax, pool, page in self._pairs(seq_cache):
            pool.select(ax, slot).copy_(page.select(ax, 0))
        self.lengths[slot] = length

    def release(self, slot: int) -> None:
        """Logical free: the next insert overwrites the page in full."""
        self.lengths[slot] = 0
