"""Deterministic, seekable synthetic LM data pipeline (a copy of
``repro.data.pipeline``: numpy throughout, int64 tensors on the
requested device at the end).

Fault-tolerance requirement: after a restart at step N, the pipeline must
produce *exactly* the batch it would have produced without the failure.
Every batch is a pure function of (seed, step), so "resume" is just setting
the step counter — no iterator state to snapshot beyond one integer (which
the trainer stores in the checkpoint manifest).

The generator is a **mixture of latent sub-languages** — each sequence
samples a cluster c and follows that cluster's affine bigram rule
``next = (mult_c * prev + add_c) % vocab`` with occasional uniform noise.
More clusters ⇒ more memorizable structure ⇒ model *capacity* (not compute)
determines achievable perplexity.  This gives the Figure-2-left
reproduction a real capacity axis on CPU-scale models: MoEs with more
experts reach lower perplexity at matched ops/timestep (see
benchmarks/capacity_scaling.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32_000
    seq_len: int = 128
    batch_size: int = 32
    n_clusters: int = 256       # latent sub-languages (capacity knob)
    noise_prob: float = 0.05
    seed: int = 0


def _cluster_tables(dc: DataConfig) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(dc.seed ^ 0x5EED)
    # Odd multipliers are invertible mod 2^k-ish vocab; any value works as a
    # deterministic rule, oddness just avoids degenerate cycles.
    mult = rng.randint(1, dc.vocab_size, size=dc.n_clusters) | 1
    add = rng.randint(0, dc.vocab_size, size=dc.n_clusters)
    return mult, add


def batch_at(dc: DataConfig, step: int, *, device="cuda") -> dict:
    """The batch for a given step — pure function of (config, step)."""
    mult, add = _cluster_tables(dc)
    rng = np.random.RandomState((dc.seed * 1_000_003 + step) % (2**31 - 1))
    b, s = dc.batch_size, dc.seq_len
    clusters = rng.randint(0, dc.n_clusters, size=b)
    toks = np.zeros((b, s + 1), np.int64)
    toks[:, 0] = rng.randint(0, dc.vocab_size, size=b)
    m = mult[clusters][:, None]
    a = add[clusters][:, None]
    noise = rng.rand(b, s) < dc.noise_prob
    rand_tok = rng.randint(0, dc.vocab_size, size=(b, s))
    for t in range(s):
        nxt = (toks[:, t] * mult[clusters] + add[clusters]) % dc.vocab_size
        toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
    dev = resolve_device(device)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


class DataIterator:
    """Stateful wrapper with exact-resume semantics."""

    def __init__(self, dc: DataConfig, start_step: int = 0, *,
                 device="cuda"):
        self.dc = dc
        self.step = start_step
        self.device = device

    def __next__(self) -> dict:
        batch = batch_at(self.dc, self.step, device=self.device)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])


def optimal_xent(dc: DataConfig) -> float:
    """Entropy floor of the generator (for benchmark calibration): a model
    that has memorized every cluster rule still faces the noise."""
    p_noise = dc.noise_prob
    # With prob (1-p)+p/V the next token is the rule token; else uniform.
    p_rule = (1 - p_noise) + p_noise / dc.vocab_size
    h = -(p_rule * np.log(p_rule)
          + (dc.vocab_size - 1) * (p_noise / dc.vocab_size)
          * np.log(p_noise / dc.vocab_size))
    return float(h)
