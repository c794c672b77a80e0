"""Roofline terms of a step on one NVIDIA H100 (counterpart of
``repro.launch.roofline``).

Per (arch x shape x mesh) cell, from the analytic per-device counts of
``launch/analytic.py``:

    compute term    = FLOPs / peak FLOP/s of the compute dtype
    memory term     = HBM bytes / HBM bandwidth
    collective term = wire bytes / NVLink bandwidth a direction

The bound of a step is the largest of the three.  Also MODEL_FLOPS
(6 N_active tokens for training, 2 N_active tokens for inference,
embeddings excluded) and MODEL_FLOPS / counted FLOPs, the "useful
compute" fraction that shows remat recompute and capacity padding.

The reference parses collective bytes out of XLA's HLO text
(``parse_collectives``); the port has no HLO, and its wire bytes come
from the analytic count alone.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, count_params

# NVIDIA H100 SXM5 80GB, the data sheet's figures at its 700 W power
# limit (a card set lower runs slower under load).  Dense tensor-core
# peaks for bf16 and tf32 (3xTF32 spends the tf32 rate three times per
# f32 product); "float32" is the CUDA cores' rate.  NVLink 4: the data
# sheet's 900 GB/s a GPU is both directions together, so a card sends
# at 450 GB/s.
H100 = {
    "name": "h100-sxm",
    "hbm_bandwidth": 3.35e12,          # bytes/s
    "peak_flops": {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12},
    "nvlink_bandwidth": 450e9,         # bytes/s a direction
    "hbm_bytes": 80 * 2**30,           # the 80 GB card's memory
}


def peak_flops(dtype: torch.dtype) -> float:
    """The card's dense peak FLOP/s for products in ``dtype``."""
    return H100["peak_flops"][str(dtype).removeprefix("torch.")]


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    flops_per_dev: float
    useful_ratio: float
    bound_step_s: float
    peak_flops: float          # of the compute dtype, per device


def model_flops(cfg: ModelConfig, kind: str, global_batch: int,
                seq_len: int) -> float:
    """6 N_active D (train) / 2 N_active D (prefill) / 2 N_active B
    (decode), N_active excluding embeddings (the paper's ops/timestep
    convention)."""
    n_active = count_params(cfg)["active_excl_embed"]
    if kind == "train":
        return 6.0 * n_active * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active * global_batch * seq_len
    return 2.0 * n_active * global_batch           # decode: one token


def analyze(record: dict, cfg: ModelConfig) -> Roofline:
    """record: ``n_devices``, ``kind``, ``global_batch``, ``seq_len``
    and ``analytic`` (``launch.analytic.Analytic``'s three per-device
    counts).  The compute term runs at the peak of the config's compute
    dtype."""
    n_dev = record["n_devices"]
    ana = record["analytic"]
    flops_dev = ana["flops_per_dev"]
    peak = peak_flops(cfg.compute_dtype)
    compute_s = flops_dev / peak
    memory_s = ana["hbm_bytes_per_dev"] / H100["hbm_bandwidth"]
    coll_s = ana["wire_bytes_per_dev"] / H100["nvlink_bandwidth"]
    mf = model_flops(cfg, record["kind"], record["global_batch"],
                     record["seq_len"])
    useful = mf / max(flops_dev * n_dev, 1.0)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    return Roofline(compute_s=compute_s, memory_s=memory_s,
                    collective_s=coll_s, dominant=dominant,
                    model_flops=mf, flops_per_dev=flops_dev,
                    useful_ratio=useful,
                    bound_step_s=max(terms.values()), peak_flops=peak)


def roofline_fraction(r: Roofline, n_devices: int) -> float:
    """Achievable MFU under the bounding term: the fraction of peak
    compute the *useful* model flops would sustain if the step ran
    exactly at the dominant roofline term."""
    ideal_s = r.model_flops / (n_devices * r.peak_flops)
    return ideal_s / max(r.bound_step_s, 1e-30)
