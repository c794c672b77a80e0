#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

The port is imported from ``src/`` beside this file, so a copy of the
script placed in another checkout (say, the parent commit's ``git
archive``) times that checkout's kernels at the same shapes.

Phases, in order; any failure exits non-zero and prints no result:

1. setup   — the card's name and power limit (nvidia-smi), torch / CUDA
             versions, and the build of the CUDA kernels from
             ``src/repro_torch/csrc`` (nvcc, one process per source),
             with each kernel's registers and spill bytes.
2. kernels — each kernel's wrapper against its plain PyTorch version on
             the card: the serving kernels in bf16 at the shapes serving
             kimi-k2 gives them, in f32 at cut, ragged shapes, and in
             f32 at the shapes training MoE-256 gives them; both GMM
             kernels (the bf16 weight stream and the tiled 3xTF32 / bf16
             one) with and without ``rows``, a kimi-k2 layer at decode
             over all 384 experts and with the rows of a decode plan,
             and both kernels at C = 8 .. 64 (their threshold); the
             training kernels (top-k backward, e-blocked dispatch and
             combine, the transposed GMMs of the backward pass) in f32
             and bf16 at the shapes training MoE-256 gives them; the
             fused decode kernels (7 and 8) in f32 at ragged shapes and
             kernel 8's "proj" mode at moa-demo's decode shape.  Each
             kernel is timed (CUDA events, median of 20 runs after
             warm-up) beside its plain version, one PyTorch library call
             computing the same function where there is one, and its
             bound (the larger of bytes / 3.35 TB/s and operations / peak
             rate of the H100 SXM).  Top-k, combine and dispatch are
             also timed at the decode (T = 8), prefill (T = 32) and
             training (T = 4096) shapes, combine and dispatch also at
             moa-demo's decode (k = 2, and k = 1 through MoA's assignment
             view): profiler device time per launch (dispatch's memset
             apart; combine's with a cold L2) and the time per launch of
             200 launches queued between two CUDA events, each beside
             its bound and the launch floor (the device time of ``add_``
             on one element); so are the top-k backward (B5) at the
             training shape and the e-blocked combine (kernel 5, cold
             L2) at the decode and prefill shapes with the reference's
             slab of 64 and at the training shape with 16.  Both are
             held bit for bit to their plain versions, B5 also on rows
             whose indices repeat, kernel 5 also at the decode shape.
3. serve   — kimi-k2-1t-a32b at full width, depth cut to 2 layers, bf16
             weights drawn from a seed on the card, served through the
             port's ServeEngine with the "cuda" backend: 8 greedy
             requests (32-token prompts, 16 new tokens, staggered
             arrivals).  Launch counts are zeroed just before and read
             just after; every kernel must have run exactly once per MoE
             layer per model call (GMM three times).
   A profile of two decode steps (torch.profiler) then gives the device
   time of each kernel per launch and the device's idle share of an
   unprofiled decode step (the profiled window itself runs slower).
4. cross   — one full-width prefill under the "cuda" and the "ref"
             backends; last-position logits must agree within a bf16
             tolerance.
5. fused   — kernels 7 and 8 at full width on layer 0's weights against
             their plain versions, each case repeated bitwise and timed:
             kernel 7 with two dead slots and with all 8 live (a full
             pool), kernel 8 on the expert_choice plan and on a 96-token
             plan with more than 64 cells on some experts (two row
             tiles); then the same 8 requests
             with ``fused_decode``: one kernel-7 launch per MoE layer per
             decode step and no top-k, dispatch, GMM or combine at
             decode; one decode step's logits against the unfused path;
             used experts per layer and step from an untimed replay;
             a profile of two fused decode steps.
6. expert_choice — the same requests under expert-choice routing with
             fused decode: kernel 8 at every MoE decode layer.  The
             serving model is then freed.
7. moa     — moa-demo (Mixture-of-Attention-Heads) at its published
             widths: first every kernel of its serve path against its
             plain version at the shapes that path gives it (top-k,
             dispatch, GMM and combine at prefill and unfused decode,
             kernel 7 on its MoE layer, kernel 8 "proj" on its MoA
             layer), then 8 requests unfused and fused (kernel 8 in
             "proj" mode for each routed Q / O projection, kernel 7 for
             the MoE layers).
8. train   — the paper's MoE-256 LM (``paper_config("moe-256")``) at its
             published widths with the 1-Billion-Word vocabulary of
             793,471 (1.085 B parameters, f32), drawn from a seed on the
             card, trained through the port's Trainer (factored Adam,
             B=32 x S=128) for 12 steps with a checkpoint at step 6.
             Launch counts per step must be exactly those of the
             resident regime; every loss finite.  A profile of two more
             steps gives the device time by kernel and the idle share.
9. eblock  — moe_apply forward + backward at the training shape with
             ``dispatch_e_block=16`` against the resident default:
             dispatch buffers bit-equal, outputs and gradients close,
             the e-blocked kernels launched.
10. grads  — one more step's gradients under "cuda" (twice) and "ref"
             from the same parameters and draws: all present and
             finite, the MoE leaves' bit-equal between the two "cuda"
             runs and within 1e-5 normwise of "ref"; w1's once the
             terms of the pre-activations whose relu masks differ
             between the two paths are taken out (phase_grads counts
             them and says why).
   The MoE-256 model is then freed.
11. hmoe   — the paper's hierarchical MoE (Appendix B),
             ``paper_config("moe-4096-h")`` at full width with its
             vocabulary of 32,000 (4.34 B parameters, f32: 16 groups of
             256 experts 512 -> 1024 -> 512 relu, k = 2 at each level),
             drawn from a seed, both levels' gates redrawn.  First every
             kernel of its training step against its plain version at
             the step's shapes (top-k over [4096, 16] and over the
             16,384 slot rows of 256 experts, dispatch / combine at both
             levels, the GMMs over all 4096 experts at C = 16), timed
             beside its bound, the launch floor and torch.bmm; then 12
             steps through the Trainer as in phase 8 (launch counts
             exactly HMOE_LAUNCHES a step: one launch of each kernel per
             level and pass, whatever the number of groups), a profile
             of two more; one more batch's loss and gradients under
             "ref" and "cuda" (the MoE leaves within 1e-5 normwise, a
             slab at a time, w1's without its relu flips as in phase 10)
             and one optimizer update timed alone.  The model is then
             freed, and one lm_loss forward and backward of
             launch/train.py's reduced() kimi-k2 with a hierarchical MoE
             runs under "cuda" and "ref": exact launch counts, losses
             and gradients within f32 tolerances.
12. arctic — arctic-480b (``configs/arctic_480b.py``) at full width, bf16,
             depth cut 35 -> 1 layer (14.12 B parameters: 128 experts
             top-2 of 7168 -> 4864 swiglu beside a dense swiglu FFN of
             7168, 56 / 8 heads of 128, vocab 32000), drawn from a seed,
             gate redrawn.  First every kernel of its training step
             against its plain version at the step's shapes (T = 4096,
             C = 80, layer 0's experts and gate), timed beside its bound
             and the launch floor; then 6 steps of ``make_train_step``
             with ``lm_loss`` (remat on, factored Adam, B = 2 x S =
             2048): launch counts exactly ARCTIC_LAUNCHES a step, every
             metric finite, peak memory under the card's; one more
             batch's gradients (all present and finite), one optimizer
             update timed alone, the forward loss under "cuda" against
             "ref" (ARCTIC_LOSS_TOL), a profile of one step.
13. qwen3  — flash attention's output and gradients against plain
             autograd through ``causal_attention`` in f32 at qwen3's
             head shape (S = 2048, 4 x 4 blocks); then qwen3-1.7b at full
             size (28 layers, qk_norm, vocab 151,936, bf16) trained 4
             steps at B = 4 x S = 2048: finite metrics, every gradient
             present, step time and peak memory.
14. launchers — ``launch.train --arch smollm-135m`` at full size, 8 steps
             of B = 8 x S = 2048 with checkpoints at 4 and 8; the same
             call again resumes at step 8 and trains nothing; then
             ``launch.serve --ckpt`` serves 4 greedy requests from it.
15. report — one ``{"kernels": [...]}`` line, then the result line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
# Dense peaks; "tf32" is the tensor cores' rate, which 3xTF32 spends
# three times per f32 product.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
REPS = 20
QUEUED_RUN = 200         # calls between two events in queued_ms
PROFILED_RUN = 50        # calls under the profiler in device_ms
ARCH = "kimi-k2-1t-a32b"
N_LAYERS = 2
N_REQUESTS, PROMPT_LEN, NEW_TOKENS = 8, 32, 16
# Training: the paper's MoE-256 LM, B x S tokens a step.
TRAIN_CONFIG, TRAIN_VOCAB = "moe-256", 793_471
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT = 32, 128, 12, 6
E_BLOCK = 16             # the reference's slab at this shape
# Launches per training step in the resident regime: the forward top-k,
# dispatch, combine and two GMMs; the backward top-k; the combine's
# backward dispatch and the dispatch's backward combine; the recomputed
# pre-activation (a forward GMM) and four transposed GMMs.
TRAIN_LAUNCHES = {"topk_gating": 1, "topk_gating_bwd": 1, "dispatch": 2,
                  "combine": 2, "gmm": 3, "gmm_bwd": 4}
# The hierarchical MoE (Appendix B): moe-4096-h at full width with its
# default vocabulary of 32,000 (4,336,144,384 parameters, 17.34 GB in
# f32): 16 groups of 256 experts 512 -> 1024 -> 512 relu, k = 2 at each
# level, trained at TRAIN_B x TRAIN_S.  Capacities: HMOE_CP =
# capacity_for(4096, 16, 2, 2.0) slots a group, HMOE_CS =
# capacity_for(1024, 256, 2, 2.0) slots an expert.
HMOE_CONFIG, HMOE_PARAMS = "moe-4096-h", 4_336_144_384
HMOE_CP, HMOE_CS = 1024, 16
# Launches per hierarchical training step: at each level the forward
# top-k, dispatch and combine, and in the backward pass the top-k
# backward (B5), the combine's backward dispatch (B7) and the dispatch's
# backward combine (B6); the one expert FFN, the secondary level's over
# all 4096 experts at once, as in TRAIN_LAUNCHES.  No count scales with
# the 16 groups.
HMOE_LAUNCHES = {"topk_gating": 2, "topk_gating_bwd": 2, "dispatch": 4,
                 "combine": 4, "gmm": 3, "gmm_bwd": 4}
# The transformer path: launch/train.py's reduced() kimi-k2 (2 MoE layers
# under remat, swiglu) with 2 groups of 4 experts, one forward and
# backward at B x S.  A layer launches both levels' top-k, dispatch and
# combine twice (the forward and remat's recompute), B5 / B6 / B7 at both
# levels, the swiglu FFN's three GMMs twice and the recomputed w1
# pre-activation, and six transposed GMMs: ARCTIC_LAUNCHES with the
# routing kernels doubled, for each of the 2 layers.
HMOE_LM_GROUPS, HMOE_LM_BATCH = (2, 4), (4, 64)
HMOE_LM_LAUNCHES = {"topk_gating": 8, "topk_gating_bwd": 4, "dispatch": 12,
                    "combine": 12, "gmm": 14, "gmm_bwd": 12}
KERNELS = ("topk_gating", "dispatch", "combine", "gmm", "topk_gating_bwd",
           "dispatch_eblock", "combine_eblock", "gmm_bwd", "fused_decode",
           "fused_routed")
REPLACES = {
    "topk_gating": "src/repro/kernels/topk_gating.py:39",
    "dispatch": "src/repro/kernels/dispatch.py:148",
    "combine": "src/repro/kernels/dispatch.py:284",
    "gmm": "src/repro/kernels/gmm.py:232",
    "topk_gating_bwd": "src/repro/kernels/topk_gating.py:116",
    "dispatch_eblock": "src/repro/kernels/dispatch.py:230",
    "combine_eblock": "src/repro/kernels/dispatch.py:338",
    "gmm_bwd": "src/repro/kernels/gmm.py:283",
    "fused_decode": "src/repro/kernels/fused_decode.py:192",
    "fused_routed": "src/repro/kernels/fused_decode.py:323",
}
SOURCES = {
    "topk_gating": "src/repro_torch/csrc/topk_gating.cu",
    "dispatch": "src/repro_torch/csrc/dispatch.cu",
    "combine": "src/repro_torch/csrc/dispatch.cu",
    "gmm": "src/repro_torch/csrc/gmm.cu",
    "topk_gating_bwd": "src/repro_torch/csrc/topk_gating.cu",
    "dispatch_eblock": "src/repro_torch/csrc/dispatch.cu",
    "combine_eblock": "src/repro_torch/csrc/dispatch.cu",
    "gmm_bwd": "src/repro_torch/csrc/gmm.cu",
    "fused_decode": "src/repro_torch/csrc/fused_decode.cu",
    "fused_routed": "src/repro_torch/csrc/fused_decode.cu",
}
# Device symbols of each kernel, matched by substring in the profiler's
# names; no symbol contains another.  "gmm" (the forward layout) is
# either GMM kernel; the tiled kernel's transposed layouts are their own
# __global__ (gmm_tile_bwd_kernel), so "gmm" and "gmm_bwd" never mix.
KERNEL_SYMBOLS = {"topk_gating": ("topk_gating_kernel",),
                  "dispatch": ("dispatch_kernel",),
                  "combine": ("combine_kernel",),
                  "gmm": ("gmm_stream_kernel", "gmm_tile_kernel"),
                  "topk_gating_bwd": ("topk_gating_bwd_kernel",),
                  "dispatch_eblock": ("dispatch_eblock_kernel",),
                  "combine_eblock": ("combine_eblock_kernel",),
                  "gmm_bwd": ("gmm_tile_bwd_kernel",),
                  "fused_decode": ("fused_decode_kernel",),
                  "fused_routed": ("fused_routed_kernel",)}
# The MoA serve phase: moa-demo at its published widths.
MOA_ARCH = "moa-demo"
# The transformer training path.  arctic-480b at full width, depth cut
# 35 -> 1 (14,120,408,064 parameters, 28.2 GB in bf16, 56.5 GB with
# their gradients): B x S tokens a step, C = capacity_for(4096, 128, 2,
# 1.25) = 80.
ARCTIC, ARCTIC_LAYERS, ARCTIC_PARAMS = "arctic-480b", 1, 14_120_408_064
ARCTIC_B, ARCTIC_S, ARCTIC_STEPS, ARCTIC_C = 2, 2048, 6, 80
# Launches per arctic step (one moe+dense layer, remat on, resident
# regime): the forward's top-k, dispatch, three GMMs (w1 with silu, w3,
# w2) and combine; remat's recompute of the layer in the backward pass,
# the same six again; then the top-k backward (B5), the combine's
# backward dispatch (B7), the dispatch's backward combine (B6), the
# recomputed w1 pre-activation (a forward GMM) and two transposed GMMs
# (dx, dw) for each of w2, w3 and w1.
ARCTIC_LAUNCHES = {"topk_gating": 2, "topk_gating_bwd": 1, "dispatch": 3,
                   "combine": 3, "gmm": 7, "gmm_bwd": 6}
# cuda vs ref forward loss: one bf16 unit in the last place (2^-8
# relative); the paths round the expert FFN's and the combine's bf16
# outputs after summing in other orders.
ARCTIC_LOSS_TOL = 2.0 ** -8
# qwen3-1.7b at full size (2,031,739,904 parameters); smollm-135m
# (162,826,560) through the launchers.
QWEN, QWEN_B, QWEN_S, QWEN_STEPS = "qwen3-1.7b", 4, 2048, 4
SMOLLM = "smollm-135m"


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def queued_ms(fn, n: int = QUEUED_RUN) -> float:
    """Device time per call over ``n`` calls queued back to back between
    two CUDA events: the kernel plus the device's gap between launches.
    A sleep kernel holds the stream while the host queues the calls, so
    host enqueue time does not enter; the start event must still be
    pending when the last call is queued, or the sleep is doubled and
    the run repeated."""
    import torch
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    for attempt in range(4):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        # Cycles at up to 2 GHz: three times the dry run's host time.
        torch.cuda._sleep(int(3 * 2 ** attempt * host_s * 2e9))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / n
    raise SmokeFailure("queued_ms: the host could not queue the run inside "
                       "the sleep")


# CUPTI drops a few device records of a profile now and then (up to 5
# of one profile seen on the card, more often after the training
# phases), so a profile is repeated when a kernel has none, and a
# profile of multi-ms calls takes enough of them that some survive.
PROFILE_ATTEMPTS = 3     # profiles of one run before device_ms gives up
PROFILED_BIG_RUN = 20    # calls of a multi-ms kernel in device_ms


def device_ms(fn, symbols, n: int = PROFILED_RUN, required=None) -> dict:
    """Profiler device time per launch of the device ops whose names hold
    each of ``symbols`` ("" matches every op), over ``n`` calls of
    ``fn``.  CUPTI now and then delivers a profile without some of its
    device records: when a symbol of ``required`` (all of ``symbols`` by
    default) has none, the run is profiled again, up to PROFILE_ATTEMPTS
    times in all, and the result of the last attempt is returned (the
    caller's check then names what is missing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    required = tuple(symbols if required is None else required)
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        sums: dict = {}
        n_device = 0
        for e in prof.key_averages():
            if (e.device_type != DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            n_device += e.count
            for sym in symbols:
                if sym in e.key:
                    c, ms = sums.get(sym, (0, 0.0))
                    sums[sym] = (c + e.count,
                                 ms + e.self_device_time_total / 1e3)
        missing = [sym for sym in required if sym not in sums]
        if not missing:
            break
        log(f"device_ms: profile {attempt} of {PROFILE_ATTEMPTS} has no "
            f"device records of {missing} ({n_device} device records in "
            f"all, {n} calls)")
    return {sym: ms / c for sym, (c, ms) in sums.items()}


def launch_floor() -> dict:
    """The card's floor for a small kernel: a one-element elementwise op
    (``add_`` on one f32), its profiler device time per launch and its
    queued time per launch."""
    import torch
    a = torch.zeros(1, device="cuda")
    res = {"dev_ms": device_ms(lambda: a.add_(1.0), ("",))[""],
           "queued_ms": queued_ms(lambda: a.add_(1.0)),
           "op": "add_ on a [1] f32 tensor"}
    log("launch floor " + json.dumps(res))
    return res


def shape_times(what: str, fn, symbol: str, n_bytes: float, flops,
                dtype_name: str, floor: dict) -> dict:
    """One kernel at one shape: profiler device time per launch (and its
    memset's, if it has one), queued time per launch, the bound, and the
    launch floor beside it."""
    dev = device_ms(fn, (symbol, "Memset"), required=(symbol,))
    check(symbol in dev, f"{what}: no {symbol} in the profile")
    b, by = bound_ms(n_bytes, flops, dtype_name)
    res = {"dev_ms": dev[symbol], "queued_ms": queued_ms(fn), "bound_ms": b,
           "bound_by": by, "launch_floor_ms": floor["dev_ms"]}
    if "Memset" in dev:
        res["memset_dev_ms"] = dev["Memset"]
    log(f"{what}: " + json.dumps(res))
    return res


def bound_ms(n_bytes: float, flops, dtype_name: str | None = None):
    """(least time in ms, what bounds it) for moving ``n_bytes`` once and
    doing ``flops`` at the card's peak for the type; ``flops`` may be a
    {type name: operations} dict for work in several types."""
    if not isinstance(flops, dict):
        flops = {dtype_name: flops}
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[dt] * 1e3 for dt, n in flops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Tensors above this many elements are reduced a slab of their leading
# axis at a time: an f32 copy of an arctic expert gradient is 17.9 GB.
_REDUCE_CHUNK = 1 << 28


def _slabs(t):
    """Views of ``t`` along its first axis of at most _REDUCE_CHUNK
    elements each (``t`` itself when it is small or 1-d)."""
    if t.numel() <= _REDUCE_CHUNK or t.dim() < 2:
        return [t]
    step = max(1, _REDUCE_CHUNK // max(t[0].numel(), 1))
    return [t[i:i + step] for i in range(0, t.shape[0], step)]


def abs_max(t) -> float:
    return max(float(s.float().abs().max()) for s in _slabs(t)) \
        if t.numel() else 0.0


def max_err(a, b) -> float:
    if not a.numel():
        return 0.0
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(_slabs(a), _slabs(b)))


def all_finite(t) -> bool:
    import torch
    return all(bool(torch.isfinite(s).all()) for s in _slabs(t))


def any_nonzero(t) -> bool:
    return any(bool((s != 0).any()) for s in _slabs(t))


def f32_tol(ref) -> float:
    """f32 outputs summed in another order: 1e-5 of the output's scale
    (at least 1e-5)."""
    return 1e-5 * max(1.0, abs_max(ref))


def bf16_tol(ref) -> float:
    """Two bf16 units in the last place at the output's largest binade:
    kernel and plain version sum in different orders in f32, so the
    rounded bf16 results may differ by one unit."""
    return 2.0 ** -7 * max(abs_max(ref), 1e-30)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_setup() -> dict:
    import torch
    from repro_torch.common.device import resolve_device
    from repro_torch.kernels import cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    resolve_device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}")
    info = cuda_lib.build_info()
    log(f"kernels built and loaded in {info['build_seconds']:.1f} s "
        f"({info['path'].name})")
    for line in ptxas_summary(info["build_log"]):
        log("  " + line)
    return {"card": card}


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` messages:
    its (mangled) name, registers and spill bytes."""
    import re
    out, name, spill = [], "?", ""
    for line in build_log.splitlines():
        if line.startswith("=="):
            out.append(line.strip())
        elif m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif m := re.search(r"Used (\d+) registers", line):
            out.append(f"{name}: {m.group(1)} registers; {spill}")
    return out


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _route(n_tokens, n_experts, k, d, dtype, gen, *, capacity=None,
           mask_frac=0.0):
    """A realistic plan: random gate logits -> top-k -> capacity plan."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.kernels.topk_gating import topk_gating_plain
    dev = "cuda"
    logits = torch.randn(n_tokens, n_experts, device=dev, generator=gen)
    w, idx, _ = topk_gating_plain(logits, k, k)
    if mask_frac:
        keep = torch.rand(n_tokens, device=dev, generator=gen) >= mask_frac
        w = w * keep[:, None]
    cap = capacity or dsp.capacity_for(n_tokens, n_experts, k, 1.25)
    plan = dsp.plan(idx, w, n_experts, cap)
    x = torch.randn(n_tokens, d, device=dev, generator=gen).to(dtype)
    return x, plan


TOPK_SHAPES = {"decode": (8, 384, 8, 9), "prefill": (32, 384, 8, 9),
               "train": (TRAIN_B * TRAIN_S, 256, 4, 5)}   # T, E, k, kk
# T, d, E, k, dtype, capacity (None: the router's) of combine / dispatch.
# moa-demo's decode: "moa_ffn" its MoE FFN (k = 2, d = 512), "moa_view"
# MoA's assignment view (8 tokens x moa_k = 2 heads as 16 rows of one
# slot each, head width 128).
COMBINE_SHAPES = {"decode": (8, 7168, 384, 8, "bfloat16", None),
                  "prefill": (32, 7168, 384, 8, "bfloat16", None),
                  "moa_ffn": (8, 512, 8, 2, "bfloat16", None),
                  "moa_view": (16, 128, 8, 1, "bfloat16", None),
                  "train": (TRAIN_B * TRAIN_S, 512, 256, 4, "float32", 128)}
# The e-blocked combine (kernel 5): the COMBINE_SHAPES entry and the slab
# the reference's select_e_block picks there (kimi-k2's decode and
# prefill buffers exceed its 16 MiB budget at e_block = 64).
EBLOCK_SHAPES = {"decode": (COMBINE_SHAPES["decode"], 64),
                 "prefill": (COMBINE_SHAPES["prefill"], 64),
                 "train": (COMBINE_SHAPES["train"], E_BLOCK)}


def check_topk(gen, floor: dict) -> dict:
    import torch
    from repro_torch.kernels.topk_gating import topk_gating, topk_gating_plain
    worst = 0.0
    # Serving shapes (kimi-k2: E = 384, k = 8), cut ragged ones, and the
    # training shape (MoE-256: T = 4096, E = 256, k = 4, kk = k + 1);
    # "floor": 8 of a row's logits above -1e30 and the rest at -1e31, so
    # the ninth round re-picks a masked winner.
    cases = [(8, 384, 8, 9, False), (32, 384, 8, 9, False),
             (32, 384, 8, 9, True), (37, 100, 2, 3, False),
             (5, 33, 1, 1, True), (TRAIN_B * TRAIN_S, 256, 4, 5, False),
             (TRAIN_B * TRAIN_S, 256, 4, 5, True), (8, 384, 8, 9, "floor")]
    for t, e, k, kk, tied in cases:
        logits = torch.randn(t, e, device="cuda", generator=gen)
        if tied == "floor":
            logits[:, 8:] = -1e31
        elif tied:
            logits = torch.round(logits * 2)
        got = topk_gating(logits, k, kk)
        want = topk_gating_plain(logits, k, kk)
        check(torch.equal(got[1], want[1]),
              f"topk indices differ at T={t} E={e} tied={tied}")
        err = max(max_err(got[0], want[0]), max_err(got[2], want[2]))
        log(f"topk_gating [{t},{e}] k={k} kk={kk} tied={tied}: indices "
            f"equal, max_abs_err {err:.3g} (tol 1e-06)")
        check(err <= 1e-6, f"topk values differ by {err} at T={t} E={e}")
        worst = max(worst, err)
    by_shape = topk_times(gen, floor)
    t, e, k, kk = TOPK_SHAPES["decode"]
    logits = torch.randn(t, e, device="cuda", generator=gen)
    ms = cuda_ms(lambda: topk_gating(logits, k, kk))
    plain = cuda_ms(lambda: topk_gating_plain(logits, k, kk))

    def library():
        vals, idx = torch.topk(logits, kk, dim=-1)
        return torch.softmax(vals[:, :k], dim=-1), idx
    lib = cuda_ms(library)
    b, by = bound_ms(t * e * 4 + t * k * 4 + t * kk * 8, 0, "float32")
    return dict(name="topk_gating", max_abs_err=worst, tol=1e-6, ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                shape=f"logits [{t},{e}] f32, k={k}, kk={kk}",
                by_shape=by_shape)


def topk_times(gen, floor: dict) -> dict:
    """Top-k at the decode, prefill and training shapes: device and
    queued time per launch, each shape's bound."""
    import torch
    from repro_torch.kernels.topk_gating import topk_gating
    out = {}
    for name, (t, e, k, kk) in TOPK_SHAPES.items():
        logits = torch.randn(t, e, device="cuda", generator=gen)
        out[name] = shape_times(
            f"topk_gating {name} [{t},{e}] k={k} kk={kk}",
            lambda: topk_gating(logits, k, kk), "topk_gating_kernel",
            t * e * 4 + t * k * 4 + t * kk * 8, 0, "float32", floor)
    return out


def dispatch_combine_times(gen, floor: dict) -> dict:
    """Combine and dispatch at the decode, prefill, moa-demo and training
    shapes: device and queued time per launch (dispatch's memset apart),
    each shape's bound from the kept slots of its plan.  Combine's
    ``dev_ms`` is taken with the L2 cache cold (a 128 MB fill before each
    launch), as on the serve and training paths, where the GMM before it
    streams more than the L2 holds, so that it compares with the HBM
    bound; its back-to-back times re-read a buffer the L2 may still hold
    and are kept apart as ``dev_ms_l2_warm`` / ``queued_ms_l2_warm``."""
    import torch
    from repro_torch.kernels import dispatch as dk
    out: dict = {"combine": {}, "dispatch": {}}
    flush = torch.empty(32 * 2 ** 20, device="cuda")
    for name, (t, d, e, k, dt, cap) in COMBINE_SHAPES.items():
        dtype = getattr(torch, dt)
        size = torch.finfo(dtype).bits // 8
        x, p = _route(t, e, k, d, dtype, gen, capacity=cap)
        ei, po, w, c = p.expert_index, p.position, p.weight, p.capacity
        n_kept = int((po < c).sum())
        buf = torch.randn(e, c, d, device="cuda", generator=gen).to(dtype)
        what = f"[{t},{d}] {dt} <-> [{e},{c},{d}], k={k}"
        out["combine"][name] = shape_times(
            f"combine {name} {what}", lambda: dk.combine(buf, w, ei, po),
            "combine_kernel", n_kept * d * size + t * k * 12 + t * d * size,
            2 * n_kept * d, dt, floor)
        out["dispatch"][name] = shape_times(
            f"dispatch {name} {what}",
            lambda: dk.dispatch(x, ei, po, n_experts=e, capacity=c),
            "dispatch_kernel", t * d * size + t * k * 8 + e * c * d * size,
            0, dt, floor)
        cold = device_ms(lambda: (flush.zero_(), dk.combine(buf, w, ei, po)),
                         ("combine_kernel",))
        res = out["combine"][name]
        res.update(dev_ms_l2_warm=res.pop("dev_ms"),
                   queued_ms_l2_warm=res.pop("queued_ms"),
                   dev_ms=cold["combine_kernel"], kept_slots=n_kept)
        log(f"combine {name}, L2 cold: {cold['combine_kernel']} ms a launch")
        del x, buf
    return out


def topk_bwd_times(gen, floor: dict) -> dict:
    """The top-k backward (B5) at the training shape: device and queued
    time per launch, the bound (the [T, E] output written once, the
    inputs read once)."""
    import torch
    from repro_torch.kernels import topk_gating as tk
    t, e, k, kk = TOPK_SHAPES["train"]
    logits = torch.randn(t, e, device="cuda", generator=gen)
    w, idx, _ = tk.topk_gating(logits, k, kk)
    dw = torch.randn(t, k, device="cuda", generator=gen)
    dvals = torch.randn(t, kk, device="cuda", generator=gen)
    return {"train": shape_times(
        f"topk_gating_bwd train [{t},{e}] k={k} kk={kk}",
        lambda: tk.topk_gating_bwd(w, idx, dw, dvals, e),
        "topk_gating_bwd_kernel", t * e * 4 + t * k * 8 + t * kk * 8, 0,
        "float32", floor)}


def combine_eblock_times(gen, floor: dict) -> dict:
    """The e-blocked combine (kernel 5) at EBLOCK_SHAPES, timed as
    ``dispatch_combine_times`` times the combine: ``dev_ms`` with a cold
    L2, the back-to-back times kept apart as ``*_l2_warm``."""
    import torch
    from repro_torch.kernels import dispatch as dk
    out = {}
    flush = torch.empty(32 * 2 ** 20, device="cuda")
    for name, ((t, d, e, k, dt, cap), e_block) in EBLOCK_SHAPES.items():
        dtype = getattr(torch, dt)
        size = torch.finfo(dtype).bits // 8
        _, p = _route(t, e, k, 1, dtype, gen, capacity=cap)
        ei, po, w, c = p.expert_index, p.position, p.weight, p.capacity
        n_kept = int((po < c).sum())
        buf = torch.randn(e, c, d, device="cuda", generator=gen).to(dtype)

        def fn():
            return dk.combine_eblock(buf, w, ei, po, e_block=e_block)
        res = shape_times(
            f"combine_eblock {name} [{t},{d}] {dt} <- [{e},{c},{d}], k={k}, "
            f"e_block={e_block}", fn, "combine_eblock_kernel",
            n_kept * d * size + t * k * 12 + t * d * size, 2 * n_kept * d, dt,
            floor)
        cold = device_ms(lambda: (flush.zero_(), fn()),
                         ("combine_eblock_kernel",))
        res.update(dev_ms_l2_warm=res.pop("dev_ms"),
                   queued_ms_l2_warm=res.pop("queued_ms"),
                   dev_ms=cold["combine_eblock_kernel"], kept_slots=n_kept,
                   e_block=e_block)
        log(f"combine_eblock {name}, L2 cold: {res['dev_ms']} ms a launch")
        out[name] = res
        del buf
    return out


def check_dispatch_combine(gen, floor: dict) -> list[dict]:
    import torch
    from repro_torch.kernels import dispatch as dk
    d, e, k = 7168, 384, 8
    worst_d = worst_c = 0.0
    tol_c = 0.0
    # Serving shapes in bf16, cut ragged ones in f32, and the training
    # shape in f32 (MoE-256: T = 4096, d = 512, E = 256, k = 4, C = 128).
    cases = [(8, d, e, k, torch.bfloat16, None, 0.0),
             (32, d, e, k, torch.bfloat16, None, 0.25),
             (13, 17, 5, 2, torch.float32, 2, 0.2),
             (40, 24, 6, 2, torch.float32, 8, 0.0),
             (TRAIN_B * TRAIN_S, 512, 256, 4, torch.float32, 128, 0.0)]
    for t, dd, ee, kk, dtype, cap, mask in cases:
        x, p = _route(t, ee, kk, dd, dtype, gen, capacity=cap,
                      mask_frac=mask)
        buf = dk.dispatch(x, p.expert_index, p.position, n_experts=ee,
                          capacity=p.capacity)
        want = dk.dispatch_plain(x, p.expert_index, p.position, None, ee,
                                 p.capacity)
        err_d = max_err(buf, want)
        check(err_d == 0.0 and torch.equal(buf, want),
              f"dispatch differs by {err_d} at T={t} d={dd}")
        worst_d = max(worst_d, err_d)
        out = torch.randn(buf.shape, device="cuda", generator=gen).to(dtype)
        y = dk.combine(out, p.weight, p.expert_index, p.position)
        yw = dk.combine_plain(out, p.weight, p.expert_index, p.position,
                              dtype)
        err_c = max_err(y, yw)
        log(f"dispatch / combine T={t} d={dd} E={ee} k={kk} C={p.capacity} "
            f"{dtype}: max_abs_err {err_d:.3g} / {err_c:.3g} (tol 0.0)")
        check(err_c == 0.0 and torch.equal(y, yw),
              f"combine differs by {err_c} at T={t} d={dd} (the kernel "
              "rounds as the plain version does)")
        worst_c = max(worst_c, err_c)
        del x, buf, want, out, y, yw
    # Time at the decode shape.
    t = 8
    x, p = _route(t, e, k, d, torch.bfloat16, gen)
    ei, po, w = p.expert_index, p.position, p.weight
    c = p.capacity
    n_kept = int((po < c).sum())
    ms_d = cuda_ms(lambda: dk.dispatch(x, ei, po, n_experts=e, capacity=c))
    plain_d = cuda_ms(lambda: dk.dispatch_plain(x, ei, po, None, e, c))
    b_d, by_d = bound_ms(t * d * 2 + t * k * 8 + e * c * d * 2, 0,
                         "bfloat16")
    buf = torch.randn(e, c, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    ms_c = cuda_ms(lambda: dk.combine(buf, w, ei, po))
    plain_c = cuda_ms(lambda: dk.combine_plain(buf, w, ei, po,
                                               torch.bfloat16))
    b_c, by_c = bound_ms(n_kept * d * 2 + t * k * 12 + t * d * 2,
                         2 * n_kept * d, "bfloat16")
    shape = f"x [{t},{d}] bf16 <-> buf [{e},{c},{d}], k={k}"
    times = dispatch_combine_times(gen, floor)
    return [dict(name="dispatch", max_abs_err=worst_d, tol=tol_c, ms=ms_d,
                 plain_ms=plain_d, bound_ms=b_d, bound_by=by_d,
                 library_ms=None, shape=shape, by_shape=times["dispatch"]),
            dict(name="combine", max_abs_err=worst_c, tol=tol_c, ms=ms_c,
                 plain_ms=plain_c, bound_ms=b_c, bound_by=by_c,
                 library_ms=None, shape=shape, by_shape=times["combine"])]


def check_gmm(gen) -> dict:
    """Kernel 6, the forward layout, against its plain version: the
    tiled kernel in f32 (3xTF32) at cut, ragged shapes and at the
    training shapes (timed beside torch.bmm); both kernels in bf16 at
    ragged shapes with and without ``rows``; one kimi-k2 MoE layer at
    decode over all 384 experts (the timed row) and with ``rows`` from a
    decode plan (its own bound, from the used experts); the streaming /
    tiled threshold (both kernels at C = 8 .. 64)."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.kernels import dispatch as dk
    from repro_torch.kernels import gmm as gk
    bf = torch.bfloat16
    # f32 at cut, ragged shapes: the tiled kernel's 3xTF32 against the
    # f32 plain path, within f32_tol (1e-5 of the output's scale).
    worst_f32 = 0.0
    for e, c, kd, n in ((5, 13, 300, 264), (3, 8, 65, 17), (2, 1, 7, 1000)):
        x = torch.randn(e, c, kd, device="cuda", generator=gen)
        w = torch.randn(e, kd, n, device="cuda", generator=gen) / kd ** 0.5
        for act in gk.ACTIVATIONS:
            got = gk.gmm(x, w, activation=act)
            want = gk.gmm_plain(x, w, act)
            err = max_err(got, want)
            tol = f32_tol(want)
            check(err <= tol, f"f32 gmm {act} [{e},{c},{kd}]x[{e},{kd},{n}] "
                              f"differs by {err} > {tol}")
            worst_f32 = max(worst_f32, err)
    log(f"gmm f32 cut shapes: max_abs_err {worst_f32:.3g}")
    # bf16 at ragged shapes, both kernels, rows with empty, partial and
    # full experts: within bf16_tol, rows past rows[e] exactly zero.
    worst_rows, tol_rows = 0.0, 0.0
    for e, c, kd, n in ((5, 13, 300, 264), (4, 9, 72, 136), (3, 64, 128, 256)):
        x = torch.randn(e, c, kd, device="cuda", generator=gen).to(bf)
        w = (torch.randn(e, kd, n, device="cuda", generator=gen)
             / kd ** 0.5).to(bf)
        rows = torch.tensor([0, c, c // 2, 1, c - 1][:e], dtype=torch.int32,
                            device="cuda")
        for kernel in ("stream", "tile"):
            for act in gk.ACTIVATIONS:
                got = gk.gmm(x, w, activation=act, rows=rows, kernel=kernel)
                want = gk.gmm_plain(x, w, act, rows=rows)
                err, tol = max_err(got, want), bf16_tol(want)
                check(err <= tol, f"bf16 gmm ({kernel}) {act} with rows "
                                  f"[{e},{c},{kd}]x[{e},{kd},{n}] differs by "
                                  f"{err} > {tol}")
                check(torch.equal(gk.mask_rows(got, rows), got),
                      f"bf16 gmm ({kernel}) wrote a nonzero past rows")
                worst_rows, tol_rows = max(worst_rows, err), max(tol_rows, tol)
    log(f"gmm bf16 ragged with rows, both kernels: max_abs_err "
        f"{worst_rows:.3g} (tol {tol_rows:.3g})")
    # f32 at the training shapes (MoE-256: E = 256, C = 128, d = 512,
    # f = 1024): the up-projection with relu (forward) and none (the
    # backward pass's recomputed pre-activation), the down-projection;
    # timed beside torch.bmm.  Bound: the 3xTF32 tensor-core floor (three
    # TF32 products at 495 TFLOP/s), with the CUDA cores' f32 figure.
    e, c, d, f = 256, 128, 512, 1024
    x = torch.randn(e, c, d, device="cuda", generator=gen)
    w1 = torch.randn(e, d, f, device="cuda", generator=gen) / d ** 0.5
    h = torch.randn(e, c, f, device="cuda", generator=gen)
    w2 = torch.randn(e, f, d, device="cuda", generator=gen) / f ** 0.5
    train_f32 = []
    train = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 bound_ms_f32_cuda_cores=0.0)
    for xi, wi, act in ((x, w1, "relu"), (x, w1, "none"), (h, w2, "none")):
        got = gk.gmm(xi, wi, activation=act)
        want = gk.gmm_plain(xi, wi, act)
        err = max_err(got, want)
        tol = f32_tol(want)
        log(f"gmm f32 {act} {tuple(xi.shape)} x {tuple(wi.shape)}: "
            f"max_abs_err {err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"f32 gmm {act} {tuple(xi.shape)} x "
                          f"{tuple(wi.shape)} differs by {err} > {tol}")
        check(torch.equal(got, gk.gmm(xi, wi, activation=act)),
              "f32 gmm: two launches differ")
        train_f32.append((err, tol))
        del got, want
        train["ms"] += cuda_ms(lambda: gk.gmm(xi, wi, activation=act))
        train["plain_ms"] += cuda_ms(lambda: gk.gmm_plain(xi, wi, act))
        train["library_ms"] += cuda_ms(lambda: torch.bmm(xi, wi))
        ee, cc, kk = xi.shape
        nn = wi.shape[-1]
        n_bytes = (ee * cc * kk + ee * kk * nn + ee * cc * nn) * 4
        flops = 2 * ee * cc * kk * nn
        train["bound_ms"] += bound_ms(n_bytes, {"tf32": 3 * flops})[0]
        train["bound_ms_f32_cuda_cores"] += bound_ms(n_bytes, flops,
                                                     "float32")[0]
    log(f"gmm f32 at the training shapes, 3 calls: {json.dumps(train)}")
    # The same calls with the rows of a training plan (T = 4096, k = 4,
    # C = 128: ~64 filled rows an expert), as a training step runs them:
    # against the plain version with rows, bitwise equal to the kernel
    # without rows (the buffers are zero past rows), timed.
    x_tok, plan = _train_plan(gen, torch.float32)
    rows = dsp.filled_rows(plan)
    buf = dk.dispatch_plain(x_tok, plan.expert_index, plan.position, None,
                            e, c)
    filled = int(rows.sum())
    train_rows = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, filled_rows=filled)
    for xi, wi, act in ((buf, w1, "relu"), (buf, w1, "none"),
                        (gk.mask_rows(h, rows), w2, "none")):
        got = gk.gmm(xi, wi, activation=act, rows=rows)
        want = gk.gmm_plain(xi, wi, act, rows=rows)
        err, tol = max_err(got, want), f32_tol(want)
        check(err <= tol, f"f32 gmm {act} with training rows differs by "
                          f"{err} > {tol}")
        check(torch.equal(got, gk.gmm(xi, wi, activation=act)),
              f"f32 gmm {act}: rows changed the result")
        train_f32.append((err, tol))
        del got, want
        train_rows["ms"] += cuda_ms(lambda: gk.gmm(xi, wi, activation=act,
                                                   rows=rows))
        train_rows["plain_ms"] += cuda_ms(lambda: gk.gmm_plain(
            xi, wi, act, rows=rows))
        kk, nn = wi.shape[1], wi.shape[2]
        train_rows["bound_ms"] += bound_ms(
            (filled * kk + e * kk * nn + e * c * nn) * 4,
            {"tf32": 3 * 2 * filled * kk * nn})[0]
    log(f"gmm f32 at the training shapes with rows ({filled} rows): "
        f"{json.dumps(train_rows)}")
    train["with_rows"] = train_rows
    del x, w1, h, w2, x_tok, buf
    # bf16 at the serving shapes: one MoE layer's expert FFN at decode,
    # over all 384 experts.
    e, c, d, f = 384, 8, 7168, 2048
    x = torch.randn(e, c, d, device="cuda", generator=gen).to(bf)
    w_up = (torch.randn(e, d, f, device="cuda", generator=gen) / d ** 0.5
            ).to(bf)
    h = torch.randn(e, c, f, device="cuda", generator=gen).to(bf)
    w_dn = (torch.randn(e, f, d, device="cuda", generator=gen) / f ** 0.5
            ).to(bf)
    calls = [(x, w_up, "silu"), (x, w_up, "none"), (h, w_dn, "none")]
    worst, tol_used = 0.0, 0.0
    ms = plain = lib = bnd = 0.0
    for xi, wi, act in calls:
        got = gk.gmm(xi, wi, activation=act)
        want = gk.gmm_plain(xi, wi, act)
        err, tol = max_err(got, want), bf16_tol(want)
        check(err <= tol, f"bf16 gmm {act} {tuple(xi.shape)} x "
                          f"{tuple(wi.shape)} differs by {err} > {tol}")
        check(torch.equal(got, gk.gmm(xi, wi, activation=act)),
              "bf16 gmm: two launches differ")
        worst, tol_used = max(worst, err), max(tol_used, tol)
        del got, want
        ms += cuda_ms(lambda: gk.gmm(xi, wi, activation=act))
        plain += cuda_ms(lambda: gk.gmm_plain(xi, wi, act))
        lib += cuda_ms(lambda: torch.bmm(xi, wi))
        ee, cc, kk = xi.shape
        nn = wi.shape[-1]
        b, _ = bound_ms((ee * cc * kk + ee * kk * nn + ee * cc * nn) * 2,
                        2 * ee * cc * kk * nn, "bfloat16")
        bnd += b
    b_bytes = (3 * e * d * f * 2) / HBM_BYTES_PER_S * 1e3
    # The same layer with rows from a decode plan (T = 8 tokens, k = 8,
    # C = 8): the buffer dispatched from the plan, h zero past rows.
    # Against the plain version with rows and the kernel without rows
    # (bitwise: rows changes no result); timed; bounded by the bytes of
    # the experts that hold a token.
    x_tok, plan = _route(N_REQUESTS, e, 8, d, bf, gen, capacity=c)
    rows = dsp.filled_rows(plan)
    buf = dk.dispatch_plain(x_tok, plan.expert_index, plan.position, None,
                            e, c)
    used, filled = int((rows > 0).sum()), int(rows.sum())
    dec = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, used_experts=used,
               filled_rows=filled)
    for xi, wi, act in [(buf, w_up, "silu"), (buf, w_up, "none"),
                        (gk.mask_rows(h, rows), w_dn, "none")]:
        got = gk.gmm(xi, wi, activation=act, rows=rows)
        want = gk.gmm_plain(xi, wi, act, rows=rows)
        err, tol = max_err(got, want), bf16_tol(want)
        check(err <= tol, f"bf16 gmm {act} with decode rows differs by "
                          f"{err} > {tol}")
        check(torch.equal(got, gk.gmm(xi, wi, activation=act)),
              f"bf16 gmm {act}: rows changed the result")
        worst_rows, tol_rows = max(worst_rows, err), max(tol_rows, tol)
        del got, want
        dec["ms"] += cuda_ms(lambda: gk.gmm(xi, wi, activation=act,
                                            rows=rows))
        dec["plain_ms"] += cuda_ms(lambda: gk.gmm_plain(xi, wi, act,
                                                        rows=rows))
        kk, nn = wi.shape[1], wi.shape[2]
        dec["bound_ms"] += bound_ms(
            (used * kk * nn + filled * kk + e * c * nn) * 2,
            2 * filled * kk * nn, "bfloat16")[0]
    dec["bound_by"] = "bytes"
    dec["library_ms"] = lib
    log(f"gmm bf16 decode layer with rows ({used} experts, {filled} rows): "
        f"{json.dumps(dec)}")
    # The streaming / tiled threshold: both kernels on the up-projection
    # [384, C, 7168] x [384, 7168, 2048] bf16 at C = 8 .. 64.
    thr = {}
    for cc in (8, 16, 32, 64):
        xc = torch.randn(e, cc, d, device="cuda", generator=gen).to(bf)
        want = gk.gmm_plain(xc, w_up, "none")
        thr[cc] = {}
        for kernel in ("stream", "tile"):
            err, tol = max_err(gk.gmm(xc, w_up, kernel=kernel), want), \
                bf16_tol(want)
            check(err <= tol, f"bf16 gmm ({kernel}) C={cc} differs by {err} "
                              f"> {tol}")
            thr[cc][kernel] = cuda_ms(lambda: gk.gmm(xc, w_up, kernel=kernel),
                                      reps=10)
        del xc, want
    log(f"gmm stream vs tile ms by C (up-projection, bf16): {json.dumps(thr)}")
    return dict(name="gmm", max_abs_err=worst, tol=tol_used, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by="bytes",
                library_ms=lib, weights_only_bound_ms=b_bytes,
                max_abs_err_f32_train=max(r[0] for r in train_f32),
                tol_f32_train=max(r[1] for r in train_f32),
                max_abs_err_rows=worst_rows, tol_rows=tol_rows,
                rows_decode=dec, train_f32=train, stream_vs_tile_ms=thr,
                shape=(f"one MoE layer at decode: 3 calls, x [{e},{c},{d}] x "
                       f"[{e},{d},{f}] (silu, none) and [{e},{c},{f}] x "
                       f"[{e},{f},{d}], bf16"))


def _train_plan(gen, dtype):
    """The MoE-256 training shape: T = 4096 tokens, E = 256, k = 4,
    C = capacity_for(4096, 256, 4, 2.0) = 128, d = 512."""
    from repro_torch.core import dispatch as dsp
    t, e, k, d = TRAIN_B * TRAIN_S, 256, 4, 512
    cap = dsp.capacity_for(t, e, k, 2.0)
    return _route(t, e, k, d, dtype, gen, capacity=cap)


def check_topk_bwd(gen, floor: dict) -> dict:
    """B5 bit for bit against its plain version at the training shape,
    on random rows and on rows whose indices repeat (fewer than kk
    logits above -1e30: one with k = 2, kk = 5; eight with k = 8,
    kk = 9, kimi-k2's E); timed at the training shape."""
    import torch
    from repro_torch.kernels import topk_gating as tk
    t = TRAIN_B * TRAIN_S
    # The training shape first: its inputs are the timed ones.
    cases = [(256, 4, 5, None), (256, 2, 5, 1), (384, 8, 9, 8)]
    worst, timed = 0.0, None
    for e, k, kk, n_finite in cases:
        logits = torch.randn(t, e, device="cuda", generator=gen)
        if n_finite:
            rank = torch.rand(t, e, device="cuda", generator=gen).argsort(1) \
                .argsort(1)
            logits = torch.where(rank < n_finite, logits, -1e31)
        w, idx, _ = tk.topk_gating(logits, k, kk)
        dw = torch.randn(t, k, device="cuda", generator=gen)
        dvals = torch.randn(t, kk, device="cuda", generator=gen)
        got = tk.topk_gating_bwd(w, idx, dw, dvals, e)
        want = tk.topk_gating_bwd_plain(w, idx, dw, dvals, e)
        repeats = int((idx.sort(1).values.diff(1) == 0).any(1).sum())
        err = max_err(got, want)
        log(f"topk_gating_bwd [{t},{e}] k={k} kk={kk}, {repeats} rows with "
            f"a repeated index: max_abs_err {err:.3g} (tol 0.0)")
        check(torch.equal(got, want), f"topk_gating_bwd differs by {err} at "
                                      f"E={e} k={k} kk={kk}")
        check(n_finite is None or repeats == t,
              f"topk_gating_bwd: {repeats} of {t} rows repeat an index")
        worst = max(worst, err)
        timed = timed or (w, idx, dw, dvals, e, k, kk)
    w, idx, dw, dvals, e, k, kk = timed
    ms = cuda_ms(lambda: tk.topk_gating_bwd(w, idx, dw, dvals, e))
    plain = cuda_ms(lambda: tk.topk_gating_bwd_plain(w, idx, dw, dvals, e))
    b, by = bound_ms(t * e * 4 + t * k * 8 + t * kk * 8, 0, "float32")
    return dict(name="topk_gating_bwd", max_abs_err=worst, tol=0.0, ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                shape=f"dlogits [{t},{e}] f32, k={k}, kk={kk}",
                by_shape=topk_bwd_times(gen, floor))


def check_eblock(gen, floor: dict) -> list[dict]:
    """The e-blocked dispatch and combine in f32 and bf16 at the
    training shape, bit-equal to their plain versions (dispatch also to
    the resident kernel; the combine with one slab to the resident
    combine); the combine also at kimi-k2's decode and prefill shapes
    with the reference's slab of 64; timed in f32, the combine also at
    EBLOCK_SHAPES."""
    import torch
    from repro_torch.kernels import dispatch as dk
    worst_d = worst_c = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x, p = _train_plan(gen, dtype)
        e, c = p.n_experts, p.capacity
        ei, po, w = p.expert_index, p.position, p.weight
        scale = torch.rand(ei.shape, device="cuda", generator=gen)
        for sc in (None, scale):
            got = dk.dispatch_eblock(x, ei, po, sc, n_experts=e, capacity=c,
                                     e_block=E_BLOCK)
            resident = dk.dispatch(x, ei, po, sc, n_experts=e, capacity=c)
            err = max(max_err(got, dk.dispatch_eblock_plain(
                x, ei, po, sc, e, c, E_BLOCK)), max_err(got, resident))
            check(err == 0.0 and torch.equal(got, resident),
                  f"dispatch_eblock {dtype} differs by {err}")
            worst_d = max(worst_d, err)
        buf = torch.randn(e, c, x.shape[1], device="cuda",
                          generator=gen).to(dtype)
        got = dk.combine_eblock(buf, w, ei, po, e_block=E_BLOCK)
        want = dk.combine_eblock_plain(buf, w, ei, po, dtype, E_BLOCK)
        err = max_err(got, want)
        log(f"combine_eblock {dtype}: max_abs_err {err:.3g} (tol 0.0)")
        check(err == 0.0 and torch.equal(got, want),
              f"combine_eblock {dtype} differs by {err}")
        worst_c = max(worst_c, err)
        # The resident combine on the same buffer, against its own plain
        # version (bitwise) and, for information, against the e-blocked
        # one (the slab grouping reorders the sum for k >= 3).
        resident = dk.combine(buf, w, ei, po)
        err_r = max_err(resident, dk.combine_plain(buf, w, ei, po, dtype))
        log(f"combine {dtype} at the training shape: max_abs_err "
            f"{err_r:.3g} (tol 0.0); vs combine_eblock max |d| "
            f"{max_err(got, resident):.3g}")
        check(err_r == 0.0, f"combine {dtype} at the training shape differs "
                            f"from its plain version by {err_r}")
        one = dk.combine_eblock(buf, w, ei, po, e_block=e)
        check(torch.equal(one, resident), f"combine_eblock {dtype} with "
              "e_block = E differs from the resident combine")
    for name in ("decode", "prefill"):
        (t, d, e, k, dt, cap), e_block = EBLOCK_SHAPES[name]
        dtype = getattr(torch, dt)
        _, p = _route(t, e, k, 1, dtype, gen, capacity=cap)
        args = (p.weight, p.expert_index, p.position)
        buf = torch.randn(e, p.capacity, d, device="cuda",
                          generator=gen).to(dtype)
        got = dk.combine_eblock(buf, *args, e_block=e_block)
        want = dk.combine_eblock_plain(buf, *args, dtype, e_block)
        err = max_err(got, want)
        log(f"combine_eblock {name} [{t},{d}] {dt}, E={e}, k={k}, "
            f"e_block={e_block}: max_abs_err {err:.3g} (tol 0.0)")
        check(torch.equal(got, want),
              f"combine_eblock at the {name} shape differs by {err}")
        del buf
    x, p = _train_plan(gen, torch.float32)
    e, c, d = p.n_experts, p.capacity, x.shape[1]
    ei, po, w = p.expert_index, p.position, p.weight
    t, k = ei.shape
    n_kept = int((po < c).sum())
    ms_d = cuda_ms(lambda: dk.dispatch_eblock(x, ei, po, n_experts=e,
                                              capacity=c, e_block=E_BLOCK))
    plain_d = cuda_ms(lambda: dk.dispatch_eblock_plain(x, ei, po, None, e, c,
                                                       E_BLOCK))
    # x read once, the [E*C] slot table (token, scale) read, the buffer
    # written once.
    b_d, by_d = bound_ms(e * c * d * 4 + t * d * 4 + e * c * 8, 0,
                         "float32")
    buf = torch.randn(e, c, d, device="cuda", generator=gen)
    ms_c = cuda_ms(lambda: dk.combine_eblock(buf, w, ei, po,
                                             e_block=E_BLOCK))
    plain_c = cuda_ms(lambda: dk.combine_eblock_plain(buf, w, ei, po,
                                                      torch.float32,
                                                      E_BLOCK))
    b_c, by_c = bound_ms(n_kept * d * 4 + t * k * 12 + t * d * 4,
                         2 * n_kept * d, "float32")
    shape = (f"x [{t},{d}] f32 <-> buf [{e},{c},{d}], k={k}, "
             f"e_block={E_BLOCK}, {n_kept} kept")
    # The resident kernels as the two VJPs run them at this shape (the
    # reference's _dispatch_bwd: the combine kernel with unit weights;
    # _combine_bwd: the dispatch kernel scaling each row by its weight),
    # timed against their plain versions, with their byte bounds.
    unit = torch.ones_like(w)
    vjps = {
        "B6_dispatch_bwd": dict(
            ms=cuda_ms(lambda: dk.combine(buf, unit, ei, po)),
            plain_ms=cuda_ms(lambda: dk.combine_plain(buf, unit, ei, po,
                                                      torch.float32)),
            bound_ms=b_c, bound_by=by_c),
        "B7_combine_bwd": dict(
            ms=cuda_ms(lambda: dk.dispatch(x, ei, po, w, n_experts=e,
                                           capacity=c)),
            plain_ms=cuda_ms(lambda: dk.dispatch_plain(x, ei, po, w, e, c)),
            # x read once, (e, p, w) read, the buffer written once.
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                e * c * d * 4 + t * d * 4 + t * k * 12, 0, "float32"))))}
    log(f"VJP kernels at the training shape ({shape}): {json.dumps(vjps)}")
    return [dict(name="dispatch_eblock", max_abs_err=worst_d, tol=0.0,
                 ms=ms_d, plain_ms=plain_d, bound_ms=b_d, bound_by=by_d,
                 library_ms=None, shape=shape),
            dict(name="combine_eblock", max_abs_err=worst_c, tol=0.0,
                 ms=ms_c, plain_ms=plain_c, bound_ms=b_c, bound_by=by_c,
                 library_ms=None, shape=shape, train_vjps=vjps,
                 by_shape=combine_eblock_times(gen, floor))]


def check_gmm_bwd(gen) -> dict:
    """The four transposed GMMs of one training step's expert FFN
    backward (MoE-256: E=256, C=128, d=512, f=1024), against the plain
    version in f32 (1e-5 relative) and bf16 (two ulps of the output's
    top binade), timed in f32 beside torch.bmm on transposed views.
    Bound: the 3xTF32 tensor-core floor, with the CUDA cores' f32
    figure beside it."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.kernels import dispatch as dk
    from repro_torch.kernels import gmm as gk
    e, c, d, f = 256, 128, 512, 1024
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    times = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0, bound_f32=0.0)
    for dtype in (torch.float32, torch.bfloat16):
        def r(*shape, scale=1.0):
            return (torch.randn(*shape, device="cuda", generator=gen)
                    * scale).to(dtype)
        x, h = r(e, c, d), r(e, c, f)
        w1, w2 = r(e, d, f, scale=d ** -0.5), r(e, f, d, scale=f ** -0.5)
        dy, dh = r(e, c, d), r(e, c, f)
        # (x, w, trans_x, trans_w): dh = dy w2^T, dw2 = h^T dy,
        # dx = dh w1^T, dw1 = x^T dh.
        calls = [(dy, w2, False, True), (h, dy, True, False),
                 (dh, w1, False, True), (x, dh, True, False)]
        for xi, wi, tx, tw in calls:
            got = gk.gmm(xi, wi, trans_x=tx, trans_w=tw)
            want = gk.gmm_plain(xi, wi, "none", tx, tw)
            tol = f32_tol(want) if dtype == torch.float32 else bf16_tol(want)
            err = max_err(got, want)
            check(err <= tol, f"gmm_bwd {dtype} trans_x={tx} trans_w={tw} "
                              f"{tuple(xi.shape)} x {tuple(wi.shape)} "
                              f"differs by {err} > {tol}")
            worst[dtype] = (max(worst[dtype][0], err),
                            max(worst[dtype][1], tol))
            if dtype != torch.float32:
                continue
            check(torch.equal(got, gk.gmm(xi, wi, trans_x=tx, trans_w=tw)),
                  "gmm_bwd: two launches differ")
            xl = xi.transpose(1, 2) if tx else xi
            wl = wi.transpose(1, 2) if tw else wi
            times["ms"] += cuda_ms(
                lambda: gk.gmm(xi, wi, trans_x=tx, trans_w=tw))
            times["plain"] += cuda_ms(
                lambda: gk.gmm_plain(xi, wi, "none", tx, tw))
            times["lib"] += cuda_ms(lambda: torch.bmm(xl, wl))
            ee, cc, kk = xl.shape
            nn = wl.shape[-1]
            n_bytes = (ee * cc * kk + ee * kk * nn + ee * cc * nn) * 4
            flops = 2 * ee * cc * kk * nn
            times["bound"] += bound_ms(n_bytes, {"tf32": 3 * flops})[0]
            times["bound_f32"] += bound_ms(n_bytes, flops, "float32")[0]
        del x, h, w1, w2, dy, dh
    # The four calls with the rows of a training plan, as GMMFn's
    # backward runs them (dz zero past rows; x and h dispatch buffers):
    # against the plain version with rows, timed.
    x_tok, plan = _train_plan(gen, torch.float32)
    rows = dsp.filled_rows(plan)
    x = dk.dispatch_plain(x_tok, plan.expert_index, plan.position, None, e, c)

    def rr(*shape, scale=1.0):
        return gk.mask_rows(torch.randn(*shape, device="cuda", generator=gen)
                            * scale, rows)
    h, dy, dh = rr(e, c, f), rr(e, c, d), rr(e, c, f)
    w1 = torch.randn(e, d, f, device="cuda", generator=gen) / d ** 0.5
    w2 = torch.randn(e, f, d, device="cuda", generator=gen) / f ** 0.5
    with_rows = dict(ms=0.0, plain_ms=0.0, filled_rows=int(rows.sum()))
    for xi, wi, tx, tw in [(dy, w2, False, True), (h, dy, True, False),
                           (dh, w1, False, True), (x, dh, True, False)]:
        got = gk.gmm(xi, wi, trans_x=tx, trans_w=tw, rows=rows)
        want = gk.gmm_plain(xi, wi, "none", tx, tw, rows)
        err, tol = max_err(got, want), f32_tol(want)
        check(err <= tol, f"gmm_bwd f32 with training rows trans_x={tx} "
                          f"trans_w={tw} differs by {err} > {tol}")
        worst[torch.float32] = (max(worst[torch.float32][0], err),
                                max(worst[torch.float32][1], tol))
        del got, want
        with_rows["ms"] += cuda_ms(
            lambda: gk.gmm(xi, wi, trans_x=tx, trans_w=tw, rows=rows))
        with_rows["plain_ms"] += cuda_ms(
            lambda: gk.gmm_plain(xi, wi, "none", tx, tw, rows))
    log(f"gmm_bwd f32 with the rows of a training plan: "
        f"{json.dumps(with_rows)}")
    del x, h, dy, dh, w1, w2, x_tok
    err_bf16, tol_bf16 = worst[torch.bfloat16]
    log(f"gmm_bwd bf16: max_abs_err {err_bf16:.3g} (tol {tol_bf16:.3g})")
    return dict(name="gmm_bwd", max_abs_err=worst[torch.float32][0],
                tol=worst[torch.float32][1], max_abs_err_bf16=err_bf16,
                tol_bf16=tol_bf16, ms=times["ms"], plain_ms=times["plain"],
                bound_ms=times["bound"], bound_by="operations",
                bound_ms_f32_cuda_cores=times["bound_f32"],
                library_ms=times["lib"], train_with_rows=with_rows,
                shape=(f"one step's 4 transposed GMMs, f32: [{e},{c},{d}] x "
                       f"[{e},{f},{d}]^T, [{e},{c},{f}]^T x [{e},{c},{d}], "
                       f"[{e},{c},{f}] x [{e},{d},{f}]^T, [{e},{c},{d}]^T x "
                       f"[{e},{c},{f}]"))


def near_ties(x, wg, k: int, rel: float = 1e-5) -> list:
    """Tokens whose k-th and (k+1)-th gate logits (plain f32 matmul) are
    within ``rel`` of the largest |logit|: where two summation orders
    may pick different experts."""
    import torch
    logits = x.float() @ wg.float()
    top = torch.topk(logits, min(k + 1, logits.shape[1]), dim=-1).values
    gap = (top[:, k - 1] - top[:, -1]).abs()
    scale = float(logits.abs().max())
    return [int(i) for i in torch.nonzero(gap < rel * scale).flatten()]


def check_fused_decode_case(x, valid, wg, w1, w2, w3, k, capacity, act,
                            tol_fn) -> tuple[float, float]:
    """Kernel 7 against its plain version: load and overflow exact, dead
    rows exactly 0, y within ``tol_fn(plain y)``.  Returns (max |dy|,
    tolerance)."""
    import torch
    from repro_torch.kernels import fused_decode as fd
    y, load, over = fd.decode_step(x, valid, wg, w1, w2, w3, k=k,
                                   capacity=capacity, activation=act)
    py, pl, po = fd.decode_step_plain(x, valid, wg, w1, w2, w3, k=k,
                                      capacity=capacity, activation=act)
    if not (torch.equal(load, pl) and torch.equal(over, po)):
        ties = near_ties(x, wg, k)
        log(f"fused_decode routing differs from plain; tokens with a "
            f"top-{k}/{k + 1} gap under 1e-5 of the largest |logit|: "
            f"{ties}")
        raise SmokeFailure(f"fused_decode load / overflow differ from the "
                           f"plain version (near-tie tokens {ties})")
    check(bool((y[valid == 0] == 0).all()), "fused_decode: a dead slot's "
                                            "row is not zero")
    err, tol = max_err(y, py), tol_fn(py)
    check(err <= tol, f"fused_decode {x.dtype} {act} C={capacity} differs "
                      f"by {err} > {tol}")
    return err, tol


def check_fused_ragged(gen) -> dict:
    """Kernels 7 and 8 in f32 at cut, ragged shapes (relu and swiglu,
    capacity 1, tied logits; kernel 8 in both modes and both plan
    views), and kernel 8 in "proj" mode at moa-demo's decode shape
    (E = 8, d 512 -> 128 and 128 -> 512, T = 8, k = 2, bf16), timed."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.core.moa import assignment_plan
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels.topk_gating import topk_gating_plain

    def r(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)
    worst7 = worst8 = 0.0
    t, d, e, f, k = 13, 72, 10, 40, 3
    for act in ("relu", "swiglu"):
        for cap, tied in ((8, False), (1, False), (8, True)):
            x, wg = r(t, d), r(d, e)
            if tied:
                wg[:, 7] = wg[:, 2]
            valid = (torch.arange(t, device="cuda") % 4 != 2).float()
            w1, w2, w3 = r(e, d, f, scale=d ** -0.5), \
                r(e, f, d, scale=f ** -0.5), r(e, d, f, scale=d ** -0.5)
            worst7 = max(worst7, check_fused_decode_case(
                x, valid, wg, w1, w2, w3 if act == "swiglu" else None, k,
                cap, act, f32_tol)[0])
    log(f"fused_decode f32 ragged [{t},{d}] E={e} f={f} k={k} (relu, "
        f"swiglu; C=8, C=1, ties): max_abs_err {worst7:.3g}")

    def plan(t_, e_, k_, cap_, dead=0.2):
        w, idx, _ = topk_gating_plain(r(t_, e_), k_, k_)
        keep = torch.rand(t_, device="cuda", generator=gen) >= dead
        return dsp.plan(idx, w * keep[:, None], e_, cap_)

    def routed(x, p_in, p_out, ws, mode, act, tol_fn):
        args = (x, p_in.expert_index, p_in.position, p_out.expert_index,
                p_out.position, p_out.weight, *ws)
        kw = dict(n_experts=p_in.n_experts, capacity=p_in.capacity,
                  mode=mode, activation=act)
        got, want = fd.routed_apply(*args, **kw), \
            fd.routed_apply_plain(*args, **kw)
        err, tol = max_err(got, want), tol_fn(want)
        check(err <= tol, f"fused_routed {mode} {act} {x.dtype} differs by "
                          f"{err} > {tol}")
        return err, args, kw
    p = plan(20, 6, 2, 6)
    check(bool((p.position >= p.capacity).any()), "no drop in the plan")
    ap = assignment_plan(p)
    for mode, act in (("ffn", "relu"), ("ffn", "swiglu"), ("proj", "relu")):
        ws = (r(6, 40, 24, scale=40 ** -0.5), r(6, 24, 40, scale=24 ** -0.5),
              r(6, 40, 24, scale=40 ** -0.5))
        ws = ws[:1] if mode == "proj" else ws[:2] if act == "relu" else ws
        for p_in, p_out in ((p, p), (p, ap)):
            x = r(p_in.expert_index.shape[0], 40)
            worst8 = max(worst8, routed(x, p_in, p_out, ws, mode, act,
                                        f32_tol)[0])
    log(f"fused_routed f32 ragged (ffn relu / swiglu, proj; token- and "
        f"assignment-major): max_abs_err {worst8:.3g}")
    # moa-demo's decode: the Q projection (x [8,512] -> [16,128], out
    # plan assignment-major) and the O projection ([16,128] -> [8,512]).
    bf = torch.bfloat16
    e, d, hh, t, k = 8, 512, 128, 8, 2
    p = plan(t, e, k, 8, dead=0.25)
    ap = assignment_plan(p)
    wq, wo = r(e, d, hh, scale=d ** -0.5, dtype=bf), \
        r(e, hh, d, scale=hh ** -0.5, dtype=bf)
    res = {}
    for name, x, p_in, p_out, w in (("q", r(t, d, dtype=bf), p, ap, wq),
                                    ("o", r(t * k, hh, dtype=bf), ap, p,
                                     wo)):
        err, args, kw = routed(x, p_in, p_out, (w,), "proj", "relu",
                               bf16_tol)
        worst8 = max(worst8, err)
        n_used = int(torch.unique(p_in.expert_index[p_in.position
                                                    < p_in.capacity]).numel())
        rows = int((p_out.position < p_out.capacity).sum())
        b, _ = bound_ms(n_used * w.shape[1] * w.shape[2] * 2
                        + x.numel() * 2 + p_out.expert_index.shape[0]
                        * w.shape[2] * 2, 2 * rows * w.shape[1] * w.shape[2],
                        "bfloat16")
        res[name] = {"ms": cuda_ms(lambda: fd.routed_apply(*args, **kw)),
                     "plain_ms": cuda_ms(
                         lambda: fd.routed_apply_plain(*args, **kw)),
                     "bound_ms": b, "max_abs_err": err, "used_experts": n_used}
    log(f"fused_routed proj at moa-demo decode (bf16): {json.dumps(res)}")
    return {"fused_decode_f32_max_abs_err": worst7,
            "fused_routed_f32_max_abs_err": worst8, "moa_proj": res}


def phase_kernels() -> dict:
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    floor = launch_floor()
    results = [check_topk(gen, floor), *check_dispatch_combine(gen, floor),
               check_gmm(gen), check_topk_bwd(gen, floor),
               *check_eblock(gen, floor),
               check_gmm_bwd(gen)]
    for r in results:
        log("kernel " + json.dumps(r))
    fused = check_fused_ragged(gen)
    torch.cuda.empty_cache()
    return {"rows": {r["name"]: r for r in results}, "fused": fused,
            "floor": floor}


# ---------------------------------------------------------------------------
# phase 3: serve kimi-k2 at full width
# ---------------------------------------------------------------------------

def build_model():
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm

    cfg = get_config(ARCH, n_layers=N_LAYERS)
    check(cfg.kernel_backend == "cuda", "config must default to cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    # The gate is zero-initialized (Appendix A), which would send every
    # token to experts 0..k-1; a served model has trained gates, so the
    # smoke draws them too, and routing spreads over all experts.
    gate = params["blocks"]["periods"]["pos0"]["moe"]["gate"]["wg"]
    gate.normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    torch.cuda.synchronize()
    log(f"materialized {ARCH} (n_layers={N_LAYERS}, d_model={cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.moe_k}) on cuda in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{pm.param_bytes(params) / 1e9:.2f} GB of parameters")
    return cfg, params


def serve_run(engine, prompts, vocab_size: int):
    """Warm up, then serve ``prompts`` (NEW_TOKENS greedy tokens each,
    arrivals one step apart) with the launch counts zeroed just before
    and read just after.  Returns (requests, launch counts, summary)."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib

    engine.generate(np.stack(prompts[:2]), 2)     # warm-up (cuBLAS, caches)
    engine.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = [engine.submit(p, NEW_TOKENS, arrival=i)
            for i, p in enumerate(prompts)]
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    stats = engine.stats
    for r in reqs:
        check(r.done and len(r.tokens) == NEW_TOKENS,
              f"request {r.rid} ended with {len(r.tokens)} tokens")
        check(all(0 <= t < vocab_size for t in r.tokens),
              f"request {r.rid} sampled a token outside the vocabulary")
    summary = {
        "requests": len(prompts),
        "generated_tokens": stats["generated_tokens"], "wall_s": wall,
        "tokens_per_s": stats["generated_tokens"] / wall,
        "prefill_ms_median": 1e3 * statistics.median(
            engine.step_times["prefill"]),
        "decode_step_ms_median": 1e3 * statistics.median(
            engine.step_times["decode"]),
        "decode_steps": stats["decode_steps"], "prefills": stats["prefills"],
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "sample_tokens": reqs[0].tokens[:8]}
    return reqs, counts, summary


def expected_launches(stats: dict, per_prefill: dict,
                      per_decode: dict) -> dict:
    """Launches a serve run must count: per model call of each kind."""
    out: dict = {}
    for table, n in ((per_prefill, stats["prefills"]),
                     (per_decode, stats["decode_steps"])):
        for name, per in table.items():
            out[name] = out.get(name, 0) + per * n
    return {k: v for k, v in out.items() if v}


def check_launches(what: str, counts: dict, want: dict) -> None:
    log(f"{what} launches {counts}, expected {want}")
    check(counts == want, f"{what}: kernel launch counts do not match the "
                          "path")


def phase_serve(cfg, params) -> dict:
    import numpy as np
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    sc = ServeConfig(max_len=PROMPT_LEN + NEW_TOKENS, n_slots=N_REQUESTS)
    engine = ServeEngine(params, cfg, sc, device="cuda")
    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(1, cfg.vocab_size, (PROMPT_LEN,))
               for _ in range(N_REQUESTS)]
    reqs, counts, out = serve_run(engine, prompts, cfg.vocab_size)
    stats = engine.stats
    n_moe = N_LAYERS
    unfused = {"topk_gating": n_moe, "dispatch": n_moe, "combine": n_moe,
               "gmm": 3 * n_moe}
    check_launches("serve", counts,
                   expected_launches(stats, unfused, unfused))
    load = np.sum([t["expert_load"] for t in engine.telemetry], axis=0)
    hist = np.bincount(load.astype(int))
    out.update({
        "decode_overflow_total": stats["overflow_total"],
        "decode_expert_load_histogram": {
            "experts_with_n_assignments": {str(n): int(c) for n, c in
                                           enumerate(hist) if c},
            "busiest": [[int(i), int(load[i])]
                        for i in np.argsort(-load, kind="stable")[:5]]}})
    log("serve " + json.dumps(out))
    return {"summary": out, "counts": counts, "prompts": prompts,
            "engine": engine, "streams": [r.tokens for r in reqs]}


def device_profile(fn) -> dict:
    """Run ``fn`` under torch.profiler (CUPTI): device time by kernel of
    the port (per launch), the largest device ops, and the share of the
    profiled window (host wall clock, ending in a sync) in which the
    device was idle.  The profiler adds host time to every launch, so
    the window runs slower than the same work unprofiled; callers that
    have an unprofiled step time report the idle share against it
    (:func:`idle_share`).  Launch counts are zeroed before ``fn``; a
    kernel that the wrappers launched in the window but that has no
    device time in the profile fails the run, after PROFILE_ATTEMPTS
    profiles of ``fn`` (each call of ``fn`` runs more steps) have all
    lacked it, as in :func:`device_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cuda_lib

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = cuda_lib.launch_counts()
        dev = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        per_kernel = {}
        for name, syms in KERNEL_SYMBOLS.items():
            hits = [(n, ms) for key, n, ms in dev
                    if any(sym in key for sym in syms)]
            calls = sum(n for n, _ in hits)
            if calls:
                per_kernel[name] = {"launches": calls,
                                    "device_ms_per_launch":
                                    sum(ms for _, ms in hits) / calls}
        missing = sorted(k for k, n in launched.items()
                         if n and k not in per_kernel)
        if not missing:
            break
        log(f"device_profile: profile {attempt} of {PROFILE_ATTEMPTS} has "
            f"no device records of {missing} ({len(dev)} device ops in "
            f"all; launch counts {launched})")
    busy = sum(ms for _, _, ms in dev)
    check(not missing, f"kernels launched in the profiled window with no "
                       f"device time in the profile: {missing} (launch "
                       f"counts {launched})")
    top = sorted(dev, key=lambda r: -r[2])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "profiled_window_idle_share": 1.0 - busy / wall_ms if dev
            else None,
            "kernels": per_kernel, "wrapper_launches": launched,
            "top_device_ms": [[k[:70], n, ms] for k, n, ms in top]}


def idle_share(prof: dict, n_steps: int, step_ms: float) -> dict:
    """The device's idle share of an unprofiled step: 1 - (device busy
    time per step under the profiler) / (median unprofiled step)."""
    busy = prof["device_busy_ms"] / n_steps
    return {"device_busy_ms_per_step": busy, "unprofiled_step_ms": step_ms,
            "device_idle_share": 1.0 - busy / step_ms,
            "host_wait_ms_per_step": step_ms - busy}


def phase_profile(engine, prompts, step_ms: float,
                  what: str = "profile") -> dict:
    """Device time by kernel over two decode steps of a full slot pool;
    the idle share against ``step_ms``, the serve run's median decode
    step."""
    import torch

    engine.reset()
    for p in prompts:
        engine.submit(p, 4)
    engine.step()                      # every slot prefills, one decode
    torch.cuda.synchronize()

    def two_steps():
        for _ in range(2):
            engine.step()
    prof = device_profile(two_steps)
    out = dict(decode_steps=2, **prof, **idle_share(prof, 2, step_ms))
    log(f"{what} " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 4: cuda vs ref prefill at full width
# ---------------------------------------------------------------------------

def phase_cross(cfg, params, prompt, engine) -> dict:
    import torch
    from repro_torch.models import lm

    tokens = torch.as_tensor(prompt, dtype=torch.int32,
                             device="cuda")[None, :]
    out = {}
    for backend in ("cuda", "ref"):
        logits, _ = lm.lm_prefill(params, {"tokens": tokens},
                                  engine.kv.new_page(),
                                  cfg.replace(kernel_backend=backend))
        out[backend] = logits
    a, b = out["cuda"], out["ref"]
    check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
          "non-finite logits")
    err = max_err(a, b)
    scale = float(b.abs().max())
    # bf16 activations round differently on the two paths (the kernel
    # path rounds silu(x w1) and x w3 to bf16 before their product, the
    # ref path multiplies in f32), and the difference crosses two layers.
    tol = 0.05 * scale
    res = {"max_abs_err": err, "tol": tol, "logit_scale": scale,
           "top1_cuda": int(a.argmax()), "top1_ref": int(b.argmax())}
    log("cross " + json.dumps(res))
    check(err <= tol, f"cuda vs ref logits differ by {err} > {tol}")
    return res


# ---------------------------------------------------------------------------
# phases 5-6: fused decode (kernels 7 and 8) on the same full-width model,
# then expert-choice routing
# ---------------------------------------------------------------------------

def _layer0_moe(params):
    moe = params["blocks"]["periods"]["pos0"]["moe"]
    return (moe["gate"]["wg"][0], moe["w1"][0], moe["w2"][0],
            moe["w3"][0])


def _used(eidx, pos, capacity: int) -> int:
    import torch
    return int(torch.unique(eidx[pos < capacity]).numel())


def _bitwise_repeat(what: str, fn) -> None:
    """Two launches on the same inputs must give the same bits: the work
    queue hands items to blocks in another order each run, and no sum
    may depend on it."""
    import torch
    a, b = fn(), fn()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    check(all(torch.equal(u, v) for u, v in zip(a, b)),
          f"{what}: two launches on the same inputs differ")


def _fused7_case(x, valid, wg, w1, w2, w3, k, cap, what) -> dict:
    """Kernel 7 on one full-width layer: checked against its plain
    version (load / overflow exact, y within bf16_tol), repeated
    bitwise, timed beside its plain version, with its byte bound over
    the experts this data uses, and beside kernel 8 on the same plan
    (the difference is the gate, the routing and one grid barrier)."""
    from repro_torch.kernels import fused_decode as fd
    t, d = x.shape
    e, f = wg.shape[1], w1.shape[-1]
    args = (x, valid, wg, w1, w2, w3)
    kw = dict(k=k, capacity=cap, activation="swiglu")
    err, tol = check_fused_decode_case(*args, k, cap, "swiglu", bf16_tol)
    _bitwise_repeat(f"fused_decode {what}", lambda: fd.decode_step(*args, **kw))
    flat_e, flat_p, flat_w, _, _ = fd.route_plain(x, valid, wg, k, cap)
    used = _used(flat_e, flat_p, cap)
    rows = int((flat_p < cap).sum())
    b, by = bound_ms(used * 3 * d * f * 2 + d * e * 4 + 2 * t * d * 2
                     + t * 4 + 2 * e * 4,
                     {"float32": 2 * t * d * e,
                      "bfloat16": 2 * rows * 3 * d * f})
    ms = cuda_ms(lambda: fd.decode_step(*args, **kw))
    plain = cuda_ms(lambda: fd.decode_step_plain(*args, **kw))
    # Phase split: kernel 8 over kernel 7's own plan does the same FFN
    # and combine work without the gate, the routing and one barrier.
    plan = [v.reshape(t, k).contiguous() for v in (flat_e, flat_p, flat_w)]
    args8 = (x, plan[0], plan[1], *plan, w1, w2, w3)
    kw8 = dict(n_experts=e, capacity=cap, mode="ffn", activation="swiglu")
    ms8 = cuda_ms(lambda: fd.routed_apply(*args8, **kw8))
    log(f"fused_decode full width [{t},{d}] E={e} f={f} k={k} C={cap} bf16 "
        f"swiglu, {what}: load / overflow equal, two launches bitwise "
        f"equal, max_abs_err {err:.3g} (tol {tol:.3g}); {used} experts "
        f"used; {ms:.4g} ms (plain {plain:.4g}, bound {b:.4g}); kernel 8 "
        f"on the same plan {ms8:.4g} ms")
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, used_experts=used,
                phase_split={"kernel8_same_plan_ms": ms8,
                             "gate_routing_barrier_ms": ms - ms8})


def _fused8_case(x, p, w1, w2, w3, what) -> dict:
    """Kernel 8 (FFN mode) on one full-width layer over the plan p,
    in-plan = out-plan: checked against its plain version within
    bf16_tol, repeated bitwise, timed, with its byte bound."""
    from repro_torch.kernels import fused_decode as fd
    t, d = x.shape
    f = w1.shape[-1]
    args = (x, p.expert_index, p.position, p.expert_index, p.position,
            p.weight, w1, w2, w3)
    kw = dict(n_experts=p.n_experts, capacity=p.capacity, mode="ffn",
              activation="swiglu")
    got, want = fd.routed_apply(*args, **kw), fd.routed_apply_plain(*args,
                                                                    **kw)
    err, tol = max_err(got, want), bf16_tol(want)
    check(err <= tol, f"fused_routed full width, {what}: differs by {err} "
                      f"> {tol}")
    _bitwise_repeat(f"fused_routed {what}", lambda: fd.routed_apply(*args,
                                                                    **kw))
    used = _used(p.expert_index, p.position, p.capacity)
    rows = int((p.position < p.capacity).sum())
    n_assign = p.expert_index.numel()
    b, by = bound_ms(used * 3 * d * f * 2 + 2 * t * d * 2
                     + n_assign * 4 * 4, 2 * rows * 3 * d * f, "bfloat16")
    ms = cuda_ms(lambda: fd.routed_apply(*args, **kw))
    plain = cuda_ms(lambda: fd.routed_apply_plain(*args, **kw))
    log(f"fused_routed full width, {what} (C={p.capacity}): max_abs_err "
        f"{err:.3g} (tol {tol:.3g}), two launches bitwise equal; {used} "
        f"experts used; {ms:.4g} ms (plain {plain:.4g}, bound {b:.4g})")
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, used_experts=used)


def check_fused_full(layer: dict) -> dict:
    """Kernels 7 and 8 at full width against their plain versions on
    layer 0's weights, bf16 swiglu, each case also repeated bitwise:
    kernel 7 at T = 8 slots with two dead (C = 8) and with all 8 live
    (the fused serve path's full pool); kernel 8 on the expert_choice
    plan of the same tokens, and on a plan of 96 tokens that sends more
    than 64 to some experts (C = 72: two row tiles of cells).  All are
    timed with their plain versions; the bounds count the bytes of the
    experts each case uses."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import router as router_lib
    from repro_torch.kernels.topk_gating import topk_gating_plain

    wg, w1, w2, w3 = layer["weights"]
    t, d = N_REQUESTS, wg.shape[0]
    e, f, k = wg.shape[1], w1.shape[-1], layer["k"]
    cap = dsp.capacity_for(t, e, k, layer["capacity_factor"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn(t, d, device="cuda", generator=gen).to(torch.bfloat16)
    valid = torch.ones(t, device="cuda")
    valid[2] = valid[5] = 0.0
    c7 = _fused7_case(x, valid, wg, w1, w2, w3, k, cap, "2 dead slots")
    full = _fused7_case(x, torch.ones(t, device="cuda"), wg, w1, w2, w3, k,
                        cap, "8 live slots")

    spec = router_lib.RouterSpec(policy="expert_choice", k=k,
                                 capacity_factor=layer["capacity_factor"])
    p = router_lib.Router(spec, e).route({"gate": {"wg": wg}}, x,
                                         train=False, mask=valid).plan
    c8 = _fused8_case(x, p, w1, w2, w3, "expert_choice plan")
    # 96 tokens whose logits favour experts 0..7: ~96 assignments each
    # on those, so cells past 64 (a second row tile) fill.
    t96 = 96
    logits = torch.randn(t96, e, device="cuda", generator=gen)
    logits[:, :8] += 4.0
    w, idx, _ = topk_gating_plain(logits, k, k)
    p96 = dsp.plan(idx, w, e, 72)
    check(int(p96.position[p96.position < 72].max()) >= 64,
          "the C = 72 plan fills no second row tile")
    x96 = torch.randn(t96, d, device="cuda", generator=gen).to(torch.bfloat16)
    c96 = _fused8_case(x96, p96, w1, w2, w3, "96 tokens, C = 72")
    shape = (f"one kimi-k2 MoE layer at decode: x [{t},{d}] bf16 (2 dead "
             f"slots), {e} experts [{d},{f}] swiglu, k={k}, C={cap}")
    return {
        "fused_decode": dict(
            name="fused_decode", library_ms=None, shape=shape, **c7,
            full_pool=full),
        "fused_routed": dict(
            name="fused_routed", library_ms=None,
            shape=shape + ", the expert_choice plan", **c8,
            c72=c96)}


def decode_logits(cfg, params, prompts, fused_flags=(False, True)) -> dict:
    """One decode step's logits after a batched prefill of ``prompts``,
    once per fused_decode flag, from the same cache."""
    import numpy as np
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models import lm, transformer

    tokens = torch.as_tensor(np.stack(prompts), dtype=torch.int32,
                             device="cuda")
    b, s = tokens.shape
    cache = pm.zeros(transformer.cache_defs(cfg, b, s + 1), "cuda")
    logits, _ = lm.lm_prefill(params, {"tokens": tokens}, cache, cfg)
    nxt = logits.argmax(dim=-1).to(torch.int32)
    cur = torch.full((b,), s, dtype=torch.int32, device="cuda")
    out = {}
    for fused in fused_flags:
        out[fused], _ = lm.lm_decode(params, nxt, cache, cur,
                                     cfg.replace(fused_decode=fused))
    for v in out.values():
        check(bool(torch.isfinite(v).all()), "non-finite decode logits")
    return out


def compare_fused_logits(what: str, logits: dict) -> dict:
    """Fused vs unfused decode logits within the cross phase's 5 % of
    the logit scale; greedy agreement printed, not gated."""
    a, b = logits[True], logits[False]
    err, scale = max_err(a, b), float(b.abs().max())
    res = {"max_abs_err": err, "tol": 0.05 * scale, "logit_scale": scale,
           "greedy_rows_equal": float(
               (a.argmax(-1) == b.argmax(-1)).float().mean())}
    log(f"{what} fused vs unfused decode logits " + json.dumps(res))
    check(err <= res["tol"], f"{what}: fused vs unfused decode logits "
                             f"differ by {err} > {res['tol']}")
    return res


def stream_agreement(a: list, b: list) -> float:
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    return same / max(sum(len(r) for r in a), 1)


def used_experts_replay(engine, prompts, n_moe: int, streams) -> list:
    """The fused serve run once more, untimed, through a copy of the
    engine's backend whose decode_step also reads kernel 7's load output:
    the experts with load > 0, per MoE layer and decode step.  The
    replay must sample the timed run's streams."""
    import dataclasses
    from repro_torch.kernels import backend as backend_lib

    orig = backend_lib.get(engine.cfg.kernel_backend)
    used = []

    def decode_step(params, x, a, *, mask=None):
        y, telem = orig.decode_step(params, x, a, mask=mask)
        used.append(int((telem["expert_load"] > 0).sum()))
        return y, telem
    backend_lib.register(dataclasses.replace(orig, decode_step=decode_step))
    try:
        engine.reset()
        reqs = [engine.submit(p, NEW_TOKENS, arrival=i)
                for i, p in enumerate(prompts)]
        engine.run()
    finally:
        backend_lib.register(orig)
    check([r.tokens for r in reqs] == streams,
          "the replayed fused serve run sampled other tokens")
    check(len(used) == n_moe * engine.stats["decode_steps"],
          f"{len(used)} fused decode layers in the replay")
    return [used[i::n_moe] for i in range(n_moe)]


def phase_fused(cfg, params, served) -> dict:
    """Kernels 7 and 8 at full width, then the same 8 requests through a
    fused-decode engine: exact launch counts, the decode step's logits
    against the unfused path, used experts per layer and step, the share
    of greedy tokens equal to the unfused run's, and a profile of two
    fused decode steps."""
    import torch
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    kernels = check_fused_full({"weights": _layer0_moe(params),
                                "k": cfg.moe_k,
                                "capacity_factor": cfg.capacity_factor})
    engine = ServeEngine(params, cfg, ServeConfig(
        max_len=PROMPT_LEN + NEW_TOKENS, n_slots=N_REQUESTS,
        fused_decode=True), device="cuda")
    reqs, counts, out = serve_run(engine, served["prompts"], cfg.vocab_size)
    n_moe = N_LAYERS
    check_launches("fused serve", counts, expected_launches(
        engine.stats, {"topk_gating": n_moe, "dispatch": n_moe,
                       "combine": n_moe, "gmm": 3 * n_moe},
        {"fused_decode": n_moe}))
    out.update({
        "greedy_tokens_equal_to_unfused": stream_agreement(
            [r.tokens for r in reqs], served["streams"]),
        "decode_overflow_total": engine.stats["overflow_total"]})
    out["used_experts_per_layer_and_step"] = used_experts_replay(
        engine, served["prompts"], n_moe, [r.tokens for r in reqs])
    log("fused serve " + json.dumps(out))
    cross = compare_fused_logits("kimi-k2", decode_logits(
        cfg, params, served["prompts"]))
    prof = phase_profile(engine, served["prompts"],
                         out["decode_step_ms_median"], "fused profile")
    torch.cuda.empty_cache()
    return {"kernels": kernels, "summary": out, "counts": counts,
            "cross": cross, "profile": prof}


def phase_expert_choice(cfg, params, prompts) -> dict:
    """8 requests under expert_choice routing with fused decode: kernel
    8 at every MoE decode layer, the prefill unfused (no top-k kernel:
    the policy picks tokens per expert with plain tensor ops)."""
    from repro_torch.core.router import RouterSpec
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    ec = cfg.replace(router=RouterSpec(policy="expert_choice",
                                       capacity_factor=cfg.capacity_factor))
    engine = ServeEngine(params, ec, ServeConfig(
        max_len=PROMPT_LEN + NEW_TOKENS, n_slots=N_REQUESTS,
        fused_decode=True), device="cuda")
    reqs, counts, out = serve_run(engine, prompts, cfg.vocab_size)
    n_moe = N_LAYERS
    check_launches("expert_choice serve", counts, expected_launches(
        engine.stats, {"dispatch": n_moe, "combine": n_moe,
                       "gmm": 3 * n_moe}, {"fused_routed": n_moe}))
    decode_logits(ec, params, prompts, fused_flags=(True,))
    out["decode_overflow_total"] = engine.stats["overflow_total"]
    log("expert_choice serve " + json.dumps(out))
    prof = phase_profile(engine, prompts, out["decode_step_ms_median"],
                         "expert_choice profile")
    return {"summary": out, "counts": counts, "profile": prof}


def run_serve() -> dict:
    """Phases 3-6 on the full-width kimi-k2; the model is freed on
    return."""
    cfg, params = build_model()
    served = phase_serve(cfg, params)
    profiled = phase_profile(served["engine"], served["prompts"],
                             served["summary"]["decode_step_ms_median"])
    cross = phase_cross(cfg, params, served["prompts"][0], served["engine"])
    fused = phase_fused(cfg, params, served)
    ec = phase_expert_choice(cfg, params, served["prompts"])
    return {"counts": served["counts"], "summary": served["summary"],
            "profile": profiled, "cross": cross, "fused": fused, "ec": ec}


# ---------------------------------------------------------------------------
# phase 7: serve moa-demo (MoA mixers) fused and unfused
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def check_moa_demo_kernels(cfg, params) -> dict:
    """Every kernel the moa-demo serve path runs, against its plain
    version at the shapes that path gives it, on layer 0's weights with
    bf16 hidden states from the seed.  Unfused, at the prefill of one
    32-token prompt and at a decode step of 8 slots (two dead): top-k,
    dispatch, the GMMs and combine of the MoE FFN (E = 8, k = 2, 512 ->
    1024 -> 512, swiglu) and of the MoA mixer (8 head groups, k = 2, Q
    512 -> 128, O 128 -> 512 through the assignment-major plan).  Fused,
    at the decode step: kernel 7 on the MoE layer, kernel 8 "proj" on
    the MoA layer (the top-k before it is the unfused decode's).
    Tolerances as in phase 2: top-k indices exact and values within
    1e-6, dispatch and combine bitwise, the GMMs and kernels 7 / 8
    within two bf16 ulps (bf16_tol), kernel 7's load and overflow
    exact.  Returns {kernel: (max |err|, tol)}."""
    import torch
    from repro_torch.core import router as router_lib
    from repro_torch.core.moa import assignment_plan
    from repro_torch.kernels import dispatch as dk
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels import gmm as gk
    from repro_torch.kernels.topk_gating import topk_gating, topk_gating_plain
    from repro_torch.models.transformer import _moa_args, _moe_args

    periods = params["blocks"]["periods"]
    moe = _layer(periods["pos0"]["moe"], 0)
    moa = _layer(periods["pos1"]["moa"], 0)
    moe_a, moa_a = _moe_args(cfg), _moa_args(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    bf = torch.bfloat16
    worst: dict = {}

    def note(name, what, err, tol):
        log(f"moa-demo {name} {what}: max_abs_err {err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"moa-demo {name} {what} differs by {err} > {tol}")
        e0, t0 = worst.get(name, (0.0, 0.0))
        worst[name] = (max(e0, err), max(t0, tol))

    def topk(what, x, wg, k):
        logits = (x.float() @ wg.float()).contiguous()
        kk = min(k + 1, logits.shape[1])
        got, want = topk_gating(logits, k, kk), topk_gating_plain(logits, k, kk)
        check(torch.equal(got[1], want[1]),
              f"moa-demo topk_gating indices differ ({what})")
        note("topk_gating", f"{what} {list(logits.shape)} k={k} kk={kk}",
             max(max_err(got[0], want[0]), max_err(got[2], want[2])), 1e-6)

    def disp(what, x, p):
        got = dk.dispatch(x, p.expert_index, p.position,
                          n_experts=p.n_experts, capacity=p.capacity)
        want = dk.dispatch_plain(x, p.expert_index, p.position, None,
                                 p.n_experts, p.capacity)
        note("dispatch", f"{what} {list(x.shape)} -> {list(got.shape)}",
             max_err(got, want), 0.0)
        check(torch.equal(got, want), f"moa-demo dispatch {what} is not "
                                      "bitwise equal to its plain version")
        return got

    def comb(what, buf, p):
        got = dk.combine(buf, p.weight, p.expert_index, p.position)
        want = dk.combine_plain(buf, p.weight, p.expert_index, p.position,
                                buf.dtype)
        note("combine", f"{what} {list(buf.shape)} -> {list(got.shape)}",
             max_err(got, want), 0.0)
        check(torch.equal(got, want), f"moa-demo combine {what} is not "
                                      "bitwise equal to its plain version")
        return got

    def gmm(what, xb, w, act):
        got, want = gk.gmm(xb, w, activation=act), gk.gmm_plain(xb, w, act)
        note("gmm", f"{what} {act} {list(xb.shape)} x {list(w.shape)}",
             max_err(got, want), bf16_tol(want))
        return got

    def route(a, layer, x, valid):
        p = router_lib.build(a).route(layer, x, train=False, mask=valid).plan
        # The backend hands the kernels contiguous plan views.
        return p._replace(expert_index=p.expert_index.contiguous(),
                          position=p.position.contiguous(),
                          weight=p.weight.contiguous())

    def routed(what, x, p_in, p_out, w):
        args = (x, p_in.expert_index, p_in.position, p_out.expert_index,
                p_out.position, p_out.weight, w)
        kw = dict(n_experts=p_in.n_experts, capacity=p_in.capacity,
                  mode="proj")
        want = fd.routed_apply_plain(*args, **kw)
        note("fused_routed", f"proj {what} {list(x.shape)} -> "
             f"{list(want.shape)}", max_err(fd.routed_apply(*args, **kw),
                                            want), bf16_tol(want))

    for what, t in (("prefill", PROMPT_LEN), ("decode", N_REQUESTS)):
        valid = torch.ones(t, device="cuda")
        if what == "decode":
            valid[2] = valid[5] = 0.0
        # The MoE FFN.
        x = torch.randn(t, cfg.d_model, device="cuda", generator=gen).to(bf)
        topk(f"moe {what}", x, moe["gate"]["wg"], cfg.moe_k)
        p = route(moe_a, moe, x, valid)
        buf = disp(f"moe {what}", x, p)
        h = gmm(f"moe {what} w1", buf, moe["w1"], "silu")
        g = gmm(f"moe {what} w3", buf, moe["w3"], "none")
        out = gmm(f"moe {what} w2", (h.float() * g.float()).to(bf),
                  moe["w2"], "none")
        comb(f"moe {what}", out, p)
        if what == "decode":
            cap = router_lib.build(moe_a).capacity(t, train=False)
            err, tol = check_fused_decode_case(
                x, valid, moe["gate"]["wg"], moe["w1"], moe["w2"],
                moe["w3"], cfg.moe_k, cap, "swiglu", bf16_tol)
            note("fused_decode", f"[{t},{cfg.d_model}] E={cfg.n_experts} "
                 f"k={cfg.moe_k} C={cap} swiglu, 2 dead slots, load / "
                 "overflow equal", err, tol)
        # The MoA mixer: Q through the token-major plan into the
        # assignment-major rows, O back.
        x = torch.randn(t, cfg.d_model, device="cuda", generator=gen).to(bf)
        topk(f"moa {what}", x, moa["gate"]["wg"], cfg.moa_k)
        p = route(moa_a, moa, x, valid)
        ap = assignment_plan(p)
        q = gmm(f"moa {what} wq", disp(f"moa {what} q", x, p), moa["wq"],
                "none")
        comb(f"moa {what} q", q, ap)
        o_sel = torch.randn(t * cfg.moa_k, moa["wo"].shape[1], device="cuda",
                            generator=gen).to(bf)
        o = gmm(f"moa {what} wo", disp(f"moa {what} o", o_sel, ap),
                moa["wo"], "none")
        comb(f"moa {what} o", o, p)
        if what == "decode":
            routed("q", x, p, ap, moa["wq"])
            routed("o", o_sel, ap, p, moa["wo"])
    log(f"moa-demo kernels against their plain versions: {json.dumps(worst)}")
    return worst


def phase_moa() -> dict:
    """moa-demo at its published widths (4 layers, d 512, 8 head groups
    of 2 heads, MoE FFN of 8 experts), bf16 weights from the seed with
    the gates redrawn, 8 requests unfused and fused.  Fused: kernel 8 in
    "proj" mode twice per MoA layer and kernel 7 once per MoE layer per
    decode step; the two runs' streams are compared and the decode
    logits held to the cross phase's tolerance."""
    import numpy as np
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config, layer_kinds
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config(MOA_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    periods = params["blocks"]["periods"]
    for gate in (periods["pos0"]["moe"]["gate"]["wg"],
                 periods["pos1"]["moa"]["gate"]["wg"]):
        gate.normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    kernel_errs = check_moa_demo_kernels(cfg, params)
    kinds = layer_kinds(cfg)
    n_rep = cfg.n_layers // cfg.period
    n_moe = n_rep * sum(k.ffn == "moe" for k in kinds)
    n_moa = n_rep * sum(k.mixer == "moa" for k in kinds)
    rs = np.random.RandomState(SEED + 1)
    prompts = [rs.randint(1, cfg.vocab_size, (PROMPT_LEN,))
               for _ in range(N_REQUESTS)]
    prefill = {"topk_gating": n_moe + n_moa, "dispatch": n_moe + 2 * n_moa,
               "combine": n_moe + 2 * n_moa, "gmm": 3 * n_moe + 2 * n_moa}
    per_decode = {False: prefill,
                  True: {"topk_gating": n_moa, "fused_routed": 2 * n_moa,
                         "fused_decode": n_moe}}
    runs = {}
    for fused in (False, True):
        engine = ServeEngine(params, cfg, ServeConfig(
            max_len=PROMPT_LEN + NEW_TOKENS, n_slots=N_REQUESTS,
            fused_decode=fused), device="cuda")
        reqs, counts, out = serve_run(engine, prompts, cfg.vocab_size)
        check_launches(f"moa-demo serve (fused={fused})", counts,
                       expected_launches(engine.stats, prefill,
                                         per_decode[fused]))
        out["moa_overflow_total"] = engine.stats["moa_overflow_total"]
        runs[fused] = (reqs, counts, out, engine)
    agree = stream_agreement([r.tokens for r in runs[True][0]],
                             [r.tokens for r in runs[False][0]])
    cross = compare_fused_logits("moa-demo", decode_logits(cfg, params,
                                                           prompts))
    fused_out = runs[True][2]
    prof = phase_profile(runs[True][3], prompts,
                         fused_out["decode_step_ms_median"], "moa profile")
    res = {"config": f"{MOA_ARCH}: {n_moa} MoA + {n_moe} MoE layers, "
                     f"d {cfg.d_model}, bf16",
           "unfused": runs[False][2], "fused": fused_out,
           "greedy_tokens_equal_fused_vs_unfused": agree, "cross": cross,
           "sample_streams": {"unfused": runs[False][0][0].tokens,
                              "fused": runs[True][0][0].tokens}}
    log("moa serve " + json.dumps(res))
    del params, runs
    torch.cuda.empty_cache()
    return {"summary": res, "counts": fused_out["launches"],
            "profile": prof, "kernel_errs": kernel_errs}


# ---------------------------------------------------------------------------
# phase 8: train the paper's MoE-256 LM at full width
# ---------------------------------------------------------------------------

def build_train_model():
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.moe_paper import paper_config
    from repro_torch.models.paper_lm import paper_lm_defs

    cfg = paper_config(TRAIN_CONFIG, vocab_size=TRAIN_VOCAB)
    check(cfg.kernel_backend == "cuda" and cfg.dtype == torch.float32,
          "the paper config must default to cuda and f32")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(paper_lm_defs(cfg), gen, "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pm.tree_leaves(params))
    log(f"materialized {TRAIN_CONFIG} (vocab {cfg.vocab_size}, d "
        f"{cfg.d_model}, {cfg.n_experts} experts {cfg.d_model}->"
        f"{cfg.expert_hidden}->{cfg.d_model} top-{cfg.k}) on cuda in "
        f"{time.perf_counter() - t0:.1f} s: {n} parameters, "
        f"{pm.param_bytes(params) / 1e9:.2f} GB")
    check(n == 1_085_410_304, f"{n} parameters, expected 1,085,410,304")
    return cfg, params


def _loss_fn(cfg):
    from repro_torch.models.paper_lm import paper_lm_loss
    return lambda p, b, g: paper_lm_loss(p, b, cfg, generator=g)


def phase_train(cfg, params, workdir, name: str = TRAIN_CONFIG,
                launches: dict = TRAIN_LAUNCHES, what: str = "train") -> dict:
    """TRAIN_STEPS steps of the paper LM ``cfg`` through the Trainer
    (factored Adam, a checkpoint every TRAIN_CKPT steps): launch counts
    exactly ``launches`` a step, every metric finite, peak memory under
    the card's; then a profile of two more steps."""
    import math
    import torch
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels import cuda_lib
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train.trainer import Trainer, TrainLoopConfig, step_seed

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                    batch_size=TRAIN_B, seed=SEED)
    oc = opt_lib.OptConfig(kind="factored")
    trainer = Trainer(
        loss_fn=_loss_fn(cfg), params=params, oc=oc,
        loop=TrainLoopConfig(total_steps=TRAIN_STEPS,
                             checkpoint_every=TRAIN_CKPT,
                             keep_checkpoints=2, log_every=1, seed=SEED),
        data_iter=DataIterator(dc, device="cuda"), workdir=workdir,
        kernel_backend="cuda", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: TRAIN_STEPS * v for k, v in launches.items()}
    log(f"{what} launches {counts}, expected {want}")
    check(counts == want, f"{what}: launch counts do not match the "
                          "derived per-step counts")
    total = torch.cuda.get_device_properties(0).total_memory
    check(peak < total, f"{what}: peak {peak} >= the card's {total} bytes")
    log_rows = trainer.metrics_log
    check(len(log_rows) == TRAIN_STEPS, f"{len(log_rows)} logged steps")
    for m in log_rows:
        check(all(math.isfinite(m[k]) for k in ("loss", "xent", "aux_loss",
                                                "grad_norm")),
              f"non-finite metrics at step {m['step']}: {m}")
    check(trainer.ckpt.all_steps() == [TRAIN_CKPT, TRAIN_STEPS],
          f"checkpoints {trainer.ckpt.all_steps()}")
    steady = trainer.step_times[2:]
    tokens = TRAIN_B * TRAIN_S
    keys = ("loss", "xent", "aux_loss", "max_over_mean_load", "cv_load",
            "fraction_dropped", "grad_norm")
    out = {
        "config": f"{name}, vocab {cfg.vocab_size}, f32",
        "steps": TRAIN_STEPS, "tokens_per_step": tokens,
        "step_ms_median_steps_3_to_12": 1e3 * statistics.median(steady),
        "step_ms_all": [1e3 * t for t in trainer.step_times],
        "tokens_per_s": tokens / statistics.median(steady),
        "wall_s_with_checkpoints": wall,
        "max_memory_allocated_gib": peak / 2**30,
        "max_memory_allocated_gb": peak / 1e9,
        "first": {k: log_rows[0][k] for k in keys},
        "last": {k: log_rows[-1][k] for k in keys},
        "launches": counts,
        "straggler_events": trainer.straggler_events,
    }
    log(f"{what} " + json.dumps(out))

    # Two more steps under the profiler.
    def two_steps():
        for step in (TRAIN_STEPS, TRAIN_STEPS + 1):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(step_seed(SEED, step))
            _, m = trainer.step_fn(trainer.state, next(trainer.data_iter),
                                   gen)
            float(m["loss"])
    dprof = device_profile(two_steps)
    prof = dict(train_steps=2, **dprof, **idle_share(
        dprof, 2, out["step_ms_median_steps_3_to_12"]))
    log(f"{what} profile " + json.dumps(prof))
    return {"summary": out, "counts": counts, "profile": prof, "dc": dc,
            "opt": trainer.state["opt"], "oc": oc}


# ---------------------------------------------------------------------------
# phase 10: one step's gradients, cuda vs ref
# ---------------------------------------------------------------------------

# Gradients of the MoE leaves, cuda vs ref (see phase_grads): each within
# GRAD_TOL normwise (||g_cuda - g_ref|| / ||g_ref||, Frobenius), w1's once
# the terms of its relu flips are taken out; EXPERT_TOL of an expert's
# largest w1 gradient entry separates a flip from rounding.
MOE_LEAVES = ("gate.wg", "gate.wnoise", "w2", "w1")
GRAD_TOL = 1e-5
EXPERT_TOL = 1e-4


def _capture_expert_ffn(name: str, store: dict):
    """Register a copy of kernel backend ``name`` whose expert FFN also
    keeps its input buffer (``buf``) and the gradient of its output
    (``dout``) in ``store``; returns the original, to register back."""
    import dataclasses
    from repro_torch.kernels import backend as backend_lib
    orig = backend_lib.get(name)

    def expert_ffn(params, x, a, *, rows=None):
        out = orig.expert_ffn(params, x, a, rows=rows)
        store["buf"] = x.detach()
        out.register_hook(lambda g: store.update(dout=g.detach()))
        return out
    backend_lib.register(dataclasses.replace(orig, expert_ffn=expert_ffn))
    return orig


def norm_rel_err(got, want) -> float:
    """||got - want|| / ||want|| (Frobenius), a slab at a time."""
    import math
    import torch
    diff = ref = 0.0
    for g, w in zip(_slabs(got), _slabs(want)):
        diff += float(torch.linalg.vector_norm(g.float() - w.float())) ** 2
        ref += float(torch.linalg.vector_norm(w.float())) ** 2
    return math.sqrt(diff) / max(math.sqrt(ref), 1e-30)


# Experts a slab in w1_check (a moe-4096-h w1 gradient is 8.6 GB).
W1_SLAB = 256


def w1_check(gc, gr, w1, w2, runs: dict) -> dict:
    """w1's gradient [E, d, f] under "cuda" (``gc``) against "ref"
    (``gr``), without the terms of its relu flips (see phase_grads), a
    slab of W1_SLAB experts at a time.

    Each run's pre-activations z = buf w1, as its own path computes them
    (the "cuda" path's GMM kernel, which its backward pass reruns; the
    "ref" path's torch.bmm); the elements whose relu masks disagree; and
    the part of each run's w1 gradient that those elements carry,
    buf^T (dh * [z > 0] * flip) with dh = dout w2^T, taken out of both
    gradients.  Checks that the pre-activations agree within f32
    rounding, that the experts whose raw gradients differ by more than
    EXPERT_TOL of their largest entry are exactly those whose flipped
    terms do, that without the flips every expert is within EXPERT_TOL
    and the whole gradient within GRAD_TOL normwise."""
    import math
    import torch
    from repro_torch.kernels import gmm as gk
    z = {"cuda": gk.gmm(runs["cuda"]["buf"], w1, activation="none"),
         "ref": torch.bmm(runs["ref"]["buf"], w1)}
    flip = (z["cuda"] > 0) != (z["ref"] > 0)
    z_err, z_tol = max_err(z["cuda"], z["ref"]), f32_tol(z["ref"])
    past, carried, after = [], [], []
    sq = dict.fromkeys(("kept_diff", "kept_ref", "raw_diff", "raw_ref"), 0.0)
    kept_err = kept_max = 0.0
    for e0 in range(0, w1.shape[0], W1_SLAB):
        sl = slice(e0, e0 + W1_SLAB)
        part = {}
        for b in z:
            dh = torch.bmm(runs[b]["dout"][sl], w2[sl].transpose(1, 2))
            part[b] = torch.bmm(runs[b]["buf"][sl].transpose(1, 2),
                                dh * (flip[sl] & (z[b][sl] > 0)))
        raw_c, raw_r = gc[sl], gr[sl]
        kept_c, kept_r = raw_c - part["cuda"], raw_r - part["ref"]
        scale = raw_r.abs().amax(dim=(1, 2)).clamp(min=1e-30)
        past.append((raw_c - raw_r).abs().amax(dim=(1, 2)) / scale
                    > EXPERT_TOL)
        carried.append((part["cuda"] - part["ref"]).abs().amax(dim=(1, 2))
                       / scale > EXPERT_TOL)
        after.append((kept_c - kept_r).abs().amax(dim=(1, 2)) / scale)
        for key, t in (("kept_diff", kept_c - kept_r), ("kept_ref", kept_r),
                       ("raw_diff", raw_c - raw_r), ("raw_ref", raw_r)):
            sq[key] += float(torch.linalg.vector_norm(t)) ** 2
        kept_err = max(kept_err, max_err(kept_c, kept_r))
        kept_max = max(kept_max, abs_max(kept_r))
        del part, kept_c, kept_r
    past, carried, after = (torch.cat(v) for v in (past, carried, after))

    def experts(mask):
        return [int(i) for i in torch.nonzero(mask).flatten()]
    out = {"w1_raw_norm_rel_err": math.sqrt(sq["raw_diff"] / sq["raw_ref"]),
           "z_max_abs_err": z_err, "z_tol": z_tol,
           "relu_flipped_elements": int(flip.sum()),
           "relu_flipped_experts": experts(flip.any(dim=(1, 2))),
           "w1_experts_past_rounding": experts(past),
           "w1_experts_carried_by_flips": experts(carried),
           "w1_expert_max_rel_err_without_flips": float(after.max()),
           "expert_tol": EXPERT_TOL,
           "norm_rel_err": math.sqrt(sq["kept_diff"]
                                     / max(sq["kept_ref"], 1e-60)),
           "max_rel_err": kept_err / max(kept_max, 1e-30)}
    check(z_err <= z_tol,
          f"the paths' pre-activations differ by {z_err} > {z_tol}")
    check(torch.equal(past, carried),
          f"experts past rounding {out['w1_experts_past_rounding']} are not "
          f"those the relu flips carry {out['w1_experts_carried_by_flips']}")
    check(out["w1_expert_max_rel_err_without_flips"] <= EXPERT_TOL,
          f"without its relu flips, an expert's w1 gradient still differs "
          f"by {float(after.max())} of its largest entry > {EXPERT_TOL}")
    check(out["norm_rel_err"] <= GRAD_TOL,
          f"w1's gradient without its relu flips differs by "
          f"{out['norm_rel_err']} normwise > {GRAD_TOL}")
    return out


def phase_grads(cfg, params, dc) -> dict:
    """Loss and gradients of one step from the same parameters and the
    same draws under the "cuda" backend (twice) and the "ref" one.

    Both paths run in f32 with the same routing and plan (the gate's
    inputs come from the same ops, and both top-k break ties to the
    lower index), but they sum in other orders (the GMM kernels against
    cuBLAS, the combine kernel against an index gather), so values
    differ by f32 roundings: the loss within 1e-5 relative, each MoE
    leaf's gradient within GRAD_TOL normwise.  w1's gradient passes
    through relu'(z), which jumps at 0: a pre-activation within a
    rounding of 0 can take opposite masks in the two paths, and then
    one token's whole term x[c, :] * dh[c, j] is in one path's gradient
    of that expert and not in the other's.  So the run recomputes both
    paths' pre-activations, checks that they agree within f32 rounding
    (so a flip is an element within a rounding of 0), takes the flipped
    elements' terms out of both w1 gradients, and holds the rest to
    GRAD_TOL normwise and every expert to EXPERT_TOL; the experts whose
    raw gradients differ by more than EXPERT_TOL must be exactly those
    whose flipped terms do.  The two "cuda" runs must agree bit for bit
    (no atomics on this path)."""
    import dataclasses
    import math
    import torch
    from repro_torch.common.param import tree_leaves
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import backend as backend_lib
    from repro_torch.models.paper_lm import paper_lm_loss

    batch = batch_at(dc, TRAIN_STEPS + 2, device="cuda")

    def moe_leaf(key):
        node = params["moe"]
        for part in key.split("."):
            node = node[part]
        return node

    res, runs = {}, {}
    for run in ("cuda", "cuda_again", "ref"):
        backend = run.split("_")[0]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        c = dataclasses.replace(cfg, kernel_backend=backend)
        runs[run] = {}
        orig = _capture_expert_ffn(backend, runs[run])
        try:
            loss, _ = paper_lm_loss(params, batch, c, generator=gen)
            loss.backward()
        finally:
            backend_lib.register(orig)
        leaves = tree_leaves(params)
        if backend == "cuda":
            check(all(p.grad is not None for p in leaves),
                  "a parameter has no gradient through backend cuda")
            check(all(bool(torch.isfinite(p.grad).all()) for p in leaves),
                  "a gradient is not finite")
            for key in MOE_LEAVES:
                check(bool((moe_leaf(key).grad != 0).any()),
                      f"the gradient of moe.{key} is zero")
        res[run] = (float(loss.detach()),
                    {k: moe_leaf(k).grad.detach() for k in MOE_LEAVES})
        for p in leaves:
            p.grad = None
        del loss
    lc, gc_ = res["cuda"]
    lr_, gr = res["ref"]
    w1 = w1_check(gc_["w1"], gr["w1"], moe_leaf("w1").detach(),
                  moe_leaf("w2").detach(), runs)
    out = {"loss_cuda": lc, "loss_ref": lr_,
           "loss_rel_err": abs(lc - lr_) / abs(lr_),
           "grad_norm_rel_err": {"w1": w1.pop("norm_rel_err")},
           "grad_max_rel_err": {"w1": w1.pop("max_rel_err")},
           "tol": GRAD_TOL,
           "cuda_repeat_bitwise": {k: bool(torch.equal(
               gc_[k], res["cuda_again"][1][k])) for k in MOE_LEAVES},
           **w1}
    for k in (k for k in MOE_LEAVES if k != "w1"):
        out["grad_norm_rel_err"][k] = norm_rel_err(gc_[k], gr[k])
        out["grad_max_rel_err"][k] = max_err(gc_[k], gr[k]) / max(
            abs_max(gr[k]), 1e-30)
    log("grads " + json.dumps(out))
    check(math.isfinite(lc) and out["loss_rel_err"] <= 1e-5,
          f"cuda vs ref loss {lc} vs {lr_}")
    check(all(out["cuda_repeat_bitwise"].values()),
          "the cuda path's MoE gradients differ between two identical runs")
    for k in MOE_LEAVES:
        check(out["grad_norm_rel_err"][k] <= GRAD_TOL,
              f"moe.{k} gradient differs by {out['grad_norm_rel_err'][k]} "
              f"normwise > {GRAD_TOL}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the e-blocked regime against the resident one
# ---------------------------------------------------------------------------

def phase_eblock(cfg, params) -> dict:
    """moe_apply forward + backward at the training shape with the
    dispatch slab forced to E_BLOCK against the resident default.
    Tolerance for outputs and gradients: 1e-5 of the largest entry (the
    e-blocked combine groups the k = 4 terms of a token by slab, so its
    sums round in another order)."""
    import dataclasses
    import torch
    from repro_torch.core import moe as moe_lib
    from repro_torch.core import router as router_lib
    from repro_torch.kernels import backend as backend_lib
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.models.paper_lm import _moe_args

    a = _moe_args(cfg)
    mp = params["moe"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    t = TRAIN_B * TRAIN_S
    x = torch.randn(t, cfg.d_model, device="cuda", generator=gen)
    noise = torch.randn(t, cfg.n_experts, device="cuda", generator=gen)
    gy = torch.randn(t, cfg.d_model, device="cuda", generator=gen)
    router = router_lib.build(a, topk_impl=backend_lib.get("cuda").topk_impl)
    with torch.no_grad():
        plan = router.route(mp, x, train=True, noise=noise).plan
        args = (x, plan.expert_index, plan.position)
        kw = dict(n_experts=plan.n_experts, capacity=plan.capacity)
        same = torch.equal(ops.dispatch(*args, **kw),
                           ops.dispatch(*args, e_block=E_BLOCK, **kw))
    check(same, "e-blocked dispatch buffer differs from the resident one")
    leaves = {"w1": mp["w1"], "w2": mp["w2"], "wg": mp["gate"]["wg"],
              "wnoise": mp["gate"]["wnoise"]}
    res, counts = {}, {}
    for e_block in (None, E_BLOCK):
        ai = dataclasses.replace(a, dispatch_e_block=e_block)
        xg = x.clone().requires_grad_(True)

        def fwd_bwd():
            y, aux = moe_lib.moe_apply(mp, xg, ai, train=True, noise=noise)
            ((y * gy).sum() + aux["aux_loss"]).backward()
            return y.detach()
        cuda_lib.reset_launch_counts()
        y = fwd_bwd()
        torch.cuda.synchronize()
        counts[str(e_block)] = cuda_lib.launch_counts()
        res[e_block] = {"y": y, "x": xg.grad,
                        **{k: v.grad.clone() for k, v in leaves.items()}}
        for v in leaves.values():
            v.grad = None
    want = {"topk_gating": 1, "topk_gating_bwd": 1, "dispatch_eblock": 2,
            "combine_eblock": 2, "gmm": 3, "gmm_bwd": 4}
    check(counts[str(E_BLOCK)] == want,
          f"e-blocked launches {counts[str(E_BLOCK)]}, expected {want}")
    errs = {}
    for k in res[None]:
        scale = max(float(res[None][k].abs().max()), 1e-30)
        errs[k] = max_err(res[E_BLOCK][k], res[None][k]) / scale
        check(errs[k] <= 1e-5, f"e-blocked {k} differs by {errs[k]} of its "
                               "largest entry > 1e-5")

    def eblock_step():
        xg.grad = None
        y, aux = moe_lib.moe_apply(
            mp, xg, dataclasses.replace(a, dispatch_e_block=E_BLOCK),
            train=True, noise=noise)
        ((y * gy).sum() + aux["aux_loss"]).backward()
    prof = device_profile(eblock_step)
    for v in leaves.values():
        v.grad = None
    out = {"dispatch_bitwise": same, "rel_err": errs, "tol": 1e-5,
           "launches": counts, "profile": prof}
    log("eblock " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 11: train the paper's hierarchical MoE-4096-h at full width
# ---------------------------------------------------------------------------

def build_hmoe():
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.moe_paper import paper_config
    from repro_torch.models.paper_lm import paper_lm_defs

    cfg = paper_config(HMOE_CONFIG)
    check(cfg.kernel_backend == "cuda" and cfg.dtype == torch.float32,
          "the paper config must default to cuda and f32")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(paper_lm_defs(cfg), gen, "cuda")
    # Zero gates send every token to groups 0 and 1 and to their experts
    # 0 and 1; the smoke draws both levels' gates, as arctic's, so that
    # routing spreads over all 4096 experts.
    for level in ("gate_primary", "gate_secondary"):
        params["moe"][level]["wg"].normal_(0.0, cfg.d_model ** -0.5,
                                           generator=gen)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pm.tree_leaves(params))
    g, b = cfg.hierarchical
    log(f"materialized {HMOE_CONFIG} (vocab {cfg.vocab_size}, d "
        f"{cfg.d_model}, {g} groups of {b} experts {cfg.d_model}->"
        f"{cfg.expert_hidden}->{cfg.d_model}, top-2 at each level) on cuda "
        f"in {time.perf_counter() - t0:.1f} s: {n} parameters, "
        f"{pm.param_bytes(params) / 1e9:.2f} GB")
    check(n == HMOE_PARAMS, f"{n} parameters, expected {HMOE_PARAMS}")
    return cfg, params


def _hmoe_topk(level, logits, k, kk, gen, floor) -> tuple:
    """Top-k (kernel 1) and its backward (B5) on one level's logits
    against their plain versions, timed.  Returns both rows and the
    kernel's (combine weights, indices)."""
    import torch
    from repro_torch.kernels import topk_gating as tk
    n, e = logits.shape
    got, want = tk.topk_gating(logits, k, kk), tk.topk_gating_plain(
        logits, k, kk)
    check(torch.equal(got[1], want[1]), f"hmoe {level} top-k indices differ")
    err = max(max_err(got[0], want[0]), max_err(got[2], want[2]))
    check(err <= 1e-6, f"hmoe {level} top-k values differ by {err}")
    row = dict(max_abs_err=err, tol=1e-6, **_timed_call(
        f"hmoe {level} topk_gating [{n},{e}] k={k} kk={kk}",
        lambda: tk.topk_gating(logits, k, kk), "topk_gating_kernel",
        n * e * 4 + n * k * 4 + n * kk * 8, 0, "float32", floor,
        plain=lambda: tk.topk_gating_plain(logits, k, kk)))
    cw, idx, _ = got
    dw_in = torch.randn(n, k, device="cuda", generator=gen)
    dvals = torch.randn(n, kk, device="cuda", generator=gen)
    check(torch.equal(tk.topk_gating_bwd(cw, idx, dw_in, dvals, e),
                      tk.topk_gating_bwd_plain(cw, idx, dw_in, dvals, e)),
          f"hmoe {level} top-k backward differs from its plain version")
    row_bwd = dict(max_abs_err=0.0, tol=0.0, **_timed_call(
        f"hmoe {level} topk_gating_bwd [{n},{e}] k={k} kk={kk}",
        lambda: tk.topk_gating_bwd(cw, idx, dw_in, dvals, e),
        "topk_gating_bwd_kernel", n * e * 4 + n * k * 8 + n * kk * 8, 0,
        "float32", floor,
        plain=lambda: tk.topk_gating_bwd_plain(cw, idx, dw_in, dvals, e)))
    return row, row_bwd, cw, idx[:, :k].contiguous()


def _hmoe_dispatch_combine(level, x, plan, gen, floor) -> tuple:
    """Dispatch (kernel 2) and B7, combine (kernel 4) and B6 on one
    level's plan against their plain versions, bit for bit, timed.
    Bytes count the token rows that hold a kept assignment once.  As in
    ``dispatch_combine_times``, combine's ``dev_ms`` is taken with the
    L2 cache cold and its back-to-back times, which re-read a buffer the
    L2 may hold, are kept apart.  Returns the dispatched buffer and both
    rows."""
    import torch
    from repro_torch.kernels import dispatch as dk
    ei, po, w = plan.expert_index, plan.position, plan.weight
    e, cap = plan.n_experts, plan.capacity
    n, d = x.shape
    k = ei.shape[1]
    kept = po < cap
    n_kept, rows_read = int(kept.sum()), int(kept.any(dim=1).sum())
    buf = dk.dispatch(x, ei, po, n_experts=e, capacity=cap)
    check(torch.equal(buf, dk.dispatch_plain(x, ei, po, None, e, cap)),
          f"hmoe {level} dispatch differs from its plain version")
    g_tok = torch.randn(n, d, device="cuda", generator=gen)
    check(torch.equal(dk.dispatch(g_tok, ei, po, w, n_experts=e,
                                  capacity=cap),
                      dk.dispatch_plain(g_tok, ei, po, w, e, cap)),
          f"hmoe {level} B7 (dispatch scaled by w) differs from its plain "
          "version")
    disp_bytes = rows_read * d * 4 + n * k * 8 + e * cap * d * 4
    shape = f"[{n},{d}] <-> [{e},{cap},{d}], k={k}, {n_kept} kept"
    row_d = dict(max_abs_err=0.0, tol=0.0, **_timed_call(
        f"hmoe {level} dispatch {shape}",
        lambda: dk.dispatch(x, ei, po, n_experts=e, capacity=cap),
        "dispatch_kernel", disp_bytes, 0, "float32", floor,
        plain=lambda: dk.dispatch_plain(x, ei, po, None, e, cap)))
    row_d["B7"] = _timed_call(
        f"hmoe {level} B7 dispatch scaled {shape}",
        lambda: dk.dispatch(g_tok, ei, po, w, n_experts=e, capacity=cap),
        "dispatch_kernel", disp_bytes + n * k * 4, 0, "float32", floor,
        plain=lambda: dk.dispatch_plain(g_tok, ei, po, w, e, cap))
    ybuf = torch.randn(e, cap, d, device="cuda", generator=gen)
    unit = torch.ones_like(w)
    for name, wt in (("combine", w), ("B6", unit)):
        check(torch.equal(dk.combine(ybuf, wt, ei, po),
                          dk.combine_plain(ybuf, wt, ei, po, torch.float32)),
              f"hmoe {level} {name} differs from its plain version")
    comb = [n_kept * d * 4 + n * k * 12 + n * d * 4, 2 * n_kept * d]
    row_c = dict(max_abs_err=0.0, tol=0.0, **_timed_call(
        f"hmoe {level} combine {shape}",
        lambda: dk.combine(ybuf, w, ei, po), "combine_kernel", *comb,
        "float32", floor,
        plain=lambda: dk.combine_plain(ybuf, w, ei, po, torch.float32)))
    row_c["B6"] = _timed_call(
        f"hmoe {level} B6 combine, unit weights {shape}",
        lambda: dk.combine(ybuf, unit, ei, po), "combine_kernel", *comb,
        "float32", floor,
        plain=lambda: dk.combine_plain(ybuf, unit, ei, po, torch.float32))
    flush = torch.empty(32 * 2 ** 20, device="cuda")
    for row, wt in ((row_c, w), (row_c["B6"], unit)):
        cold = device_ms(lambda: (flush.zero_(), dk.combine(ybuf, wt, ei, po)),
                         ("combine_kernel",))
        check("combine_kernel" in cold,
              f"hmoe {level}: no combine_kernel in the L2-cold profile")
        row.update(dev_ms_l2_warm=row.pop("dev_ms"),
                   queued_ms_l2_warm=row.pop("queued_ms"),
                   dev_ms=cold["combine_kernel"])
    log(f"hmoe {level} combine, L2 cold: {row_c['dev_ms']} ms a launch "
        f"(B6 {row_c['B6']['dev_ms']})")
    return buf, row_d, row_c


def check_hmoe_kernels(cfg, params, gen, floor) -> dict:
    """Every kernel of the moe-4096-h training step against its plain
    version at the shapes a step gives it, in f32 (T = 4096 tokens of
    d = 512, k = 2 at each level): the primary level's top-k over
    [4096, 16] and its dispatch into [16, HMOE_CP, 512] and combine back;
    the secondary level's top-k over the 16 x HMOE_CP slot rows of 256
    experts, with the primary plan's empty slots masked, and its dispatch
    into [4096, HMOE_CS, 512] and combine back, on the plan over the flat
    4096 experts that the router builds; B5, B6 and B7 at both levels;
    the expert FFN's GMMs over all 4096 experts with the plan's rows
    (w1 with relu, w1 without: the backward pass's recomputed
    pre-activation, w2) and the transposed ones (dx = dz w^T and dw =
    x^T dz at w1's and w2's shapes).  Tolerances as in phase 2: top-k
    indices exact and values within 1e-6, B5, dispatch, B7, combine and
    B6 bit for bit, the GMMs within f32_tol.  Each is timed beside its
    bound and the launch floor, the GMMs also beside torch.bmm."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import hierarchical as hmoe_lib
    from repro_torch.core import router as router_lib
    from repro_torch.kernels import gmm as gk
    from repro_torch.models.paper_lm import _hmoe_args

    moe = params["moe"]
    g, b = cfg.hierarchical
    d, f, e = cfg.d_model, cfg.expert_hidden, cfg.n_experts
    t = TRAIN_B * TRAIN_S
    spec_p, spec_s = hmoe_lib._level_specs(_hmoe_args(cfg))
    k, kk = spec_p.k, spec_p.k + 1
    cp = spec_p.capacity(t, g, train=True)
    cs = spec_s.capacity(cp, b, train=True)
    check((cp, cs) == (HMOE_CP, HMOE_CS),
          f"hmoe capacities {cp}, {cs}, expected {HMOE_CP}, {HMOE_CS}")
    x = torch.randn(t, d, device="cuda", generator=gen)
    out: dict = {name: {} for name in ("topk_gating", "topk_gating_bwd",
                                       "dispatch", "combine")}
    with torch.no_grad():
        # The primary level: tokens into the groups' slot buffers.
        logits = x @ moe["gate_primary"]["wg"] + torch.randn(
            t, g, device="cuda", generator=gen)
        r1, r5, cw, idx = _hmoe_topk("primary", logits, k, kk, gen, floor)
        out["topk_gating"]["primary"] = r1
        out["topk_gating_bwd"]["primary"] = r5
        plan_p = dsp.plan(idx, cw, g, cp)
        buf, r2, r4 = _hmoe_dispatch_combine("primary", x, plan_p, gen,
                                             floor)
        out["dispatch"]["primary"], out["combine"]["primary"] = r2, r4
        # The secondary level: every group's slots at once.
        valid = hmoe_lib._kept_slots(plan_p, g)
        logits = (torch.bmm(buf, moe["gate_secondary"]["wg"])
                  + torch.randn(g, cp, b, device="cuda", generator=gen))
        r1, r5, cw, idx = _hmoe_topk("secondary", logits.reshape(g * cp, b),
                                     k, kk, gen, floor)
        out["topk_gating"]["secondary"] = r1
        out["topk_gating_bwd"]["secondary"] = r5
        plan_s = dsp.plan(router_lib.flat_expert_ids(idx.reshape(g, cp, k),
                                                     b),
                          cw * valid.reshape(-1, 1), e, cs)
        rows = dsp.filled_rows(plan_s)
        xs, r2, r4 = _hmoe_dispatch_combine("secondary", buf.reshape(-1, d),
                                            plan_s, gen, floor)
        out["dispatch"]["secondary"], out["combine"]["secondary"] = r2, r4
        del buf
    n_kept_p = int((plan_p.position < cp).sum())
    used, filled = int((rows > 0).sum()), int(rows.sum())
    log(f"hmoe plans: primary C={cp}, {n_kept_p} of {t * k} kept; secondary"
        f" C={cs} over {e} experts, {used} used, {filled} filled rows")
    # The expert FFN: GMMs over the flat experts (views of the [16, 256,
    # ...] leaves), the tiled 3xTF32 kernel.
    check(gk.kernel_for(torch.float32, cs, False) == "tile",
          "the hmoe GMMs must run the tiled kernel")
    w1 = moe["w1"].detach().reshape(e, d, f)
    w2 = moe["w2"].detach().reshape(e, f, d)
    hid = gk.mask_rows(torch.randn(e, cs, f, device="cuda", generator=gen),
                       rows)
    dz = gk.mask_rows(torch.randn(e, cs, f, device="cuda", generator=gen),
                      rows)
    dy = gk.mask_rows(torch.randn(e, cs, d, device="cuda", generator=gen),
                      rows)
    cases = {"gmm": [("w1_relu", xs, w1, "relu", False, False),
                     ("w1_none", xs, w1, "none", False, False),
                     ("w2", hid, w2, "none", False, False)],
             "gmm_bwd": [("dx_w1", dz, w1, "none", False, True),
                         ("dw_w1", xs, dz, "none", True, False),
                         ("dh_w2", dy, w2, "none", False, True),
                         ("dw_w2", hid, dy, "none", True, False)]}
    for kernel, calls_of in cases.items():
        symbol = ("gmm_tile_kernel" if kernel == "gmm"
                  else "gmm_tile_bwd_kernel")
        worst, tol_used, calls = 0.0, 0.0, {}
        for name, xi, wi, act, tx, tw in calls_of:
            got = gk.gmm(xi, wi, activation=act, trans_x=tx, trans_w=tw,
                         rows=rows)
            want = gk.gmm_plain(xi, wi, act, tx, tw, rows)
            err, tol = max_err(got, want), f32_tol(want)
            check(err <= tol, f"hmoe {kernel} {name} differs by {err} > {tol}")
            worst, tol_used = max(worst, err), max(tol_used, tol)
            del got, want
            xl = xi.transpose(1, 2) if tx else xi
            wl = wi.transpose(1, 2) if tw else wi
            md, kd, nd = xl.shape[1], xl.shape[2], wl.shape[2]
            if tx:      # dw [E, M, N]: the filled rows of both operands in
                n_bytes = (filled * (md + nd) + e * md * nd) * 4
                flops = 2 * filled * md * nd
            else:       # the filled rows and the used experts' weights in
                n_bytes = (filled * kd + used * kd * nd + e * cs * nd) * 4
                flops = 2 * filled * kd * nd
            calls[name] = dict(max_abs_err=err, tol=tol, **_timed_call(
                f"hmoe {kernel} {name} {tuple(xl.shape)} x "
                f"{tuple(wl.shape)}",
                lambda: gk.gmm(xi, wi, activation=act, trans_x=tx,
                               trans_w=tw, rows=rows),
                symbol, n_bytes, {"tf32": 3 * flops}, None, floor,
                plain=lambda: gk.gmm_plain(xi, wi, act, tx, tw, rows),
                library=lambda: torch.bmm(xl, wl), big=True))
            torch.cuda.empty_cache()
        out[kernel] = dict(max_abs_err=worst, tol=tol_used, calls=calls,
                           **{key: sum(c[key] for c in calls.values())
                              for key in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "dev_ms")})
    dw = out["gmm_bwd"]["calls"]
    log(f"hmoe dw layout (x^T dz) at K = {cs}: dw_w1 "
        f"{dw['dw_w1']['dev_ms']:.3f} ms, dw_w2 "
        f"{dw['dw_w2']['dev_ms']:.3f} ms a call (torch.bmm "
        f"{dw['dw_w1']['library_ms']:.3f}, {dw['dw_w2']['library_ms']:.3f}; "
        f"bound {dw['dw_w1']['bound_ms']:.3f}, {dw['dw_w2']['bound_ms']:.3f})")
    del xs, hid, dz, dy
    torch.cuda.empty_cache()
    out["plan"] = dict(tokens=t, primary_capacity=cp, secondary_capacity=cs,
                       primary_kept=n_kept_p, used_experts=used,
                       filled_rows=filled)
    return out


# The MoE leaves of the hierarchical layer compared in hmoe_grads.
HMOE_LEAVES = ("gate_primary.wg", "gate_primary.wnoise", "gate_secondary.wg",
               "gate_secondary.wnoise", "w2", "w1")


def hmoe_grads(cfg, params, trained) -> dict:
    """One more batch's loss and gradients from the same parameters and
    draws under "ref", then "cuda" (phase_grads' comparison without its
    second "cuda" run: each run holds two 8.6 GB expert gradients): the
    loss within 1e-5 relative, every gradient present and finite, the
    MoE leaves within GRAD_TOL normwise of "ref", w1's through
    w1_check.  Then one optimizer update on the "cuda" gradients, timed
    alone with CUDA events."""
    import dataclasses
    import math
    import torch
    from repro_torch.common.param import tree_leaves, tree_map
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import backend as backend_lib
    from repro_torch.models.paper_lm import paper_lm_loss
    from repro_torch.optim import optimizers as opt_lib

    batch = batch_at(trained["dc"], TRAIN_STEPS + 2, device="cuda")

    def moe_leaf(key):
        node = params["moe"]
        for part in key.split("."):
            node = node[part]
        return node

    res, runs = {}, {}
    leaves = tree_leaves(params)
    for backend in ("ref", "cuda"):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        runs[backend] = {}
        orig = _capture_expert_ffn(backend, runs[backend])
        try:
            loss, _ = paper_lm_loss(
                params, batch,
                dataclasses.replace(cfg, kernel_backend=backend),
                generator=gen)
            loss.backward()
        finally:
            backend_lib.register(orig)
        check(all(p.grad is not None for p in leaves),
              f"hmoe {backend}: a parameter has no gradient")
        check(all(all_finite(p.grad) for p in leaves),
              f"hmoe {backend}: a gradient is not finite")
        for key in HMOE_LEAVES:
            check(any_nonzero(moe_leaf(key).grad),
                  f"hmoe {backend}: the gradient of moe.{key} is zero")
        res[backend] = (float(loss.detach()),
                        {k: moe_leaf(k).grad for k in HMOE_LEAVES})
        del loss
        if backend == "ref":
            for p in leaves:
                p.grad = None
    (lc, gc_), (lr_, gr) = res["cuda"], res["ref"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_hidden
    w1 = w1_check(gc_["w1"].reshape(e, d, f), gr["w1"].reshape(e, d, f),
                  moe_leaf("w1").detach().reshape(e, d, f),
                  moe_leaf("w2").detach().reshape(e, f, d), runs)
    out = {"loss_cuda": lc, "loss_ref": lr_,
           "loss_rel_err": abs(lc - lr_) / abs(lr_),
           "grad_norm_rel_err": {"w1": w1.pop("norm_rel_err")},
           "grad_max_rel_err": {"w1": w1.pop("max_rel_err")},
           "tol": GRAD_TOL, **w1}
    for k in (k for k in HMOE_LEAVES if k != "w1"):
        out["grad_norm_rel_err"][k] = norm_rel_err(gc_[k], gr[k])
        out["grad_max_rel_err"][k] = max_err(gc_[k], gr[k]) / max(
            abs_max(gr[k]), 1e-30)
    del res, gr, runs
    torch.cuda.empty_cache()
    check(math.isfinite(lc) and out["loss_rel_err"] <= 1e-5,
          f"hmoe cuda vs ref loss {lc} vs {lr_}")
    for k in HMOE_LEAVES:
        check(out["grad_norm_rel_err"][k] <= GRAD_TOL,
              f"hmoe moe.{k} gradient differs by "
              f"{out['grad_norm_rel_err'][k]} normwise > {GRAD_TOL}")
    grads = tree_map(lambda p: p.grad, params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    opt_lib.apply_updates(params, grads, trained["opt"], trained["oc"])
    end.record()
    torch.cuda.synchronize()
    out["optimizer_ms"] = start.elapsed_time(end)
    del grads
    for p in leaves:
        p.grad = None
    log("hmoe grads " + json.dumps(out))
    return out


def phase_hmoe(cfg, params, floor, workdir) -> dict:
    """moe-4096-h at full width: its kernels at the step's shapes, then
    TRAIN_STEPS steps through the Trainer with exact launch counts
    (HMOE_LAUNCHES a step), a profile of two more, the cuda-vs-ref
    gradient check and one optimizer update timed alone."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    kernels = check_hmoe_kernels(cfg, params, gen, floor)
    trained = phase_train(cfg, params, workdir, name=HMOE_CONFIG,
                          launches=HMOE_LAUNCHES, what="hmoe")
    grads = hmoe_grads(cfg, params, trained)
    return {"kernels": kernels, "summary": trained["summary"],
            "counts": trained["counts"], "profile": trained["profile"],
            "grads": grads}


def phase_hmoe_lm() -> dict:
    """The hierarchical MoE in the transformer: one ``lm_loss`` forward
    and backward of ``launch/train.py::reduced()`` kimi-k2 (2 layers,
    d 64, 8 experts top-2, swiglu, f32, remat) with ``moe_hierarchical``
    = HMOE_LM_GROUPS, gates drawn, under "cuda" and "ref" with the same
    draws: "cuda" launches exactly HMOE_LM_LAUNCHES, the losses agree
    within 1e-5 relative and every gradient is present, finite and
    within GRAD_TOL normwise of "ref"'s."""
    import math
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.train import reduced
    from repro_torch.models import lm

    cfg = reduced(get_config(ARCH)).replace(moe_hierarchical=HMOE_LM_GROUPS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    moe = params["blocks"]["periods"]["pos0"]["moe"]
    for level in ("gate_primary", "gate_secondary"):
        moe[level]["wg"].normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    leaves = pm.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    b, s = HMOE_LM_BATCH
    batch = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                batch_size=b, seed=SEED), 0, device="cuda")
    draws = lm.make_draws(cfg, b, s, gen, "cuda")
    res = {}
    for backend in ("cuda", "ref"):
        cuda_lib.reset_launch_counts()
        loss, _ = lm.lm_loss(params, batch,
                             cfg.replace(kernel_backend=backend), draws=draws)
        loss.backward()
        torch.cuda.synchronize()
        check(all(p.grad is not None and all_finite(p.grad) for p in leaves),
              f"hmoe lm {backend}: a gradient is missing or not finite")
        res[backend] = (float(loss.detach()), cuda_lib.launch_counts(),
                        [p.grad for p in leaves])
        for p in leaves:
            p.grad = None
    (lc, counts, gc_), (lr_, _, gr) = res["cuda"], res["ref"]
    errs = [norm_rel_err(a, r) for a, r in zip(gc_, gr)]
    out = {"config": f"reduced {ARCH}, moe_hierarchical={HMOE_LM_GROUPS}, "
                     f"B={b} x S={s}, f32",
           "loss_cuda": lc, "loss_ref": lr_,
           "loss_rel_err": abs(lc - lr_) / abs(lr_),
           "grad_norm_rel_err_max": max(errs), "tol": GRAD_TOL,
           "launches": counts}
    log("hmoe lm " + json.dumps(out))
    check(counts == HMOE_LM_LAUNCHES, f"hmoe lm launches {counts}, expected "
                                      f"{HMOE_LM_LAUNCHES}")
    check(math.isfinite(lc) and out["loss_rel_err"] <= 1e-5,
          f"hmoe lm cuda vs ref loss {lc} vs {lr_}")
    check(max(errs) <= GRAD_TOL, f"hmoe lm: a gradient differs by "
                                 f"{max(errs)} normwise > {GRAD_TOL}")
    return {"summary": out, "counts": counts}


# ---------------------------------------------------------------------------
# phase 12: train arctic-480b at full width (one layer, bf16)
# ---------------------------------------------------------------------------

def build_arctic():
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm

    cfg = get_config(ARCTIC, n_layers=ARCTIC_LAYERS)
    check(cfg.kernel_backend == "cuda" and cfg.param_dtype == torch.bfloat16
          and cfg.remat, "arctic must default to cuda, bf16 and remat")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    # A zero gate sends every token to experts 0..k-1; the smoke draws
    # it, as for serving, so routing spreads over all 128 experts.
    gate = params["blocks"]["periods"]["pos0"]["moe"]["gate"]["wg"]
    gate.normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pm.tree_leaves(params))
    log(f"materialized {ARCTIC} (n_layers={ARCTIC_LAYERS}, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
        f"top-{cfg.moe_k} x {cfg.moe_d_ff} + dense {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}) in {time.perf_counter() - t0:.1f} s: {n} "
        f"parameters, {pm.param_bytes(params) / 1e9:.2f} GB")
    check(n == ARCTIC_PARAMS, f"{n} parameters, expected {ARCTIC_PARAMS}")
    return cfg, params


def _timed_call(what, fn, symbol, n_bytes, flops, dtype_name, floor,
                plain=None, library=None, big=False) -> dict:
    """One kernel call at the arctic shape: device time per launch
    (profiler), CUDA-event time, plain and library times, the bound and
    the launch floor.  ``big``: a multi-ms call, timed with fewer
    repeats and no queued run."""
    if big:
        dev = device_ms(fn, (symbol,), n=PROFILED_BIG_RUN)
        check(symbol in dev, f"{what}: no {symbol} in the profile")
        b, by = bound_ms(n_bytes, flops, dtype_name)
        res = {"dev_ms": dev[symbol], "bound_ms": b, "bound_by": by,
               "launch_floor_ms": floor["dev_ms"]}
    else:
        res = shape_times(what, fn, symbol, n_bytes, flops, dtype_name,
                          floor)
    reps = dict(reps=5, warmup=1) if big else {}
    res["ms"] = cuda_ms(fn, **reps)
    res["plain_ms"] = (cuda_ms(plain, **(dict(reps=3, warmup=1) if big
                                         else {})) if plain else None)
    res["library_ms"] = cuda_ms(library, **reps) if library else None
    log(f"{what}: " + json.dumps(res))
    return res


def check_arctic_kernels(cfg, params, gen, floor) -> dict:
    """Every kernel of the arctic training step against its plain version
    at the shapes a step gives it (T = 4096 tokens of d = 7168 bf16, E =
    128, k = 2, C = 80; layer 0's expert weights; a plan routed by layer
    0's gate with noise), with phase 2's tolerances: top-k indices exact
    and values within 1e-6, B5, dispatch (and B7, the dispatch scaled by
    the combine weights) and combine (and B6, unit weights) bit for bit,
    the GMMs within two bf16 ulps of the output's largest binade, with
    the plan's ``rows``: the forward calls (w1 with silu, w3, w2; w1
    without the activation is the backward pass's recomputed
    pre-activation) and the transposed ones (dx = dz w^T, dw = x^T dz
    for w1 / w3's shape and w2's).  Each is timed beside its bound and
    the launch floor."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.kernels import dispatch as dk
    from repro_torch.kernels import gmm as gk
    from repro_torch.kernels import topk_gating as tk

    bf = torch.bfloat16
    moe = params["blocks"]["periods"]["pos0"]["moe"]
    w1, w3, w2 = (moe[k][0].detach() for k in ("w1", "w3", "w2"))
    wg = moe["gate"]["wg"][0].detach()
    t, d = ARCTIC_B * ARCTIC_S, cfg.d_model
    e, k, f = cfg.n_experts, cfg.moe_k, cfg.moe_d_ff
    kk = k + 1
    x = torch.randn(t, d, device="cuda", generator=gen).to(bf)
    logits = x.float() @ wg.float() + torch.randn(t, e, device="cuda",
                                                  generator=gen)
    out: dict = {}
    # Top-k (kernel 1) and its backward (B5).
    got, want = tk.topk_gating(logits, k, kk), tk.topk_gating_plain(
        logits, k, kk)
    check(torch.equal(got[1], want[1]), "arctic top-k indices differ")
    err = max(max_err(got[0], want[0]), max_err(got[2], want[2]))
    check(err <= 1e-6, f"arctic top-k values differ by {err}")
    cw, idx, _ = got
    out["topk_gating"] = dict(max_abs_err=err, tol=1e-6, **_timed_call(
        f"arctic topk_gating [{t},{e}] k={k} kk={kk}",
        lambda: tk.topk_gating(logits, k, kk), "topk_gating_kernel",
        t * e * 4 + t * k * 4 + t * kk * 8, 0, "float32", floor,
        plain=lambda: tk.topk_gating_plain(logits, k, kk)))
    dw_in = torch.randn(t, k, device="cuda", generator=gen)
    dvals = torch.randn(t, kk, device="cuda", generator=gen)
    got = tk.topk_gating_bwd(cw, idx, dw_in, dvals, e)
    check(torch.equal(got, tk.topk_gating_bwd_plain(cw, idx, dw_in, dvals,
                                                    e)),
          "arctic top-k backward differs from its plain version")
    out["topk_gating_bwd"] = dict(max_abs_err=0.0, tol=0.0, **_timed_call(
        f"arctic topk_gating_bwd [{t},{e}] k={k} kk={kk}",
        lambda: tk.topk_gating_bwd(cw, idx, dw_in, dvals, e),
        "topk_gating_bwd_kernel", t * e * 4 + t * k * 8 + t * kk * 8, 0,
        "float32", floor,
        plain=lambda: tk.topk_gating_bwd_plain(cw, idx, dw_in, dvals, e)))
    # The plan, as the router builds it.
    cap = dsp.capacity_for(t, e, k, cfg.capacity_factor)
    check(cap == ARCTIC_C, f"arctic capacity {cap}, expected {ARCTIC_C}")
    plan = dsp.plan(idx[:, :k].contiguous(), cw, e, cap)
    ei, po, w = plan.expert_index, plan.position, plan.weight
    rows = dsp.filled_rows(plan)
    n_kept, filled = int((po < cap).sum()), int(rows.sum())
    used = int((rows > 0).sum())
    log(f"arctic plan: C={cap}, {n_kept} of {t * k} slots kept, {used} "
        f"experts used, {filled} filled rows")
    # Dispatch (kernel 2) and B7; combine (kernel 4) and B6.
    buf = dk.dispatch(x, ei, po, n_experts=e, capacity=cap)
    check(torch.equal(buf, dk.dispatch_plain(x, ei, po, None, e, cap)),
          "arctic dispatch differs from its plain version")
    g_tok = torch.randn(t, d, device="cuda", generator=gen).to(bf)
    check(torch.equal(dk.dispatch(g_tok, ei, po, w, n_experts=e,
                                  capacity=cap),
                      dk.dispatch_plain(g_tok, ei, po, w, e, cap)),
          "arctic B7 (dispatch scaled by w) differs from its plain version")
    disp_bytes = t * d * 2 + t * k * 8 + e * cap * d * 2
    out["dispatch"] = dict(max_abs_err=0.0, tol=0.0, **_timed_call(
        f"arctic dispatch [{t},{d}] bf16 -> [{e},{cap},{d}]",
        lambda: dk.dispatch(x, ei, po, n_experts=e, capacity=cap),
        "dispatch_kernel", disp_bytes, 0, "bfloat16", floor,
        plain=lambda: dk.dispatch_plain(x, ei, po, None, e, cap)))
    out["dispatch"]["B7"] = _timed_call(
        f"arctic B7 dispatch scaled [{t},{d}] bf16 -> [{e},{cap},{d}]",
        lambda: dk.dispatch(g_tok, ei, po, w, n_experts=e, capacity=cap),
        "dispatch_kernel", disp_bytes + t * k * 4, 0, "bfloat16", floor,
        plain=lambda: dk.dispatch_plain(g_tok, ei, po, w, e, cap))
    ybuf = torch.randn(e, cap, d, device="cuda", generator=gen).to(bf)
    unit = torch.ones_like(w)
    for name, wt in (("combine", w), ("B6", unit)):
        check(torch.equal(dk.combine(ybuf, wt, ei, po),
                          dk.combine_plain(ybuf, wt, ei, po, bf)),
              f"arctic {name} differs from its plain version")
    comb = [n_kept * d * 2 + t * k * 12 + t * d * 2, 2 * n_kept * d]
    out["combine"] = dict(max_abs_err=0.0, tol=0.0, **_timed_call(
        f"arctic combine [{e},{cap},{d}] bf16 -> [{t},{d}], k={k}",
        lambda: dk.combine(ybuf, w, ei, po), "combine_kernel", *comb,
        "bfloat16", floor,
        plain=lambda: dk.combine_plain(ybuf, w, ei, po, bf)))
    out["combine"]["B6"] = _timed_call(
        f"arctic B6 combine, unit weights [{e},{cap},{d}] bf16",
        lambda: dk.combine(ybuf, unit, ei, po), "combine_kernel", *comb,
        "bfloat16", floor,
        plain=lambda: dk.combine_plain(ybuf, unit, ei, po, bf))
    del g_tok, ybuf
    # The GMMs, forward layout: the tiled bf16 kernel (C = 80 > 64).
    check(gk.kernel_for(bf, cap, False) == "tile",
          "the arctic GMMs must run the tiled kernel")
    hid = torch.randn(e, cap, f, device="cuda", generator=gen).to(bf)
    hid = gk.mask_rows(hid, rows)
    fwd = [("w1_silu", buf, w1, "silu"), ("w1_none", buf, w1, "none"),
           ("w3", buf, w3, "none"), ("w2", hid, w2, "none")]
    worst, tol_used, calls = 0.0, 0.0, {}
    for name, xi, wi, act in fwd:
        got = gk.gmm(xi, wi, activation=act, rows=rows)
        want = gk.gmm_plain(xi, wi, act, rows=rows)
        err, tol = max_err(got, want), bf16_tol(want)
        check(err <= tol, f"arctic gmm {name} differs by {err} > {tol}")
        worst, tol_used = max(worst, err), max(tol_used, tol)
        del got, want
        kd, nd = wi.shape[1], wi.shape[2]
        calls[name] = dict(max_abs_err=err, tol=tol, **_timed_call(
            f"arctic gmm {name} {tuple(xi.shape)} x {tuple(wi.shape)}",
            lambda: gk.gmm(xi, wi, activation=act, rows=rows),
            "gmm_tile_kernel", (used * kd * nd + filled * kd + e * cap * nd)
            * 2, 2 * filled * kd * nd, "bfloat16", floor,
            plain=lambda: gk.gmm_plain(xi, wi, act, rows=rows),
            library=lambda: torch.bmm(xi, wi), big=True))
    out["gmm"] = dict(max_abs_err=worst, tol=tol_used, calls=calls,
                      **{key: sum(c[key] for c in calls.values())
                         for key in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "dev_ms")})
    # The transposed GMMs: dx = dz w^T and dw = x^T dz, at w1 / w3's
    # shape (dz [E, C, f]) and w2's (dz [E, C, d]).
    dz = gk.mask_rows(torch.randn(e, cap, f, device="cuda", generator=gen)
                      .to(bf), rows)
    dy = gk.mask_rows(torch.randn(e, cap, d, device="cuda", generator=gen)
                      .to(bf), rows)
    bwd = [("dx_w1", dz, w1, False, True), ("dw_w1", buf, dz, True, False),
           ("dh_w2", dy, w2, False, True), ("dw_w2", hid, dy, True, False)]
    worst, tol_used, calls = 0.0, 0.0, {}
    for name, xi, wi, tx, tw in bwd:
        got = gk.gmm(xi, wi, trans_x=tx, trans_w=tw, rows=rows)
        want = gk.gmm_plain(xi, wi, "none", tx, tw, rows)
        err, tol = max_err(got, want), bf16_tol(want)
        check(err <= tol, f"arctic gmm_bwd {name} differs by {err} > {tol}")
        worst, tol_used = max(worst, err), max(tol_used, tol)
        del got, want
        xl = xi.transpose(1, 2) if tx else xi
        wl = wi.transpose(1, 2) if tw else wi
        md, kd, nd = xl.shape[1], xl.shape[2], wl.shape[2]
        if tx:      # dw [E, M, N]: the filled rows of both operands in
            n_bytes = filled * (md + nd) * 2 + e * md * nd * 2
            flops = 2 * filled * md * nd
        else:       # dx: dz's filled rows and the used weights in
            n_bytes = (filled * kd + used * kd * nd + e * cap * nd) * 2
            flops = 2 * filled * kd * nd
        calls[name] = dict(max_abs_err=err, tol=tol, **_timed_call(
            f"arctic gmm_bwd {name} {tuple(xl.shape)} x {tuple(wl.shape)}",
            lambda: gk.gmm(xi, wi, trans_x=tx, trans_w=tw, rows=rows),
            "gmm_tile_bwd_kernel", n_bytes, flops, "bfloat16", floor,
            plain=lambda: gk.gmm_plain(xi, wi, "none", tx, tw, rows),
            library=lambda: torch.bmm(xl, wl), big=True))
        torch.cuda.empty_cache()
    out["gmm_bwd"] = dict(max_abs_err=worst, tol=tol_used, calls=calls,
                          **{key: sum(c[key] for c in calls.values())
                             for key in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "dev_ms")})
    del x, buf, hid, dz, dy
    torch.cuda.empty_cache()
    out["plan"] = dict(tokens=t, capacity=cap, kept_slots=n_kept,
                       used_experts=used, filled_rows=filled)
    return out


def _train_loop(cfg, params, dc, steps: int, what: str) -> dict:
    """``steps`` steps of ``make_train_step`` (lm_loss, factored Adam),
    each with the trainer's per-step generator; launch counts zeroed just
    before and read just after.  Returns times, metrics, counts, peak
    memory and the step function."""
    import math
    import torch
    from repro_torch.common.param import tree_leaves
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train.trainer import make_train_step, step_seed

    for p in tree_leaves(params):
        p.requires_grad_(True)
    oc = opt_lib.OptConfig(kind="factored")
    state = {"params": params, "opt": opt_lib.init(params, oc)}
    step = make_train_step(lambda p, b, g: lm.lm_loss(p, b, cfg, generator=g),
                           oc)
    data = DataIterator(dc, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    times, rows = [], []
    for s in range(steps):
        gen = torch.Generator(device="cuda").manual_seed(step_seed(SEED, s))
        batch = next(data)
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        rows.append({k: float(v) for k, v in m.items()})   # syncs
        times.append(time.perf_counter() - t0)
        log(f"{what} step {s + 1}: loss {rows[-1]['loss']:.4f} in "
            f"{1e3 * times[-1]:.1f} ms")
    counts = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for m in rows:
        check(all(math.isfinite(v) for v in m.values()),
              f"{what}: non-finite metrics {m}")
    total = torch.cuda.get_device_properties(0).total_memory
    check(peak < total, f"{what}: peak {peak} >= the card's {total} bytes")
    return {"times": times, "rows": rows, "counts": counts, "peak": peak,
            "state": state, "step": step, "oc": oc, "data": data}


def _grad_check(cfg, params, batch, draws, what: str,
                moe_leaves=()) -> None:
    """One backward pass from fixed draws: every leaf has a gradient, all
    finite; the named MoE leaves' are not all zero.  Leaves the
    gradients in ``.grad``."""
    from repro_torch.common.param import tree_leaves
    from repro_torch.models import lm
    loss, _ = lm.lm_loss(params, batch, cfg, draws=draws)
    loss.backward()
    leaves = tree_leaves(params)
    check(all(p.grad is not None for p in leaves),
          f"{what}: a parameter has no gradient")
    check(all(all_finite(p.grad) for p in leaves),
          f"{what}: a gradient is not finite")
    for leaf in moe_leaves:
        check(any_nonzero(leaf.grad), f"{what}: an MoE gradient is zero")


def phase_arctic(cfg, params, floor) -> dict:
    """arctic-480b at full width, depth cut to one layer: the kernels at
    its shapes, ARCTIC_STEPS training steps with exact launch counts, a
    gradient check, the optimizer's time, the cuda-vs-ref forward loss,
    a profile of one step."""
    import torch
    from repro_torch.common.param import tree_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train.trainer import step_seed

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    kernels = check_arctic_kernels(cfg, params, gen, floor)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=ARCTIC_S,
                    batch_size=ARCTIC_B, seed=SEED)
    run = _train_loop(cfg, params, dc, ARCTIC_STEPS, "arctic")
    want = {k: ARCTIC_STEPS * v for k, v in ARCTIC_LAUNCHES.items()}
    log(f"arctic launches {run['counts']}, expected {want}")
    check(run["counts"] == want, "arctic launch counts differ from the "
                                 "derivation in ARCTIC_LAUNCHES")
    median = statistics.median(run["times"][1:])
    # One more batch and its draws: the forward loss under "cuda" against
    # "ref" (before any update has seen the batch), then its gradients,
    # then one optimizer update on them, timed alone.
    batch = batch_at(dc, ARCTIC_STEPS, device="cuda")
    gdraw = torch.Generator(device="cuda").manual_seed(
        step_seed(SEED, ARCTIC_STEPS))
    draws = lm.make_draws(cfg, ARCTIC_B, ARCTIC_S, gdraw, "cuda")
    with torch.no_grad():
        lc = float(lm.lm_loss(params, batch, cfg, draws=draws)[0])
        lr_ = float(lm.lm_loss(params, batch,
                               cfg.replace(kernel_backend="ref"),
                               draws=draws)[0])
    rel = abs(lc - lr_) / abs(lr_)
    log(f"arctic cuda vs ref forward loss: {lc} vs {lr_} (rel {rel:.3g}, "
        f"tol {ARCTIC_LOSS_TOL:.3g})")
    check(rel <= ARCTIC_LOSS_TOL, f"arctic cuda vs ref loss {lc} vs {lr_}")
    torch.cuda.empty_cache()
    moe = params["blocks"]["periods"]["pos0"]["moe"]
    _grad_check(cfg, params, batch, draws, "arctic",
                (moe["w1"], moe["w2"], moe["w3"], moe["gate"]["wg"]))
    grads = tree_map(lambda p: p.grad, params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    opt_lib.apply_updates(params, grads, run["state"]["opt"], run["oc"])
    end.record()
    torch.cuda.synchronize()
    opt_ms = start.elapsed_time(end)
    del grads
    for p in tree_leaves(params):
        p.grad = None
    with torch.no_grad():
        after = float(lm.lm_loss(params, batch, cfg, draws=draws)[0])
    log(f"arctic: the batch's loss {lc} before and {after} after the "
        "update computed on it")

    # One more step under the profiler.
    def one_step():
        g = torch.Generator(device="cuda").manual_seed(
            step_seed(SEED, ARCTIC_STEPS + 1))
        _, m = run["step"](run["state"], next(run["data"]), g)
        float(m["loss"])
    dprof = device_profile(one_step)
    prof = dict(train_steps=1, **dprof, **idle_share(dprof, 1, 1e3 * median))
    # The step's device time split: the port's kernels (by their symbols),
    # the optimizer (its update timed alone above), everything else
    # (attention, the dense FFN, the loss, casts and copies).
    kernels_ms = sum(v["launches"] * v["device_ms_per_launch"]
                     for v in dprof["kernels"].values())
    prof["split_ms"] = {"device_busy": dprof["device_busy_ms"],
                        "port_kernels": kernels_ms, "optimizer": opt_ms,
                        "other": dprof["device_busy_ms"] - kernels_ms
                        - opt_ms}
    keys = ("loss", "xent", "aux_loss", "cv_load", "max_over_mean_load",
            "fraction_dropped", "grad_norm")
    out = {"config": f"{ARCTIC}, {ARCTIC_LAYERS} layer, bf16, remat, "
                     f"B={ARCTIC_B} x S={ARCTIC_S}, factored Adam",
           "step_ms_median_steps_2_to_6": 1e3 * median,
           "step_ms_all": [1e3 * t for t in run["times"]],
           "tokens_per_s": ARCTIC_B * ARCTIC_S / median,
           "optimizer_ms": opt_ms,
           "max_memory_allocated_gib": run["peak"] / 2 ** 30,
           "max_memory_allocated_gb": run["peak"] / 1e9,
           "first": {k: run["rows"][0][k] for k in keys},
           "last": {k: run["rows"][-1][k] for k in keys},
           "launches": run["counts"],
           "loss_cuda": lc, "loss_ref": lr_, "loss_rel_err": rel,
           "loss_tol": ARCTIC_LOSS_TOL, "loss_after_its_own_update": after}
    log("arctic train " + json.dumps(out))
    log("arctic profile " + json.dumps(prof))
    return {"summary": out, "kernels": kernels, "counts": run["counts"],
            "profile": prof}


# ---------------------------------------------------------------------------
# phase 13: train qwen3-1.7b at full size; flash attention on the card
# ---------------------------------------------------------------------------

def check_flash(gen) -> dict:
    """flash_attention's output and gradients against plain autograd
    through causal_attention, in f32 at qwen3-1.7b's head shape (16 / 8
    heads of 128, S = 2048 in 4 x 4 blocks of 512), within 1e-5 of each
    result's scale."""
    import torch
    from repro_torch.models import attention as at
    b, kvh, g, s, hd = 2, 8, 2, QWEN_S, 128
    q = torch.randn(b, s, kvh * g, hd, device="cuda", generator=gen)
    k = torch.randn(b, s, kvh, hd, device="cuda", generator=gen)
    v = torch.randn(b, s, kvh, hd, device="cuda", generator=gen)
    dout = torch.randn(b, s, kvh * g, hd, device="cuda", generator=gen)

    def flash(q, k, v):
        qr = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
        o = at.flash_attention(qr, k.permute(0, 2, 3, 1),
                               v.permute(0, 2, 1, 3), True, 0, 512, 512)
        return o.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd)

    res = {}
    for name, fn in (("flash", flash), ("plain", at.causal_attention)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves)
        (o * dout).sum().backward()
        res[name] = [o.detach()] + [t.grad for t in leaves]
    errs = {}
    for key, got, want in zip(("out", "dq", "dk", "dv"), res["flash"],
                              res["plain"]):
        errs[key] = (max_err(got, want), f32_tol(want))
        check(errs[key][0] <= errs[key][1], f"flash {key} differs from plain "
              f"autograd by {errs[key][0]} > {errs[key][1]}")

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves) * dout).sum().backward()
    times = {"flash_ms": cuda_ms(lambda: fwd_bwd(flash), reps=3, warmup=1),
             "plain_ms": cuda_ms(lambda: fwd_bwd(at.causal_attention),
                                 reps=3, warmup=1)}
    out = {"shape": f"B={b}, {kvh * g}/{kvh} heads x {hd}, S={s}, blocks "
                    "512 x 512, f32", "max_abs_err_and_tol": errs, **times}
    log("flash attention " + json.dumps(out))
    return out


def phase_qwen3() -> dict:
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import lm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    flash = check_flash(gen)
    cfg = get_config(QWEN)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    n = sum(p.numel() for p in pm.tree_leaves(params))
    log(f"materialized {QWEN} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"qk_norm, vocab {cfg.vocab_size}): {n} parameters")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=QWEN_S,
                    batch_size=QWEN_B, seed=SEED)
    run = _train_loop(cfg, params, dc, QWEN_STEPS, "qwen3")
    check(not any(run["counts"].values()),
          f"qwen3 (dense) launched MoE kernels: {run['counts']}")
    _grad_check(cfg, params, batch_at(dc, QWEN_STEPS, device="cuda"),
                None, "qwen3")
    median = statistics.median(run["times"][1:])
    out = {"config": f"{QWEN}, full size, bf16, remat, B={QWEN_B} x "
                     f"S={QWEN_S}, factored Adam",
           "parameters": n, "flash": flash,
           "step_ms_median_steps_2_to_4": 1e3 * median,
           "step_ms_all": [1e3 * t for t in run["times"]],
           "tokens_per_s": QWEN_B * QWEN_S / median,
           "max_memory_allocated_gib": run["peak"] / 2 ** 30,
           "losses": [m["loss"] for m in run["rows"]]}
    log("qwen3 train " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 14: the two launchers: train smollm-135m, resume, serve its
# checkpoint
# ---------------------------------------------------------------------------

def phase_launchers(workdir: str) -> dict:
    import math
    import os
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch

    argv = ["--arch", SMOLLM, "--device", "cuda", "--steps", "8", "--batch",
            "8", "--seq", str(QWEN_S), "--checkpoint-every", "4",
            "--workdir", workdir]
    t0 = time.perf_counter()
    final = train_launch.main(argv)
    train_s = time.perf_counter() - t0
    check(final.get("step") == 8 and math.isfinite(final["loss"]),
          f"smollm launcher: {final}")
    ckpt = os.path.join(workdir, "ckpt")
    steps = sorted(os.listdir(ckpt))
    check(steps == ["step_0000000004", "step_0000000008"],
          f"smollm checkpoints {steps}")
    t0 = time.perf_counter()
    again = train_launch.main(argv)
    resume_s = time.perf_counter() - t0
    check(again == {}, f"the second launch trained again: {again}")
    t0 = time.perf_counter()
    tokens = serve_launch.main(["--arch", SMOLLM, "--device", "cuda",
                                "--ckpt", ckpt, "--requests", "4",
                                "--new-tokens", "8"])
    serve_s = time.perf_counter() - t0
    check(len(tokens) == 4 and all(len(t) == 8 for t in tokens),
          f"smollm served {tokens}")
    out = {"train_s": train_s, "final": final, "resume_s": resume_s,
           "serve_s": serve_s, "tokens": tokens}
    log("launchers " + json.dumps(out))
    return out


def kernel_row(name, r, launches_by_path, profiles, floor) -> dict:
    dev = [p["kernels"][name]["device_ms_per_launch"] for p in profiles
           if name in p["kernels"]]
    return {
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name],
        "launches": sum(c.get(name, 0) for c in launches_by_path.values()),
        "launches_by_path": {k: c.get(name, 0)
                             for k, c in launches_by_path.items()},
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "device_ms_per_launch": dev[0] if dev else None,
        "tol": r["tol"], "check": "pass", "shape": r["shape"],
        "launch_floor_ms": floor["dev_ms"],
        **{k: v for k, v in r.items()
           if k.startswith(("max_abs_err_", "tol_", "used_", "moa_", "rows_",
                            "full_pool", "c72", "phase_split",
                            "train_", "stream_", "bound_ms_", "by_shape"))}}


def main() -> int:
    import gc
    import os
    import tempfile
    # The training phases hold logits-sized (13 GB) temporaries of
    # changing sizes; growable segments keep the freed ones reusable.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: cannot import repro_torch from {ROOT / 'src'} "
              f"({err}); run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        setup = phase_setup()
        kernels = phase_kernels()
        served = run_serve()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"serving model freed; {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB still allocated; {time.perf_counter() - t_start:.0f} s "
            "so far")
        moa = phase_moa()
        cfg, params = build_train_model()
        with tempfile.TemporaryDirectory() as workdir:
            trained = phase_train(cfg, params, workdir)
        eblock = phase_eblock(cfg, params)
        grads = phase_grads(cfg, params, trained["dc"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        hcfg, hparams = build_hmoe()
        with tempfile.TemporaryDirectory() as workdir:
            hmoe = phase_hmoe(hcfg, hparams, kernels["floor"], workdir)
        del hparams
        gc.collect()
        torch.cuda.empty_cache()
        hmoe["lm"] = phase_hmoe_lm()
        acfg, aparams = build_arctic()
        arctic = phase_arctic(acfg, aparams, kernels["floor"])
        del aparams
        gc.collect()
        torch.cuda.empty_cache()
        qwen3 = phase_qwen3()
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            launchers = phase_launchers(workdir)
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    launches = {"serve": served["counts"],
                "serve_fused": served["fused"]["counts"],
                "serve_expert_choice": served["ec"]["counts"],
                "serve_moa_fused": moa["counts"],
                "train": trained["counts"],
                "train_eblock": eblock["launches"][str(E_BLOCK)],
                "train_hmoe": hmoe["counts"],
                "train_hmoe_lm": hmoe["lm"]["counts"],
                "train_arctic": arctic["counts"]}
    profiles = [served["profile"], served["fused"]["profile"],
                served["ec"]["profile"], moa["profile"], trained["profile"],
                eblock["profile"], hmoe["profile"], arctic["profile"]]
    measured = dict(kernels["rows"], **served["fused"]["kernels"])
    measured["fused_routed"].update(
        max_abs_err_f32_ragged=kernels["fused"]["fused_routed_f32_max_abs_err"],
        moa_proj=kernels["fused"]["moa_proj"])
    measured["fused_decode"]["max_abs_err_f32_ragged"] = \
        kernels["fused"]["fused_decode_f32_max_abs_err"]
    for name, (err, tol) in moa["kernel_errs"].items():
        measured[name].update(max_abs_err_moa_demo=err, tol_moa_demo=tol)
    for name in ("topk_gating", "topk_gating_bwd", "dispatch", "combine",
                 "gmm", "gmm_bwd"):
        measured[name]["train_hmoe"] = hmoe["kernels"][name]
        measured[name]["train_arctic"] = arctic["kernels"][name]
    dw = {what: run["kernels"]["gmm_bwd"]["calls"]["dw_w1"]
          for what, run in (("hmoe", hmoe), ("arctic", arctic))}
    log("the dw layout (x^T dz, dev ms a call / torch.bmm ms / bound ms): "
        + "; ".join(f"{what} K = {k} {dw[what]['dev_ms']:.3f} / "
                    f"{dw[what]['library_ms']:.3f} / "
                    f"{dw[what]['bound_ms']:.3f}"
                    for what, k in (("hmoe", HMOE_CS), ("arctic", ARCTIC_C))))
    rows = [kernel_row(name, measured[name], launches, profiles,
                       kernels["floor"]) for name in KERNELS]
    log(f"card {setup['card']}; serve cross-check max_abs_err "
        f"{served['cross']['max_abs_err']:.4g} (tol "
        f"{served['cross']['tol']:.4g}); train cuda-vs-ref loss rel err "
        f"{grads['loss_rel_err']:.3g}; {HMOE_CONFIG} step "
        f"{hmoe['summary']['step_ms_median_steps_3_to_12']:.1f} ms, peak "
        f"{hmoe['summary']['max_memory_allocated_gib']:.2f} GiB, cuda-vs-"
        f"ref loss rel err {hmoe['grads']['loss_rel_err']:.3g}; arctic step "
        f"{arctic['summary']['step_ms_median_steps_2_to_6']:.1f} ms, peak "
        f"{arctic['summary']['max_memory_allocated_gib']:.2f} GiB, cuda-vs-"
        f"ref loss rel err {arctic['summary']['loss_rel_err']:.3g}; qwen3 "
        f"step {qwen3['step_ms_median_steps_2_to_4']:.1f} ms; smollm "
        f"launchers {launchers['train_s']:.1f} + {launchers['resume_s']:.1f}"
        f" + {launchers['serve_s']:.1f} s; {time.perf_counter() - t_start:.0f}"
        " s in all")
    print(setup["card"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
