#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result:

1. setup   — the card's name and power limit (nvidia-smi), torch / CUDA
             versions, and the build of the CUDA kernels from
             ``src/repro_torch/csrc`` (nvcc, one process per source).
2. kernels — each kernel's wrapper against its plain PyTorch version on
             the card: the serving kernels in bf16 at the shapes serving
             kimi-k2 gives them, in f32 at cut, ragged shapes, and in
             f32 at the shapes training MoE-256 gives them; the
             training kernels (top-k backward, e-blocked dispatch and
             combine, the transposed GMMs of the backward pass) in f32
             and bf16 at the shapes training MoE-256 gives them; the
             fused decode kernels (7 and 8) in f32 at ragged shapes and
             kernel 8's "proj" mode at moa-demo's decode shape.  Each
             kernel is timed (CUDA events, median of 20 runs after
             warm-up) beside its plain version, one PyTorch library call
             computing the same function where there is one, and its
             bound (the larger of bytes / 3.35 TB/s and operations / peak
             rate of the H100 SXM).
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
             their plain versions and timed; then the same 8 requests
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
11. report — one ``{"kernels": [...]}`` line, then the result line.
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REPS = 20
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
KERNEL_SYMBOLS = {"topk_gating": "topk_gating_kernel",
                  "dispatch": "dispatch_kernel", "combine": "combine_kernel",
                  "gmm": "gmm_kernel",
                  "topk_gating_bwd": "topk_gating_bwd_kernel",
                  "dispatch_eblock": "dispatch_eblock_kernel",
                  "combine_eblock": "combine_eblock_kernel",
                  "gmm_bwd": "gmm_tiled_kernel",
                  "fused_decode": "fused_decode_kernel",
                  "fused_routed": "fused_routed_kernel"}
# The MoA serve phase: moa-demo at its published widths.
MOA_ARCH = "moa-demo"


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


def bound_ms(n_bytes: float, flops, dtype_name: str | None = None):
    """(least time in ms, what bounds it) for moving ``n_bytes`` once and
    doing ``flops`` at the card's peak for the type; ``flops`` may be a
    {type name: operations} dict for work in several types."""
    if not isinstance(flops, dict):
        flops = {dtype_name: flops}
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[dt] * 1e3 for dt, n in flops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def f32_tol(ref) -> float:
    """f32 outputs summed in another order: 1e-5 of the output's scale
    (at least 1e-5)."""
    return 1e-5 * max(1.0, float(ref.float().abs().max()))


def bf16_tol(ref) -> float:
    """Two bf16 units in the last place at the output's largest binade:
    kernel and plain version sum in different orders in f32, so the
    rounded bf16 results may differ by one unit."""
    return 2.0 ** -7 * max(float(ref.float().abs().max()), 1e-30)


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
    for line in info["build_log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    return {"card": card}


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


def check_topk(gen) -> dict:
    import torch
    from repro_torch.kernels.topk_gating import topk_gating, topk_gating_plain
    worst = 0.0
    # Serving shapes (kimi-k2: E = 384, k = 8), cut ragged ones, and the
    # training shape (MoE-256: T = 4096, E = 256, k = 4, kk = k + 1).
    cases = [(8, 384, 8, 9, False), (32, 384, 8, 9, False),
             (32, 384, 8, 9, True), (37, 100, 2, 3, False),
             (5, 33, 1, 1, True), (TRAIN_B * TRAIN_S, 256, 4, 5, False),
             (TRAIN_B * TRAIN_S, 256, 4, 5, True)]
    for t, e, k, kk, tied in cases:
        logits = torch.randn(t, e, device="cuda", generator=gen)
        if tied:
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
    t, e, k, kk = 8, 384, 8, 9
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
                shape=f"logits [{t},{e}] f32, k={k}, kk={kk}")


def check_dispatch_combine(gen) -> list[dict]:
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
    return [dict(name="dispatch", max_abs_err=worst_d, tol=tol_c, ms=ms_d,
                 plain_ms=plain_d, bound_ms=b_d, bound_by=by_d,
                 library_ms=None, shape=shape),
            dict(name="combine", max_abs_err=worst_c, tol=tol_c, ms=ms_c,
                 plain_ms=plain_c, bound_ms=b_c, bound_by=by_c,
                 library_ms=None, shape=shape)]


def check_gmm(gen) -> dict:
    import torch
    from repro_torch.kernels import gmm as gk
    # f32 at cut, ragged shapes: exact f32 FMA against the f32 plain path.
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
    # f32 at the training shapes (MoE-256: E = 256, C = 128, d = 512,
    # f = 1024): the up-projection with relu (forward) and none (the
    # backward pass's recomputed pre-activation), the down-projection.
    e, c, d, f = 256, 128, 512, 1024
    x = torch.randn(e, c, d, device="cuda", generator=gen)
    w1 = torch.randn(e, d, f, device="cuda", generator=gen) / d ** 0.5
    h = torch.randn(e, c, f, device="cuda", generator=gen)
    w2 = torch.randn(e, f, d, device="cuda", generator=gen) / f ** 0.5
    train_f32 = []
    for xi, wi, act in ((x, w1, "relu"), (x, w1, "none"), (h, w2, "none")):
        got = gk.gmm(xi, wi, activation=act)
        want = gk.gmm_plain(xi, wi, act)
        err = max_err(got, want)
        tol = f32_tol(want)
        log(f"gmm f32 {act} {tuple(xi.shape)} x {tuple(wi.shape)}: "
            f"max_abs_err {err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"f32 gmm {act} {tuple(xi.shape)} x "
                          f"{tuple(wi.shape)} differs by {err} > {tol}")
        train_f32.append((err, tol))
        del got, want
    del x, w1, h, w2
    # bf16 at the serving shapes: one MoE layer's expert FFN at decode.
    e, c, d, f = 384, 8, 7168, 2048
    x = torch.randn(e, c, d, device="cuda", generator=gen).to(torch.bfloat16)
    w_up = (torch.randn(e, d, f, device="cuda", generator=gen) / d ** 0.5
            ).to(torch.bfloat16)
    h = torch.randn(e, c, f, device="cuda", generator=gen).to(torch.bfloat16)
    w_dn = (torch.randn(e, f, d, device="cuda", generator=gen) / f ** 0.5
            ).to(torch.bfloat16)
    calls = [(x, w_up, "silu"), (x, w_up, "none"), (h, w_dn, "none")]
    worst, tol_used = 0.0, 0.0
    ms = plain = lib = bnd = 0.0
    for xi, wi, act in calls:
        got = gk.gmm(xi, wi, activation=act)
        want = gk.gmm_plain(xi, wi, act)
        err, tol = max_err(got, want), bf16_tol(want)
        check(err <= tol, f"bf16 gmm {act} {tuple(xi.shape)} x "
                          f"{tuple(wi.shape)} differs by {err} > {tol}")
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
    return dict(name="gmm", max_abs_err=worst, tol=tol_used, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by="bytes",
                library_ms=lib, weights_only_bound_ms=b_bytes,
                max_abs_err_f32_train=max(r[0] for r in train_f32),
                tol_f32_train=max(r[1] for r in train_f32),
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


def check_topk_bwd(gen) -> dict:
    import torch
    from repro_torch.kernels import topk_gating as tk
    t, e, k, kk = TRAIN_B * TRAIN_S, 256, 4, 5
    logits = torch.randn(t, e, device="cuda", generator=gen)
    w, idx, _ = tk.topk_gating(logits, k, kk)
    dw = torch.randn(t, k, device="cuda", generator=gen)
    dvals = torch.randn(t, kk, device="cuda", generator=gen)
    got = tk.topk_gating_bwd(w, idx, dw, dvals, e)
    want = tk.topk_gating_bwd_plain(w, idx, dw, dvals, e)
    err = max_err(got, want)
    check(err <= 1e-6, f"topk_gating_bwd differs by {err}")
    ms = cuda_ms(lambda: tk.topk_gating_bwd(w, idx, dw, dvals, e))
    plain = cuda_ms(lambda: tk.topk_gating_bwd_plain(w, idx, dw, dvals, e))
    b, by = bound_ms(t * e * 4 + t * k * 8 + t * kk * 8, 0, "float32")
    return dict(name="topk_gating_bwd", max_abs_err=err, tol=1e-6, ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                shape=f"dlogits [{t},{e}] f32, k={k}, kk={kk}")


def check_eblock(gen) -> list[dict]:
    """The e-blocked dispatch and combine in f32 and bf16 at the
    training shape, bit-equal to their plain versions (dispatch also to
    the resident kernel); timed in f32."""
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
    return [dict(name="dispatch_eblock", max_abs_err=worst_d, tol=0.0,
                 ms=ms_d, plain_ms=plain_d, bound_ms=b_d, bound_by=by_d,
                 library_ms=None, shape=shape),
            dict(name="combine_eblock", max_abs_err=worst_c, tol=0.0,
                 ms=ms_c, plain_ms=plain_c, bound_ms=b_c, bound_by=by_c,
                 library_ms=None, shape=shape)]


def check_gmm_bwd(gen) -> dict:
    """The four transposed GMMs of one training step's expert FFN
    backward (MoE-256: E=256, C=128, d=512, f=1024), against the plain
    version in f32 (1e-5 relative) and bf16 (two ulps of the output's
    top binade), timed in f32 beside torch.bmm on transposed views."""
    import torch
    from repro_torch.kernels import gmm as gk
    e, c, d, f = 256, 128, 512, 1024
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    times = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0)
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
            xl = xi.transpose(1, 2) if tx else xi
            wl = wi.transpose(1, 2) if tw else wi
            times["ms"] += cuda_ms(
                lambda: gk.gmm(xi, wi, trans_x=tx, trans_w=tw))
            times["plain"] += cuda_ms(
                lambda: gk.gmm_plain(xi, wi, "none", tx, tw))
            times["lib"] += cuda_ms(lambda: torch.bmm(xl, wl))
            ee, cc, kk = xl.shape
            nn = wl.shape[-1]
            b, _ = bound_ms((ee * cc * kk + ee * kk * nn + ee * cc * nn) * 4,
                            2 * ee * cc * kk * nn, "float32")
            times["bound"] += b
        del x, h, w1, w2, dy, dh
    err_bf16, tol_bf16 = worst[torch.bfloat16]
    log(f"gmm_bwd bf16: max_abs_err {err_bf16:.3g} (tol {tol_bf16:.3g})")
    return dict(name="gmm_bwd", max_abs_err=worst[torch.float32][0],
                tol=worst[torch.float32][1], max_abs_err_bf16=err_bf16,
                tol_bf16=tol_bf16, ms=times["ms"], plain_ms=times["plain"],
                bound_ms=times["bound"], bound_by="operations",
                library_ms=times["lib"],
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
    results = [check_topk(gen), *check_dispatch_combine(gen), check_gmm(gen),
               check_topk_bwd(gen), *check_eblock(gen), check_gmm_bwd(gen)]
    for r in results:
        log("kernel " + json.dumps(r))
    fused = check_fused_ragged(gen)
    torch.cuda.empty_cache()
    return {"rows": {r["name"]: r for r in results}, "fused": fused}


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
    (:func:`idle_share`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy = sum(ms for _, _, ms in dev)
    per_kernel = {}
    for name, sym in KERNEL_SYMBOLS.items():
        hits = [(n, ms) for key, n, ms in dev if sym in key]
        calls = sum(n for n, _ in hits)
        if calls:
            per_kernel[name] = {"launches": calls, "device_ms_per_launch":
                                sum(ms for _, ms in hits) / calls}
    top = sorted(dev, key=lambda r: -r[2])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "profiled_window_idle_share": 1.0 - busy / wall_ms if dev
            else None,
            "kernels": per_kernel,
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


def check_fused_full(layer: dict) -> dict:
    """Kernels 7 and 8 at full width against their plain versions on
    layer 0's weights: T = 8 slots (two dead), C = 8, bf16 swiglu.
    Kernel 8 runs the expert_choice plan of the same tokens.  Both are
    timed with their plain versions; the bounds count the bytes of the
    experts this data uses."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import router as router_lib
    from repro_torch.kernels import fused_decode as fd

    wg, w1, w2, w3 = layer["weights"]
    t, d = N_REQUESTS, wg.shape[0]
    e, f, k = wg.shape[1], w1.shape[-1], layer["k"]
    cap = dsp.capacity_for(t, e, k, layer["capacity_factor"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn(t, d, device="cuda", generator=gen).to(torch.bfloat16)
    valid = torch.ones(t, device="cuda")
    valid[2] = valid[5] = 0.0
    args7 = (x, valid, wg, w1, w2, w3)
    kw7 = dict(k=k, capacity=cap, activation="swiglu")
    err7, tol7 = check_fused_decode_case(*args7, k, cap, "swiglu", bf16_tol)
    flat_e, flat_p, _, _, _ = fd.route_plain(x, valid, wg, k, cap)
    used7 = _used(flat_e, flat_p, cap)
    rows7 = int((flat_p < cap).sum())
    weight_bytes = 3 * d * f * 2
    b7, by7 = bound_ms(used7 * weight_bytes + d * e * 4 + 2 * t * d * 2
                       + t * 4 + 2 * e * 4,
                       {"float32": 2 * t * d * e,
                        "bfloat16": 2 * rows7 * 3 * d * f})
    ms7 = cuda_ms(lambda: fd.decode_step(*args7, **kw7))
    plain7 = cuda_ms(lambda: fd.decode_step_plain(*args7, **kw7))
    log(f"fused_decode full width [{t},{d}] E={e} f={f} k={k} C={cap} bf16 "
        f"swiglu, 2 dead slots: load / overflow equal, max_abs_err "
        f"{err7:.3g}; {used7} experts used; {ms7:.4g} ms (plain "
        f"{plain7:.4g}, bound {b7:.4g})")

    spec = router_lib.RouterSpec(policy="expert_choice", k=k,
                                 capacity_factor=layer["capacity_factor"])
    p = router_lib.Router(spec, e).route({"gate": {"wg": wg}}, x,
                                         train=False, mask=valid).plan
    args8 = (x, p.expert_index, p.position, p.expert_index, p.position,
             p.weight, w1, w2, w3)
    kw8 = dict(n_experts=e, capacity=p.capacity, mode="ffn",
               activation="swiglu")
    got, want = fd.routed_apply(*args8, **kw8), \
        fd.routed_apply_plain(*args8, **kw8)
    err8, tol8 = max_err(got, want), bf16_tol(want)
    check(err8 <= tol8, f"fused_routed full width differs by {err8} > "
                        f"{tol8}")
    used8 = _used(p.expert_index, p.position, p.capacity)
    rows8 = int((p.position < p.capacity).sum())
    b8, by8 = bound_ms(used8 * weight_bytes + 2 * t * d * 2
                       + t * k * 4 * 4, 2 * rows8 * 3 * d * f, "bfloat16")
    ms8 = cuda_ms(lambda: fd.routed_apply(*args8, **kw8))
    plain8 = cuda_ms(lambda: fd.routed_apply_plain(*args8, **kw8))
    log(f"fused_routed full width, expert_choice plan (C={p.capacity}): "
        f"max_abs_err {err8:.3g} (tol {tol8:.3g}); {used8} experts used; "
        f"{ms8:.4g} ms (plain {plain8:.4g}, bound {b8:.4g})")
    shape = (f"one kimi-k2 MoE layer at decode: x [{t},{d}] bf16 (2 dead "
             f"slots), {e} experts [{d},{f}] swiglu, k={k}, C={cap}")
    return {
        "fused_decode": dict(
            name="fused_decode", max_abs_err=err7, tol=tol7, ms=ms7,
            plain_ms=plain7, bound_ms=b7, bound_by=by7, library_ms=None,
            used_experts=used7, shape=shape),
        "fused_routed": dict(
            name="fused_routed", max_abs_err=err8, tol=tol8, ms=ms8,
            plain_ms=plain8, bound_ms=b8, bound_by=by8, library_ms=None,
            used_experts=used8, shape=shape + ", the expert_choice plan")}


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


def phase_train(cfg, params, workdir) -> dict:
    import math
    import torch
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels import cuda_lib
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train.trainer import Trainer, TrainLoopConfig, step_seed

    dc = DataConfig(vocab_size=TRAIN_VOCAB, seq_len=TRAIN_S,
                    batch_size=TRAIN_B, seed=SEED)
    trainer = Trainer(
        loss_fn=_loss_fn(cfg), params=params,
        oc=opt_lib.OptConfig(kind="factored"),
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
    want = {k: TRAIN_STEPS * v for k, v in TRAIN_LAUNCHES.items()}
    log(f"train launches {counts}, expected {want}")
    check(counts == want, "training launch counts do not match the "
                          "resident regime's per-step counts")
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
        "config": f"{TRAIN_CONFIG}, vocab {TRAIN_VOCAB}, f32",
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
    log("train " + json.dumps(out))

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
    log("train profile " + json.dumps(prof))
    return {"summary": out, "counts": counts, "profile": prof, "dc": dc}


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

    def expert_ffn(params, x, a):
        out = orig.expert_ffn(params, x, a)
        store["buf"] = x.detach()
        out.register_hook(lambda g: store.update(dout=g.detach()))
        return out
    backend_lib.register(dataclasses.replace(orig, expert_ffn=expert_ffn))
    return orig


def relu_flips(w1, w2, runs: dict) -> dict:
    """Each run's pre-activations z = buf w1, as its own path computes
    them (the "cuda" path's GMM kernel, which its backward pass reruns;
    the "ref" path's torch.bmm), the elements whose relu masks
    disagree, and the part of each run's w1 gradient that those
    elements carry: buf^T (dh * [z > 0] * flip), dh = dout w2^T."""
    import torch
    from repro_torch.kernels import gmm as gk
    z = {"cuda": gk.gmm(runs["cuda"]["buf"], w1, activation="none"),
         "ref": torch.bmm(runs["ref"]["buf"], w1)}
    flip = (z["cuda"] > 0) != (z["ref"] > 0)
    part = {}
    for b in z:
        dh = torch.bmm(runs[b]["dout"], w2.transpose(1, 2))
        part[b] = torch.bmm(runs[b]["buf"].transpose(1, 2),
                            dh * (flip & (z[b] > 0)))
    z_err = max_err(z["cuda"], z["ref"])
    z_tol = 1e-5 * max(1.0, float(z["ref"].abs().max()))
    return {"flip": flip, "part": part, "z_err": z_err, "z_tol": z_tol}


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
    rf = relu_flips(moe_leaf("w1").detach(), moe_leaf("w2").detach(), runs)
    # w1 without the flipped elements' terms, in both paths.
    kept = {"cuda": gc_["w1"] - rf["part"]["cuda"],
            "ref": gr["w1"] - rf["part"]["ref"]}
    scale = gr["w1"].abs().amax(dim=(1, 2)).clamp(min=1e-30)

    def per_expert(diff):
        return diff.abs().amax(dim=(1, 2)) / scale

    def experts(mask):
        return [int(i) for i in torch.nonzero(mask).flatten()]

    past = per_expert(gc_["w1"] - gr["w1"]) > EXPERT_TOL
    carried = per_expert(rf["part"]["cuda"] - rf["part"]["ref"]) > EXPERT_TOL
    after = per_expert(kept["cuda"] - kept["ref"])
    out = {"loss_cuda": lc, "loss_ref": lr_,
           "loss_rel_err": abs(lc - lr_) / abs(lr_),
           "grad_norm_rel_err": {}, "grad_max_rel_err": {}, "tol": GRAD_TOL,
           "cuda_repeat_bitwise": {k: bool(torch.equal(
               gc_[k], res["cuda_again"][1][k])) for k in MOE_LEAVES},
           "w1_raw_norm_rel_err": float(
               (gc_["w1"] - gr["w1"]).norm() / gr["w1"].norm()),
           "z_max_abs_err": rf["z_err"], "z_tol": rf["z_tol"],
           "relu_flipped_elements": int(rf["flip"].sum()),
           "relu_flipped_experts": experts(rf["flip"].any(dim=(1, 2))),
           "w1_experts_past_rounding": experts(past),
           "w1_experts_carried_by_flips": experts(carried),
           "w1_expert_max_rel_err_without_flips": float(after.max()),
           "expert_tol": EXPERT_TOL}
    for k in MOE_LEAVES:
        got, want = (kept["cuda"], kept["ref"]) if k == "w1" else \
            (gc_[k], gr[k])
        out["grad_norm_rel_err"][k] = float(
            (got - want).norm() / want.norm().clamp(min=1e-30))
        out["grad_max_rel_err"][k] = max_err(got, want) / max(
            float(want.abs().max()), 1e-30)
    log("grads " + json.dumps(out))
    check(math.isfinite(lc) and out["loss_rel_err"] <= 1e-5,
          f"cuda vs ref loss {lc} vs {lr_}")
    check(all(out["cuda_repeat_bitwise"].values()),
          "the cuda path's MoE gradients differ between two identical runs")
    check(rf["z_err"] <= rf["z_tol"],
          f"the paths' pre-activations differ by {rf['z_err']} > "
          f"{rf['z_tol']}")
    check(torch.equal(past, carried),
          f"experts past rounding {out['w1_experts_past_rounding']} are not "
          f"those the relu flips carry {out['w1_experts_carried_by_flips']}")
    check(float(after.max()) <= EXPERT_TOL,
          f"without its relu flips, an expert's w1 gradient still differs "
          f"by {float(after.max())} of its largest entry > {EXPERT_TOL}")
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


def kernel_row(name, r, launches_by_path, profiles) -> dict:
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
        **{k: v for k, v in r.items()
           if k.startswith(("max_abs_err_", "tol_", "used_", "moa_"))}}


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
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    launches = {"serve": served["counts"],
                "serve_fused": served["fused"]["counts"],
                "serve_expert_choice": served["ec"]["counts"],
                "serve_moa_fused": moa["counts"],
                "train": trained["counts"],
                "train_eblock": eblock["launches"][str(E_BLOCK)]}
    profiles = [served["profile"], served["fused"]["profile"],
                served["ec"]["profile"], moa["profile"], trained["profile"],
                eblock["profile"]]
    measured = dict(kernels["rows"], **served["fused"]["kernels"])
    measured["fused_routed"].update(
        max_abs_err_f32_ragged=kernels["fused"]["fused_routed_f32_max_abs_err"],
        moa_proj=kernels["fused"]["moa_proj"])
    measured["fused_decode"]["max_abs_err_f32_ragged"] = \
        kernels["fused"]["fused_decode_f32_max_abs_err"]
    for name, (err, tol) in moa["kernel_errs"].items():
        measured[name].update(max_abs_err_moa_demo=err, tol_moa_demo=tol)
    rows = [kernel_row(name, measured[name], launches, profiles)
            for name in KERNELS]
    log(f"card {setup['card']}; serve cross-check max_abs_err "
        f"{served['cross']['max_abs_err']:.4g} (tol "
        f"{served['cross']['tol']:.4g}); train cuda-vs-ref loss rel err "
        f"{grads['loss_rel_err']:.3g}; {time.perf_counter() - t_start:.0f} s "
        "in all")
    print(setup["card"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
