#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result:

1. setup   — the card's name and power limit (nvidia-smi), torch / CUDA
             versions, and the build of the CUDA kernels from
             ``src/repro_torch/csrc`` (nvcc, one process per source).
2. kernels — each kernel's wrapper against its plain PyTorch version on
             the card: in bf16 at the shapes serving kimi-k2 gives it, and
             in f32 at cut, ragged shapes under a tight tolerance.  Each
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
   time of each kernel per launch and the device's idle share.
4. cross   — one full-width prefill under the "cuda" and the "ref"
             backends; last-position logits must agree within a bf16
             tolerance.
5. report  — one ``{"kernels": [...]}`` line, then the result line.
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
REPLACES = {
    "topk_gating": "src/repro/kernels/topk_gating.py:39",
    "dispatch": "src/repro/kernels/dispatch.py:148",
    "combine": "src/repro/kernels/dispatch.py:284",
    "gmm": "src/repro/kernels/gmm.py:232",
}
SOURCES = {
    "topk_gating": "src/repro_torch/csrc/topk_gating.cu",
    "dispatch": "src/repro_torch/csrc/dispatch.cu",
    "combine": "src/repro_torch/csrc/dispatch.cu",
    "gmm": "src/repro_torch/csrc/gmm.cu",
}


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


def bound_ms(n_bytes: float, flops: float, dtype_name: str):
    """(least time in ms, what bounds it) for moving ``n_bytes`` once and
    doing ``flops`` at the card's peak for the type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


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
    cases = [(8, 384, 8, 9, False), (32, 384, 8, 9, False),
             (32, 384, 8, 9, True), (37, 100, 2, 3, False),
             (5, 33, 1, 1, True)]
    for t, e, k, kk, tied in cases:
        logits = torch.randn(t, e, device="cuda", generator=gen)
        if tied:
            logits = torch.round(logits * 2)
        got = topk_gating(logits, k, kk)
        want = topk_gating_plain(logits, k, kk)
        check(torch.equal(got[1], want[1]),
              f"topk indices differ at T={t} E={e} tied={tied}")
        err = max(max_err(got[0], want[0]), max_err(got[2], want[2]))
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
    cases = [(8, d, e, k, torch.bfloat16, None, 0.0),
             (32, d, e, k, torch.bfloat16, None, 0.25),
             (13, 17, 5, 2, torch.float32, 2, 0.2),
             (40, 24, 6, 2, torch.float32, 8, 0.0)]
    for t, dd, ee, kk, dtype, cap, mask in cases:
        x, p = _route(t, ee, kk, dd, dtype, gen, capacity=cap,
                      mask_frac=mask)
        buf = dk.dispatch(x, p.expert_index, p.position, n_experts=ee,
                          capacity=p.capacity)
        want = dk.dispatch_plain(x, p.expert_index, p.position, None, ee,
                                 p.capacity)
        err = max_err(buf, want)
        check(err == 0.0, f"dispatch differs by {err} at T={t} d={dd}")
        worst_d = max(worst_d, err)
        out = torch.randn(buf.shape, device="cuda", generator=gen).to(dtype)
        y = dk.combine(out, p.weight, p.expert_index, p.position)
        yw = dk.combine_plain(out, p.weight, p.expert_index, p.position,
                              dtype)
        err = max_err(y, yw)
        check(err == 0.0, f"combine differs by {err} at T={t} d={dd} "
                          "(the kernel rounds as the plain version does)")
        worst_c = max(worst_c, err)
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
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            check(err <= tol, f"f32 gmm {act} [{e},{c},{kd}]x[{e},{kd},{n}] "
                              f"differs by {err} > {tol}")
            worst_f32 = max(worst_f32, err)
    log(f"gmm f32 cut shapes: max_abs_err {worst_f32:.3g}")
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
                shape=(f"one MoE layer at decode: 3 calls, x [{e},{c},{d}] x "
                       f"[{e},{d},{f}] (silu, none) and [{e},{c},{f}] x "
                       f"[{e},{f},{d}], bf16"))


def phase_kernels() -> dict:
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = [check_topk(gen), *check_dispatch_combine(gen), check_gmm(gen)]
    for r in results:
        log("kernel " + json.dumps(r))
    torch.cuda.empty_cache()
    return {r["name"]: r for r in results}


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


def phase_serve(cfg, params) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    sc = ServeConfig(max_len=PROMPT_LEN + NEW_TOKENS, n_slots=N_REQUESTS)
    engine = ServeEngine(params, cfg, sc, device="cuda")
    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(1, cfg.vocab_size, (PROMPT_LEN,))
               for _ in range(N_REQUESTS)]
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
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid} sampled a token outside the vocabulary")
    model_calls = stats["prefill_calls"] + stats["decode_steps"]
    n_moe = N_LAYERS
    want = {"topk_gating": n_moe * model_calls, "dispatch": n_moe * model_calls,
            "combine": n_moe * model_calls, "gmm": 3 * n_moe * model_calls}
    log(f"launches {counts}, expected {want} ({model_calls} model calls x "
        f"{n_moe} MoE layers)")
    check(counts == want, "kernel launch counts do not match the path")
    load = np.sum([t["expert_load"] for t in engine.telemetry], axis=0)
    hist = np.bincount(load.astype(int))
    out = {
        "requests": N_REQUESTS, "generated_tokens": stats["generated_tokens"],
        "wall_s": wall, "tokens_per_s": stats["generated_tokens"] / wall,
        "prefill_ms_median": 1e3 * statistics.median(
            engine.step_times["prefill"]),
        "decode_step_ms_median": 1e3 * statistics.median(
            engine.step_times["decode"]),
        "decode_steps": stats["decode_steps"],
        "prefills": stats["prefills"],
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "decode_overflow_total": stats["overflow_total"],
        "decode_expert_load_histogram": {
            "experts_with_n_assignments": {str(n): int(c) for n, c in
                                           enumerate(hist) if c},
            "busiest": [[int(i), int(load[i])]
                        for i in np.argsort(-load, kind="stable")[:5]]},
        "launches": counts,
        "sample_tokens": reqs[0].tokens[:8],
    }
    log("serve " + json.dumps(out))
    return {"summary": out, "counts": counts, "prompts": prompts,
            "engine": engine}


KERNEL_SYMBOLS = {"topk_gating": "topk_gating_kernel",
                  "dispatch": "dispatch_kernel", "combine": "combine_kernel",
                  "gmm": "gmm_kernel"}


def phase_profile(engine, prompts) -> dict:
    """Device time by kernel over two decode steps of a full slot pool,
    from torch.profiler (CUPTI), against the host wall clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.reset()
    for p in prompts:
        engine.submit(p, 4)
    engine.step()                      # every slot prefills, one decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            engine.step()
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
        per_kernel[name] = ({"launches": calls, "device_ms_per_launch":
                             sum(ms for _, ms in hits) / calls}
                            if calls else None)
    top = sorted(dev, key=lambda r: -r[2])[:8]
    out = {"decode_steps": 2, "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms if dev else None,
           "kernels": per_kernel,
           "top_device_ms": [[k[:70], n, ms] for k, n, ms in top]}
    log("profile " + json.dumps(out))
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


def main() -> int:
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
    try:
        setup = phase_setup()
        kernels = phase_kernels()
        cfg, params = build_model()
        served = phase_serve(cfg, params)
        profiled = phase_profile(served["engine"], served["prompts"])
        cross = phase_cross(cfg, params, served["prompts"][0],
                            served["engine"])
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    rows = []
    for name in ("topk_gating", "dispatch", "combine", "gmm"):
        r = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": served["counts"].get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms_per_launch": (profiled["kernels"][name] or {}).get(
                "device_ms_per_launch"),
            "tol": r["tol"], "check": "pass", "shape": r["shape"]})
    log(f"card {setup['card']}; cross-check max_abs_err "
        f"{cross['max_abs_err']:.4g} (tol {cross['tol']:.4g})")
    print(setup["card"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
