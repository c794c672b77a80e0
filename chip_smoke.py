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
             fused decode: kernel 8 at every MoE decode layer.
7. prefix  — chunked prefill, cross-slot batched prefill and the
             shared-prefix KV cache on the same model: top-k, dispatch,
             combine and the GMM stream against their plain versions at
             a chunk call's shapes (two 512-token chunks: top-k
             [1024, 384], [1024, 7168] <-> [384, 32, 7168]; the GMM at
             C = 32 and 16), timed beside bound, floor, plain and
             library; a 1536-token prompt pair as chunks at offsets 0 /
             512 / 1024 in calls of two rows under "cuda" and "ref"; one
             prompt chunked against whole at a capacity factor where
             neither call drops a token (logits and K/V); then 9
             requests of a shared 1024-token system prompt and 512
             tokens each (request 0 first, the others one step apart
             after it retired) through a chunked engine (budget 1024
             tokens a step, fused decode) with the cache off and on:
             8 hits of 1024 tokens, 8 x 1024 prefill tokens saved, pins
             released, launch counts exact per prefill call and decode
             step, and the trie's page of request 0 bit for bit a fresh
             chunked prefill of its prompt; TTFT, chunk-call time, the
             stall of decode steps that ran a chunk, prefill tokens/s
             and peak memory printed.
7b. obs    — observability on the same model (``repro_torch.obs``):
             (a) phase 7's traffic with the cache on, traced without a
             sync: greedy streams and launch counts equal to phase 7's,
             the trace loads with the reference test's span names, no
             negative duration, kernel.dispatch / kernel.combine spans
             equal to those kernels' launches, kernel.gmm spans a third
             of the GMM launches, kernel.decode_step spans kernel 7's;
             the registry: one decode_overflow_per_step observation a
             decode step, the decode_expert_load family equal to the
             telemetry's summed load; (b) the same traffic with
             ``trace_sync`` and ``log_decisions`` (a warm-up pass, then
             reset, clear and the measured pass): ``CostModel`` fitted
             on the trace (the table printed), a ``replay`` with the
             engine's page bytes: decisions and ten counters equal to
             the engine's, the predicted wall within 10 % of the
             recorded time of the ops it charges, a zero-cost replay
             deciding the same; (c) phase 3's traffic on phase 3's
             engine untraced and traced in turns (the median decode step
             of each pass printed, not gated), and one traced pass with
             fused decode (kernel.decode_step spans equal to kernel 7's
             launches, streams phase 5's).  The serving model is then
             freed.
8. moa     — moa-demo (Mixture-of-Attention-Heads) at its published
             widths: first every kernel of its serve path against its
             plain version at the shapes that path gives it (top-k,
             dispatch, GMM and combine at prefill and unfused decode,
             kernel 7 on its MoE layer, kernel 8 "proj" on its MoA
             layer), then 8 requests unfused and fused (kernel 8 in
             "proj" mode for each routed Q / O projection, kernel 7 for
             the MoE layers).
9. train   — the paper's MoE-256 LM (``paper_config("moe-256")``) at its
             published widths with the 1-Billion-Word vocabulary of
             793,471 (1.085 B parameters, f32), drawn from a seed on the
             card, trained through the port's Trainer (factored Adam,
             B=32 x S=128) for 12 steps with a checkpoint at step 6,
             traced (``trace_path`` under its workdir).  Launch counts
             per step must be exactly those of the resident regime;
             every loss finite; the trace's train.step spans 12, its
             train.checkpoint spans 2, kernel spans present, the median
             train.step span within 2 % of the median step time.  A
             profile of two more steps gives the device time by kernel
             and the idle share.
10. eblock  — moe_apply forward + backward at the training shape with
             ``dispatch_e_block=16`` against the resident default:
             dispatch buffers bit-equal, outputs and gradients close,
             the e-blocked kernels launched.
11. grads  — one more step's gradients under "cuda" (twice) and "ref"
             from the same parameters and draws: all present and
             finite, the MoE leaves' bit-equal between the two "cuda"
             runs and within 1e-5 normwise of "ref"; w1's once the
             terms of the pre-activations whose relu masks differ
             between the two paths are taken out (phase_grads counts
             them and says why).
   The MoE-256 model is then freed.
12. hmoe   — the paper's hierarchical MoE (Appendix B),
             ``paper_config("moe-4096-h")`` at full width with its
             vocabulary of 32,000 (4.34 B parameters, f32: 16 groups of
             256 experts 512 -> 1024 -> 512 relu, k = 2 at each level),
             drawn from a seed, both levels' gates redrawn.  First every
             kernel of its training step against its plain version at
             the step's shapes (top-k over [4096, 16] and over the
             16,384 slot rows of 256 experts, dispatch / combine at both
             levels, the GMMs over all 4096 experts at C = 16), timed
             beside its bound, the launch floor and torch.bmm; then 12
             steps through the Trainer as in phase 9 (launch counts
             exactly HMOE_LAUNCHES a step: one launch of each kernel per
             level and pass, whatever the number of groups), a profile
             of two more; one more batch's loss and gradients under
             "ref" and "cuda" (the MoE leaves within 1e-5 normwise, a
             slab at a time, w1's without its relu flips as in phase 11)
             and one optimizer update timed alone.  The model is then
             freed, and one lm_loss forward and backward of
             launch/train.py's reduced() kimi-k2 with a hierarchical MoE
             runs under "cuda" and "ref": exact launch counts, losses
             and gradients within f32 tolerances.
13. arctic — arctic-480b (``configs/arctic_480b.py``) at full width, bf16,
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
14. qwen3  — flash attention's output and gradients against plain
             autograd through ``causal_attention`` in f32 at qwen3's
             head shape (S = 2048, 4 x 4 blocks); then qwen3-1.7b at full
             size (28 layers, qk_norm, vocab 151,936, bf16) trained 4
             steps at B = 4 x S = 2048: finite metrics, every gradient
             present, step time and peak memory.
15. moa_train — moa-demo at its published widths (no cut: 4 layers, d
             512, vocab 32,000, bf16, gates redrawn) trained: first every
             kernel of its training step against its plain version at the
             step's shapes (T = 8 x 1024), in its first MoE FFN (top-k
             and B5 over [8192, 8]; dispatch / combine / B6 / B7 on its
             plan, [8192, 512] <-> [8, C, 512]; the swiglu FFN's GMMs
             with the plan's rows, forward and transposed) and its first
             MoA mixer (top-k and B5; dispatch / combine / B6 / B7 on the
             token plan and on the assignment plan, [16384, 128] <->
             [8, C, 128]; the GMMs of wq and wo and their transposed
             calls), timed beside bound, floor, plain and torch.bmm; step
             0's loss and every gradient under "cuda" and "ref" from the
             same draws, the ref run's routing pinned to the cuda run's
             and the tokens whose own top-k differs counted per layer
             (MOA_LOSS_TOL, MOA_GRAD_TOL; every gradient present, finite
             and nonzero, the MoA gates' included); then 6 Trainer steps
             with exact launch counts (MOA_TRAIN_LAUNCHES a step) and
             finite losses, a profile of one more.
16. gemma3 — gemma3-27b at full width (62 layers when they fit, else cut
             a period at a time: d 5376, 32 / 16 heads x 128, geglu
             21504, vocab 262,144, a 1024-token window on 52 layers,
             qk-norm, bf16) served: 4 requests of 1536-token prompts and
             32 greedy tokens, 4 slots, whole-prompt prefill; no kernel
             launch; the cache's bytes exactly the ring-buffer formula
             (windowed layers 1024 positions, global ones max_len); the
             engine with prefill_chunk=512 warns, falls back and serves
             the same streams, its prefill and decode logits (recorded)
             within 5 % of the logit scale of a training forward over
             each prompt and its tokens.  The model is then freed.
17. gemma3_train — gemma3-27b at full width cut to one period (5
             windowed layers, 1 global): the windowed flash attention
             against plain masked autograd at S = 4096, its time beside
             the global layer's, then 3 steps (B = 1 x S = 4096, remat):
             finite metrics, every gradient present and finite.
18. launchers — ``launch.train --arch smollm-135m --trace`` at full
             size, 8 steps of B = 8 x S = 2048 with checkpoints at 4 and
             8; the same call again resumes at step 8 and trains
             nothing; then ``launch.serve --ckpt --trace --trace-sync
             --log-decisions`` serves 4 greedy requests from it.  Both
             traces load (8 train.step and 2 train.checkpoint spans;
             serve.step and serve.decode spans) and both launchers print
             their trace lines.
19. falcon — falcon-mamba-7b at full size (64 mamba layers, no FFN,
             7.27 B parameters, bf16): layer 0's chunked scan against
             ``mamba_decode`` stepped token by token (f32 and bf16,
             SCAN_TOL); 4 requests of 1024-token prompts and 32 greedy
             tokens, 4 slots: no kernel launch, the decode state exactly
             146,800,640 bytes at any page length, the chunked engine's
             warning and fall-back; its logits against the training
             forward: in bf16 no farther from the f32 forward than
             BF16_FORWARD_RATIO times the bf16 forward, and the same
             engine in f32 (the weights widened) within 5 % of the
             logit scale of the f32 forward, greedy equal >= 0.9;
             profiles of two decode steps and of a prefill (the scan's
             device time: ops on [..., d_inner, d_state] tensors).
20. jamba  — jamba-v0.1-52b at full width cut to 16 layers (2 periods:
             14 mamba and 2 attention layers, 8 MoE FFNs of 16 experts
             top-2 swiglu 4096 -> 14336; 26.05 B parameters): kernels 1,
             2, 4, 6 and 7 against their plain versions at its prefill
             (T 1024, C 256) and decode (T 4, C 8) shapes, timed; 4
             requests of 1024 tokens and 32 greedy tokens unfused and
             fused, launch counts exact; cuda vs ref prefill logits;
             fused vs unfused decode logits; at capacity factor 8 (no
             drops) the chunked engine's fall-back and its logits
             against the training forward.
21. jamba_train — one period (8 layers, 13.29 B parameters), B = 1 x
             S = 4096, remat: the training kernels against their plain
             versions at C = 1024; step 0's loss and every gradient cuda
             vs ref with the ref run's routing pinned (loss 2^-7; each
             gradient within 2 x what bf16 rounding alone moves it,
             from a pinned ref run with the compute in f32); 3
             steps, launch counts exactly 4 x ARCTIC_LAUNCHES a step; one
             more step timed as in phase 22.
22. falcon_train — falcon-mamba-7b trained at B = 2 x S = 2048, remat,
             3 steps: finite metrics, every gradient present and finite,
             the optimizer timed alone, one more step with CUDA events
             around it and around every call of the scan (its share).
23. report — one ``{"kernels": [...]}`` line, then the result line.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
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
# Chunked prefill and the shared-prefix cache on the same model: 512-token
# chunks (kimi-k2's kv_block and q_block), at most two a step; 9 prompts
# of a 1024-token shared system prompt and 512 tokens of their own; the
# page sized to a chunk multiple above prompt + new tokens.  Request 0
# arrives at step 0 and retires at step 15 (its chunks at steps 0, 0 and
# 1, then 16 tokens, the first at step 1); the 8 others arrive one step
# apart from step 16.  PREFIX_C = capacity_for(1024, 384, 8, 1.25), the
# capacity of a two-chunk call.  PREFIX_CROSS_CF: the capacity factor of
# the chunked-vs-whole gate, at which neither call drops a token.
PREFIX_CHUNK, PREFIX_BUDGET, PREFIX_SHARED, PREFIX_LEN = 512, 1024, 1024, 1536
PREFIX_MAX_LEN, PREFIX_FIRST_ARRIVAL, PREFIX_C = 2048, 16, 32
PREFIX_CROSS_CF = 8.0
# Training: the paper's MoE-256 LM, B x S tokens a step.
TRAIN_CONFIG, TRAIN_VOCAB = "moe-256", 793_471
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT = 32, 128, 12, 6
# The traced training run's median train.step span against the trainer's
# median step time (the span sits inside the step's timer).
TRAIN_SPAN_TOL = 0.02
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
# Training moa-demo (no cut): B x S tokens a step through the Trainer.
MOA_TRAIN_B, MOA_TRAIN_S, MOA_TRAIN_STEPS = 8, 1024, 6
# Launches per moa-demo training step (remat on, resident regime; the
# derivation is tests/test_torch_moa_train.py's): each of the two MoE
# layers as ARCTIC_LAUNCHES; each of the two MoA layers its top-k, the
# Q dispatch (token plan), GMM wq, the Q combine (assignment plan), the
# O dispatch (assignment plan), GMM wo and the O combine (token plan),
# twice with remat's recompute, then B5, a combine for each dispatch's
# backward (B6), a dispatch for each combine's (B7; the assignment
# plan's unit weights take no gradient) and two transposed GMMs for each
# of wq and wo.
MOA_TRAIN_LAUNCHES = {"topk_gating": 8, "topk_gating_bwd": 4, "dispatch": 18,
                      "combine": 18, "gmm": 22, "gmm_bwd": 20}
# cuda vs ref at step 0 from the same draws, bf16, the ref run's routing
# pinned to the cuda run's (_TopkReplay): the loss within MOA_LOSS_TOL
# relative, each gradient leaf within MOA_GRAD_TOL normwise (||g_cuda -
# g_ref|| / ||g_ref||).  With the same plans the paths differ only where
# they round the GMMs', the expert FFN's and the combines' bf16 outputs
# after summing in other orders, through four layers and their backward
# passes; the same pinned step under "ref" in f32 is logged beside as
# what bf16 rounding alone moves.
MOA_LOSS_TOL, MOA_GRAD_TOL = 2.0 ** -7, 2.0 ** -5
# gemma3-27b: served at full width (all 62 layers when they fit the
# card), 4 requests of 1536-token prompts (longer than the 1024-token
# window) and 32 greedy tokens, 4 slots; then trained for one period (5
# windowed layers and a global one) at B x S tokens a step.
GEMMA = "gemma3-27b"
GEMMA_REQUESTS, GEMMA_PROMPT, GEMMA_NEW, GEMMA_CHUNK = 4, 1536, 32, 512
GEMMA_TRAIN_B, GEMMA_TRAIN_S, GEMMA_TRAIN_STEPS = 1, 4096, 3
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
# The Mamba mixer (models/ssm.py).  falcon-mamba-7b at full size (64
# layers, 7,270,825,984 parameters, 14.54 GB in bf16): served with 4
# slots, 4 prompts of 1024 tokens and 32 greedy tokens; trained at B x S
# tokens a step with remat.  Its decode state is n_layers x slots x
# (d_in·N·4 + (d_conv - 1)·d_in·2) bytes at any page length:
# 64 x 4 x (8192·16·4 + 3·8192·2).  SCAN_S: the one-layer scan-vs-decode
# gate's length (two chunks of 128), SCAN_TOL its tolerance a dtype,
# relative to the output's (and the state's) scale.
FALCON, FALCON_PARAMS = "falcon-mamba-7b", 7_270_825_984
SSM_REQUESTS, SSM_PROMPT, SSM_NEW = 4, 1024, 32
FALCON_STATE_BYTES = 146_800_640
FALCON_TRAIN_B, FALCON_TRAIN_S, FALCON_TRAIN_STEPS = 2, 2048, 3
SCAN_S, SCAN_TOL = 256, {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# The engine against the training forward at falcon's 64 layers: in bf16
# the forward itself moves 10-15 % of the logit scale from the same
# forward in f32 (rounding carried through 64 random layers; 2.8 % at
# 16 layers, 6-8 % at 32: my chip experiment, PR 22), so the 5 % gate
# and greedy >= 0.9 hold the f32 engine (the weights widened) to the f32
# forward, and the bf16 engine may be at most BF16_FORWARD_RATIO times
# as far from the f32 forward as the bf16 forward is.
BF16_FORWARD_RATIO = 2.0
# jamba-v0.1-52b at full width: served cut 32 -> 16 layers (2 periods,
# 26,052,591,616 parameters), trained cut to one period (8 layers,
# 13,294,731,264; its 4 MoE layers each launch ARCTIC_LAUNCHES a step).
# Capacities, capacity_for(T, 16, 2, 2.0) (the config keeps the default
# factor): a 1024-token prefill 256, a decode step of 4 slots 8, a
# training step of 4096 tokens 1024.  The
# engine-vs-forward gate runs at JAMBA_CROSS_CF, where C = T and no call
# drops a token (the prefill, the decode steps and the forward over
# the whole sequence route the same tokens with other capacities).
JAMBA = "jamba-v0.1-52b"
JAMBA_SERVE_LAYERS, JAMBA_SERVE_PARAMS = 16, 26_052_591_616
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_PARAMS = 8, 13_294_731_264
JAMBA_PREFILL_C, JAMBA_DECODE_C, JAMBA_TRAIN_C = 256, 8, 1024
JAMBA_TRAIN_B, JAMBA_TRAIN_S, JAMBA_TRAIN_STEPS = 1, 4096, 3
JAMBA_CROSS_CF = 8.0
# cuda vs ref at step 0 from the same draws, the ref run's routing pinned
# to the cuda run's (_TopkReplay): the loss within JAMBA_LOSS_TOL
# relative, as MOA_LOSS_TOL.  The gradients differ by 1.1-3.6 %
# normwise on every leaf, the MoE leaves no more than the others (my
# chip run 7, PR 22): bf16 rounding carried through seven mamba layers
# (in bf16 the forward of 8 falcon layers moves 2 % of the logit scale
# from f32, my chip experiment, PR 22), where moa-demo's were within
# MOA_GRAD_TOL.  So each leaf's cuda-vs-ref error is held to
# JAMBA_GRAD_RATIO times what bf16 rounding alone moves it: the same
# pinned step under "ref" with the compute in f32 (the weights stay
# bf16: f32 weights and gradients would not fit).
JAMBA_LOSS_TOL, JAMBA_GRAD_RATIO = 2.0 ** -7, 2.0


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


def serve_run(engine, prompts, vocab_size: int, *,
              new_tokens: int = NEW_TOKENS, stagger: int = 1):
    """Warm up, then serve ``prompts`` (``new_tokens`` greedy tokens
    each, arrivals ``stagger`` steps apart) with the launch counts
    zeroed just before and read just after.  Returns (requests, launch
    counts, summary)."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib

    engine.generate(np.stack(prompts[:2]), 2)     # warm-up (cuBLAS, caches)
    engine.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = [engine.submit(p, new_tokens, arrival=stagger * i)
            for i, p in enumerate(prompts)]
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    stats = engine.stats
    for r in reqs:
        check(r.done and len(r.tokens) == new_tokens,
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
    """Launches a serve run must count: per model call of each kind (a
    prefill call is one whole prompt or one group of same-offset
    chunks)."""
    out: dict = {}
    for table, n in ((per_prefill, stats["prefill_calls"]),
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


def device_profile(fn, scan=None) -> dict:
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
    lacked it, as in :func:`device_ms`.  ``scan`` = (d_inner, d_state)
    records the ops' input shapes and adds ``scan_ms``
    (:func:`scan_device_ms`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cuda_lib

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=scan is not None) as prof:
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
    extra = {} if scan is None else scan_device_ms(prof, *scan)
    return {**extra, "wall_ms": wall_ms, "device_busy_ms": busy,
            "profiled_window_idle_share": 1.0 - busy / wall_ms if dev
            else None,
            "kernels": per_kernel, "wrapper_launches": launched,
            "top_device_ms": [[k[:70], n, ms] for k, n, ms in top]}


def scan_device_ms(prof, d_in: int, d_state: int) -> dict:
    """The selective scan's device time in a profile taken with shapes:
    the self device time of every op with an input of rank 3 or more
    shaped [..., d_in, d_state] (dA and dB·x, the doubling steps, the
    carried state, the C contraction; forward, recomputed and backward),
    beside the self device time of all ops."""
    from torch.autograd import DeviceType

    def shapes(sh):
        """The tensor shapes in one recorded input (a tensor list, as
        ``cat``'s, records one shape a tensor)."""
        if sh and isinstance(sh[0], (list, tuple)):
            for inner in sh:
                yield from shapes(inner)
        else:
            yield list(sh)

    scan_ms = ops_ms = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU:
            continue
        ms = e.self_device_time_total / 1e3
        ops_ms += ms
        if any(len(sh) >= 3 and sh[-2:] == [d_in, d_state]
               for inp in e.input_shapes or () for sh in shapes(inp)):
            scan_ms += ms
    return {"scan_ms": scan_ms, "ops_device_ms": ops_ms,
            "scan_share": scan_ms / ops_ms if ops_ms else None}


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
    once per fused_decode flag, each from its own copy of the prefilled
    cache (a mamba mixer's decode advances its state in place)."""
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
        out[fused], _ = lm.lm_decode(params, nxt,
                                     pm.tree_map(torch.clone, cache), cur,
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
            "cross": cross, "profile": prof,
            "streams": [list(r.tokens) for r in reqs]}


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


# ---------------------------------------------------------------------------
# the kernel checks shared by the serve and training paths
# ---------------------------------------------------------------------------

def _timed_call(what, fn, symbol, n_bytes, flops, dtype_name, floor,
                plain=None, library=None, big=False) -> dict:
    """One kernel call at a path's shape: device time per launch
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


def _dtype_name(t) -> str:
    import torch
    return "bfloat16" if t.dtype == torch.bfloat16 else "float32"


def _topk_rows(label, logits, k, kk, gen, floor, *, bwd=True,
               library=None) -> tuple:
    """Top-k (kernel 1) on ``logits`` [N, E] against its plain version
    (indices exact, values within 1e-6) and, with ``bwd``, its backward
    (B5) on random cotangents, bit for bit; each timed.  Returns the
    row, B5's row (or None), and the kernel's combine weights and
    indices [N, k]."""
    import torch
    from repro_torch.kernels import topk_gating as tk
    n, e = logits.shape
    got, want = tk.topk_gating(logits, k, kk), tk.topk_gating_plain(
        logits, k, kk)
    check(torch.equal(got[1], want[1]), f"{label} top-k indices differ")
    err = max(max_err(got[0], want[0]), max_err(got[2], want[2]))
    check(err <= 1e-6, f"{label} top-k values differ by {err}")
    row = dict(max_abs_err=err, tol=1e-6, **_timed_call(
        f"{label} topk_gating [{n},{e}] k={k} kk={kk}",
        lambda: tk.topk_gating(logits, k, kk), "topk_gating_kernel",
        n * e * 4 + n * k * 4 + n * kk * 8, 0, "float32", floor,
        plain=lambda: tk.topk_gating_plain(logits, k, kk), library=library))
    cw, idx, _ = got
    row_bwd = None
    if bwd:
        dw_in = torch.randn(n, k, device="cuda", generator=gen)
        dvals = torch.randn(n, kk, device="cuda", generator=gen)
        check(torch.equal(tk.topk_gating_bwd(cw, idx, dw_in, dvals, e),
                          tk.topk_gating_bwd_plain(cw, idx, dw_in, dvals,
                                                   e)),
              f"{label} top-k backward differs from its plain version")
        row_bwd = dict(max_abs_err=0.0, tol=0.0, **_timed_call(
            f"{label} topk_gating_bwd [{n},{e}] k={k} kk={kk}",
            lambda: tk.topk_gating_bwd(cw, idx, dw_in, dvals, e),
            "topk_gating_bwd_kernel", n * e * 4 + n * k * 8 + n * kk * 8, 0,
            "float32", floor,
            plain=lambda: tk.topk_gating_bwd_plain(cw, idx, dw_in, dvals,
                                                   e)))
    return row, row_bwd, cw, idx[:, :k].contiguous()


def _dispatch_combine_rows(label, x, plan, gen, floor, *, backward=True,
                           b6=True, l2_cold=False) -> tuple:
    """Dispatch (kernel 2) and combine (kernel 4) on ``plan`` against
    their plain versions, bit for bit, and with ``backward`` the calls
    of their backward passes: B7, the dispatch scaled by the plan's
    weights, and with ``b6`` B6, the combine with unit weights (a plan
    whose weights are already 0 / 1, as MoA's assignment view, shares it
    with the combine).  Each is timed; bytes count the token rows that
    hold a kept assignment once.  With ``l2_cold`` the combine's
    ``dev_ms`` is taken with the L2 cache cold, as in
    ``dispatch_combine_times``, and its back-to-back times, which re-read
    a buffer the L2 may hold, are kept apart.  Returns the dispatched
    buffer and both rows."""
    import torch
    from repro_torch.kernels import dispatch as dk
    ei, po, w = (v.contiguous() for v in (plan.expert_index, plan.position,
                                          plan.weight))
    e, cap = plan.n_experts, plan.capacity
    n, d = x.shape
    k, es, dt = ei.shape[1], x.element_size(), _dtype_name(x)
    kept = po < cap
    n_kept, rows_read = int(kept.sum()), int(kept.any(dim=1).sum())
    buf = dk.dispatch(x, ei, po, n_experts=e, capacity=cap)
    check(torch.equal(buf, dk.dispatch_plain(x, ei, po, None, e, cap)),
          f"{label} dispatch differs from its plain version")
    disp_bytes = (rows_read * d + e * cap * d) * es + n * k * 8
    shape = f"[{n},{d}] {dt} <-> [{e},{cap},{d}], k={k}, {n_kept} kept"
    row_d = dict(max_abs_err=0.0, tol=0.0, **_timed_call(
        f"{label} dispatch {shape}",
        lambda: dk.dispatch(x, ei, po, n_experts=e, capacity=cap),
        "dispatch_kernel", disp_bytes, 0, dt, floor,
        plain=lambda: dk.dispatch_plain(x, ei, po, None, e, cap)))
    if backward:
        g_tok = torch.randn(n, d, device="cuda", generator=gen).to(x.dtype)
        check(torch.equal(dk.dispatch(g_tok, ei, po, w, n_experts=e,
                                      capacity=cap),
                          dk.dispatch_plain(g_tok, ei, po, w, e, cap)),
              f"{label} B7 (dispatch scaled by w) differs from its plain "
              "version")
        row_d["B7"] = _timed_call(
            f"{label} B7 dispatch scaled {shape}",
            lambda: dk.dispatch(g_tok, ei, po, w, n_experts=e,
                                capacity=cap),
            "dispatch_kernel", disp_bytes + n * k * 4, 0, dt, floor,
            plain=lambda: dk.dispatch_plain(g_tok, ei, po, w, e, cap))
    ybuf = torch.randn(e, cap, d, device="cuda", generator=gen).to(x.dtype)
    weights = [("combine", w)]
    if backward and b6:
        weights.append(("B6", torch.ones_like(w)))
    for name, wt in weights:
        check(torch.equal(dk.combine(ybuf, wt, ei, po),
                          dk.combine_plain(ybuf, wt, ei, po, x.dtype)),
              f"{label} {name} differs from its plain version")
    comb = [n_kept * d * es + n * k * 12 + n * d * es, 2 * n_kept * d]
    rows = []
    for name, wt in weights:
        row = _timed_call(
            f"{label} {name} {shape}", lambda: dk.combine(ybuf, wt, ei, po),
            "combine_kernel", *comb, dt, floor,
            plain=lambda: dk.combine_plain(ybuf, wt, ei, po, x.dtype))
        if l2_cold:
            flush = torch.empty(32 * 2 ** 20, device="cuda")
            cold = device_ms(
                lambda: (flush.zero_(), dk.combine(ybuf, wt, ei, po)),
                ("combine_kernel",))
            check("combine_kernel" in cold,
                  f"{label}: no combine_kernel in the L2-cold profile")
            row.update(dev_ms_l2_warm=row.pop("dev_ms"),
                       queued_ms_l2_warm=row.pop("queued_ms", None),
                       dev_ms=cold["combine_kernel"])
            del flush
        rows.append(row)
    row_c = dict(max_abs_err=0.0, tol=0.0, **rows[0])
    if len(rows) > 1:
        row_c["B6"] = rows[1]
    if l2_cold:
        log(f"{label} combine, L2 cold: {row_c['dev_ms']} ms a launch")
    return buf, row_d, row_c


def _gmm_rows(label, cases, rows, floor) -> dict:
    """GMM calls against ``gmm_plain``: kernel 6 in the forward layout
    and B8's transposed ones (dx = dz w^T, dw = x^T dz).  ``cases``:
    (name, x, w, activation, trans_x, trans_w); ``rows`` the plan's
    filled rows an expert, or None for every row.  Each within
    ``bf16_tol`` / ``f32_tol`` of the output's largest binade by its
    dtype, timed beside its bound (bytes and operations of the filled
    rows and the used experts' weights; an f32 call does 3xTF32's three
    products), the launch floor and torch.bmm.  Returns the calls and
    their sums."""
    import torch
    from repro_torch.kernels import gmm as gk
    x0 = cases[0][1]
    e, es = x0.shape[0], x0.element_size()
    f32 = x0.dtype == torch.float32
    if rows is None:
        used, filled = e, e * x0.shape[1]
    else:
        used, filled = int((rows > 0).sum()), int(rows.sum())
    worst, tol_used, calls = 0.0, 0.0, {}
    for name, xi, wi, act, tx, tw in cases:
        cap = xi.shape[1]
        got = gk.gmm(xi, wi, activation=act, trans_x=tx, trans_w=tw,
                     rows=rows)
        want = gk.gmm_plain(xi, wi, act, tx, tw, rows)
        err = max_err(got, want)
        tol = f32_tol(want) if f32 else bf16_tol(want)
        check(err <= tol, f"{label} gmm {name} differs by {err} > {tol}")
        worst, tol_used = max(worst, err), max(tol_used, tol)
        del got, want
        xl = xi.transpose(1, 2) if tx else xi
        wl = wi.transpose(1, 2) if tw else wi
        md, kd, nd = xl.shape[1], xl.shape[2], wl.shape[2]
        if tx:      # dw [E, M, N]: the filled rows of both operands in
            n_bytes = (filled * (md + nd) + e * md * nd) * es
            flops = 2 * filled * md * nd
        else:       # the filled rows and the used experts' weights in
            n_bytes = (filled * kd + used * kd * nd + e * cap * nd) * es
            flops = 2 * filled * kd * nd
        if tx or tw:
            symbol = "gmm_tile_bwd_kernel"
        else:
            symbol = f"gmm_{gk.kernel_for(xi.dtype, cap, False)}_kernel"
        calls[name] = dict(max_abs_err=err, tol=tol, **_timed_call(
            f"{label} gmm {name} {tuple(xl.shape)} x {tuple(wl.shape)}"
            + (" rows" if rows is not None else ""),
            lambda: gk.gmm(xi, wi, activation=act, trans_x=tx, trans_w=tw,
                           rows=rows), symbol, n_bytes,
            {"tf32": 3 * flops} if f32 else flops,
            None if f32 else "bfloat16", floor,
            plain=lambda: gk.gmm_plain(xi, wi, act, tx, tw, rows),
            library=lambda: torch.bmm(xl, wl), big=True))
        torch.cuda.empty_cache()
    return dict(max_abs_err=worst, tol=tol_used, calls=calls,
                used_experts=used, filled_rows=filled,
                **{key: sum(c[key] for c in calls.values())
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "dev_ms")})


def _moe_ffn_cases(x_buf, hid, dz, dy, w1, w2, w3, activation) -> tuple:
    """The GMM calls of one MoE FFN's training step, as ``expert_ffn``
    and its backward make them: forward, w1 with its activation (silu
    for swiglu, then w3) and w2, and w1 without the activation (the
    backward pass's recomputed pre-activation); transposed, dx and dw
    at w1's shape (dz [E, C, f]) and w2's (dy [E, C, d])."""
    up = "silu" if activation == "swiglu" else activation
    fwd = [(f"w1_{up}", x_buf, w1, up, False, False),
           ("w1_none", x_buf, w1, "none", False, False)]
    if w3 is not None:
        fwd.append(("w3", x_buf, w3, "none", False, False))
    fwd.append(("w2", hid, w2, "none", False, False))
    bwd = [("dx_w1", dz, w1, "none", False, True),
           ("dw_w1", x_buf, dz, "none", True, False),
           ("dh_w2", dy, w2, "none", False, True),
           ("dw_w2", hid, dy, "none", True, False)]
    return fwd, bwd


# ---------------------------------------------------------------------------
# phase 7: chunked prefill and the shared-prefix KV cache on the same
# full-width model
# ---------------------------------------------------------------------------

def check_chunk_kernels(cfg, params, gen, floor) -> dict:
    """Kernels 1, 2, 4 and 6 at the shapes a chunk call gives them: two
    512-token chunks in one call (T = 1024: top-k [1024, 384], dispatch
    and combine [1024, 7168] <-> [384, 32, 7168] bf16, the GMM stream
    over all 384 experts at C = 32 with a plan's rows) and one (T = 512,
    C = 16: the GMM).  Each against its plain version with phase 2's
    tolerances (top-k indices exact and values within 1e-6, dispatch
    and combine bit for bit, the GMM within bf16_tol), then timed:
    profiler device time per launch, CUDA events, plain and library
    times, the bound and the launch floor; the combine's device time
    with a cold L2."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.kernels import dispatch as dk
    from repro_torch.kernels import gmm as gk

    bf = torch.bfloat16
    e, k, kk, d = cfg.n_experts, cfg.moe_k, cfg.moe_k + 1, cfg.d_model
    t = PREFIX_BUDGET
    out: dict = {}
    logits = torch.randn(t, e, device="cuda", generator=gen)

    def library():
        vals, idx = torch.topk(logits, kk, dim=-1)
        return torch.softmax(vals[:, :k], dim=-1), idx
    out["topk_gating"] = _topk_rows("chunk", logits, k, kk, gen, floor,
                                    bwd=False, library=library)[0]
    x, p = _route(t, e, k, d, bf, gen)
    check(p.capacity == PREFIX_C,
          f"chunk capacity {p.capacity}, expected {PREFIX_C}")
    buf, out["dispatch"], out["combine"] = _dispatch_combine_rows(
        "chunk", x, p, gen, floor, backward=False, l2_cold=True)
    # The expert FFN of layer 0 on the dispatched buffer (C = 32) and on
    # a one-chunk plan's (C = 16), with the plans' rows, as the path
    # runs it: w1 with silu, w3, w2.
    _, w1, w2, w3 = _layer0_moe(params)
    f = w1.shape[-1]
    x16, p16 = _route(t // 2, e, k, d, bf, gen)
    buf16 = dk.dispatch(x16, p16.expert_index, p16.position, n_experts=e,
                        capacity=p16.capacity)
    out["gmm"] = {}
    for b_in, plan in ((buf, p), (buf16, p16)):
        rows = dsp.filled_rows(plan)
        h = gk.mask_rows(torch.randn(e, plan.capacity, f, device="cuda",
                                     generator=gen).to(bf), rows)
        out["gmm"][f"C{plan.capacity}"] = _gmm_rows(
            f"chunk C={plan.capacity}",
            [("w1", b_in, w1, "silu", False, False),
             ("w3", b_in, w3, "none", False, False),
             ("w2", h, w2, "none", False, False)], rows, floor)
    log("chunk kernels " + json.dumps(out))
    del buf, buf16, x, x16, logits
    torch.cuda.empty_cache()
    return out


def chunked_prefill(cfg, params, rows, page, *, n_chunks=None) -> tuple:
    """``rows`` ([G, S] int) through ``lm_prefill`` as PREFIX_CHUNK-token
    chunks at offsets 0, PREFIX_CHUNK, ... into ``page``: (last logits
    of the last chunk, page)."""
    import torch
    from repro_torch.models import lm

    tokens = torch.as_tensor(rows, dtype=torch.int32, device="cuda")
    n = n_chunks or tokens.shape[1] // PREFIX_CHUNK
    for i in range(n):
        off = i * PREFIX_CHUNK
        logits, page = lm.lm_prefill(
            params, {"tokens": tokens[:, off:off + PREFIX_CHUNK]}, page, cfg,
            start_pos=off)
    return logits, page


def kv_span(cfg, page, lo: int, hi: int) -> list:
    """Each K/V leaf of ``page`` on cache positions [lo, hi)."""
    from repro_torch.common import param as pm
    from repro_torch.models import transformer
    defs = transformer.cache_defs(cfg, 1, PREFIX_MAX_LEN)
    return [leaf.narrow(d.axes.index("kv_seq"), lo, hi - lo)
            for d, leaf in zip(pm.tree_leaves(defs), pm.tree_leaves(page))]


def overflow_probe():
    """Wrap the router's telemetry so every routing call of a block
    records its dropped assignments and its busiest expert's load;
    returns (records, restore)."""
    from repro_torch.core import router as router_lib
    orig = router_lib.route_telemetry
    records = []

    def probe(info, p):
        telem = orig(info, p)
        records.append((float(telem["overflow"].sum()),
                        float(telem["expert_load"].max()), p.capacity))
        return telem
    router_lib.route_telemetry = probe
    return records, lambda: setattr(router_lib, "route_telemetry", orig)


def phase_chunk_gates(cfg, params, prompts) -> dict:
    """Gate 1: one prompt pair taken as chunks at offsets 0 / 512 / 1024
    in calls of G = 2 rows under the "cuda" and "ref" backends, last
    logits within phase_cross's tolerance.  Gate 2: one prompt chunked
    (three G = 1 calls) against whole (one call of 1536 tokens) at
    PREFIX_CROSS_CF, where neither call drops a token (checked): last
    logits and the page's K/V on [0, 1536) within 5 % of their scale."""
    import numpy as np
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models import lm, transformer

    pair = np.stack(prompts[:2])
    out = {}
    for backend in ("cuda", "ref"):
        page = pm.zeros(transformer.cache_defs(cfg, 2, PREFIX_MAX_LEN),
                        "cuda")
        out[backend], _ = chunked_prefill(
            cfg.replace(kernel_backend=backend), params, pair, page)
        del page
    a, b = out["cuda"], out["ref"]
    check(all_finite(a) and all_finite(b), "non-finite chunk logits")
    scale = float(b.abs().max())
    g1 = {"max_abs_err": max_err(a, b), "tol": 0.05 * scale,
          "logit_scale": scale, "rows": 2, "chunks": PREFIX_LEN //
          PREFIX_CHUNK, "top1_equal": bool(torch.equal(a.argmax(-1),
                                                          b.argmax(-1)))}
    log("chunk cross (cuda vs ref, G = 2) " + json.dumps(g1))
    check(g1["max_abs_err"] <= g1["tol"], f"chunked cuda vs ref logits "
          f"differ by {g1['max_abs_err']} > {g1['tol']}")
    del out, a, b
    ccfg = cfg.replace(capacity_factor=PREFIX_CROSS_CF)
    records, restore = overflow_probe()
    try:
        lc, pc = chunked_prefill(ccfg, params, pair[:1],
                                 pm.zeros(transformer.cache_defs(
                                     ccfg, 1, PREFIX_MAX_LEN), "cuda"))
        chunk_rec = list(records)
        records.clear()
        lw, pw = lm.lm_prefill(
            params, {"tokens": torch.as_tensor(pair[:1], dtype=torch.int32,
                                               device="cuda")},
            pm.zeros(transformer.cache_defs(ccfg, 1, PREFIX_MAX_LEN), "cuda"),
            ccfg)
        whole_rec = list(records)
    finally:
        restore()
    n_moe = N_LAYERS
    check(len(chunk_rec) == 3 * n_moe and len(whole_rec) == n_moe,
          f"routing calls: {len(chunk_rec)} chunked, {len(whole_rec)} whole")
    dropped = sum(r[0] for r in chunk_rec + whole_rec)
    scale = float(lw.abs().max())
    kv_err = kv_scale = 0.0
    for x, y in zip(kv_span(cfg, pc, 0, PREFIX_LEN),
                    kv_span(cfg, pw, 0, PREFIX_LEN)):
        kv_err = max(kv_err, max_err(x, y))
        kv_scale = max(kv_scale, abs_max(y))
    g2 = {"capacity_factor": PREFIX_CROSS_CF,
          "capacity_chunk": chunk_rec[0][2], "capacity_whole": whole_rec[0][2],
          "busiest_expert_chunk": max(r[1] for r in chunk_rec),
          "busiest_expert_whole": max(r[1] for r in whole_rec),
          "dropped_assignments": dropped,
          "logits_max_abs_err": max_err(lc, lw), "logits_tol": 0.05 * scale,
          "kv_max_abs_err": kv_err, "kv_tol": 0.05 * kv_scale,
          "top1_equal": bool(torch.equal(lc.argmax(-1), lw.argmax(-1)))}
    log("chunked vs whole prompt (tolerance: 5 % of the logits' and of the "
        "K/V's largest magnitude, as the cross phase) " + json.dumps(g2))
    check(dropped == 0, f"chunked vs whole: {dropped} assignments dropped")
    check(g2["logits_max_abs_err"] <= g2["logits_tol"],
          f"chunked vs whole logits differ by {g2['logits_max_abs_err']}")
    check(kv_err <= g2["kv_tol"], f"chunked vs whole K/V differ by {kv_err}")
    del pc, pw
    torch.cuda.empty_cache()
    return {"cuda_vs_ref": g1, "chunked_vs_whole": g2}


def prefix_engine(cfg, params, prefix_cache: bool = True, **kw):
    """The chunked engine of the shared-system-prompt trace (fused
    decode); ``kw`` adds ServeConfig fields."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    return ServeEngine(params, cfg, ServeConfig(
        max_len=PREFIX_MAX_LEN, n_slots=N_REQUESTS,
        prefill_chunk=PREFIX_CHUNK, prefill_budget=PREFIX_BUDGET,
        admission="aware", fused_decode=True, prefix_cache=prefix_cache,
        **kw), device="cuda")


def prefix_traffic(prompts) -> list:
    """(prompt, new tokens, arrival) of the shared-system-prompt trace:
    request 0 at step 0, the others one step apart from
    PREFIX_FIRST_ARRIVAL."""
    arrivals = [0] + [PREFIX_FIRST_ARRIVAL + i
                      for i in range(len(prompts) - 1)]
    return [(p, NEW_TOKENS, a) for p, a in zip(prompts, arrivals)]


def prefix_run(cfg, params, prompts, prefix_cache: bool) -> dict:
    """The shared-system-prompt trace through a chunked engine (fused
    decode), each step timed to a device sync.  Launch counts are zeroed
    just before the run and read just after."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib

    engine = prefix_engine(cfg, params, prefix_cache)
    reqs = [engine.submit(p, m, arrival=a)
            for p, m, a in prefix_traffic(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    steps = []
    while engine.queue or engine.sched.active():
        calls, dec = (engine.stats["prefill_calls"],
                      engine.stats["decode_steps"])
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        steps.append((t0, time.perf_counter(),
                      engine.stats["prefill_calls"] > calls,
                      engine.stats["decode_steps"] > dec))
    counts = cuda_lib.launch_counts()
    for r in reqs:
        check(r.done and len(r.tokens) == NEW_TOKENS,
              f"prefix run: request {r.rid} ended with {len(r.tokens)} "
              "tokens")
        check(all(0 <= tok < cfg.vocab_size for tok in r.tokens),
              f"prefix run: request {r.rid} sampled outside the vocabulary")
    check(reqs[0].finished_step < PREFIX_FIRST_ARRIVAL,
          f"request 0 retired at step {reqs[0].finished_step}, not before "
          f"the others arrive at {PREFIX_FIRST_ARRIVAL}")
    ttft_steps = [r.first_token_step - r.arrival for r in reqs]
    ttft_ms = [1e3 * (steps[r.first_token_step][1] - steps[r.arrival][0])
               for r in reqs]
    stall = [1e3 * (b - a) for a, b, chunk, dec in steps if chunk and dec]
    chunk_s = engine.step_times["chunk"]
    stats = engine.stats
    summary = {
        "prefix_cache": prefix_cache, "first_arrival_step":
        PREFIX_FIRST_ARRIVAL, "request0_finished_step": reqs[0].finished_step,
        "steps": len(steps), "ttft_steps": ttft_steps,
        "ttft_ms_median": statistics.median(ttft_ms),
        "ttft_ms_p95": float(np.percentile(ttft_ms, 95)),
        "ttft_steps_median": statistics.median(ttft_steps),
        "ttft_steps_p95": float(np.percentile(ttft_steps, 95)),
        "chunk_call_ms_median": 1e3 * statistics.median(chunk_s),
        "stall_steps": len(stall),
        "stall_ms_p95": float(np.percentile(stall, 95)) if stall else None,
        "prefill_tokens_per_s": stats["prefill_tokens"] / sum(chunk_s),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "stats": stats, "launches": counts}
    if engine.prefix is not None:
        summary["prefix"] = dict(engine.prefix.stats,
                                 pages=engine.prefix.n_pages,
                                 bytes=engine.prefix.bytes)
    log(f"prefix run (cache {'on' if prefix_cache else 'off'}) "
        + json.dumps(summary))
    return {"engine": engine, "reqs": reqs, "summary": summary,
            "counts": counts}


def phase_prefix(cfg, params, floor) -> dict:
    """Chunked prefill, cross-slot batching and the shared-prefix cache
    at kimi-k2's full width: the kernels at the chunk shapes, gates 1-2
    (phase_chunk_gates), then the shared-system-prompt trace with the
    cache off and on: gate 3 (every request finishes inside the
    vocabulary; 8 hits of 1024 tokens; 8 x 1024 prefill tokens fewer
    than with the cache off; every pin released; the trie within its
    budget), gate 4 (launches exactly per prefill call and decode step)
    and gate 5 (the trie's page of request 0 equals, bit for bit on the
    prompt, a fresh chunked prefill of that prompt at the same calls:
    no hit's tail chunk wrote into it)."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = check_chunk_kernels(cfg, params, gen, floor)
    rs = np.random.RandomState(SEED)
    shared = rs.randint(1, cfg.vocab_size, (PREFIX_SHARED,))
    prompts = [np.concatenate([shared, rs.randint(
        1, cfg.vocab_size, (PREFIX_LEN - PREFIX_SHARED,))])
        for _ in range(N_REQUESTS + 1)]
    gates = phase_chunk_gates(cfg, params, prompts)
    off = prefix_run(cfg, params, prompts, False)
    on = prefix_run(cfg, params, prompts, True)
    eng = on["engine"]
    s_on, s_off = on["summary"]["stats"], off["summary"]["stats"]
    n_hit = len(prompts) - 1
    check(s_on["prefix_hits"] == n_hit, f"{s_on['prefix_hits']} prefix hits")
    check(s_on["prefix_hit_tokens"] == n_hit * PREFIX_SHARED,
          f"{s_on['prefix_hit_tokens']} prefix hit tokens")
    check(s_off["prefill_tokens"] - s_on["prefill_tokens"]
          == n_hit * PREFIX_SHARED,
          f"prefill tokens {s_on['prefill_tokens']} with the cache, "
          f"{s_off['prefill_tokens']} without")
    check(eng._pins == {} and all(e.pins == 0 for e in eng.prefix._entries),
          "prefix pins left after the run")
    check(eng.prefix.bytes <= eng.sc.prefix_cache_bytes,
          f"the trie holds {eng.prefix.bytes} B over its budget")
    n_moe = N_LAYERS
    per_call = {"topk_gating": n_moe, "dispatch": n_moe, "combine": n_moe,
                "gmm": 3 * n_moe}
    for run, what in ((off, "prefix off"), (on, "prefix on")):
        check_launches(f"{what} serve", run["counts"], expected_launches(
            run["summary"]["stats"], per_call, {"fused_decode": n_moe}))
    entry, depth = eng.prefix._walk(prompts[0], PREFIX_LEN // PREFIX_CHUNK)
    check(entry is not None and depth == PREFIX_LEN // PREFIX_CHUNK,
          "request 0's prompt is not in the trie")
    _, fresh = chunked_prefill(eng.cfg, params, np.stack(prompts[:1]),
                               eng.kv.new_page())
    same = {}
    for what, lo, hi in (("shared_prefix", 0, PREFIX_SHARED),
                         ("request0_tail", PREFIX_SHARED, PREFIX_LEN)):
        same[what] = all(torch.equal(x, y) for x, y in zip(
            kv_span(cfg, entry.page, lo, hi), kv_span(cfg, fresh, lo, hi)))
    log("trie page of request 0 against a fresh chunked prefill, bit for "
        "bit " + json.dumps(same))
    check(all(same.values()), f"the trie's page changed: {same}")
    agree = stream_agreement([r.tokens for r in on["reqs"]],
                             [r.tokens for r in off["reqs"]])
    res = {"kernels": kernels, "gates": gates, "off": off["summary"],
           "on": on["summary"], "trie_page_bitwise": same,
           "greedy_tokens_equal_on_vs_off": agree,
           "prefill_tokens_saved": s_off["prefill_tokens"]
           - s_on["prefill_tokens"]}
    log(f"prefix phase: greedy tokens equal with the cache on and off "
        f"{agree:.4f}; prefill tokens saved {res['prefill_tokens_saved']}")
    streams_on = [list(r.tokens) for r in on["reqs"]]
    del off, on, eng, fresh
    torch.cuda.empty_cache()
    return dict(res, counts=res["on"]["launches"], prompts=prompts,
                streams_on=streams_on)


# ---------------------------------------------------------------------------
# phase 7b: observability on the same model: phase 7's traffic traced, the
# replay cost model fitted on the card, tracing's cost at decode, the
# metrics registry
# ---------------------------------------------------------------------------

# The span names the reference's engine test requires of a traced run.
OBS_SPANS = {"serve.step", "serve.schedule", "serve.prefill_chunk",
             "serve.decode", "serve.sample", "serve.kv_insert",
             "serve.retire", "serve.prefix_probe", "serve.queue"}
# The ops the replay charges (serve.step would count its children twice)
# and the counters it must reproduce; its predicted wall within
# OBS_WALL_TOL of the recorded time of those ops.
OBS_CHARGED = {"serve.schedule", "serve.prefix_probe", "serve.prefix_hit",
               "serve.retire", "serve.prefill", "serve.prefill_chunk",
               "serve.kv_insert", "serve.sample", "serve.decode"}
OBS_COUNTERS = ("prefills", "decode_steps", "generated_tokens",
                "slot_steps_active", "slot_steps_total", "prefill_chunks",
                "prefill_tokens", "prefill_calls", "prefix_hits",
                "prefix_hit_tokens")
OBS_WALL_TOL = 0.10
OBS_AB_PAIRS = 4         # untraced / traced decode passes, in turns


def span_counts(events) -> dict:
    out: dict = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def obs_run(engine, traffic) -> tuple:
    """Serve ``traffic`` through ``engine.run()`` (which saves its trace)
    with the launch counts zeroed just before and read just after.
    Returns (streams, launch counts, wall seconds)."""
    import torch
    from repro_torch.kernels import cuda_lib

    reqs = [engine.submit(p, m, arrival=a) for p, m, a in traffic]
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        check(r.done and len(r.tokens) == r.max_new_tokens,
              f"obs: request {r.rid} ended with {len(r.tokens)} tokens")
    return [list(r.tokens) for r in reqs], cuda_lib.launch_counts(), wall


def obs_kernel_spans(what, events, counts) -> dict:
    """Each kernel span against its kernels' launches: one dispatch,
    combine and kernel-7 launch a span, three GMM launches (w1, w3, w2)
    a ``kernel.gmm`` span of the expert FFN."""
    spans = span_counts(events)
    pairs = {"kernel.dispatch": counts.get("dispatch", 0),
             "kernel.combine": counts.get("combine", 0),
             "kernel.gmm": counts.get("gmm", 0) / 3,
             "kernel.decode_step": counts.get("fused_decode", 0)}
    got = {name: [spans.get(name, 0), want] for name, want in pairs.items()}
    log(f"{what}: kernel spans [spans, launches (GMM / 3)] "
        + json.dumps(got))
    check(all(a == b for a, b in got.values()),
          f"{what}: kernel span counts do not match the launches: {got}")
    return got


def obs_registry(what, engine) -> dict:
    """The registry against the engine's own records: one overflow
    observation a decode step, the per-expert load family summed equal
    to the telemetry ring's summed ``expert_load`` (the ring holds every
    step here)."""
    import numpy as np

    stats = engine.stats
    n = engine.metrics.get("decode_overflow_per_step").count
    check(n == stats["decode_steps"] == len(engine.telemetry),
          f"{what}: {n} overflow observations, {stats['decode_steps']} "
          f"decode steps, {len(engine.telemetry)} telemetry entries")
    load = np.sum([t["expert_load"] for t in engine.telemetry], axis=0)
    fam = engine.metrics.get("decode_expert_load").children()
    got = [fam[(e,)].value if (e,) in fam else 0.0
           for e in range(load.shape[0])]
    check(got == load.tolist(),
          f"{what}: decode_expert_load differs from the telemetry's sum")
    out = {"decode_steps": stats["decode_steps"],
           "expert_load_total": float(load.sum()),
           "experts_loaded": int((load > 0).sum()),
           "decode_active_slots_p50":
           engine.metrics.get("decode_active_slots").p50,
           "overflow_total": stats["overflow_total"]}
    log(f"{what} registry " + json.dumps(out))
    return out


def obs_overhead(served) -> dict:
    """Phase 3's traffic on phase 3's engine, untraced and traced (no
    sync) in turns: the median decode step of each pass; the streams
    must not change.  Reported, not gated."""
    import torch
    from repro_torch.obs import trace as trace_lib

    engine = served["engine"]
    traffic = [(p, NEW_TOKENS, i) for i, p in enumerate(served["prompts"])]
    passes = []
    for _ in range(OBS_AB_PAIRS):
        for traced in (False, True):
            engine.tracer = trace_lib.Tracer() if traced else trace_lib.NULL
            engine.reset()
            streams, _, _ = obs_run(engine, traffic)
            check(streams == served["streams"],
                  f"obs overhead: the {'traced' if traced else 'untraced'} "
                  "pass changed the greedy streams")
            passes.append((traced, 1e3 * statistics.median(
                engine.step_times["decode"])))
    engine.tracer = trace_lib.NULL
    engine.reset()
    torch.cuda.synchronize()
    out = {"order": ["traced" if t else "untraced" for t, _ in passes],
           "decode_step_ms_median_by_pass": [ms for _, ms in passes],
           "untraced_ms": statistics.median(ms for t, ms in passes if not t),
           "traced_ms": statistics.median(ms for t, ms in passes if t)}
    log("obs overhead (phase 3 traffic, one engine) " + json.dumps(out))
    return out


def phase_obs(cfg, params, served, fused, prefix, workdir) -> dict:
    """Observability on the full-width kimi-k2 (phase 7's model):

    (a) phase 7's shared-prefix traffic (cache on) with ``trace_path``
        and no sync: the streams and launch counts equal to phase 7's
        untraced run, the trace loads with the reference test's span
        names, every span's duration >= 0, kernel spans equal to
        launches; (d) the registry against the telemetry;
    (b) the same traffic with ``trace_sync`` and ``log_decisions``: a
        warm-up pass, then ``reset()`` and ``tracer.clear()`` and the
        measured pass; ``CostModel.fit_trace`` and a ``replay`` of the
        traffic: the decisions and counters equal to the engine's, the
        predicted wall within OBS_WALL_TOL of the recorded time of the
        ops it charges, a zero-cost replay deciding the same;
    (c) tracing's cost at decode (obs_overhead), and one traced pass of
        phase 3's traffic with fused decode: ``kernel.decode_step``
        spans equal to kernel 7's launches, the streams phase 5's."""
    import os
    import torch
    from repro_torch.obs import replay as replay_lib
    from repro_torch.obs import trace as trace_lib
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    traffic = prefix_traffic(prefix["prompts"])
    # (a)
    path = os.path.join(workdir, "serve_prefix.json")
    engine = prefix_engine(cfg, params, trace_path=path)
    streams, counts, wall = obs_run(engine, traffic)
    check(streams == prefix["streams_on"],
          "obs (a): traced greedy streams differ from phase 7's untraced "
          "run")
    check(counts == prefix["counts"],
          f"obs (a): launches {counts} != phase 7's {prefix['counts']}")
    events = trace_lib.load(path)
    names = span_counts(events)
    check(OBS_SPANS <= set(names),
          f"obs (a): trace lacks {sorted(OBS_SPANS - set(names))}")
    check(all(e["dur"] >= 0 for e in events if e["ph"] == "X"),
          "obs (a): a span has a negative duration")
    spans_a = obs_kernel_spans("obs (a)", events, counts)
    registry = obs_registry("obs (a)", engine)
    host_ms = {}
    for e in events:
        if e["ph"] == "X" and e["name"] in OBS_CHARGED:
            host_ms[e["name"]] = host_ms.get(e["name"], 0.0) + e["dur"] / 1e3
    traced = {"wall_s": wall, "events": len(events), "span_counts": names,
              "span_ms_total_unsynced": host_ms}
    log("obs (a) traced prefix run " + json.dumps(traced))
    del engine
    torch.cuda.empty_cache()
    # (b)
    path = os.path.join(workdir, "serve_fit.json")
    engine = prefix_engine(cfg, params, trace_path=path, trace_sync=True,
                           log_decisions=True)
    obs_run(engine, traffic)                       # warm-up pass
    engine.reset()
    engine.tracer.clear()
    streams, _, wall = obs_run(engine, traffic)
    check(streams == prefix["streams_on"],
          "obs (b): synced greedy streams differ from phase 7's")
    real = tuple(engine.sched.decision_log)
    check(len(real) > 0, "obs (b): the engine logged no decisions")
    model = replay_lib.CostModel.fit_trace(path)
    rcfg = replay_lib.ReplayConfig(
        n_slots=N_REQUESTS, admission="aware", prefill_chunk=PREFIX_CHUNK,
        prefill_budget=PREFIX_BUDGET, prefix_cache=True,
        prefix_cache_bytes=engine.sc.prefix_cache_bytes,
        page_bytes=engine.kv.page_bytes, max_len=PREFIX_MAX_LEN)
    res = replay_lib.replay(traffic, rcfg, model)
    check(tuple(res.decisions) == real,
          "obs (b): the replay's decisions differ from the engine's")
    for key in OBS_COUNTERS:
        check(res.stats[key] == engine.stats[key],
              f"obs (b): replay {key} {res.stats[key]} != engine "
              f"{engine.stats[key]}")
    recorded = sum(e["dur"] for e in trace_lib.load(path)
                   if e["ph"] == "X" and e["name"] in OBS_CHARGED) / 1e6
    rel = abs(res.predicted_wall_s - recorded) / recorded
    check(rel < OBS_WALL_TOL,
          f"obs (b): predicted wall {res.predicted_wall_s:.6f} s vs "
          f"recorded {recorded:.6f} s ({rel:.3%})")
    zero = replay_lib.replay(traffic, rcfg, None)
    check(tuple(zero.decisions) == real and zero.predicted_wall_s == 0.0,
          "obs (b): a zero-cost replay decided differently")
    for op, c in model.to_dict().items():
        log(f"fitted cost {op}: a {c['a']:.6e} s per unit of "
            f"{replay_lib.OP_X.get(op, '(constant)')}, b {c['b']:.6e} s, "
            f"n {c['n']}")
    lat = res.metrics.get("request_latency_s")
    fit = {"decisions": len(real), "page_bytes": engine.kv.page_bytes,
           "predicted_wall_s": res.predicted_wall_s,
           "recorded_charged_s": recorded, "rel_err": rel,
           "measured_pass_wall_s": wall,
           "replay_request_latency_s_p50": lat.p50,
           "replay_request_latency_s_p95": lat.p95,
           "costs": model.to_dict(), "stats": res.stats}
    log("obs (b) replay calibration " + json.dumps(fit))
    del engine
    torch.cuda.empty_cache()
    # (c)
    overhead = obs_overhead(served)
    path = os.path.join(workdir, "serve_fused.json")
    engine = ServeEngine(params, cfg, ServeConfig(
        max_len=PROMPT_LEN + NEW_TOKENS, n_slots=N_REQUESTS,
        fused_decode=True, trace_path=path), device="cuda")
    streams, counts, _ = obs_run(engine, [
        (p, NEW_TOKENS, i) for i, p in enumerate(served["prompts"])])
    check(streams == fused["streams"],
          "obs (c): traced fused streams differ from phase 5's")
    spans_c = obs_kernel_spans("obs (c) fused", trace_lib.load(path), counts)
    check(spans_c["kernel.decode_step"][0] > 0,
          "obs (c): no kernel.decode_step span")
    del engine
    torch.cuda.empty_cache()
    return {"traced": traced, "kernel_spans": spans_a, "registry": registry,
            "fit": fit, "overhead": overhead, "fused_kernel_spans": spans_c}


def run_serve(floor: dict) -> dict:
    """Phases 3-7b on the full-width kimi-k2; the model is freed on
    return."""
    cfg, params = build_model()
    served = phase_serve(cfg, params)
    profiled = phase_profile(served["engine"], served["prompts"],
                             served["summary"]["decode_step_ms_median"])
    cross = phase_cross(cfg, params, served["prompts"][0], served["engine"])
    fused = phase_fused(cfg, params, served)
    ec = phase_expert_choice(cfg, params, served["prompts"])
    prefix = phase_prefix(cfg, params, floor)
    with tempfile.TemporaryDirectory() as workdir:
        obs = phase_obs(cfg, params, served, fused, prefix, workdir)
    return {"counts": served["counts"], "summary": served["summary"],
            "profile": profiled, "cross": cross, "fused": fused, "ec": ec,
            "prefix": prefix, "obs": obs}


# ---------------------------------------------------------------------------
# phase 8: serve moa-demo (MoA mixers) fused and unfused
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
# phase 9: train the paper's MoE-256 LM at full width
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
    (factored Adam, a checkpoint every TRAIN_CKPT steps), traced: launch
    counts exactly ``launches`` a step, every metric finite, peak memory
    under the card's, the trace's train.step spans one a step, its
    train.checkpoint spans one a checkpoint, kernel spans present, the
    median train.step span within TRAIN_SPAN_TOL of the trainer's median
    step time; then a profile of two more steps."""
    import math
    import os
    import torch
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels import cuda_lib
    from repro_torch.obs import trace as trace_lib
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
        kernel_backend="cuda",
        trace_path=os.path.join(workdir, "train_trace.json"), device="cuda")
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
    events = trace_lib.load(trainer.tracer.path)
    spans = span_counts(events)
    kernel_spans = {k: v for k, v in spans.items()
                    if k.startswith("kernel.")}
    check(spans.get("train.step") == TRAIN_STEPS
          and spans.get("train.data") == TRAIN_STEPS,
          f"{what}: train spans {spans}")
    check(spans.get("train.checkpoint") == TRAIN_STEPS // TRAIN_CKPT,
          f"{what}: {spans.get('train.checkpoint')} checkpoint spans")
    check(kernel_spans, f"{what}: no kernel spans in the trace")
    span_ms = statistics.median(e["dur"] / 1e3 for e in events
                                if e["name"] == "train.step")
    step_ms = 1e3 * statistics.median(trainer.step_times)
    check(abs(span_ms - step_ms) <= TRAIN_SPAN_TOL * step_ms,
          f"{what}: median train.step span {span_ms:.3f} ms vs step "
          f"{step_ms:.3f} ms")
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
        "trace": {"span_counts": spans,
                  "train_step_span_ms_median": span_ms,
                  "step_ms_median_all": step_ms},
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
# phase 11: one step's gradients, cuda vs ref
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
# phase 10: the e-blocked regime against the resident one
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
# phase 12: train the paper's hierarchical MoE-4096-h at full width
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


def check_hmoe_kernels(cfg, params, gen, floor) -> dict:
    """Every kernel of the moe-4096-h training step against its plain
    version at the shapes a step gives it, in f32 (T = 4096 tokens of
    d = 512, k = 2 at each level): the primary level's top-k over
    [4096, 16] and its dispatch into [16, HMOE_CP, 512] and combine back;
    the secondary level's top-k over the 16 x HMOE_CP slot rows of 256
    experts, with the primary plan's empty slots masked, and its dispatch
    into [4096, HMOE_CS, 512] and combine back, on the plan over the flat
    4096 experts that the router builds; B5, B6 and B7 at both levels
    (combine's device time with a cold L2); the expert FFN's GMMs over
    all 4096 experts with the plan's rows (``_moe_ffn_cases``).
    Tolerances as in phase 2: top-k indices exact and values within
    1e-6, B5, dispatch, B7, combine and B6 bit for bit, the GMMs within
    f32_tol.  Each is timed beside its bound and the launch floor, the
    GMMs also beside torch.bmm."""
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

    def level(name, x_in, logits, n_experts, cap, valid=None):
        r1, r5, cw, idx = _topk_rows(f"hmoe {name}", logits, k, kk, gen,
                                     floor)
        out["topk_gating"][name], out["topk_gating_bwd"][name] = r1, r5
        if valid is None:
            plan = dsp.plan(idx, cw, n_experts, cap)
        else:       # the flat expert ids over all groups
            plan = dsp.plan(router_lib.flat_expert_ids(
                idx.reshape(g, cp, k), b), cw * valid.reshape(-1, 1),
                n_experts, cap)
        buf, out["dispatch"][name], out["combine"][name] = \
            _dispatch_combine_rows(f"hmoe {name}", x_in, plan, gen, floor,
                                   l2_cold=True)
        return buf, plan

    with torch.no_grad():
        # The primary level: tokens into the groups' slot buffers.
        logits = x @ moe["gate_primary"]["wg"] + torch.randn(
            t, g, device="cuda", generator=gen)
        buf, plan_p = level("primary", x, logits, g, cp)
        # The secondary level: every group's slots at once.
        logits = (torch.bmm(buf, moe["gate_secondary"]["wg"])
                  + torch.randn(g, cp, b, device="cuda", generator=gen))
        xs, plan_s = level("secondary", buf.reshape(-1, d),
                           logits.reshape(g * cp, b), e, cs,
                           valid=hmoe_lib._kept_slots(plan_p, g))
        del buf
    rows = dsp.filled_rows(plan_s)
    n_kept_p = int((plan_p.position < cp).sum())
    used, filled = int((rows > 0).sum()), int(rows.sum())
    log(f"hmoe plans: primary C={cp}, {n_kept_p} of {t * k} kept; secondary"
        f" C={cs} over {e} experts, {used} used, {filled} filled rows")
    # The expert FFN: GMMs over the flat experts (views of the [16, 256,
    # ...] leaves), the tiled 3xTF32 kernel.
    check(gk.kernel_for(torch.float32, cs, False) == "tile",
          "the hmoe GMMs must run the tiled kernel")

    def act(shape):
        return gk.mask_rows(torch.randn(*shape, device="cuda",
                                        generator=gen), rows)
    hid, dz, dy = act((e, cs, f)), act((e, cs, f)), act((e, cs, d))
    fwd, bwd = _moe_ffn_cases(xs, hid, dz, dy,
                              moe["w1"].detach().reshape(e, d, f),
                              moe["w2"].detach().reshape(e, f, d), None,
                              "relu")
    out["gmm"] = _gmm_rows("hmoe", fwd, rows, floor)
    out["gmm_bwd"] = _gmm_rows("hmoe", bwd, rows, floor)
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
# phase 13: train arctic-480b at full width (one layer, bf16)
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


def check_train_kernels(label, cfg, moe, t, want_cap, gen, floor) -> dict:
    """Every kernel of one MoE layer's training step against its plain
    version at the shapes a step gives it (T tokens of d bf16, the
    layer's expert weights ``moe``, a plan routed by its gate with
    noise), with phase 2's tolerances: top-k indices exact and values
    within 1e-6, B5, dispatch (and B7, the dispatch scaled by the
    combine weights) and combine (and B6, unit weights) bit for bit, the
    GMMs (the tiled bf16 kernel) within two bf16 ulps of the output's
    largest binade, with the plan's ``rows`` (``_moe_ffn_cases``).  Each
    is timed beside its bound and the launch floor."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.kernels import gmm as gk

    bf = torch.bfloat16
    w1, w3, w2 = (moe[k].detach() for k in ("w1", "w3", "w2"))
    wg = moe["gate"]["wg"].detach()
    d = cfg.d_model
    e, k, f = cfg.n_experts, cfg.moe_k, cfg.moe_d_ff
    x = torch.randn(t, d, device="cuda", generator=gen).to(bf)
    logits = x.float() @ wg.float() + torch.randn(t, e, device="cuda",
                                                  generator=gen)
    out: dict = {}
    out["topk_gating"], out["topk_gating_bwd"], cw, idx = _topk_rows(
        label, logits, k, k + 1, gen, floor)
    # The plan, as the router builds it.
    cap = dsp.capacity_for(t, e, k, cfg.capacity_factor)
    check(cap == want_cap, f"{label} capacity {cap}, expected {want_cap}")
    plan = dsp.plan(idx, cw, e, cap)
    rows = dsp.filled_rows(plan)
    n_kept, filled = int((plan.position < cap).sum()), int(rows.sum())
    used = int((rows > 0).sum())
    log(f"{label} plan: C={cap}, {n_kept} of {t * k} slots kept, {used} "
        f"experts used, {filled} filled rows")
    buf, out["dispatch"], out["combine"] = _dispatch_combine_rows(
        label, x, plan, gen, floor)
    check(gk.kernel_for(bf, cap, False) == "tile",
          f"the {label} GMMs must run the tiled kernel")

    def act(shape):
        return gk.mask_rows(torch.randn(*shape, device="cuda",
                                        generator=gen).to(bf), rows)
    hid, dz, dy = act((e, cap, f)), act((e, cap, f)), act((e, cap, d))
    fwd, bwd = _moe_ffn_cases(buf, hid, dz, dy, w1, w2, w3, cfg.activation)
    out["gmm"] = _gmm_rows(label, fwd, rows, floor)
    out["gmm_bwd"] = _gmm_rows(label, bwd, rows, floor)
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
    kernels = check_train_kernels(
        "arctic", cfg, _layer(params["blocks"]["periods"]["pos0"]["moe"], 0),
        ARCTIC_B * ARCTIC_S, ARCTIC_C, gen, floor)
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
# phase 14: train qwen3-1.7b at full size; flash attention on the card
# ---------------------------------------------------------------------------

def check_flash(gen, *, b: int = 2, kvh: int = 8, g: int = 2,
                s: int = QWEN_S, hd: int = 128, window: int = 0,
                what: str = "flash attention") -> dict:
    """flash_attention's output and gradients against plain autograd
    through causal_attention (with its window mask), in f32 at a head
    shape (by default qwen3-1.7b's: 16 / 8 heads of 128, S = 2048 in
    4 x 4 blocks of 512, no window), within 1e-5 of each result's
    scale."""
    import torch
    from repro_torch.models import attention as at
    q = torch.randn(b, s, kvh * g, hd, device="cuda", generator=gen)
    k = torch.randn(b, s, kvh, hd, device="cuda", generator=gen)
    v = torch.randn(b, s, kvh, hd, device="cuda", generator=gen)
    dout = torch.randn(b, s, kvh * g, hd, device="cuda", generator=gen)

    def flash(q, k, v):
        qr = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
        o = at.flash_attention(qr, k.permute(0, 2, 3, 1),
                               v.permute(0, 2, 1, 3), True, window, 512, 512)
        return o.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd)

    def plain(q, k, v):
        return at.causal_attention(q, k, v, window=window)

    res = {}
    for name, fn in (("flash", flash), ("plain", plain)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves)
        (o * dout).sum().backward()
        res[name] = [o.detach()] + [t.grad for t in leaves]
    errs = {}
    for key, got, want in zip(("out", "dq", "dk", "dv"), res["flash"],
                              res["plain"]):
        errs[key] = (max_err(got, want), f32_tol(want))
        check(errs[key][0] <= errs[key][1], f"{what} {key} differs from "
              f"plain autograd by {errs[key][0]} > {errs[key][1]}")

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves) * dout).sum().backward()
    times = {"flash_ms": cuda_ms(lambda: fwd_bwd(flash), reps=3, warmup=1),
             "plain_ms": cuda_ms(lambda: fwd_bwd(plain), reps=3, warmup=1)}
    out = {"shape": f"B={b}, {kvh * g}/{kvh} heads x {hd}, S={s}, blocks "
                    f"512 x 512, window {window}, f32",
           "max_abs_err_and_tol": errs, **times}
    log(f"{what} " + json.dumps(out))
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
# phase 15: train moa-demo (MoA's backward passes through the kernels)
# ---------------------------------------------------------------------------

def _named_leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a parameter tree, in sorted key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named_leaves(tree[key], f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def check_moa_train_kernels(cfg, params, gen, floor) -> dict:
    """Every kernel of moa-demo's training step against its plain
    version at the shapes a step gives it (T = B x S tokens of d = 512
    bf16), in the first layer of each routed kind.  The MoE FFN (8
    experts top-2, swiglu 512 -> 1024), routed by its gate with
    training noise: top-k over [T, 8] and B5, dispatch / combine / B6 /
    B7 on its plan ([T, 512] <-> [8, C, 512]) and the FFN's GMMs with
    the plan's rows (``_moe_ffn_cases``).  The MoA mixer, routed by its
    gate likewise: top-k and B5, dispatch / combine / B6 / B7 on the
    token plan and on the assignment plan ([T·k, 128] <-> [8, C, 128],
    unit weights, which B6 and the combine share), the GMMs of wq
    ([8, C, 512] x [8, 512, 128]) and wo and their transposed calls,
    without rows (MoA's projections take none).  Phase 2's tolerances
    (top-k indices exact and values within 1e-6, B5, dispatch and
    combine bit for bit, the GMMs within two bf16 ulps), each timed
    beside its bound, the launch floor and torch.bmm."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import router as router_lib
    from repro_torch.core.moa import assignment_plan
    from repro_torch.kernels import gmm as gk
    from repro_torch.kernels import topk_gating as tk
    from repro_torch.models.transformer import _moa_args, _moe_args

    bf = torch.bfloat16
    periods = params["blocks"]["periods"]
    t, d = MOA_TRAIN_B * MOA_TRAIN_S, cfg.d_model
    out: dict = {name: {} for name in ("topk_gating", "topk_gating_bwd",
                                       "dispatch", "combine", "gmm",
                                       "gmm_bwd")}

    def route(label, a, layer):
        """The router's plan of T random tokens (training noise and
        capacity); the noisy logits its top-k sees go to kernel 1's
        check."""
        x = torch.randn(t, d, device="cuda", generator=gen).to(bf)
        noise = torch.randn(t, a.n_experts, device="cuda", generator=gen)
        seen: dict = {}

        def topk_seen(noisy, k_, kk_):
            seen.update(logits=noisy, kk=kk_)
            w_, i_, v_ = tk.topk_gating(noisy, k_, kk_)
            return w_, i_[:, :k_].contiguous(), v_
        with torch.no_grad():
            p = router_lib.build(a, topk_impl=topk_seen).route(
                layer, x, train=True, noise=noise).plan
        (out["topk_gating"][label], out["topk_gating_bwd"][label], _,
         _) = _topk_rows(f"moa-demo train {label}", seen["logits"], a.k,
                         seen["kk"], gen, floor)
        n_kept = int((p.position < p.capacity).sum())
        log(f"moa-demo train {label} plan: C={p.capacity}, {n_kept} of "
            f"{t * a.k} assignments kept")
        out.setdefault("plan", {})[label] = dict(
            tokens=t, capacity=p.capacity, kept=n_kept)
        return x, p

    # The MoE FFN of layer 0.
    moe = {k: v.detach() for k, v in _layer(periods["pos0"]["moe"],
                                            0).items() if k != "gate"}
    x, p = route("moe", _moe_args(cfg), _layer(periods["pos0"]["moe"], 0))
    rows = dsp.filled_rows(p)
    buf, out["dispatch"]["moe"], out["combine"]["moe"] = \
        _dispatch_combine_rows("moa-demo train moe", x, p, gen, floor)
    e, cap, f = p.n_experts, p.capacity, cfg.moe_d_ff

    def act(shape):
        return gk.mask_rows(torch.randn(*shape, device="cuda",
                                        generator=gen).to(bf), rows)
    hid, dz, dy = act((e, cap, f)), act((e, cap, f)), act((e, cap, d))
    fwd, bwd = _moe_ffn_cases(buf, hid, dz, dy, moe["w1"], moe["w2"],
                              moe.get("w3"), cfg.activation)
    out["gmm"]["moe"] = _gmm_rows("moa-demo train moe", fwd, rows, floor)
    out["gmm_bwd"]["moe"] = _gmm_rows("moa-demo train moe", bwd, rows,
                                      floor)
    del x, buf, hid, dz, dy
    # The MoA mixer of layer 1: both plans, then wq and wo.
    moa = _layer(periods["pos1"]["moa"], 0)
    a = _moa_args(cfg)
    hh = a.d_head_group
    x, p = route("moa", a, moa)
    e, cap = p.n_experts, p.capacity
    _, out["dispatch"]["moa_token"], out["combine"]["moa_token"] = \
        _dispatch_combine_rows("moa-demo train moa token plan", x, p, gen,
                               floor)
    xa = torch.randn(t * a.k, hh, device="cuda", generator=gen).to(bf)
    _, out["dispatch"]["moa_assign"], out["combine"]["moa_assign"] = \
        _dispatch_combine_rows("moa-demo train moa assignment plan", xa,
                               assignment_plan(p), gen, floor, b6=False)
    xq = torch.randn(e, cap, d, device="cuda", generator=gen).to(bf)
    xo = torch.randn(e, cap, hh, device="cuda", generator=gen).to(bf)
    wq, wo = moa["wq"].detach(), moa["wo"].detach()
    out["gmm"]["moa"] = _gmm_rows(
        "moa-demo train moa", [("wq", xq, wq, "none", False, False),
                               ("wo", xo, wo, "none", False, False)],
        None, floor)
    out["gmm_bwd"]["moa"] = _gmm_rows(
        "moa-demo train moa", [("dx_wq", xo, wq, "none", False, True),
                               ("dw_wq", xq, xo, "none", True, False),
                               ("dx_wo", xq, wo, "none", False, True),
                               ("dw_wo", xo, xq, "none", True, False)],
        None, floor)
    del x, xa, xq, xo
    torch.cuda.empty_cache()
    return out


class _TopkReplay:
    """Pins the "ref" runs' routing to the "cuda" run's.  ``record``
    keeps every top-k choice kernel 1 makes (k + 1 indices a row, in
    call order: the forward's layers, then remat's recompute);
    ``replay`` makes the sort-based top-k of ``core.gating`` take them in
    the same order, with its own values gathered at those indices.  A
    "ref" run then has the cuda run's plans, capacity drops and load
    thresholds, and its own values and gradients.  ``flips`` counts, per
    call, the rows whose own top-k set is not the recorded one."""

    def __init__(self):
        self.choices: list = []
        self.flips: list = []

    @contextlib.contextmanager
    def record(self):
        from repro_torch.kernels import ops
        orig = ops.topk_gating

        def recorded(logits, k, kk=None):
            w, idx, vals = orig(logits, k, kk)
            self.choices.append(idx.detach().clone())
            return w, idx, vals
        ops.topk_gating = recorded
        try:
            yield
        finally:
            ops.topk_gating = orig

    @contextlib.contextmanager
    def replay(self):
        import torch
        from repro_torch.core import gating
        orig = gating.top_k
        self.flips = []

        def replayed(v, kk):
            n = len(self.flips)
            check(n < len(self.choices),
                  "the ref run made more top-k calls than the cuda run")
            idx = self.choices[n]
            check(tuple(idx.shape) == tuple(v.shape[:-1]) + (kk,),
                  f"top-k call {n}: recorded {tuple(idx.shape)}, logits "
                  f"{tuple(v.shape)}, kk={kk}")
            _, own = orig(v, kk)
            mine = torch.sort(own[..., :kk - 1].long(), dim=-1).values
            theirs = torch.sort(idx[..., :kk - 1].long(), dim=-1).values
            self.flips.append(int((mine != theirs).any(dim=-1).sum()))
            return v.gather(-1, idx.long()), idx.to(torch.int32)
        gating.top_k = replayed
        try:
            yield
        finally:
            gating.top_k = orig
        check(len(self.flips) == len(self.choices),
              f"the ref run made {len(self.flips)} top-k calls, the cuda "
              f"run {len(self.choices)}")


def moa_grads_cuda_vs_ref(cfg, params, batch, draws) -> dict:
    """Step 0's loss and every gradient under "cuda" and "ref" from the
    same parameters, batch and draws (MoE and MoA noise), the ref run's
    routing pinned to the cuda run's (``_TopkReplay``): every gradient
    present, finite and not all zero under "cuda" (the MoA gates'
    included), the loss within MOA_LOSS_TOL relative and each leaf
    within MOA_GRAD_TOL normwise of "ref".  The same pinned step under
    "ref" in f32 (the weights upcast) shows what bf16 rounding alone
    moves; the tokens whose own top-k differs from the cuda run's are
    counted for each routed layer of the forward."""
    import torch
    from repro_torch.common.param import tree_map
    from repro_torch.models import lm
    from repro_torch.models.transformer import layer_index

    f32 = torch.float32
    wide = tree_map(lambda p: p.detach().float().requires_grad_(True),
                    params)
    runs = {"cuda": (params, cfg),
            "ref": (params, cfg.replace(kernel_backend="ref")),
            "ref_f32": (wide, cfg.replace(kernel_backend="ref",
                                          param_dtype=f32,
                                          compute_dtype=f32))}
    pin = _TopkReplay()
    res, flips = {}, {}
    for what, (tree, c) in runs.items():
        named = list(_named_leaves(tree))
        with pin.record() if what == "cuda" else pin.replay():
            loss, _ = lm.lm_loss(tree, batch, c, draws=draws)
            loss.backward()
        if what != "cuda":
            flips[what] = pin.flips
        res[what] = (float(loss.detach()),
                     {name: p.grad for name, p in named})
        for _, p in named:
            p.grad = None
    del wide
    routed = [f"layer {i} {'moa' if kind.mixer == 'moa' else 'moe'}"
              for i, kind in layer_index(cfg)
              if kind.mixer == "moa" or kind.ffn in ("moe", "moe+dense")]
    flips = {what: dict(zip(routed, f)) for what, f in flips.items()}
    (lc, gc), (lr_, gr), (lw, gw) = res["cuda"], res["ref"], res["ref_f32"]
    rel = abs(lc - lr_) / abs(lr_)
    errs, floor = {}, {}
    for name, g in gc.items():
        check(g is not None, f"moa-demo: {name} has no gradient")
        check(all_finite(g), f"moa-demo: {name}'s gradient is not finite")
        check(any_nonzero(g), f"moa-demo: {name}'s gradient is zero")
        errs[name] = norm_rel_err(g, gr[name])
        floor[name] = norm_rel_err(gr[name], gw[name])
    worst = max(errs, key=errs.get)
    t = batch["tokens"].numel()
    log(f"moa-demo routing flips at step 0 (tokens of {t} whose own top-k "
        "differs from the cuda run's; both ref runs take the cuda run's): "
        + json.dumps(flips))
    log(f"moa-demo cuda vs ref at step 0, routing pinned: loss {lc} vs "
        f"{lr_} (rel {rel:.3g}, tol {MOA_LOSS_TOL:.3g}; ref in f32 {lw}); "
        f"gradients normwise rel err (tol {MOA_GRAD_TOL:.3g}): "
        + json.dumps(errs))
    log("moa-demo bf16 ref vs f32 ref gradients, routing pinned, normwise "
        "rel err: " + json.dumps(floor))
    moa_leaves = {n.split("moa.", 1)[1] for n in errs if ".moa." in n}
    check({"gate.wg", "wq", "wo", "wk", "wv"} <= moa_leaves,
          f"moa-demo: MoA leaves missing from {sorted(errs)}")
    check(rel <= MOA_LOSS_TOL, f"moa-demo cuda vs ref loss {lc} vs {lr_}")
    check(errs[worst] <= MOA_GRAD_TOL,
          f"moa-demo cuda vs ref gradient of {worst} differs by "
          f"{errs[worst]} > {MOA_GRAD_TOL} normwise")
    return {"loss_cuda": lc, "loss_ref": lr_, "loss_rel_err": rel,
            "loss_tol": MOA_LOSS_TOL, "grad_tol": MOA_GRAD_TOL,
            "loss_ref_f32": lw, "grad_norm_rel_err": errs,
            "worst_leaf": worst, "ref_bf16_vs_f32": floor,
            "routing_flips": flips}


def phase_moa_train(floor, workdir: str) -> dict:
    """moa-demo at its published widths (4 layers, d 512: two MoE FFN
    layers of 8 experts top-2, two MoA mixers of 8 head groups x 2 heads
    x 64 top-2 over one shared K/V head; vocab 32,000, bf16), drawn from
    a seed, gates redrawn: its kernels at the training shapes, step 0's
    loss and gradients cuda vs ref, then MOA_TRAIN_STEPS Trainer steps
    with exact launch counts (MOA_TRAIN_LAUNCHES a step) and finite
    losses, and a profile of one more step."""
    import math
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, DataIterator, batch_at
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train.trainer import Trainer, TrainLoopConfig, step_seed

    cfg = get_config(MOA_ARCH)
    check(cfg.kernel_backend == "cuda" and cfg.param_dtype == torch.bfloat16
          and cfg.remat, "moa-demo must default to cuda, bf16 and remat")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    periods = params["blocks"]["periods"]
    for gate in (periods["pos0"]["moe"]["gate"]["wg"],
                 periods["pos1"]["moa"]["gate"]["wg"]):
        gate.normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    n = sum(p.numel() for p in pm.tree_leaves(params))
    log(f"materialized {MOA_ARCH} for training: {n} parameters")
    kernels = check_moa_train_kernels(cfg, params, gen, floor)
    b, s = MOA_TRAIN_B, MOA_TRAIN_S
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=s, batch_size=b,
                    seed=SEED)
    for p in pm.tree_leaves(params):
        p.requires_grad_(True)
    draws = lm.make_draws(cfg, b, s, torch.Generator(device="cuda")
                          .manual_seed(step_seed(SEED, 0)), "cuda")
    check(sum(x is not None for x in draws["moa_noise"]) == 2
          and sum(x is not None for x in draws["noise"]) == 2,
          "moa-demo draws: one per MoE FFN and one per MoA mixer")
    grads = moa_grads_cuda_vs_ref(cfg, params, batch_at(dc, 0, device="cuda"),
                                  draws)
    trainer = Trainer(
        loss_fn=lambda p, bt, g: lm.lm_loss(p, bt, cfg, generator=g),
        params=params, oc=opt_lib.OptConfig(kind="factored"),
        loop=TrainLoopConfig(total_steps=MOA_TRAIN_STEPS,
                             checkpoint_every=MOA_TRAIN_STEPS, log_every=1,
                             seed=SEED),
        data_iter=DataIterator(dc, device="cuda"), workdir=workdir,
        kernel_backend="cuda", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    trainer.run()
    torch.cuda.synchronize()
    counts = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches("moa-demo train", counts,
                   {key: MOA_TRAIN_STEPS * v
                    for key, v in MOA_TRAIN_LAUNCHES.items()})
    rows = trainer.metrics_log
    check(len(rows) == MOA_TRAIN_STEPS, f"{len(rows)} logged moa-demo steps")
    for m in rows:
        check(all(math.isfinite(m[key]) for key in ("loss", "xent",
                                                    "aux_loss", "grad_norm")),
              f"moa-demo: non-finite metrics at step {m['step']}: {m}")
    median = statistics.median(trainer.step_times[1:])

    def one_step():
        g = torch.Generator(device="cuda").manual_seed(
            step_seed(SEED, MOA_TRAIN_STEPS))
        _, m = trainer.step_fn(trainer.state, next(trainer.data_iter), g)
        float(m["loss"])
    dprof = device_profile(one_step)
    prof = dict(train_steps=1, **dprof, **idle_share(dprof, 1, 1e3 * median))
    keys = ("loss", "xent", "aux_loss", "cv_load", "max_over_mean_load",
            "fraction_dropped", "grad_norm")
    out = {"config": f"{MOA_ARCH}, no cut, bf16, remat, B={b} x S={s}, "
                     "factored Adam",
           "parameters": n,
           "step_ms_median_steps_2_to_6": 1e3 * median,
           "step_ms_all": [1e3 * t for t in trainer.step_times],
           "tokens_per_s": b * s / median,
           "max_memory_allocated_gib": peak / 2 ** 30,
           "losses": [m["loss"] for m in rows],
           "first": {key: rows[0][key] for key in keys},
           "last": {key: rows[-1][key] for key in keys},
           "launches": counts, "grads": grads}
    log("moa-demo train " + json.dumps(out))
    log("moa-demo train profile " + json.dumps(prof))
    del params, trainer
    torch.cuda.empty_cache()
    return {"summary": out, "kernels": kernels, "counts": counts,
            "profile": prof}


# ---------------------------------------------------------------------------
# phase 16: serve gemma3-27b at full width (ring-buffer caches)
# ---------------------------------------------------------------------------

def build_gemma():
    """gemma3-27b with bf16 weights drawn from the seed on the card, at
    all 62 layers when they fit beside the serve run's caches and 6 GiB
    of work space, else cut a period (6 layers) at a time."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import count_params, get_config
    from repro_torch.models import lm, transformer

    full = get_config(GEMMA)
    check(full.param_dtype == torch.bfloat16 and full.sliding_window == 1024,
          "gemma3-27b must be bf16 with a 1024-token window")
    free, _ = torch.cuda.mem_get_info()
    max_len = GEMMA_PROMPT + GEMMA_NEW
    n_layers = full.n_layers
    while True:
        cfg = full.replace(n_layers=n_layers)
        need = (2 * count_params(cfg)["total"] + pm.param_bytes(
            transformer.cache_defs(cfg, GEMMA_REQUESTS, max_len))
            + 6 * 2 ** 30)
        if need <= free or n_layers <= cfg.period:
            break
        n_layers -= cfg.period
    check(need <= free, f"gemma3-27b does not fit: {need} > {free} bytes")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pm.tree_leaves(params))
    log(f"materialized {GEMMA} ({n_layers} of {full.n_layers} layers"
        f"{'' if n_layers == full.n_layers else ', depth cut to fit'}, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
        f"{cfg.head_dim}, geglu {cfg.d_ff}, vocab {cfg.vocab_size}, window "
        f"{cfg.sliding_window}) in {time.perf_counter() - t0:.1f} s: {n} "
        f"parameters ({count_params(cfg)['total']} without the norms' "
        f"scales), {pm.param_bytes(params) / 1e9:.2f} GB; "
        f"{free / 2 ** 30:.2f} GiB were free")
    return cfg, params


def full_forward_logits(cfg, params, seq, positions):
    """No-grad logits of one sequence at ``positions`` from the training
    forward (``stack_apply``: the windowed FlashAttentionFn, no cache),
    the sequence padded at its end to a multiple of the attention
    blocks (causal, so the padding changes no earlier position)."""
    import torch
    from repro_torch.models import layers, lm, transformer

    blk = max(cfg.q_block, cfg.kv_block)
    s = -(-len(seq) // blk) * blk
    tokens = torch.zeros((1, s), dtype=torch.int32, device="cuda")
    tokens[0, :len(seq)] = torch.as_tensor(seq, dtype=torch.int32)
    with torch.no_grad():
        x = layers.embed(params["embed"], tokens, cfg.compute_dtype)
        pos = torch.arange(s, device="cuda")[None]
        x, _ = transformer.stack_apply(params["blocks"], x, cfg,
                                       positions=pos, train=False)
        x = layers.rmsnorm(params["ln_f"], x[:, positions], cfg.norm_eps)
        return lm.logits_fn(params, x, cfg)[0]


def _recording_lm(records: dict):
    """Wrap lm_prefill / lm_decode to keep each call's logits (on the
    card) with the tokens and positions it was called with; returns the
    function that restores them."""
    from repro_torch.models import lm
    real_prefill, real_decode = lm.lm_prefill, lm.lm_decode

    def prefill(params, batch, cache, cfg, **kw):
        logits, cache = real_prefill(params, batch, cache, cfg, **kw)
        records["prefill"].append((batch["tokens"][0].cpu().numpy(),
                                   logits[0].detach().clone()))
        return logits, cache

    def decode(params, tokens, cache, cur, cfg, **kw):
        out = real_decode(params, tokens, cache, cur, cfg, **kw)
        records["decode"].append((tokens.cpu().numpy(), cur.cpu().numpy(),
                                  kw["valid"].cpu().numpy(),
                                  out[0].detach().clone()))
        return out

    lm.lm_prefill, lm.lm_decode = prefill, decode

    def restore():
        lm.lm_prefill, lm.lm_decode = real_prefill, real_decode
    return restore


def fallback_records(what, cfg, params, prompts, new_tokens, max_len,
                     streams) -> tuple:
    """An engine with ``prefill_chunk=GEMMA_CHUNK`` for a model whose
    caches cannot resume mid-prompt (ring buffers, scan states): it must
    warn, fall back to whole prompts, run no chunk and serve ``streams``
    (unless None).  Returns its prefill and decode logits, recorded
    (``_recording_lm``), and its streams."""
    import warnings
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    records: dict = {"prefill": [], "decode": []}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        chunked = ServeEngine(params, cfg, ServeConfig(
            max_len=max_len, n_slots=len(prompts),
            prefill_chunk=GEMMA_CHUNK), device="cuda")
    check(any(issubclass(w.category, RuntimeWarning)
              and "chunked prefill" in str(w.message) for w in caught)
          and chunked._chunk == 0,
          f"{what}: prefill_chunk did not warn and fall back ({caught})")
    restore = _recording_lm(records)
    try:
        creqs = [chunked.submit(p, new_tokens) for p in prompts]
        chunked.run()
    finally:
        restore()
    check(chunked.stats["prefill_chunks"] == 0,
          f"{what}: the fall-back engine ran chunks {chunked.stats}")
    got = [r.tokens for r in creqs]
    check(streams is None or got == streams,
          f"{what}: the fall-back engine's streams differ from the engine's")
    return records, got


class _RoutingPin:
    """Pins a full forward's MoE routing to a serve run's.  ``record``
    wraps ``lm_prefill`` / ``lm_decode`` and kernel 1
    (``ops.topk_gating``) while the engine serves ``prompts`` and keeps
    each token's choice by (request, MoE layer, position): a prefill
    call's rows are its request's positions, a decode step's rows its
    live slots at their positions (request i holds slot i).
    ``replay(i)`` makes kernel 1, in a forward over request i's
    sequence, return those choices at every recorded position (its own
    values gathered at them, the combine weights their softmax) and
    counts, by layer, the rows whose own top-k differs (``flips``)."""

    def __init__(self, prompts):
        self.prompts = prompts
        self.table: dict = {}
        self.flips: dict = {}
        self._rows = None        # [(request, position)] of the lm call
        self._layer = 0

    @contextlib.contextmanager
    def record(self):
        import numpy as np
        import torch
        from repro_torch.kernels import ops
        from repro_torch.models import lm
        real_prefill, real_decode, real_topk = (lm.lm_prefill, lm.lm_decode,
                                                ops.topk_gating)

        def prefill(params, batch, cache, cfg, **kw):
            toks = batch["tokens"][0].cpu().numpy()
            i = next(j for j, p in enumerate(self.prompts)
                     if np.array_equal(p, toks))
            # (rows, request, positions): a prefill's rows are its
            # request's positions 0, 1, ...
            self._rows = [(slice(None), i, slice(0, len(toks)))]
            self._layer = 0
            return real_prefill(params, batch, cache, cfg, **kw)

        def decode(params, tokens, cache, cur, cfg, **kw):
            live = np.nonzero(kw["valid"].cpu().numpy())[0]
            cur_np = cur.cpu().numpy()
            self._rows = [(int(s), int(s), int(cur_np[s])) for s in live]
            self._layer = 0
            return real_decode(params, tokens, cache, cur, cfg, **kw)

        def topk(logits, k, kk=None):
            w, idx, vals = real_topk(logits, k, kk)
            for r, i, pos in self._rows:
                key = (i, self._layer)
                if key not in self.table:
                    self.table[key] = torch.full(
                        (4 * len(self.prompts[0]), idx.shape[1]), -1,
                        dtype=idx.dtype, device=idx.device)
                self.table[key][pos] = idx[r]
            self._layer += 1
            return w, idx, vals

        lm.lm_prefill, lm.lm_decode, ops.topk_gating = prefill, decode, topk
        try:
            yield
        finally:
            lm.lm_prefill, lm.lm_decode, ops.topk_gating = (
                real_prefill, real_decode, real_topk)

    @contextlib.contextmanager
    def replay(self, i: int):
        import torch
        from repro_torch.kernels import ops
        real_topk = ops.topk_gating
        layer = [0]

        def topk(logits, k, kk=None):
            w, idx, vals = real_topk(logits, k, kk)
            pinned = self.table[(i, layer[0])][:logits.shape[0]]
            rec = pinned[:, 0] >= 0
            mine = torch.sort(idx[:, :k].long(), dim=-1).values
            theirs = torch.sort(pinned[:, :k].long(), dim=-1).values
            n = int(((mine != theirs).any(dim=-1) & rec).sum())
            self.flips[layer[0]] = self.flips.get(layer[0], 0) + n
            idx = torch.where(rec[:, None], pinned, idx)
            vals = logits.gather(-1, idx.long())
            w = torch.softmax(vals[:, :k], dim=-1)
            layer[0] += 1
            return w, idx, vals

        ops.topk_gating = topk
        try:
            yield
        finally:
            ops.topk_gating = real_topk


def engine_rows(what, prompts, streams, records) -> list:
    """The engine's recorded logits, one [new tokens, V] tensor a
    request: the prefill row by prompt, decode rows by slot (request i
    holds slot i), each checked against the token the request had at
    that position."""
    import numpy as np
    import torch

    plen, new = len(prompts[0]), len(streams[0])
    seqs = [np.concatenate([p, np.asarray(t[:-1])])
            for p, t in zip(prompts, streams)]
    rows = {}
    for toks, logits in records["prefill"]:
        i = next(j for j, p in enumerate(prompts) if np.array_equal(p, toks))
        rows[(i, plen - 1)] = logits
    for toks, cur, valid, logits in records["decode"]:
        for i in np.nonzero(valid)[0]:
            check(seqs[i][cur[i]] == toks[i], f"{what}: decode row {i} fed "
                                              "another request's token")
            rows[(int(i), int(cur[i]))] = logits[i]
    positions = range(plen - 1, plen + new - 1)
    check(len(rows) == len(prompts) * new,
          f"{what}: {len(rows)} recorded logits rows")
    return [torch.stack([rows[(i, p)] for p in positions])
            for i in range(len(prompts))]


def forward_rows(what, cfg, params, prompts, streams, pin=None) -> list:
    """The training forward's logits (``full_forward_logits``) over each
    prompt and its generated tokens, at the positions the engine
    sampled from: one [new tokens, V] tensor a request; with ``pin`` (a
    recorded ``_RoutingPin``) the MoE layers route as the engine did."""
    import numpy as np

    plen, new = len(prompts[0]), len(streams[0])
    positions = list(range(plen - 1, plen + new - 1))
    out = []
    for i, (p, t) in enumerate(zip(prompts, streams)):
        with pin.replay(i) if pin else contextlib.nullcontext():
            ref = full_forward_logits(
                cfg, params, np.concatenate([p, np.asarray(t[:-1])]),
                positions)
        check(all_finite(ref), f"{what}: non-finite full-forward logits")
        out.append(ref)
    return out


def engine_vs_forward(what, cfg, params, prompts, streams, records,
                      pin=None) -> dict:
    """The engine's recorded logits (``engine_rows``) against the
    training forward's (``forward_rows``, routed as the engine was when
    ``pin`` is given).  Gate: within 5 % of the logit scale (the cross
    phase's tolerance); the share of the engine's greedy tokens equal to
    the forward's argmax is returned beside it."""
    import numpy as np

    got = engine_rows(what, prompts, streams, records)
    ref = forward_rows(what, cfg, params, prompts, streams, pin)
    err = max(max_err(g, r) for g, r in zip(got, ref))
    scale = max(abs_max(r) for r in ref)
    same = sum(int((r.argmax(-1).cpu().numpy() == np.asarray(t)).sum())
               for r, t in zip(ref, streams))
    plen, new = len(prompts[0]), len(streams[0])
    tol = 0.05 * scale
    gate = {"max_abs_err": err, "tol": tol, "logit_scale": scale,
            "positions": f"{plen - 1}..{plen + new - 2} of each request",
            "greedy_equal_full_forward_argmax": same / (len(prompts) * new)}
    if pin is not None:
        gate["routing_flips"] = pin.flips
    log(f"{what} engine vs full forward " + json.dumps(gate))
    check(err <= tol, f"{what}: engine logits differ from the full forward "
                      f"by {err} > {tol}")
    return gate


def phase_gemma_serve() -> dict:
    """gemma3-27b served at full width: GEMMA_REQUESTS prompts of
    GEMMA_PROMPT tokens and GEMMA_NEW greedy tokens each, all arriving
    at step 0, one slot each, whole-prompt prefill.  Gates: no kernel
    launch (a dense model); the cache's bytes exactly the ring-buffer
    formula; the engine with ``prefill_chunk`` warns, falls back to
    whole prompts and gives the same streams; its prefill and decode
    logits (recorded) against the training forward over each prompt and
    its generated tokens, within 5 % of the logit scale (the cross
    phase's tolerance)."""
    import numpy as np
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import layer_kinds
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, params = build_gemma()
    max_len = GEMMA_PROMPT + GEMMA_NEW
    rs = np.random.RandomState(SEED + 6)
    prompts = [rs.randint(1, cfg.vocab_size, (GEMMA_PROMPT,))
               for _ in range(GEMMA_REQUESTS)]
    engine = ServeEngine(params, cfg, ServeConfig(
        max_len=max_len, n_slots=GEMMA_REQUESTS), device="cuda")
    reqs, counts, out = serve_run(engine, prompts, cfg.vocab_size,
                                  new_tokens=GEMMA_NEW, stagger=0)
    check_launches("gemma3 serve", counts, {})
    streams = [r.tokens for r in reqs]
    prof = serve_profiles("gemma3", engine, params, cfg, prompts, out)
    # The cache: windowed layers hold min(window, max_len) positions.
    kinds = layer_kinds(cfg)
    full, rem = divmod(cfg.n_layers, cfg.period)
    n_local = sum((full + (p < rem)) * (kinds[p].mixer == "attn_local")
                  for p in range(cfg.period))
    per_pos = 2 * GEMMA_REQUESTS * cfg.n_kv_heads * cfg.head_dim * 2
    ring = min(cfg.sliding_window, max_len)
    want = per_pos * (n_local * ring + (cfg.n_layers - n_local) * max_len)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in pm.tree_leaves(engine.kv.cache))
    full_len = per_pos * cfg.n_layers * max_len
    log(f"gemma3 cache: {cache_bytes} bytes ({n_local} windowed layers of "
        f"{ring} positions, {cfg.n_layers - n_local} global of {max_len}); "
        f"a full-length cache {full_len} bytes "
        f"({cache_bytes / full_len:.4f} of it)")
    check(cache_bytes == want,
          f"gemma3 cache holds {cache_bytes} bytes, the formula {want}")
    records, _ = fallback_records("gemma3", cfg, params, prompts,
                                  GEMMA_NEW, max_len, streams)
    del engine
    torch.cuda.empty_cache()
    ring_gate = engine_vs_forward("gemma3", cfg, params, prompts, streams,
                                  records)
    out.update(config=f"{GEMMA}, {cfg.n_layers} layers, bf16, window "
                      f"{cfg.sliding_window}",
               cache_bytes=cache_bytes, cache_bytes_full_length=full_len,
               ring=ring_gate, sample_tokens=streams[0][:8])
    log("gemma3 serve " + json.dumps(out))
    del params
    torch.cuda.empty_cache()
    return {"summary": out, "counts": counts, "profile": prof}


# ---------------------------------------------------------------------------
# phase 17: train gemma3-27b for one period at full width
# ---------------------------------------------------------------------------

def phase_gemma_train() -> dict:
    """gemma3-27b at full width, depth cut to one period (5 windowed
    layers and 1 global), remat on, B = 1 x S = 4096: the windowed
    FlashAttentionFn against plain masked autograd at gemma3's head
    shape, its time against the global layer's, then GEMMA_TRAIN_STEPS
    steps (finite metrics, no kernel launch) and every gradient present
    and finite."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import attention as at
    from repro_torch.models import lm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cfg = get_config(GEMMA)
    cfg = cfg.replace(n_layers=cfg.period)
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    s, w = GEMMA_TRAIN_S, cfg.sliding_window
    flash = check_flash(gen, b=GEMMA_TRAIN_B, kvh=kvh, g=g, s=s, hd=hd,
                        window=w, what="gemma3 windowed")
    q = torch.randn(GEMMA_TRAIN_B, kvh, g, s, hd, device="cuda",
                    generator=gen).to(torch.bfloat16)
    k = torch.randn(GEMMA_TRAIN_B, kvh, hd, s, device="cuda",
                    generator=gen).to(torch.bfloat16)
    v = torch.randn(GEMMA_TRAIN_B, kvh, s, hd, device="cuda",
                    generator=gen).to(torch.bfloat16)

    def fwd_bwd(window):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        at.flash_attention(*leaves, True, window, cfg.q_block,
                           cfg.kv_block).sum().backward()
    attn_ms = {"windowed_ms": cuda_ms(lambda: fwd_bwd(w), reps=5, warmup=1),
               "global_ms": cuda_ms(lambda: fwd_bwd(0), reps=5, warmup=1)}
    nq = s // cfg.q_block
    visits = {"windowed": sum(hi - lo for lo, hi in (
        at._kv_range(i, nq, cfg.q_block, cfg.kv_block, True, w)
        for i in range(nq))), "global": nq * (nq + 1) // 2}
    log(f"gemma3 attention forward + backward, bf16, B={GEMMA_TRAIN_B}, "
        f"{kvh * g}/{kvh} heads x {hd}, S={s}, blocks {cfg.q_block}: "
        + json.dumps({**attn_ms, "block_pairs": visits}))
    del q, k, v
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    n = sum(p.numel() for p in pm.tree_leaves(params))
    log(f"materialized {GEMMA} (one period: {cfg.n_layers} layers) for "
        f"training: {n} parameters, {pm.param_bytes(params) / 1e9:.2f} GB")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                    batch_size=GEMMA_TRAIN_B, seed=SEED)
    run = _train_loop(cfg, params, dc, GEMMA_TRAIN_STEPS, "gemma3 train")
    check(not any(run["counts"].values()),
          f"gemma3 (dense) launched MoE kernels: {run['counts']}")
    _grad_check(cfg, params, batch_at(dc, GEMMA_TRAIN_STEPS, device="cuda"),
                None, "gemma3")
    median = statistics.median(run["times"][1:])
    out = {"config": f"{GEMMA}, one period ({cfg.n_layers} layers: 5 "
                     f"windowed of {w}, 1 global), bf16, remat, "
                     f"B={GEMMA_TRAIN_B} x S={s}, factored Adam",
           "parameters": n, "flash": flash, "attention": attn_ms,
           "attention_block_pairs": visits,
           "step_ms_median_steps_2_to_3": 1e3 * median,
           "step_ms_all": [1e3 * t for t in run["times"]],
           "tokens_per_s": GEMMA_TRAIN_B * s / median,
           "max_memory_allocated_gib": run["peak"] / 2 ** 30,
           "losses": [m["loss"] for m in run["rows"]]}
    log("gemma3 train " + json.dumps(out))
    del params, run
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: the two launchers: train smollm-135m, resume, serve its
# checkpoint
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tee_stdout():
    """Capture what the block prints, and print it too."""
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
    finally:
        sys.stdout.write(buf.getvalue())
        sys.stdout.flush()


def phase_launchers(workdir: str) -> dict:
    import math
    import os
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.obs import trace as trace_lib

    argv = ["--arch", SMOLLM, "--device", "cuda", "--steps", "8", "--batch",
            "8", "--seq", str(QWEN_S), "--checkpoint-every", "4",
            "--workdir", workdir]
    traces = {k: os.path.join(workdir, f"{k}_trace.json")
              for k in ("train", "serve")}
    t0 = time.perf_counter()
    with tee_stdout() as out_train:
        final = train_launch.main(argv + ["--trace", traces["train"]])
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
    with tee_stdout() as out_serve:
        tokens = serve_launch.main(["--arch", SMOLLM, "--device", "cuda",
                                    "--ckpt", ckpt, "--requests", "4",
                                    "--new-tokens", "8", "--trace",
                                    traces["serve"], "--trace-sync",
                                    "--log-decisions"])
    serve_s = time.perf_counter() - t0
    check(len(tokens) == 4 and all(len(t) == 8 for t in tokens),
          f"smollm served {tokens}")
    spans = {k: span_counts(trace_lib.load(p)) for k, p in traces.items()}
    check(spans["train"].get("train.step") == 8
          and spans["train"].get("train.checkpoint") == 2,
          f"smollm train trace: {spans['train']}")
    check(spans["serve"].get("serve.step", 0) > 0
          and spans["serve"].get("serve.decode", 0) > 0,
          f"smollm serve trace: {spans['serve']}")
    for buf, line in ((out_train, "[train] trace written: "),
                      (out_serve, "[serve] trace written: "),
                      (out_serve, "[serve] decision log: ")):
        check(line in buf.getvalue(), f"a launcher did not print {line!r}")
    out = {"train_s": train_s, "final": final, "resume_s": resume_s,
           "serve_s": serve_s, "tokens": tokens, "trace_spans": spans}
    log("launchers " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 19-22: the Mamba mixer (models/ssm.py): falcon-mamba-7b served and
# trained at full size, jamba-v0.1-52b served at full width cut to two
# periods and trained for one
# ---------------------------------------------------------------------------

def build_ssm(name: str, n_layers: int | None = None):
    """``name`` (cut to ``n_layers`` when given) with bf16 weights drawn
    from the seed on the card; MoE gates, zero-initialized, redrawn at
    std d^-1/2 as in ``build_model``, so routing spreads over all the
    experts.  Returns (cfg, params, parameter count)."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import count_params, get_config, layer_kinds
    from repro_torch.models import lm

    cfg = get_config(name, **({} if n_layers is None
                              else {"n_layers": n_layers}))
    check(cfg.kernel_backend == "cuda" and cfg.param_dtype == torch.bfloat16
          and cfg.remat, f"{name} must default to cuda, bf16 and remat")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    for p, kind in enumerate(layer_kinds(cfg)):
        if kind.ffn == "moe":
            params["blocks"]["periods"][f"pos{p}"]["moe"]["gate"][
                "wg"].normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pm.tree_leaves(params))
    log(f"materialized {name} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"d_inner {cfg.ssm_expand * cfg.d_model}, d_state "
        f"{cfg.ssm_d_state}, vocab {cfg.vocab_size}) in "
        f"{time.perf_counter() - t0:.1f} s: {n} parameters "
        f"({count_params(cfg)['total']} without the norms' scales and the "
        f"scan's vectors), {pm.param_bytes(params) / 1e9:.2f} GB")
    return cfg, params, n


def scan_vs_decode(cfg, params, gen) -> dict:
    """Layer 0's mixer at full width, two chunks (SCAN_S tokens): the
    chunked scan (``ssm.mamba`` with ``return_state``) against
    ``mamba_decode`` stepped token by token from a zero state, as the
    reference's own check; the outputs and the final scan and conv
    states, in f32 (the weights widened) and in bf16.  Gate: each max
    abs error within SCAN_TOL[dtype] of the scan's scale."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models import ssm

    mp = _layer(params["blocks"]["periods"]["pos0"]["mamba"], 0)
    x0 = torch.randn(1, SCAN_S, cfg.d_model, device="cuda", generator=gen)
    out = {}
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        p = {k: v.float() if dt == torch.float32 else v
             for k, v in mp.items()}
        x = x0.to(dt)
        with torch.no_grad():
            y, st = ssm.mamba(p, x, d_state=cfg.ssm_d_state,
                              return_state=True)
            state = pm.zeros(ssm.init_state_defs(
                1, cfg.d_model, d_state=cfg.ssm_d_state,
                d_conv=cfg.ssm_d_conv, expand=cfg.ssm_expand, dtype=dt),
                "cuda")
            ys = []
            for i in range(SCAN_S):
                yi, state = ssm.mamba_decode(p, x[:, i:i + 1], state,
                                             d_state=cfg.ssm_d_state)
                ys.append(yi)
            ys = torch.cat(ys, dim=1)
        res = {}
        for what, got, want in (("y", ys, y), ("ssm", state["ssm"],
                                               st["ssm"]),
                                ("conv", state["conv"], st["conv"])):
            err, scale = max_err(got, want), abs_max(want)
            res[what] = {"max_abs_err": err, "scale": scale,
                         "tol": SCAN_TOL[name] * max(scale, 1e-30)}
            check(all_finite(want) and err <= res[what]["tol"],
                  f"scan vs decode ({name}) {what}: {res[what]}")
        out[name] = res
        del p
    log(f"scan vs step-by-step decode, layer 0 at full width, S={SCAN_S}: "
        + json.dumps(out))
    return out


def serve_profiles(what, engine, params, cfg, prompts, out,
                   scan=None) -> dict:
    """Two decode steps of the full slot pool and one whole-prompt
    prefill under the profiler, each with the device's idle share
    against the serve run's median step; ``scan`` as in
    ``device_profile``."""
    import torch
    from repro_torch.models import lm

    prof = {"decode": phase_profile(engine, prompts,
                                    out["decode_step_ms_median"],
                                    f"{what} decode profile")}
    page = engine.kv.new_page()
    tokens = torch.as_tensor(prompts[0], dtype=torch.int32,
                             device="cuda")[None]
    dprof = device_profile(lambda: lm.lm_prefill(params, {"tokens": tokens},
                                                 page, cfg), scan=scan)
    prof["prefill"] = dict(prefills=1, **dprof, **idle_share(
        dprof, 1, out["prefill_ms_median"]))
    log(f"{what} prefill profile " + json.dumps(prof["prefill"]))
    return prof


def _scan_shape(cfg) -> tuple:
    return (cfg.ssm_expand * cfg.d_model, cfg.ssm_d_state)


def phase_falcon_serve() -> dict:
    """falcon-mamba-7b at full size: the scan against step-by-step
    decode on layer 0; SSM_REQUESTS prompts of SSM_PROMPT tokens and
    SSM_NEW greedy tokens, one slot each, whole-prompt prefill.  Gates:
    no kernel launch (no FFN); the decode state exactly
    FALCON_STATE_BYTES at this page length and at four times it; the
    engine with ``prefill_chunk`` warns, falls back and serves the same
    streams; its bf16 logits no farther from the f32 forward than
    BF16_FORWARD_RATIO times the bf16 forward's; the same engine in f32
    against the f32 training forward over each prompt and its tokens
    within 5 % of the logit scale, greedy tokens equal to the forward's
    argmax on at least 0.9 of the positions."""
    import numpy as np
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import count_params
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, params, n = build_ssm(FALCON)
    check(count_params(cfg)["total"] == FALCON_PARAMS,
          f"falcon: {count_params(cfg)['total']} parameters, expected "
          f"{FALCON_PARAMS}")
    scan = scan_vs_decode(cfg, params,
                          torch.Generator(device="cuda").manual_seed(SEED + 8))
    max_len = SSM_PROMPT + SSM_NEW
    rs = np.random.RandomState(SEED + 9)
    prompts = [rs.randint(1, cfg.vocab_size, (SSM_PROMPT,))
               for _ in range(SSM_REQUESTS)]
    engine = ServeEngine(params, cfg, ServeConfig(
        max_len=max_len, n_slots=SSM_REQUESTS), device="cuda")
    reqs, counts, out = serve_run(engine, prompts, cfg.vocab_size,
                                  new_tokens=SSM_NEW, stagger=0)
    check_launches("falcon serve", counts, {})
    streams = [r.tokens for r in reqs]
    state_bytes = sum(t.numel() * t.element_size()
                      for t in pm.tree_leaves(engine.kv.cache))
    longer = pm.param_bytes(transformer.cache_defs(cfg, SSM_REQUESTS,
                                                   4 * max_len))
    log(f"falcon decode state: {state_bytes} bytes for {SSM_REQUESTS} "
        f"slots (pages of {max_len}), {longer} at pages of {4 * max_len}")
    check(state_bytes == longer == FALCON_STATE_BYTES,
          f"falcon state {state_bytes} / {longer} bytes, the formula "
          f"{FALCON_STATE_BYTES}")
    prof = serve_profiles("falcon", engine, params, cfg, prompts, out,
                          scan=_scan_shape(cfg))
    del engine
    records, _ = fallback_records("falcon", cfg, params, prompts, SSM_NEW,
                                  max_len, streams)
    torch.cuda.empty_cache()
    # bf16: the engine and the forward, each against the f32 forward over
    # the same tokens.
    got = engine_rows("falcon", prompts, streams, records)
    ref = forward_rows("falcon", cfg, params, prompts, streams)
    f32 = torch.float32
    cfg32 = cfg.replace(param_dtype=f32, compute_dtype=f32)
    params32 = pm.tree_map(lambda t: t.float(), params)
    ref32 = forward_rows("falcon f32", cfg32, params32, prompts, streams)
    bf16 = {"engine_vs_forward": max(map(max_err, got, ref)),
            "engine_vs_f32_forward": max(map(max_err, got, ref32)),
            "forward_vs_f32_forward": max(map(max_err, ref, ref32)),
            "logit_scale": max(map(abs_max, ref32)),
            "greedy_equal_forward_argmax": sum(
                int((r.argmax(-1).cpu().numpy() == np.asarray(t)).sum())
                for r, t in zip(ref, streams)) / (SSM_REQUESTS * SSM_NEW)}
    log("falcon bf16 engine and forward against the f32 forward "
        + json.dumps(bf16))
    check(bf16["engine_vs_f32_forward"]
          <= BF16_FORWARD_RATIO * bf16["forward_vs_f32_forward"],
          f"falcon: the bf16 engine is {bf16['engine_vs_f32_forward']} from "
          "the f32 forward, more than "
          f"{BF16_FORWARD_RATIO} x the bf16 forward's "
          f"{bf16['forward_vs_f32_forward']}")
    del got, ref, ref32, params
    # f32: the engine (recorded, the chunked engine's fall-back) against
    # the forward over its own tokens.
    records, streams32 = fallback_records("falcon f32", cfg32, params32,
                                          prompts, SSM_NEW, max_len, None)
    gate = engine_vs_forward("falcon f32", cfg32, params32, prompts,
                             streams32, records)
    check(gate["greedy_equal_full_forward_argmax"] >= 0.9,
          f"falcon: greedy tokens equal the full forward's argmax on "
          f"{gate['greedy_equal_full_forward_argmax']} of the positions")
    out.update(config=f"{FALCON}, {cfg.n_layers} layers, bf16, no cut",
               parameters=n, state_bytes=state_bytes, scan=scan,
               forward_f32=gate, forward_bf16=bf16,
               sample_tokens=streams[0][:8])
    log("falcon serve " + json.dumps(out))
    del params32, records
    torch.cuda.empty_cache()
    return {"summary": out, "profile": prof}


def scan_event_ms(fn) -> dict:
    """One call of ``fn`` (a training step) with CUDA events around the
    whole call and around every call of the scan Function
    (``ssm._ChunkScan``: its forwards, the recomputed ones included, and
    its backward passes; the calls run in stream order, so each pair of
    events brackets its kernels).  Returns the scan's device time, the
    span of the call on the device and the share.  No profiler: a
    profile of a falcon step holds ~10^5 device records, which took
    minutes to read back and after which CUPTI delivered none in the
    same process (my chip runs 2 and 8, PR 22)."""
    import torch
    from repro_torch.models import ssm

    cls = ssm._ChunkScan
    fwd, bwd = cls.forward, cls.backward
    pairs = []

    def timed(f):
        def run(ctx, *args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = f(ctx, *args)
            end.record()
            pairs.append((start, end))
            return out
        return staticmethod(run)

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cls.forward, cls.backward = timed(fwd), timed(bwd)
    try:
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)
    span = start.elapsed_time(end)
    scan = sum(a.elapsed_time(b) for a, b in pairs)
    return {"scan_calls": len(pairs), "scan_ms": scan, "span_ms": span,
            "scan_share_of_span": scan / span}


def train_tail(what, cfg, params, dc, run, steps: int,
               moe_leaves=()) -> dict:
    """After ``_train_loop``: one more batch's gradients (every leaf
    present and finite, the named MoE leaves nonzero), one optimizer
    update on them timed alone, and one more step timed with CUDA
    events: its span on the device and the scan's share of it
    (``scan_event_ms``)."""
    import torch
    from repro_torch.common.param import tree_leaves, tree_map
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import lm
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train.trainer import step_seed

    median = statistics.median(run["times"][1:])
    b, s = dc.batch_size, dc.seq_len
    gdraw = torch.Generator(device="cuda").manual_seed(step_seed(SEED, steps))
    draws = lm.make_draws(cfg, b, s, gdraw, "cuda")
    _grad_check(cfg, params, batch_at(dc, steps, device="cuda"), draws,
                what, moe_leaves)
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

    def one_step():
        g = torch.Generator(device="cuda").manual_seed(
            step_seed(SEED, steps + 1))
        _, m = run["step"](run["state"], next(run["data"]), g)
        float(m["loss"])
    split = dict(scan_event_ms(one_step), optimizer_ms=opt_ms)
    log(f"{what} train step split " + json.dumps(split))
    out = {"step_ms_median_steps_2_on": 1e3 * median,
           "step_ms_all": [1e3 * t for t in run["times"]],
           "tokens_per_s": b * s / median, "optimizer_ms": opt_ms,
           "max_memory_allocated_gib": run["peak"] / 2 ** 30,
           "losses": [m["loss"] for m in run["rows"]],
           "launches": run["counts"], "split": split}
    return {"summary": out}


def phase_falcon_train() -> dict:
    """falcon-mamba-7b at full size, B x S = FALCON_TRAIN_B x
    FALCON_TRAIN_S, remat: FALCON_TRAIN_STEPS steps (finite metrics, no
    kernel launch), every gradient present and finite, the optimizer
    timed alone, one step profiled (the scan's share)."""
    import torch
    from repro_torch.data.pipeline import DataConfig

    cfg, params, n = build_ssm(FALCON)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=FALCON_TRAIN_S,
                    batch_size=FALCON_TRAIN_B, seed=SEED)
    run = _train_loop(cfg, params, dc, FALCON_TRAIN_STEPS, "falcon train")
    check(not any(run["counts"].values()),
          f"falcon (no FFN) launched MoE kernels: {run['counts']}")
    res = train_tail("falcon", cfg, params, dc, run, FALCON_TRAIN_STEPS)
    res["summary"].update(config=f"{FALCON}, {cfg.n_layers} layers, bf16, "
                                 f"remat, B={FALCON_TRAIN_B} x "
                                 f"S={FALCON_TRAIN_S}, factored Adam",
                          parameters=n)
    log("falcon train " + json.dumps(res["summary"]))
    del params, run
    torch.cuda.empty_cache()
    return res


def check_jamba_serve_kernels(cfg, params, gen, floor) -> dict:
    """Kernels 1, 2, 4, 6 and 7 at the shapes serving jamba gives them,
    on its first MoE layer's weights (E = 16, k = 2, swiglu 4096 ->
    14336): a 1024-token prefill (top-k [1024, 16], dispatch / combine
    [1024, 4096] <-> [16, 256, 4096], the tiled GMM at C = 256 with the
    plan's rows) and an unfused decode step of 4 slots (top-k [4, 16],
    [4, 4096] <-> [16, 8, 4096], the GMM stream at C = 8), then kernel 7
    on the 4 slots; phase 2's tolerances, each timed beside its bound,
    the launch floor, its plain version and torch.bmm."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.kernels import gmm as gk

    bf = torch.bfloat16
    moe = _layer(params["blocks"]["periods"]["pos1"]["moe"], 0)
    wg, w1, w2, w3 = (moe["gate"]["wg"], moe["w1"], moe["w2"], moe["w3"])
    e, k, d, f = cfg.n_experts, cfg.moe_k, cfg.d_model, cfg.moe_d_ff
    out: dict = {"topk_gating": {}, "dispatch": {}, "combine": {},
                 "gmm": {}}
    for label, t, want_cap in (("prefill", SSM_PROMPT, JAMBA_PREFILL_C),
                               ("decode", SSM_REQUESTS, JAMBA_DECODE_C)):
        x = torch.randn(t, d, device="cuda", generator=gen).to(bf)
        logits = x.float() @ wg.float()

        def library():
            vals, idx = torch.topk(logits, k + 1, dim=-1)
            return torch.softmax(vals[:, :k], dim=-1), idx
        out["topk_gating"][label], _, cw, idx = _topk_rows(
            f"jamba {label}", logits, k, k + 1, gen, floor, bwd=False,
            library=library)
        cap = dsp.capacity_for(t, e, k, cfg.capacity_factor)
        check(cap == want_cap, f"jamba {label} capacity {cap}, expected "
                               f"{want_cap}")
        plan = dsp.plan(idx, cw, e, cap)
        rows = dsp.filled_rows(plan)
        buf, out["dispatch"][label], out["combine"][label] = \
            _dispatch_combine_rows(f"jamba {label}", x, plan, gen, floor,
                                   backward=False, l2_cold=True)
        h = gk.mask_rows(torch.randn(e, cap, f, device="cuda",
                                     generator=gen).to(bf), rows)
        out["gmm"][label] = _gmm_rows(
            f"jamba {label} C={cap}",
            [("w1", buf, w1, "silu", False, False),
             ("w3", buf, w3, "none", False, False),
             ("w2", h, w2, "none", False, False)], rows, floor)
        del x, buf, h
    x = torch.randn(SSM_REQUESTS, d, device="cuda", generator=gen).to(bf)
    out["fused_decode"] = _fused7_case(
        x, torch.ones(SSM_REQUESTS, device="cuda"), wg, w1, w2, w3, k,
        JAMBA_DECODE_C, f"jamba, {SSM_REQUESTS} slots")
    torch.cuda.empty_cache()
    return out


def phase_jamba_serve(floor) -> dict:
    """jamba-v0.1-52b at full width cut to JAMBA_SERVE_LAYERS layers (2
    periods: 14 mamba, 2 attention; 8 MoE FFNs): its kernels against
    their plain versions at its shapes; SSM_REQUESTS prompts of
    SSM_PROMPT tokens and SSM_NEW greedy tokens, unfused and fused, with
    exact launch counts (a prefill or unfused decode step: each MoE
    layer's top-k, dispatch, combine and three GMMs; a fused decode
    step: kernel 7 once a MoE layer); cuda vs ref prefill logits and
    fused vs unfused decode logits within 5 % of the logit scale; then,
    at JAMBA_CROSS_CF (no call drops a token), the chunked engine's
    fall-back and its logits against the training forward."""
    import numpy as np
    import torch
    from repro_torch.configs.base import count_params, layer_kinds
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg, params, n = build_ssm(JAMBA, JAMBA_SERVE_LAYERS)
    check(count_params(cfg)["total"] == JAMBA_SERVE_PARAMS,
          f"jamba: {count_params(cfg)['total']} parameters, expected "
          f"{JAMBA_SERVE_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    kernels = check_jamba_serve_kernels(cfg, params, gen, floor)
    max_len = SSM_PROMPT + SSM_NEW
    rs = np.random.RandomState(SEED + 11)
    prompts = [rs.randint(1, cfg.vocab_size, (SSM_PROMPT,))
               for _ in range(SSM_REQUESTS)]
    n_moe = (cfg.n_layers // cfg.period) * sum(
        kind.ffn == "moe" for kind in layer_kinds(cfg))
    unfused = {"topk_gating": n_moe, "dispatch": n_moe, "combine": n_moe,
               "gmm": 3 * n_moe}
    engine = ServeEngine(params, cfg, ServeConfig(
        max_len=max_len, n_slots=SSM_REQUESTS), device="cuda")
    reqs, counts, out = serve_run(engine, prompts, cfg.vocab_size,
                                  new_tokens=SSM_NEW, stagger=0)
    check_launches("jamba serve", counts,
                   expected_launches(engine.stats, unfused, unfused))
    streams = [r.tokens for r in reqs]
    prof = serve_profiles("jamba", engine, params, cfg, prompts, out,
                          scan=_scan_shape(cfg))
    cross = phase_cross(cfg, params, prompts[0], engine)
    del engine
    fengine = ServeEngine(params, cfg, ServeConfig(
        max_len=max_len, n_slots=SSM_REQUESTS, fused_decode=True),
        device="cuda")
    freqs, fcounts, fout = serve_run(fengine, prompts, cfg.vocab_size,
                                     new_tokens=SSM_NEW, stagger=0)
    check_launches("jamba fused serve", fcounts, expected_launches(
        fengine.stats, unfused, {"fused_decode": n_moe}))
    fout["greedy_tokens_equal_to_unfused"] = stream_agreement(
        [r.tokens for r in freqs], streams)
    prof["fused_decode"] = phase_profile(
        fengine, prompts, fout["decode_step_ms_median"],
        "jamba fused decode profile")
    del fengine
    fused_cross = compare_fused_logits("jamba", decode_logits(
        cfg, params, prompts))
    torch.cuda.empty_cache()
    xcfg = cfg.replace(capacity_factor=JAMBA_CROSS_CF)
    pin = _RoutingPin(prompts)
    with pin.record():
        records, xstreams = fallback_records("jamba", xcfg, params, prompts,
                                             SSM_NEW, max_len, None)
    gate = engine_vs_forward("jamba", xcfg, params, prompts, xstreams,
                             records, pin)
    check(gate["greedy_equal_full_forward_argmax"] >= 0.9,
          f"jamba: greedy tokens equal the full forward's argmax on "
          f"{gate['greedy_equal_full_forward_argmax']} of the positions")
    out.update(config=f"{JAMBA}, {cfg.n_layers} of 32 layers (2 periods), "
                      "bf16", parameters=n, n_moe_layers=n_moe,
               cross=cross, fused=fout, fused_vs_unfused=fused_cross,
               forward=gate, sample_tokens=streams[0][:8])
    log("jamba serve " + json.dumps(out))
    del params
    torch.cuda.empty_cache()
    return {"summary": out, "kernels": kernels, "profile": prof,
            "counts": counts, "fused_counts": fcounts}


def jamba_grads_cuda_vs_ref(cfg, params, batch, draws) -> dict:
    """Step 0's loss and every gradient under "cuda", "ref" and "ref"
    with the compute in f32, from the same parameters, batch and draws,
    both ref runs' routing pinned to the cuda run's (``_TopkReplay``):
    every cuda gradient present, finite and nonzero; the loss within
    JAMBA_LOSS_TOL relative; each leaf's cuda-vs-ref normwise error
    within JAMBA_GRAD_RATIO times its ref-vs-f32-compute error.  One
    run's gradients wait on the host while the next computes its own
    (two sets on the card would not fit beside the weights)."""
    import torch
    from repro_torch.models import lm

    named = list(_named_leaves(params))
    pin = _TopkReplay()
    runs = (("cuda", cfg), ("ref", cfg.replace(kernel_backend="ref")),
            ("ref_f32", cfg.replace(kernel_backend="ref",
                                    compute_dtype=torch.float32)))
    losses, errs, floor, host, flips = {}, {}, {}, {}, {}
    for what, c in runs:
        with pin.record() if what == "cuda" else pin.replay():
            loss, _ = lm.lm_loss(params, batch, c, draws=draws)
            loss.backward()
        losses[what] = float(loss.detach())
        if what != "cuda":
            flips[what] = pin.flips
        for name, p in named:
            if what == "cuda":
                check(p.grad is not None, f"jamba: {name} has no gradient")
                check(all_finite(p.grad),
                      f"jamba: {name}'s gradient is not finite")
                check(any_nonzero(p.grad), f"jamba: {name}'s gradient is zero")
            else:
                (errs if what == "ref" else floor)[name] = norm_rel_err(
                    host[name].to("cuda"), p.grad)
            host[name] = p.grad.to("cpu") if what != "ref_f32" else None
            p.grad = None
    lc, lr_ = losses["cuda"], losses["ref"]
    rel = abs(lc - lr_) / abs(lr_)
    ratio = {name: errs[name] / max(floor[name], 1e-30) for name in errs}
    worst = max(ratio, key=ratio.get)
    log(f"jamba routing flips at step 0 (tokens of {batch['tokens'].numel()}"
        " whose own top-k differs from the cuda run's, forward then remat's "
        "recompute): " + json.dumps(flips))
    log(f"jamba cuda vs ref at step 0, routing pinned: loss {lc} vs {lr_} "
        f"(rel {rel:.3g}, tol {JAMBA_LOSS_TOL:.3g}; ref in f32 "
        f"{losses['ref_f32']}); gradients normwise rel err: "
        + json.dumps(errs))
    log("jamba ref vs ref in f32 (what bf16 rounding moves), routing "
        "pinned, normwise rel err: " + json.dumps(floor))
    check(rel <= JAMBA_LOSS_TOL, f"jamba cuda vs ref loss {lc} vs {lr_}")
    check(ratio[worst] <= JAMBA_GRAD_RATIO,
          f"jamba cuda vs ref gradient of {worst} differs by {errs[worst]}"
          f", {ratio[worst]} x its bf16 rounding {floor[worst]} > "
          f"{JAMBA_GRAD_RATIO}")
    return {"loss_cuda": lc, "loss_ref": lr_, "loss_ref_f32": losses[
                "ref_f32"], "loss_rel_err": rel, "loss_tol": JAMBA_LOSS_TOL,
            "grad_ratio_tol": JAMBA_GRAD_RATIO, "grad_norm_rel_err": errs,
            "ref_bf16_vs_f32": floor, "worst_leaf": worst,
            "worst_ratio": ratio[worst], "routing_flips": flips}


def phase_jamba_train(floor) -> dict:
    """jamba-v0.1-52b at full width cut to one period (8 layers: 7
    mamba, 1 attention, 4 MoE FFNs), B x S = JAMBA_TRAIN_B x
    JAMBA_TRAIN_S, remat: the training kernels against their plain
    versions at the step's shapes (its first MoE layer, C = 1024), step
    0's loss and gradients cuda vs ref (routing pinned), then
    JAMBA_TRAIN_STEPS steps with exact launch counts (4 x
    ARCTIC_LAUNCHES a step) and the tail of ``train_tail``."""
    import torch
    from repro_torch.common.param import tree_leaves
    from repro_torch.configs.base import count_params
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.models.transformer import layer_index
    from repro_torch.train.trainer import step_seed

    cfg, params, n = build_ssm(JAMBA, JAMBA_TRAIN_LAYERS)
    check(count_params(cfg)["total"] == JAMBA_TRAIN_PARAMS,
          f"jamba: {count_params(cfg)['total']} parameters, expected "
          f"{JAMBA_TRAIN_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    periods = params["blocks"]["periods"]
    kernels = check_train_kernels(
        "jamba", cfg, _layer(periods["pos1"]["moe"], 0),
        JAMBA_TRAIN_B * JAMBA_TRAIN_S, JAMBA_TRAIN_C, gen, floor)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=JAMBA_TRAIN_S,
                    batch_size=JAMBA_TRAIN_B, seed=SEED)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    draws = lm.make_draws(cfg, JAMBA_TRAIN_B, JAMBA_TRAIN_S,
                          torch.Generator(device="cuda").manual_seed(
                              step_seed(SEED, 0)), "cuda")
    grads = jamba_grads_cuda_vs_ref(cfg, params,
                                    batch_at(dc, 0, device="cuda"), draws)
    del draws
    torch.cuda.empty_cache()
    run = _train_loop(cfg, params, dc, JAMBA_TRAIN_STEPS, "jamba train")
    n_moe = sum(kind.ffn == "moe" for _, kind in layer_index(cfg))
    check_launches("jamba train", run["counts"],
                   {k: JAMBA_TRAIN_STEPS * n_moe * v
                    for k, v in ARCTIC_LAUNCHES.items()})
    moe = periods["pos1"]["moe"]
    res = train_tail("jamba", cfg, params, dc, run, JAMBA_TRAIN_STEPS,
                     (moe["w1"], moe["w2"], moe["w3"], moe["gate"]["wg"]))
    res["summary"].update(config=f"{JAMBA}, one period ({cfg.n_layers} "
                                 "layers), bf16, remat, "
                                 f"B={JAMBA_TRAIN_B} x S={JAMBA_TRAIN_S}, "
                                 "factored Adam", parameters=n,
                          grads=grads)
    log("jamba train " + json.dumps(res["summary"]))
    res.update(kernels=kernels, counts=run["counts"])
    del params, run
    torch.cuda.empty_cache()
    return res


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
                            "full_pool", "c72", "phase_split", "chunk_",
                            "train_", "stream_", "bound_ms_", "by_shape",
                            "jamba_"))}}


def main() -> int:
    import gc
    import os
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
        served = run_serve(kernels["floor"])
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
            moa_train = phase_moa_train(kernels["floor"], workdir)
        gemma = phase_gemma_serve()
        gc.collect()
        torch.cuda.empty_cache()
        gemma["train"] = phase_gemma_train()
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            launchers = phase_launchers(workdir)
        gc.collect()
        torch.cuda.empty_cache()
        falcon = phase_falcon_serve()
        gc.collect()
        torch.cuda.empty_cache()
        jamba = phase_jamba_serve(kernels["floor"])
        gc.collect()
        torch.cuda.empty_cache()
        jamba["train"] = phase_jamba_train(kernels["floor"])
        gc.collect()
        torch.cuda.empty_cache()
        falcon["train"] = phase_falcon_train()
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    launches = {"serve": served["counts"],
                "serve_fused": served["fused"]["counts"],
                "serve_expert_choice": served["ec"]["counts"],
                "serve_prefix": served["prefix"]["counts"],
                "serve_moa_fused": moa["counts"],
                "train_moa": moa_train["counts"],
                "train": trained["counts"],
                "train_eblock": eblock["launches"][str(E_BLOCK)],
                "train_hmoe": hmoe["counts"],
                "train_hmoe_lm": hmoe["lm"]["counts"],
                "train_arctic": arctic["counts"],
                "serve_jamba": jamba["counts"],
                "serve_jamba_fused": jamba["fused_counts"],
                "train_jamba": jamba["train"]["counts"]}
    profiles = [served["profile"], served["fused"]["profile"],
                served["ec"]["profile"], moa["profile"],
                moa_train["profile"], trained["profile"],
                eblock["profile"], hmoe["profile"], arctic["profile"],
                jamba["profile"]["decode"], jamba["profile"]["prefill"],
                jamba["profile"]["fused_decode"]]
    measured = dict(kernels["rows"], **served["fused"]["kernels"])
    measured["fused_routed"].update(
        max_abs_err_f32_ragged=kernels["fused"]["fused_routed_f32_max_abs_err"],
        moa_proj=kernels["fused"]["moa_proj"])
    measured["fused_decode"]["max_abs_err_f32_ragged"] = \
        kernels["fused"]["fused_decode_f32_max_abs_err"]
    for name, r in served["prefix"]["kernels"].items():
        measured[name]["chunk_prefill"] = r
    for name, (err, tol) in moa["kernel_errs"].items():
        measured[name].update(max_abs_err_moa_demo=err, tol_moa_demo=tol)
    for name in ("topk_gating", "topk_gating_bwd", "dispatch", "combine",
                 "gmm", "gmm_bwd"):
        measured[name]["train_moa"] = moa_train["kernels"][name]
        measured[name]["train_hmoe"] = hmoe["kernels"][name]
        measured[name]["train_arctic"] = arctic["kernels"][name]
        measured[name]["jamba_train"] = jamba["train"]["kernels"][name]
    for name in ("topk_gating", "dispatch", "combine", "gmm",
                 "fused_decode"):
        measured[name]["jamba_serve"] = jamba["kernels"][name]
    dw = {what: run["kernels"]["gmm_bwd"]["calls"]["dw_w1"]
          for what, run in (("hmoe", hmoe), ("arctic", arctic))}
    log("the dw layout (x^T dz, dev ms a call / torch.bmm ms / bound ms): "
        + "; ".join(f"{what} K = {k} {dw[what]['dev_ms']:.3f} / "
                    f"{dw[what]['library_ms']:.3f} / "
                    f"{dw[what]['bound_ms']:.3f}"
                    for what, k in (("hmoe", HMOE_CS), ("arctic", ARCTIC_C))))
    rows = [kernel_row(name, measured[name], launches, profiles,
                       kernels["floor"]) for name in KERNELS]
    mt, gs, gt = moa_train["summary"], gemma["summary"], gemma["train"]
    obs = served["obs"]
    log(f"card {setup['card']}; serve cross-check max_abs_err "
        f"{served['cross']['max_abs_err']:.4g} (tol "
        f"{served['cross']['tol']:.4g}); moa-demo train step "
        f"{mt['step_ms_median_steps_2_to_6']:.1f} ms, cuda-vs-ref loss rel "
        f"err {mt['grads']['loss_rel_err']:.3g}; gemma3 serve prefill "
        f"{gs['prefill_ms_median']:.1f} ms, decode step "
        f"{gs['decode_step_ms_median']:.1f} ms, engine vs full forward "
        f"{gs['ring']['max_abs_err']:.4g} (tol {gs['ring']['tol']:.4g}); "
        f"gemma3 train step {gt['step_ms_median_steps_2_to_3']:.1f} ms; "
        "MoE-256 train cuda-vs-ref loss rel err "
        f"{grads['loss_rel_err']:.3g}; {HMOE_CONFIG} step "
        f"{hmoe['summary']['step_ms_median_steps_3_to_12']:.1f} ms, peak "
        f"{hmoe['summary']['max_memory_allocated_gib']:.2f} GiB, cuda-vs-"
        f"ref loss rel err {hmoe['grads']['loss_rel_err']:.3g}; arctic step "
        f"{arctic['summary']['step_ms_median_steps_2_to_6']:.1f} ms, peak "
        f"{arctic['summary']['max_memory_allocated_gib']:.2f} GiB, cuda-vs-"
        f"ref loss rel err {arctic['summary']['loss_rel_err']:.3g}; qwen3 "
        f"step {qwen3['step_ms_median_steps_2_to_4']:.1f} ms; falcon "
        f"prefill {falcon['summary']['prefill_ms_median']:.1f} ms, decode "
        f"step {falcon['summary']['decode_step_ms_median']:.1f} ms, train "
        f"step {falcon['train']['summary']['step_ms_median_steps_2_on']:.1f}"
        f" ms; jamba prefill {jamba['summary']['prefill_ms_median']:.1f} ms,"
        f" decode step {jamba['summary']['decode_step_ms_median']:.1f} ms "
        f"(fused {jamba['summary']['fused']['decode_step_ms_median']:.1f}),"
        " train step "
        f"{jamba['train']['summary']['step_ms_median_steps_2_on']:.1f} ms, "
        "cuda-vs-ref loss rel err "
        f"{jamba['train']['summary']['grads']['loss_rel_err']:.3g}; smollm "
        f"launchers {launchers['train_s']:.1f} + {launchers['resume_s']:.1f}"
        f" + {launchers['serve_s']:.1f} s; obs: replay predicted "
        f"{obs['fit']['predicted_wall_s']:.4f} s of recorded "
        f"{obs['fit']['recorded_charged_s']:.4f} s, decode step untraced "
        f"{obs['overhead']['untraced_ms']:.2f} / traced "
        f"{obs['overhead']['traced_ms']:.2f} ms; "
        f"{time.perf_counter() - t_start:.0f} s in all")
    print(setup["card"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
