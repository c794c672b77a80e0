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
             tolerance; the 8 prompts as one prefill under "ref", its
             products counted by FlopCounterMode (phase 26 (b)).
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
             steps through the Trainer as in phase 9, with one
             checkpoint, at step 12 (HMOE_CKPT; launch counts
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
             present, step time and peak memory; one more forward and
             backward counted by FlopCounterMode (phase 26 (b)).
14b. blockwise — the blockwise prefill attention
    (``attention.blockwise_attention``, which every serving prefill
    runs) against the plain whole-matrix ``causal_attention`` on the
    same bf16 inputs at gemma3-27b's prefill (1 x 1,536, a windowed and
    a global layer) and kimi-k2's chunk call (512 queries at offset
    1,024), within two bf16 units of the output's scale; then one
    32,768-token prompt through qwen3-1.7b at full width (28 layers,
    2,080 block pairs a layer), whole and in chunks of 4,096: its peak
    ``max_memory_allocated`` (traced on ``meta`` in phase 27 (b)), its
    time, and its last logits against the chunked prefill's within
    LONG_LOGIT_TOL of their scale (and whether they are bitwise equal).
    Reported after phase 21: the gemma3, jamba and kimi-k2 prefill and
    chunk-call medians beside the card's name and power limit.
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
22. falcon_train — falcon-mamba-7b cut to 8 layers, trained at B = 2 x
             S = 2048, remat,
             3 steps: finite metrics, every gradient present and finite,
             the optimizer timed alone, one more step with CUDA events
             around it and around every call of the scan (its share).
23. distributed — the paper's Sec. 3.1 schedule (core/expert_parallel.py)
             on MoE-256 at full width (vocab 793,471, f32, B = 16 x S =
             128): (a) step 0 on this process at capacity factor 4 (no
             token dropped), its loss, metrics and gradients kept, exact
             launches; (b) two ranks spawned on the one card over gloo
             (a file store), mesh (data 1, model 2) (EP 2, 128 experts a
             rank) and then (2, 1) (data parallel, FSDP experts): step 0
             against (a) (loss, metrics, every gradient a rank holds),
             launch counts exactly phase 9's a step, 3 steps at the
             config's factor (finite, every gradient present; the last
             instrumented: each collective synchronized and timed, the
             collectives' share, the all-to-all bytes), peak memory,
             on (1, 2) one int8 error-feedback sync of the gradients
             (within one quantization step of the mean); (c)
             ``launch.train`` under ``torchrun`` on one NCCL rank against
             the same launcher without it (kimi-k2 --reduce, 4 steps).
24. mesh_serve — serving on a mesh (ServeEngine(ctx=)): kimi-k2 at
             full width cut to 1 layer, (a) on this process, then (b) on
             two gloo ranks sharing the card, mesh (data 1, model 2):
             EP 2 (192 experts a rank, the global dispatch plan, the
             expert outputs all-gathered), the decode pool's kv_seq over
             model, each rank building only its own slices from the
             seed.  Phase 3's traffic unfused and fused, then 4 requests
             of 1536 tokens sharing a 1024-token prompt (chunks of 512,
             the prefix cache on).  Gates: each call's logits within
             MESH_LOGIT_TOL of the logit scale of (a)'s where the inputs
             are the same, reshards = completed prompts, launches of
             kernels 1 / 2 / 4 / 6 (8 fused) exact on each rank, kernel
             8 on a rank's slab (the plan restricted to its experts)
             against its plain version.  Reported: stream agreement,
             decode-step ms, each collective's time and bytes (those
             inside decode calls apart, for phase 26 (c)), peak memory a
             rank.  (c) the same traffic on two ranks on mesh (data 2,
             model 1): the experts tensor-parallel, each rank holding
             d_ff 1024 of every expert, its f32 partial sums all-reduced
             over data.  Gates: the ranks' streams equal, every call's
             logits within two bf16 units of (a)'s with its inputs and
             routing pinned to (a)'s (each flip a near tie, at most 12 a
             run; fused decode against (a)'s unfused run, as phase 29),
             each rank's resident experts half of (a)'s, exact
             launches; kernel 6's f32 output and kernel 8 on a d_ff
             slice against their plain versions.
25. pipeline — the GPipe schedule (train/pipeline.py): qwen3-1.7b at
             full width in f32, cut to 8 layers, (a) lm_loss and its
             gradients on this
             process, (b) pipelined over (stage 2, model 1), 4
             microbatches of B 4 x S 1024: loss and every gradient
             against (a), one make_pipeline_train_step step (its
             forward ticks timed: the bubble share); (c) the
             kimi-k2 family at --reduce widths (4 layers) on (stage 2,
             model 2), four ranks: cuda against ref loss and gradients,
             exact launches a step (one MoE layer's lm_loss launches x
             microbatches x layers a stage); in the same ranks, (d) the
             row split: the reduced kimi with one row a microbatch
             (whole on both model ranks, its tokens split), the ranks'
             mean loss against one process's lm_loss, cuda against
             ref, exact launches; (e) moa-demo's period-1 variant at
             its own widths in f32, 4 microbatches of B 8 x S 128, MoA
             dropping: the mean loss and every gradient against one
             process's lm_loss, cuda against ref, exact launches of
             kernels 1, 2, 4, 6 and B5-B8; then the reduced kimi with a
             (2, 4) hierarchical MoE one step, cuda against ref; the
             seconds (d) and (e) added.
26. roofline — arithmetic on the host over what the phases above
             measured (it times nothing): (a) for each full-width
             transformer path (kimi-k2's prefill, unfused and fused
             decode steps and 512-token chunk call; arctic-480b, qwen3-
             1.7b trained; gemma3-27b, falcon-mamba-7b and jamba served
             (jamba unfused and fused) and trained) a record of
             ``launch/analytic.py`` and ``launch/roofline.py`` at the
             phase's own B and S on one card: FLOPs, HBM bytes, compute
             and memory ms, the bound and what dominates, the measured
             median, bound_share = bound / measured, mfu = model FLOPs /
             (measured x the dtype's peak), the resident estimate beside
             the measured peak; printed, written as JSON lines to
             chiprun_out/roofline.jsonl and as ``launch/report.py``'s
             tables; gate: every term finite and positive, bound <=
             measured.  (b) the analytic FLOPs against FlopCounterMode's
             count of qwen3-1.7b's train step (phase 14) and of kimi-k2's
             prefill of phase 3's 8 x 32 tokens on the ref backend (phase
             4), within 0.7-1.45.  (c) the analytic wire bytes of a
             decode step of phase 24's cell against the bytes its ranks'
             lm_decode calls sent, unfused and fused, within 10 %.
27. dryrun — the dry run (``launch/steps.py``, ``launch/dryrun.py``)
             against the card.  (a) every kernel wrapper (rows 1-8, the
             VJPs B5-B8) on the card and its meta branch
             (``cuda_lib.meta_trace``) on ``meta`` copies of the same
             inputs, at the kernels phase's training shapes and each
             full-width path's (META_SHAPES): outputs' shapes, dtypes and
             strides, and the bytes allocated over the call (held after
             it, and at its peak: ``memory_allocated`` /
             ``max_memory_allocated`` against ``MemTrace``, both in the
             caching allocator's 512-byte blocks) equal; the fused
             kernels' host workspace mirror equal to the library's.  (b)
             on each single-card full-width path (``dryrun_plan``), the
             phase that holds the model runs one call of the step that
             ``launch/steps.py`` builds on its parameters
             (``dryrun_peak``); the same steps, traced on ``meta``
             (``trace_path``, host work) by TRACE_WORKERS spawned
             processes beside phase 1's kernel build, before any timed
             phase on the host (the LONG_S path's trace runs on beside
             phase 2, whose times are the card's own; the phases'
             configs and shapes are known up front;
             a path whose phase ran another is traced again here): the
             card's peak (the parameters plus the rise over the call)
             against the dry run's, gate DRYRUN_BAND, the
             analytic resident estimate's ratio beside it; records to
             chiprun_out/dryrun.jsonl and ``launch/report.py``'s tables.
             (c) ``python -m repro_torch.launch.dryrun`` on a fake (data
             1, model 2) group at phase 24's decode cell, unfused and
             fused, run beside (a): its collective bytes a step equal to
             phase 24's measured bytes and to ``analyze_cell``'s wire
             bytes.
28. mesh_routed — MoA and the hierarchical MoE on a mesh, their global
             plan (``core/expert_parallel.py::GlobalPlan``): two gloo
             ranks sharing the card against one process on the same
             weights and draws.  (a) moa-demo at its published widths
             in f32, step 0 of B 8 x S 1024 on (1, 2) and (2, 1) at its
             own capacity factor, and on (1, 2) at MoA capacity factor
             1 (tokens drop); (b) moa-demo served (bf16) on (1, 2)
             under decode_std, phase 8's traffic unfused and fused; (c)
             moe-4096-h at full width in f32, step 0 of B 32 x S 128 on
             (1, 2), 8 groups a rank.  Gates: loss, metrics and every
             gradient a rank holds to phase 23's tolerances (for (c)
             the non-expert gradients and the expert gradients of each
             rank's first and last group), fraction_dropped equal,
             streams equal, logits within one bf16 unit of the logit
             scale, exact launches on every rank.  Reported: the
             collectives' calls, bytes and share of each step.
29. mesh_mixers — mamba mixers and sliding-window attention served on
             a mesh (ServeEngine(ctx=), the decode plan fitted to the
             pool): two gloo ranks sharing the card against one process
             on the same weights and traffic, bf16 at full width.  (a)
             jamba-v0.1-52b cut to one period on (1, 2) (8 experts a
             rank, the mamba states whole, the attention page over
             model), phase 20's traffic unfused and fused; (b)
             falcon-mamba-7b cut to 4 layers on (2, 1) (2 slots a rank);
             (c) gemma3-27b cut to one period on (1, 2), phase 16's
             prompts wrapping its 1024-token ring (512 slots a rank).
             The ranks are handed one process's tokens (jamba's also
             its kernel-1 choices).  Gates: every call's logits within
             two bf16 units of one process's, own greedy tokens one
             process's but at near ties, the ranks' engine stats equal,
             exact launches a rank, kernels 1, 2, 4, 6 and 8 against
             their plain versions at (a)'s mesh shapes.  Reported: a
             rank's decode-step ms, the collectives' calls, bytes and
             share of the decode time, peak memory a rank, the routing
             flips.
30. dense_tp — the dense layers tensor-parallel where a step's rows are
             whole (``MeshContext.tp_axes``): gemma3-27b at full width
             cut to one period (5 windowed layers, 1 global), bf16,
             remat, factored Adam, B 1 x S 4096 on two gloo ranks
             sharing the card on (data 1, model 2), each drawing its
             slices from phase 17's generator state: 16 of 32 query
             heads, 8 of 16 key / value heads, 10,752 of 21,504 d_ff,
             131,072 of 262,144 words a rank.  Gates: the dense leaves a
             rank gathers exactly half of one process's bytes; step 0's
             loss within DENSE_TP_LOSS_TOL of phase 17's one process,
             each gradient leaf's slice norm and sample within
             DENSE_TP_NORM_TOL / DENSE_TP_SAMPLE_TOL of one process's;
             the all-reduce calls of the gradient step exactly
             ``dense_tp_all_reduces``; no kernel launch; each rank's card
             peak within DRYRUN_BAND of its step traced on ``meta`` under
             a fake (1, 2) group.  Reported: the all-reduce bytes beside
             the exits' prediction, a rank's gradient and update time.
31. report — one ``{"kernels": [...]}`` line, then the result line.
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
# One checkpoint (17.3 GB), at the last step: two of them after phase 9's
# write 45 GiB to the disk (freed files included), more than a
# measurement machine may take from one command.
HMOE_CKPT = TRAIN_STEPS
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
    "gmm": "src/repro_torch/csrc/gmm.cuh",
    "topk_gating_bwd": "src/repro_torch/csrc/topk_gating.cu",
    "dispatch_eblock": "src/repro_torch/csrc/dispatch.cu",
    "combine_eblock": "src/repro_torch/csrc/dispatch.cu",
    "gmm_bwd": "src/repro_torch/csrc/gmm.cuh",
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
# Phase 14b: (a) the blockwise prefill against causal_attention, bf16:
# (what, heads, kv heads, head dim, queries, query offset, window);
# (b) one LONG_S-token qwen3-1.7b prompt, whole and in LONG_CHUNK
# chunks, whose last logits agree within LONG_LOGIT_TOL of their largest
# magnitude (five bf16 units: both run the same 512 x 512 blocks, but a
# projection over 4,096 rows may round otherwise than over 32,768).
BLOCKWISE_CASES = (
    ("gemma3-27b prefill, windowed layer", 32, 16, 128, GEMMA_PROMPT, 0,
     1024),
    ("gemma3-27b prefill, global layer", 32, 16, 128, GEMMA_PROMPT, 0, 0),
    ("kimi-k2 chunk call", 64, 8, 128, PREFIX_CHUNK, PREFIX_SHARED, 0))
LONG_S, LONG_CHUNK, LONG_LOGIT_TOL = 32_768, 4_096, 0.02
# PERF.md's medians (PR 30's table, PR 26's chip run 1) that phase 14b
# reprints beside this run's: gemma3, jamba and kimi-k2 prefill, the
# kimi-k2 chunk call.
PREFILL_MEDIANS_BEFORE = {"gemma3-27b prefill": 379.6,
                          "jamba-v0.1-52b prefill": 242.6,
                          "kimi-k2 prefill": 20.2, "kimi-k2 chunk call": 34.4}
SMOLLM = "smollm-135m"
# The Mamba mixer (models/ssm.py).  falcon-mamba-7b at full size (64
# layers, 7,270,825,984 parameters, 14.54 GB in bf16): served with 4
# slots, 4 prompts of 1024 tokens and 32 greedy tokens; trained at B x S
# tokens a step with remat, cut to FALCON_TRAIN_LAYERS (8: phases 29
# and 30 take the time of the other layers; at 32 the smoke ran over its
# budget).  Its decode state is n_layers x slots x
# (d_in·N·4 + (d_conv - 1)·d_in·2) bytes at any page length:
# 64 x 4 x (8192·16·4 + 3·8192·2).  SCAN_S: the one-layer scan-vs-decode
# gate's length (two chunks of 128), SCAN_TOL its tolerance a dtype,
# relative to the output's (and the state's) scale.
FALCON, FALCON_PARAMS = "falcon-mamba-7b", 7_270_825_984
SSM_REQUESTS, SSM_PROMPT, SSM_NEW = 4, 1024, 32
FALCON_STATE_BYTES = 146_800_640
FALCON_TRAIN_B, FALCON_TRAIN_S, FALCON_TRAIN_STEPS = 2, 2048, 3
FALCON_TRAIN_LAYERS = 8
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
# The first profile of a big call's ``device_ms`` held no device record
# at all in 14 to 29 of a run's ~51 big calls (a discarded profile
# before it changed nothing), and up to three profiles in a row did.
PROFILE_ATTEMPTS = 5     # profiles of one run before device_ms gives up
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


def h100() -> dict:
    """The card's constants: ``launch/roofline.py``'s table (the H100
    SXM data sheet's HBM rate and dense peaks; "tf32" is the tensor
    cores' rate, which 3xTF32 spends three times per f32 product)."""
    from repro_torch.launch.roofline import H100
    return H100


def bound_ms(n_bytes: float, flops, dtype_name: str | None = None):
    """(least time in ms, what bounds it) for moving ``n_bytes`` once and
    doing ``flops`` at the card's peak for the type; ``flops`` may be a
    {type name: operations} dict for work in several types."""
    if not isinstance(flops, dict):
        flops = {dtype_name: flops}
    card = h100()
    t_bytes = n_bytes / card["hbm_bandwidth"] * 1e3
    t_ops = sum(n / card["peak_flops"][dt] * 1e3 for dt, n in flops.items())
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


def combine_library(buf, w, ei, po):
    """The one PyTorch call that computes combine on the same plan,
    ``F.embedding_bag`` (mode "sum"): the buffer flattened to [E*C, d]
    with one more row, each token's k slots a bag of row e*C + p weighted
    by its weight, a dropped slot pointing at the extra row (the call's
    ``padding_idx``, left out of the sum).  The table and the indices are
    built here, once; the returned closure is the call to time."""
    import torch
    import torch.nn.functional as F
    e, c, d = buf.shape
    table = torch.cat([buf.reshape(e * c, d), buf.new_zeros(1, d)])
    idx = torch.where(po < c, ei.long() * c + po.long(), e * c)
    wl = w.to(buf.dtype)
    return lambda: F.embedding_bag(idx, table, mode="sum",
                                   per_sample_weights=wl, padding_idx=e * c)


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
                   dev_ms=cold["combine_kernel"], kept_slots=n_kept,
                   library_ms=cuda_ms(combine_library(buf, w, ei, po)))
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
                   e_block=e_block,
                   library_ms=cuda_ms(combine_library(buf, w, ei, po)))
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
    lib_c = cuda_ms(combine_library(buf, w, ei, po))
    b_c, by_c = bound_ms(n_kept * d * 2 + t * k * 12 + t * d * 2,
                         2 * n_kept * d, "bfloat16")
    shape = f"x [{t},{d}] bf16 <-> buf [{e},{c},{d}], k={k}"
    times = dispatch_combine_times(gen, floor)
    return [dict(name="dispatch", max_abs_err=worst_d, tol=tol_c, ms=ms_d,
                 plain_ms=plain_d, bound_ms=b_d, bound_by=by_d,
                 library_ms=None, shape=shape, by_shape=times["dispatch"]),
            dict(name="combine", max_abs_err=worst_c, tol=tol_c, ms=ms_c,
                 plain_ms=plain_c, bound_ms=b_c, bound_by=by_c,
                 library_ms=lib_c, shape=shape, by_shape=times["combine"])]


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
    b_bytes, _ = bound_ms(3 * e * d * f * 2, 0, "bfloat16")
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
    lib_c = cuda_ms(combine_library(buf, w, ei, po))
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
            library_ms=cuda_ms(combine_library(buf, unit, ei, po)),
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
                 library_ms=lib_c, shape=shape, train_vjps=vjps,
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
        "prefill_lengths": sorted(engine.prefill_lengths),
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
        short = {k: (per_kernel[k]["launches"], n) for k, n in
                 launched.items() if k in per_kernel
                 and per_kernel[k]["launches"] != n}
        if short:
            log(f"device_profile: records / launches of {short}")
        if not missing:
            break
        others = [(key[:60], n) for key, n, _ in dev
                  if not any(sym in key for syms in KERNEL_SYMBOLS.values()
                             for sym in syms)]
        log(f"device_profile: profile {attempt} of {PROFILE_ATTEMPTS} has "
            f"no device records of {missing} ({len(dev)} device ops in "
            f"all; launch counts {launched}; the other ops {others})")
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


def kimi_prefill_flops(cfg, params, prompts) -> dict:
    """Phase 3's prompts as one prefill of N_REQUESTS x PROMPT_LEN
    tokens through the plain versions (``kernel_backend="ref"``: every
    product an aten op), counted by FlopCounterMode."""
    import numpy as np
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models import lm, transformer
    tokens = torch.as_tensor(np.stack(prompts), dtype=torch.int32,
                             device="cuda")
    cache = pm.zeros(transformer.cache_defs(cfg, *tokens.shape), "cuda")
    out = flop_count(
        f"kimi-k2 prefill of {tuple(tokens.shape)} tokens, ref backend",
        lambda: lm.lm_prefill(params, {"tokens": tokens}, cache,
                              cfg.replace(kernel_backend="ref")))
    del cache
    torch.cuda.empty_cache()
    return out


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
    flops = kimi_prefill_flops(cfg, params, served["prompts"])
    fused = phase_fused(cfg, params, served)
    ec = phase_expert_choice(cfg, params, served["prompts"])
    prefix = phase_prefix(cfg, params, floor)
    with tempfile.TemporaryDirectory() as workdir:
        obs = phase_obs(cfg, params, served, fused, prefix, workdir)
    page = PROMPT_LEN + NEW_TOKENS
    dryrun_peak("kimi-k2 prefill", cfg, "prefill", 1, PROMPT_LEN, params)
    dryrun_peak("kimi-k2 decode", cfg, "decode", N_REQUESTS, page, params)
    dryrun_peak("kimi-k2 fused decode", cfg.replace(fused_decode=True),
                "decode", N_REQUESTS, page, params)
    return {"counts": served["counts"], "summary": served["summary"],
            "profile": profiled, "cross": cross, "fused": fused, "ec": ec,
            "prefix": prefix, "obs": obs, "flops": flops}


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
                launches: dict = TRAIN_LAUNCHES, what: str = "train",
                ckpt_every: int = TRAIN_CKPT) -> dict:
    """TRAIN_STEPS steps of the paper LM ``cfg`` through the Trainer
    (factored Adam, a checkpoint every ``ckpt_every`` steps), traced: launch
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
                             checkpoint_every=ckpt_every,
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
    check(trainer.ckpt.all_steps() == list(range(
        ckpt_every, TRAIN_STEPS + 1, ckpt_every)),
          f"checkpoints {trainer.ckpt.all_steps()}")
    events = trace_lib.load(trainer.tracer.path)
    spans = span_counts(events)
    kernel_spans = {k: v for k, v in spans.items()
                    if k.startswith("kernel.")}
    check(spans.get("train.step") == TRAIN_STEPS
          and spans.get("train.data") == TRAIN_STEPS,
          f"{what}: train spans {spans}")
    check(spans.get("train.checkpoint") == TRAIN_STEPS // ckpt_every,
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

    # Two steps in the profiled window, so each kernel launches at least
    # twice there: in some processes CUPTI lost the one top-k record of a
    # one-step window in every profile.
    def eblock_steps():
        for _ in range(2):
            xg.grad = None
            y, aux = moe_lib.moe_apply(
                mp, xg, dataclasses.replace(a, dispatch_e_block=E_BLOCK),
                train=True, noise=noise)
            ((y * gy).sum() + aux["aux_loss"]).backward()
    prof = device_profile(eblock_steps)
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
                          launches=HMOE_LAUNCHES, what="hmoe",
                          ckpt_every=HMOE_CKPT)
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
    dryrun_peak("arctic-480b train", cfg, "train", ARCTIC_B, ARCTIC_S, params)
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
    for p in pm.tree_leaves(params):
        p.grad = None
    batch = batch_at(dc, QWEN_STEPS + 1, device="cuda")
    flops = flop_count("qwen3 train step (lm_loss forward + backward)",
                       lambda: lm.lm_loss(params, batch, cfg)[0].backward())
    for p in pm.tree_leaves(params):
        p.grad = None
    median = statistics.median(run["times"][1:])
    out = {"config": f"{QWEN}, full size, bf16, remat, B={QWEN_B} x "
                     f"S={QWEN_S}, factored Adam",
           "parameters": n, "flash": flash,
           "step_ms_median_steps_2_to_4": 1e3 * median,
           "step_ms_all": [1e3 * t for t in run["times"]],
           "tokens_per_s": QWEN_B * QWEN_S / median,
           "max_memory_allocated_gib": run["peak"] / 2 ** 30,
           "losses": [m["loss"] for m in run["rows"]], "flops": flops}
    log("qwen3 train " + json.dumps(out))
    dryrun_peak("qwen3-1.7b train", cfg, "train", QWEN_B, QWEN_S, params)
    return out


# ---------------------------------------------------------------------------
# phase 14b: the blockwise prefill; one 32,768-token qwen3-1.7b prompt
# ---------------------------------------------------------------------------

def check_blockwise(gen) -> dict:
    """(a): blockwise_attention against causal_attention on the same
    bf16 inputs at each BLOCKWISE_CASES shape (blocks of 512): the error
    within two bf16 units of the output's scale, and both times."""
    import torch
    from repro_torch.models import attention as at
    out = {}
    for what, h, kvh, hd, sq, off, window in BLOCKWISE_CASES:
        q = torch.randn(1, sq, h, hd, device="cuda", generator=gen).to(
            torch.bfloat16)
        k = torch.randn(1, off + sq, kvh, hd, device="cuda",
                        generator=gen).to(torch.bfloat16)
        v = torch.randn(1, off + sq, kvh, hd, device="cuda",
                        generator=gen).to(torch.bfloat16)

        def block():
            return at.blockwise_attention(q, k, v, window=window,
                                          q_block=512, kv_block=512,
                                          q_offset=off)

        def plain():
            return at.causal_attention(q, k, v, window=window, q_offset=off)
        got, want = block(), plain()
        err, tol = max_err(got, want), bf16_tol(want)
        check(got.dtype == torch.bfloat16 and all_finite(got),
              f"blockwise {what}: not finite bf16")
        check(err <= tol, f"blockwise {what}: differs from causal_attention "
              f"by {err} > {tol}")
        out[what] = {"shape": f"1 x {sq} queries at offset {off}, {h} / "
                              f"{kvh} heads x {hd}, window {window}, bf16",
                     "max_abs_err": err, "tol": tol,
                     "blockwise_ms": cuda_ms(block, reps=5, warmup=1),
                     "causal_attention_ms": cuda_ms(plain, reps=5,
                                                    warmup=1)}
        log(f"blockwise (a) {what}: " + json.dumps(out[what]))
    return out


def phase_blockwise() -> dict:
    """Phase 14b (the module docstring): (a) :func:`check_blockwise`;
    (b) one LONG_S-token qwen3-1.7b prompt at full width: phase 27
    (b)'s step peak (``dryrun_peak``, its first call), then one timed
    whole prefill and the same prompt in LONG_CHUNK chunks."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm, transformer

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    blockwise = check_blockwise(gen)
    cfg = get_config(QWEN)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    dryrun_peak("qwen3-1.7b prefill 32k", cfg, "prefill", 1, LONG_S, params)
    tokens = torch.randint(1, cfg.vocab_size, (1, LONG_S), generator=gen,
                           device="cuda", dtype=torch.int32)

    def prefill(chunk: int):
        cache = pm.zeros(transformer.cache_defs(cfg, 1, LONG_S), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with torch.no_grad():
            for off in range(0, LONG_S, chunk):
                logits, cache = lm.lm_prefill(
                    params, {"tokens": tokens[:, off:off + chunk]}, cache,
                    cfg, start_pos=off if chunk < LONG_S else None)
        torch.cuda.synchronize()
        return (logits, 1e3 * (time.perf_counter() - t),
                torch.cuda.max_memory_allocated())
    whole, whole_ms, peak = prefill(LONG_S)
    chunked, chunked_ms, chunked_peak = prefill(LONG_CHUNK)
    err = max_err(chunked, whole)
    tol = LONG_LOGIT_TOL * abs_max(whole)
    check(all_finite(whole) and tuple(whole.shape) == (1, cfg.vocab_size),
          f"qwen3 32k prefill logits: shape {tuple(whole.shape)} or not "
          "finite")
    check(err <= tol, f"qwen3 32k prefill: chunks of {LONG_CHUNK} move the "
          f"last logits by {err} > {tol}")
    nq = LONG_S // cfg.q_block
    out = {"config": f"{QWEN}, full width ({cfg.n_layers} layers), bf16, "
                     f"1 x {LONG_S} tokens, blocks {cfg.q_block} x "
                     f"{cfg.kv_block}",
           "block_pairs_a_layer": nq * (nq + 1) // 2,
           "prefill_ms": whole_ms, "chunked_prefill_ms": chunked_ms,
           "max_memory_allocated_gib": peak / 2**30,
           "chunked_max_memory_allocated_gib": chunked_peak / 2**30,
           "chunked_vs_whole_max_abs_err": err, "tol": tol,
           "bitwise_equal": bool(torch.equal(chunked, whole)),
           "blockwise": blockwise, "wall_s": time.perf_counter() - t0}
    log("blockwise (b) qwen3 32k prefill " + json.dumps(
        {k: v for k, v in out.items() if k != "blockwise"}))
    del params
    return out


def log_prefill_medians(card: str, served, gemma, jamba) -> dict:
    """The prefill and chunk-call medians of this run beside
    PREFILL_MEDIANS_BEFORE, with the card's name and power limit."""
    now = {"gemma3-27b prefill": gemma["summary"]["prefill_ms_median"],
           "jamba-v0.1-52b prefill": jamba["summary"]["prefill_ms_median"],
           "kimi-k2 prefill": served["summary"]["prefill_ms_median"],
           "kimi-k2 chunk call": served["prefix"]["on"][
               "chunk_call_ms_median"]}
    log(f"prefill medians ({card}), ms this run / PERF.md before: "
        + ", ".join(f"{k} {v:.1f} / {PREFILL_MEDIANS_BEFORE[k]}"
                    for k, v in now.items()))
    return now


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
                      f"{cfg.sliding_window}", n_layers=cfg.n_layers,
               cache_bytes=cache_bytes, cache_bytes_full_length=full_len,
               ring=ring_gate, sample_tokens=streams[0][:8])
    log("gemma3 serve " + json.dumps(out))
    dryrun_peak("gemma3-27b prefill", cfg, "prefill", 1, GEMMA_PROMPT,
                params)
    dryrun_peak("gemma3-27b decode", cfg, "decode", GEMMA_REQUESTS, max_len,
                params)
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
    # Phase 30's ranks draw the same weights from this state.
    DENSE_TP_REF["gen_state"] = gen.get_state()
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    n = sum(p.numel() for p in pm.tree_leaves(params))
    log(f"materialized {GEMMA} (one period: {cfg.n_layers} layers) for "
        f"training: {n} parameters, {pm.param_bytes(params) / 1e9:.2f} GB")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                    batch_size=GEMMA_TRAIN_B, seed=SEED)
    dense_tp_reference(cfg, params, batch_at(dc, 0, device="cuda"))
    run = _train_loop(cfg, params, dc, GEMMA_TRAIN_STEPS, "gemma3 train")
    DENSE_TP_REF["step0_loss"] = run["rows"][0]["loss"]
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
    del run
    dryrun_peak("gemma3-27b train", cfg, "train", GEMMA_TRAIN_B, s, params)
    del params
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
    torch.cuda.empty_cache()
    dryrun_peak("falcon-mamba-7b prefill", cfg, "prefill", 1, SSM_PROMPT,
                params)
    dryrun_peak("falcon-mamba-7b decode", cfg, "decode", SSM_REQUESTS,
                max_len, params)
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
    """falcon-mamba-7b at full width cut to FALCON_TRAIN_LAYERS, B x S =
    FALCON_TRAIN_B x FALCON_TRAIN_S, remat: FALCON_TRAIN_STEPS steps
    (finite metrics, no
    kernel launch), every gradient present and finite, the optimizer
    timed alone, one step profiled (the scan's share)."""
    import torch
    from repro_torch.data.pipeline import DataConfig

    cfg, params, n = build_ssm(FALCON, FALCON_TRAIN_LAYERS)
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
    del run
    dryrun_peak("falcon-mamba-7b train", cfg, "train", FALCON_TRAIN_B,
                FALCON_TRAIN_S, params)
    del params
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
    dryrun_peak("jamba-v0.1-52b prefill", cfg, "prefill", 1, SSM_PROMPT,
                params)
    dryrun_peak("jamba-v0.1-52b decode", cfg, "decode", SSM_REQUESTS,
                max_len, params)
    dryrun_peak("jamba-v0.1-52b fused decode", cfg.replace(fused_decode=True),
                "decode", SSM_REQUESTS, max_len, params)
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
    del run
    dryrun_peak("jamba-v0.1-52b train", cfg, "train", JAMBA_TRAIN_B,
                JAMBA_TRAIN_S, params)
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 23: the distributed MoE (Sec. 3.1) on two ranks sharing the card
# ---------------------------------------------------------------------------

# MoE-256 at full width (phase 9's config), first on one process, then on
# two ranks sharing the card over gloo: mesh (data 1, model 2), EP = 2,
# 128 experts a rank; then (data 2, model 1), pure data parallel with
# FSDP experts.  The global batch is cut to DIST_B x TRAIN_S (phase 9:
# 32 x 128): at 32 rows the two ranks' logits ([2048, 793471] f32, 6.5
# GB, and the backward pass's temporaries of that size) ran out of the
# card's 80 GB together (31.7 GiB a rank before a 6.05 GiB allocation,
# measured on one H100).  Step 0 at DIST_CF, where neither run drops a
# token (C = 128 on one process, 64 a rank); then DIST_STEPS steps at
# the config's own factor.
DIST_B = 16
DIST_MESHES = ((1, 2), (2, 1))
DIST_CF = 4.0
DIST_STEPS = 3
# Step 0 on two ranks against one process: the loss within
# DIST_LOSS_TOL relative, the balancing metrics within DIST_METRIC_TOL
# relative, each gradient leaf within DIST_GRAD_TOL normwise (||g_ranks
# - g_one|| / ||g_one||).  Both runs are f32 on the same kernels; their
# reductions run in other orders (two halves of the batch, the
# gradients summed over the ranks, the combined batch's rows in other
# GMM tiles, the embedding's atomics) and cuBLAS picks its algorithms
# by the LSTMs' batch (16 rows a rank, 32 on one process).
DIST_LOSS_TOL = 1e-5
DIST_METRIC_TOL = 1e-4
DIST_GRAD_TOL = 1e-4
# The launcher on one NCCL rank (torchrun) against the same launcher
# without torchrun: the last logged metrics within DIST_LAUNCH_TOL
# relative.
DIST_LAUNCH_ARGS = ("--arch", "kimi-k2-1t-a32b", "--reduce", "--steps", "4")
DIST_LAUNCH_TOL = 1e-5


def _dist_cfg(cf=None):
    import dataclasses
    from repro_torch.configs.moe_paper import paper_config
    cfg = paper_config(TRAIN_CONFIG, vocab_size=TRAIN_VOCAB)
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def _dist_data():
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(vocab_size=TRAIN_VOCAB, seq_len=TRAIN_S,
                      batch_size=DIST_B, seed=SEED)


def _dist_params(device="cuda"):
    """MoE-256 drawn from SEED, as build_train_model draws it."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models.paper_lm import paper_lm_defs
    defs = paper_lm_defs(_dist_cfg())
    gen = torch.Generator(device=device).manual_seed(SEED)
    return defs, pm.materialize(defs, gen, device)


def dist_reference(workdir: str) -> dict:
    """(a) Step 0 of MoE-256 at DIST_CF on this process: the loss, the
    metrics and every gradient (written to ``workdir`` for the ranks,
    with the step's draws), exact launch counts, no token dropped."""
    import os
    import torch
    from repro_torch.common.param import tree_leaves, tree_map
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import paper_lm
    from repro_torch.train.trainer import step_seed

    cfg = _dist_cfg(DIST_CF)
    _, params = _dist_params()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = batch_at(_dist_data(), 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(step_seed(SEED, 0))
    draws = paper_lm.make_draws(cfg, DIST_B, TRAIN_S, gen, "cuda")
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    loss, metrics = paper_lm.paper_lm_loss(params, batch, cfg, draws=draws)
    loss.backward()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = cuda_lib.launch_counts()
    check(counts == TRAIN_LAUNCHES,
          f"dist reference launches {counts}, expected {TRAIN_LAUNCHES}")
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    check(metrics["fraction_dropped"] == 0.0,
          f"dist reference dropped tokens at capacity factor {DIST_CF}: "
          f"{metrics}")
    grads = tree_map(lambda p: p.grad.detach().cpu(), params)
    torch.save(grads, os.path.join(workdir, "ref_grads.pt"))
    torch.save({"draws": {k: (v.cpu() if v is not None else None)
                          for k, v in draws.items()}},
               os.path.join(workdir, "ref_draws.pt"))
    out = {"loss": float(loss), "metrics": metrics, "step_ms": step_ms,
           "launches": counts,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("dist (a) one process " + json.dumps(out))
    del params, grads, loss, draws
    return out


class _CollectiveClock:
    """Wraps torch.distributed's all_to_all_single / all_gather /
    all_reduce while on: each call synchronized and timed on the host,
    its bytes counted by op."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.on = dist, False
        self.ms, self.bytes, self.calls = {}, {}, {}
        for name in ("all_to_all_single", "all_gather", "all_reduce"):
            setattr(dist, name, self._wrap(name, getattr(dist, name)))

    def _wrap(self, name, fn):
        import torch

        def call(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            t = args[1] if name != "all_reduce" else args[0]
            n = t.numel() * t.element_size()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + 1e3 * (
                time.perf_counter() - t0)
            self.bytes[name] = self.bytes.get(name, 0) + n
            self.calls[name] = self.calls.get(name, 0) + 1
            return out
        return call

    @contextlib.contextmanager
    def in_decode(self):
        """While on: the bytes, synchronized ms and calls of the
        collectives that ``lm.lm_decode`` calls run, by op, and the number
        of decode calls (one a decode step)."""
        from repro_torch.models import lm
        real = lm.lm_decode
        dec = {"calls": 0, "bytes": {}, "ms": {}, "op_calls": {}}
        mine = (("bytes", self.bytes), ("ms", self.ms),
                ("op_calls", self.calls))

        def decode(*args, **kw):
            before = [dict(table) for _, table in mine]
            out = real(*args, **kw)
            for (key, table), was in zip(mine, before):
                for name, n in table.items():
                    dec[key][name] = (dec[key].get(name, 0) + n
                                      - was.get(name, 0))
            dec["calls"] += 1
            return out
        lm.lm_decode = decode
        try:
            yield dec
        finally:
            lm.lm_decode = real


def _leaf_errs(ctx, grads, ref, defs, expert=None) -> dict:
    """Each gradient leaf of this rank (its slice of the full gradient)
    against the same slice of the one process's (``ref``, on the host):
    the normwise relative and the largest absolute error, and the one
    process's norm.  ``expert(path, g, r)`` gives the (tag, rank's, one
    process's) pairs of a leaf whose one-process gradient holds some
    expert groups only (None: the leaf is whole)."""
    import torch
    errs = {}

    def one(name, g, want):
        want = want.to("cuda")
        diff = torch.linalg.vector_norm((g - want).float())
        norm = torch.linalg.vector_norm(want.float())
        errs[name] = {"norm_rel": float(diff / torch.clamp(norm, min=1e-30)),
                      "max_abs": float((g - want).abs().max()),
                      "finite": bool(torch.isfinite(g).all()),
                      "norm": float(norm)}

    def walk(g, r, s, path):
        if isinstance(g, dict):
            for k in sorted(g):
                walk(g[k], r[k], s[k], path + (k,))
            return
        pairs = None if expert is None else expert(path, g, r)
        if pairs is None:
            one(".".join(path), g, ctx.shard_leaf(r, s))
        else:
            for tag, mine, want in pairs:
                one(f"{'.'.join(path)}[{tag}]", mine, want)
    walk(grads, ref, ctx.specs(defs), ())
    return errs


def _dist_rank(rank: int, world: int, model: int, workdir: str,
               ef: bool) -> None:
    """One of the two ranks of phase 23 (a spawned process)."""
    import os
    import traceback
    import torch
    import torch.distributed as dist
    store = os.path.join(workdir, f"store_{world}_{model}")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = _dist_rank_body(rank, model, workdir, ef)
        with open(os.path.join(workdir, f"rank{rank}_{model}.json"),
                  "w") as f:
            json.dump(out, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _dist_rank_body(rank: int, model: int, workdir: str, ef: bool) -> dict:
    import math
    import os
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch.common.param import tree_leaves
    from repro_torch.core.dispatch import capacity_for
    from repro_torch.data.pipeline import batch_at
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import paper_lm
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.sharding.context import MeshContext
    from repro_torch.train import compression
    from repro_torch.train.trainer import make_grad_fn, step_seed

    clock = _CollectiveClock()
    ctx = MeshContext.for_mesh(make_host_mesh(model, device="cuda"),
                               "dp_tp_ep")
    res = {"rank": rank, "mesh": ctx.sizes}
    defs, params = _dist_params()
    local = ctx.shard(params, defs)
    del params
    torch.cuda.empty_cache()
    for p in tree_leaves(local):
        p.requires_grad_(True)
    dc = _dist_data()

    # Step 0 at DIST_CF from the reference's draws.
    cfg = _dist_cfg(DIST_CF)
    saved = torch.load(os.path.join(workdir, "ref_draws.pt"),
                       weights_only=True)["draws"]
    draws = {k: (v.to("cuda") if v is not None else None)
             for k, v in saved.items()}
    grads_fn = make_grad_fn(
        lambda p, b, g: paper_lm.paper_lm_loss(p, b, cfg, draws=draws,
                                               ctx=ctx), ctx=ctx, defs=defs)
    batch = batch_at(dc, 0, device="cuda")
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    grads, metrics = grads_fn(local, batch, None)
    torch.cuda.synchronize()
    res["step0_launches"] = cuda_lib.launch_counts()
    res["step0_metrics"] = {k: float(v) for k, v in metrics.items()}
    res["step0_grads"] = _leaf_errs(
        ctx, grads, torch.load(os.path.join(workdir, "ref_grads.pt"),
                               mmap=True, weights_only=True), defs)
    if ef:
        # One int8 error-feedback sync of the step's gradient tree over
        # the two ranks; each leaf's error against the exact mean (an
        # all-reduce), in quantization steps (the larger rank's scale).
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synced, _ = compression.ef_compress_sync(
            grads, compression.init_ef_state(grads))
        torch.cuda.synchronize()
        ef_ms = 1e3 * (time.perf_counter() - t0)
        worst, leaves = 0.0, tree_leaves(grads)
        for g, s in zip(leaves, tree_leaves(synced)):
            mean = g.detach().float().clone()
            dist.all_reduce(mean)
            step = compression.quantize_int8(g.detach())[1].clone()
            dist.all_reduce(step, op=dist.ReduceOp.MAX)
            err = (s.float() - mean / ctx.world).abs().max()
            worst = max(worst, float(err / step))
            del mean
        n = sum(g.numel() for g in leaves)
        res["ef"] = {"max_err_in_steps": worst, "ms": ef_ms, "elements": n,
                     "wire_bytes_a_rank": (ctx.world - 1) * (n + 4 * len(
                         leaves)),
                     "allreduce_bytes_a_rank": 2 * (ctx.world - 1)
                     / ctx.world * 4 * n}
        del synced
    del grads, draws, saved
    for p in tree_leaves(local):
        p.grad = None
    torch.cuda.empty_cache()

    # DIST_STEPS steps at the config's own capacity factor, the last one
    # instrumented (each collective synchronized and timed).
    cfg = _dist_cfg()
    oc = opt_lib.OptConfig(kind="factored")
    opt = opt_lib.init(local, oc)
    grads_fn = make_grad_fn(
        lambda p, b, g: paper_lm.paper_lm_loss(p, b, cfg, generator=g,
                                               ctx=ctx), ctx=ctx, defs=defs)
    a2a = []
    plain_a2a = MeshContext.all_to_all

    def counted_a2a(self, x, axis):
        a2a.append(x.numel() * x.element_size())
        return plain_a2a(self, x, axis)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    step_ms, losses, dropped = [], [], []
    for i in range(DIST_STEPS):
        if i == DIST_STEPS - 1:
            clock.on = True
            MeshContext.all_to_all = counted_a2a
        batch = batch_at(dc, i, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(step_seed(SEED, i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, m = grads_fn(local, batch, gen)
        ok = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        check(ok, f"rank {rank}: a non-finite gradient at step {i}")
        check(all(p.grad is not None for p in tree_leaves(local)),
              f"rank {rank}: a parameter without a gradient at step {i}")
        opt_lib.apply_updates(local, grads, opt, oc, ctx=ctx, defs=defs)
        for p in tree_leaves(local):
            p.grad = None
        loss = float(m["loss"])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        dropped.append(float(m["fraction_dropped"]))
        check(math.isfinite(loss), f"rank {rank}: loss {loss} at step {i}")
    clock.on = False
    MeshContext.all_to_all = plain_a2a
    res["launches"] = cuda_lib.launch_counts()
    t_local = DIST_B * TRAIN_S // ctx.world
    c_local = capacity_for(t_local, cfg.n_experts, cfg.k,
                           cfg.capacity_factor)
    ep = ctx.sizes["model"]
    res.update({
        "losses": losses, "fraction_dropped": dropped, "step_ms": step_ms,
        "step_ms_steady": statistics.median(step_ms[1:DIST_STEPS - 1]),
        "collective_ms": clock.ms, "collective_bytes": clock.bytes,
        "collective_calls": clock.calls,
        "collective_share": sum(clock.ms.values()) / step_ms[-1],
        "a2a_forward_bytes_each": a2a,
        "a2a_bytes_leaving_rank_each": [b * (ep - 1) // ep for b in a2a],
        "a2a_expected_bytes_each": cfg.n_experts * c_local * cfg.d_model * 4,
        "a2a_formula_2kTd4": 2 * cfg.k * t_local * cfg.d_model * 4,
        "capacity_local": c_local, "tokens_local": t_local,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    return res


def dist_ranks(workdir: str, data: int, model: int, ef: bool) -> list:
    """(b) The two ranks on mesh (data, model), spawned; their reports."""
    import os
    import torch.multiprocessing as mp
    world = data * model
    t0 = time.perf_counter()
    try:
        mp.spawn(_dist_rank, args=(world, model, workdir, ef), nprocs=world,
                 join=True)
    except Exception as err:       # a rank failed: the phase fails
        raise SmokeFailure(f"dist ranks on mesh ({data}, {model}): {err}")
    wall = time.perf_counter() - t0
    reports = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}_{model}.json")) as f:
            reports.append(json.load(f))
    reports[0]["spawn_wall_s"] = wall
    return reports


def check_dist_ranks(what: str, reports: list, ref: dict) -> dict:
    """Step 0 of every rank against the one-process reference, and the
    launches, losses and gradients of its steps."""
    worst = {"loss_rel": 0.0, "metric_rel": 0.0, "grad_norm_rel": 0.0}
    for r in reports:
        check(r["step0_launches"] == TRAIN_LAUNCHES,
              f"{what} rank {r['rank']}: step 0 launches "
              f"{r['step0_launches']}, expected {TRAIN_LAUNCHES}")
        want = {k: DIST_STEPS * v for k, v in TRAIN_LAUNCHES.items()}
        check(r["launches"] == want,
              f"{what} rank {r['rank']}: launches {r['launches']} in "
              f"{DIST_STEPS} steps, expected {want}")
        m = r["step0_metrics"]
        check(m["fraction_dropped"] == 0.0,
              f"{what} rank {r['rank']}: step 0 dropped tokens: {m}")
        rel = abs(m["loss"] - ref["loss"]) / abs(ref["loss"])
        worst["loss_rel"] = max(worst["loss_rel"], rel)
        check(rel <= DIST_LOSS_TOL, f"{what} rank {r['rank']}: loss "
              f"{m['loss']} vs one process {ref['loss']} (rel {rel:.3g})")
        for k in ("xent", "aux_loss", "cv_importance", "cv_load",
                  "max_over_mean_load"):
            want_k = ref["metrics"][k]
            err = abs(m[k] - want_k) / max(abs(want_k), 1e-6)
            worst["metric_rel"] = max(worst["metric_rel"], err)
            check(err <= DIST_METRIC_TOL, f"{what} rank {r['rank']}: {k} "
                  f"{m[k]} vs one process {want_k}")
        for name, e in r["step0_grads"].items():
            check(e["finite"], f"{what} rank {r['rank']}: {name} not finite")
            worst["grad_norm_rel"] = max(worst["grad_norm_rel"],
                                         e["norm_rel"])
            check(e["norm_rel"] <= DIST_GRAD_TOL,
                  f"{what} rank {r['rank']}: gradient {name} "
                  f"{e['norm_rel']:.3g} normwise from one process")
        if "ef" in r:
            check(r["ef"]["max_err_in_steps"] <= 1.0,
                  f"{what} rank {r['rank']}: int8 EF sync off the mean by "
                  f"{r['ef']['max_err_in_steps']:.3g} quantization steps")
    check(reports[0]["losses"] == reports[1]["losses"],
          f"{what}: the ranks' losses differ: {reports[0]['losses']} vs "
          f"{reports[1]['losses']}")
    return worst


def dist_launcher_start(workdir: str) -> tuple:
    """(c)'s launch.train under torchrun on one NCCL rank, a subprocess
    started with the phase, so that its start-up (the interpreter, CUDA,
    NCCL: ~30 s of the phase on a slow host) overlaps (a) and (b)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    work = os.path.join(workdir, "torchrun")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "repro_torch.launch.train",
         *DIST_LAUNCH_ARGS, "--workdir", work], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, work, time.perf_counter()


def dist_launcher(workdir: str, started: tuple) -> dict:
    """(c) the torchrun subprocess of :func:`dist_launcher_start` against
    the same launcher without torchrun (in this process): the last
    logged metrics.  ``wall_s`` of torchrun spans (a) and (b)."""
    import os
    from repro_torch.launch import train as train_launch
    proc, work, t0 = started
    stdout, stderr = proc.communicate(timeout=300)
    torchrun_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"launcher under torchrun exited "
          f"{proc.returncode}: {stderr[-3000:]}")
    check("1 rank(s) over nccl, mesh {'data': 1, 'model': 1}" in stdout,
          "the torchrun launcher did not run one NCCL rank on the mesh")
    with open(os.path.join(work, "metrics.jsonl")) as f:
        b = [json.loads(line) for line in f][-1]
    t0 = time.perf_counter()
    a = train_launch.main([*DIST_LAUNCH_ARGS, "--workdir",
                           os.path.join(workdir, "plain")])
    plain_s = time.perf_counter() - t0
    errs = {}
    for k in ("loss", "xent", "aux_loss", "grad_norm"):
        errs[k] = abs(b[k] - a[k]) / max(abs(a[k]), 1e-9)
        check(errs[k] <= DIST_LAUNCH_TOL, f"launcher under torchrun: {k} "
              f"{b[k]} vs {a[k]} without")
    out = {"plain": a, "torchrun": b, "rel_errs": errs,
           "wall_s": {"torchrun": torchrun_s, "plain": plain_s}}
    log("dist (c) launcher " + json.dumps(out))
    return out


def _dist_meshes(workdir: str) -> dict:
    """(a) one process, then (b) two ranks on each mesh."""
    import gc
    import torch
    out = {"one": dist_reference(workdir)}
    gc.collect()
    torch.cuda.empty_cache()
    for data, model in DIST_MESHES:
        what = f"dist ({data}, {model})"
        reports = dist_ranks(workdir, data, model, ef=(model == 2))
        worst = check_dist_ranks(what, reports, out["one"])
        for r in reports:
            r["step0_grads"] = {k: e["norm_rel"]
                                for k, e in r["step0_grads"].items()}
        out[f"{data}x{model}"] = {"ranks": reports, "worst": worst}
        log(f"{what} " + json.dumps(out[f"{data}x{model}"]))
    return out


def phase_distributed() -> dict:
    """Phase 23: (a) one process, (b) two ranks on each mesh, (c) the
    launcher on one NCCL rank, started with the phase."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        launcher = dist_launcher_start(workdir)
        try:
            out.update(_dist_meshes(workdir))
        except BaseException:
            launcher[0].kill()
            launcher[0].communicate()
            raise
        out["launcher"] = dist_launcher(workdir, launcher)
    out["wall_s"] = time.perf_counter() - t0
    log(f"dist phase {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 24: serving on a mesh (two ranks sharing the card)
# ---------------------------------------------------------------------------

# kimi-k2 at full width cut to MESH_LAYERS layer, first on this process,
# then on two gloo ranks sharing the card, mesh (data 1, model 2): EP 2
# (192 experts a rank), the decode pool's kv_seq over model.  Phase 3's
# traffic (N_REQUESTS x PROMPT_LEN, NEW_TOKENS greedy tokens) unfused and
# fused, then the shared-prefix traffic of phase 7 cut to MESH_PREFIX_N
# requests, chunks of PREFIX_CHUNK, the prefix cache on.  Each rank
# builds only its own slices from SEED (the one-process tree's draws,
# one whole leaf at a time).  Gates: every prefill and decode call whose
# input tokens equal the one process's has logits within phase 4's
# tolerance (MESH_LOGIT_TOL x the logit scale: the attention's partial
# softmaxes merge in another rounding, the fused partial sums too), the
# reshards counter equals the completed prompts, the launches of kernels
# 1 / 2 / 4 / 6 (and 8 fused) are exact on every rank.
MESH_LAYERS = 1
MESH_SERVE = (1, 2)
# (c): the experts' d_ff over data (the reference's expert_mlp).  Each
# call's logits within MIXER_LOGIT_UNITS bf16 units of (a)'s, its
# routing pinned to (a)'s (_TopkPin) and its inputs (a)'s.  Kernel 6's
# f32 output within GMM_F32_TOL of the output's scale of its plain
# version (f32 sums over K = 1024 bf16 products in another order).
MESH_TP = (2, 1)
GMM_F32_TOL = 2.0 ** -12
MESH_PREFIX_N = 4
MESH_LOGIT_TOL = 0.05
MESH_TRAFFIC = ("serve", "fused", "prefix")
MESH_UNFUSED = {"topk_gating": 1, "dispatch": 1, "gmm": 3, "combine": 1}
# Fused decode a layer: kernel 7 on one process (noisy_topk routes in
# the kernel), the routing's top-k and kernel 8 on a mesh.
MESH_FUSED_DECODE = {"one": {"fused_decode": 1},
                     "mesh": {"topk_gating": 1, "fused_routed": 1}}


def _mesh_cfg():
    from repro_torch.configs.base import get_config
    return get_config(ARCH, n_layers=MESH_LAYERS)


def _mesh_params(cut=None):
    """kimi-k2 at MESH_LAYERS layers drawn from SEED as build_model draws
    it (the gate redrawn after the tree); with ``cut`` each leaf is
    reduced to a rank's slice as it is drawn."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models import lm
    cfg = _mesh_cfg()
    defs = lm.lm_defs(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(defs, gen, "cuda", cut=cut)
    gdef = defs["blocks"]["periods"]["pos0"]["moe"]["gate"]["wg"]
    gate = torch.empty(gdef.shape, dtype=gdef.dtype, device="cuda")
    gate.normal_(0.0, cfg.d_model ** -0.5, generator=gen)
    params["blocks"]["periods"]["pos0"]["moe"]["gate"]["wg"] = (
        gate if cut is None else cut(gdef, gate))
    return cfg, params


def _mesh_traffic():
    """(ServeConfig fields, [(prompt, new tokens, arrival)]) of each
    traffic: phase 3's prompts one step apart, unfused and fused; the
    shared-prefix trace (request 0 retires before the others arrive)."""
    import numpy as np
    vocab = _mesh_cfg().vocab_size
    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(1, vocab, (PROMPT_LEN,)) for _ in range(N_REQUESTS)]
    plain = [(p, NEW_TOKENS, i) for i, p in enumerate(prompts)]
    sc = dict(max_len=PROMPT_LEN + NEW_TOKENS, n_slots=N_REQUESTS)
    rs = np.random.RandomState(SEED + 24)
    shared = rs.randint(1, vocab, (PREFIX_SHARED,))
    prefix = [(np.concatenate([shared, rs.randint(
        1, vocab, (PREFIX_LEN - PREFIX_SHARED,))]), NEW_TOKENS,
        0 if i == 0 else PREFIX_FIRST_ARRIVAL + i)
        for i in range(MESH_PREFIX_N)]
    return {"serve": (sc, plain), "fused": (dict(sc, fused_decode=True), plain),
            "prefix": (dict(max_len=PREFIX_MAX_LEN, n_slots=MESH_PREFIX_N,
                            prefill_chunk=PREFIX_CHUNK,
                            prefill_budget=PREFIX_BUDGET, admission="aware",
                            prefix_cache=True), prefix)}


class _LogitRecorder:
    """Wraps lm_prefill / lm_decode while on: each call's input tokens
    (and decode positions) and its logits, on the host; and in
    ``routes``, a call's kernel-1 choices (the indices of each
    ``ops.topk_gating`` it makes, with ``gates`` (index, the gate logits
    it was given) pairs)."""

    def __init__(self, gates: bool = False):
        from repro_torch.kernels import ops
        from repro_torch.models import lm
        self.lm, self.ops, self.calls, self.routes = lm, ops, [], []
        self.real = (lm.lm_prefill, lm.lm_decode, ops.topk_gating)
        self.gates = gates
        self._route = []

    def __enter__(self):
        real_prefill, real_decode, real_topk = self.real

        def prefill(params, batch, cache, cfg, **kw):
            logits, cache = real_prefill(params, batch, cache, cfg, **kw)
            self.calls.append(("prefill", batch["tokens"].cpu(), None,
                               logits.float().cpu()))
            self.routes.append(self._route)
            self._route = []
            return logits, cache

        def decode(params, tokens, cache, cur, cfg, **kw):
            out = real_decode(params, tokens, cache, cur, cfg, **kw)
            self.calls.append(("decode", tokens.cpu(), cur.cpu(),
                               out[0].float().cpu()))
            self.routes.append(self._route)
            self._route = []
            return out

        def topk(logits, k, kk=None):
            out = real_topk(logits, k, kk)
            self._route.append((out[1].cpu(), logits.float().cpu())
                               if self.gates else out[1].cpu())
            return out
        self.lm.lm_prefill, self.lm.lm_decode = prefill, decode
        self.ops.topk_gating = topk
        return self

    def __exit__(self, *exc):
        self.lm.lm_prefill, self.lm.lm_decode, self.ops.topk_gating = \
            self.real
        return False


def _mesh_serve_run(what, cfg, params, sc_kw, trace, ctx=None,
                    launches=None, follow=None, pin=None,
                    clock=None, gates=False) -> dict:
    """One traffic through an engine (on ``ctx`` or one process): a
    warm-up, then the run with the launches zeroed just before and read
    just after, each call's logits recorded.  ``launches``: (a model
    call's unfused launches, a fused decode step's on one process, on a
    mesh); phase 24's kimi-k2 layer by default.  Each sampling's greedy
    tokens are kept (``samples``); with ``follow`` (a one-process run's
    ``samples``) the engine is handed those tokens instead of its own,
    so every call's inputs are that run's.  ``pin``: a :class:`_TopkPin`
    active during the run; ``clock``: a :class:`_CollectiveClock` on
    during the run alone (its tables reset, the decode calls' part in
    ``decode_collectives``); ``gates``: keep each top-k call's gate
    logits in ``routes`` (:class:`_LogitRecorder`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    engine = ServeEngine(params, cfg, ServeConfig(**sc_kw), device="cuda",
                         ctx=ctx)
    engine.generate(np.stack([p[:PROMPT_LEN] for p, _, _ in trace[:2]]), 2)
    engine.reset()
    reqs = [engine.submit(p, m, arrival=a) for p, m, a in trace]
    samples, real_sample = [], engine._sample_rows

    def sample(logits, rows):
        toks = real_sample(logits, rows)
        samples.append(toks.tolist())
        if follow is None:
            return toks
        want = np.asarray(follow[len(samples) - 1], np.int32)
        first = engine.kv.first_slot
        return want if len(want) == len(toks) else want[first:first
                                                         + len(toks)]
    engine._sample_rows = sample
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        in_decode = None
        if clock is not None:
            clock.ms, clock.bytes, clock.calls = {}, {}, {}
            in_decode = stack.enter_context(clock.in_decode())
            clock.on = True
        if pin is not None:
            stack.enter_context(pin.pinned())
        rec = stack.enter_context(_LogitRecorder(gates))
        engine.run()
    if clock is not None:
        clock.on = False
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    for r in reqs:
        check(r.done and len(r.tokens) == r.max_new_tokens,
              f"{what}: request {r.rid} ended with {len(r.tokens)} tokens")
    stats = engine.stats
    fused = sc_kw.get("fused_decode", False)
    unfused, fused_one, fused_mesh = launches or (
        MESH_UNFUSED, MESH_FUSED_DECODE["one"], MESH_FUSED_DECODE["mesh"])
    want = expected_launches(
        stats, unfused, (fused_one if ctx is None else fused_mesh)
        if fused else unfused)
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    if ctx is not None:
        check(stats["reshards"] == stats["prefills"] == len(reqs),
              f"{what}: {stats['reshards']} reshards for {stats['prefills']}"
              f" prefills of {len(reqs)} prompts")
    dec = engine.step_times["decode"]
    return {"streams": [list(r.tokens) for r in reqs], "calls": rec.calls,
            "routes": rec.routes, "samples": samples,
            "decode_collectives": in_decode,
            "first_slot": engine.kv.first_slot, "n_local": engine.kv.n_local,
            "summary": {
                "wall_s": wall, "launches": counts,
                "decode_step_ms_median": 1e3 * statistics.median(dec),
                "decode_ms_total": 1e3 * sum(dec),
                "prefill_ms_median": (1e3 * statistics.median(
                    engine.step_times["prefill"])
                    if engine.step_times["prefill"] else None),
                "chunk_call_ms_median": (1e3 * statistics.median(
                    engine.step_times["chunk"])
                    if engine.step_times["chunk"] else None),
                "stats": {k: stats[k] for k in (
                    "prefills", "prefill_chunks", "prefill_calls",
                    "reshards", "decode_steps", "generated_tokens",
                    "prefix_hits", "prefix_hit_tokens")},
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}}


def _logit_errs(calls, ref_calls, first: int, n_local: int) -> dict:
    """Each recorded call against the one-process call at the same place
    in the run, where its input tokens (and positions) are the same: the
    largest |difference| over the logit scale, and in bf16 units in the
    last place at the binade of the call's logit scale."""
    import math
    worst, compared, scale_at, units = 0.0, 0, None, 0.0
    for (kind, tok, cur, logits), (rkind, rtok, rcur, rlogits) in zip(
            calls, ref_calls):
        if kind != rkind:
            break
        if kind == "decode":
            rtok, rcur = rtok[first:first + n_local], rcur[first:first +
                                                           n_local]
            rlogits = rlogits[first:first + n_local]
            if not (torch_equal(tok, rtok) and torch_equal(cur, rcur)):
                continue
        elif not torch_equal(tok, rtok):
            continue
        scale = max(float(rlogits.abs().max()), 1e-30)
        diff = float((logits - rlogits).abs().max())
        if diff / scale >= worst:
            worst, scale_at = diff / scale, scale
        units = max(units, diff / 2.0 ** (math.floor(math.log2(scale)) - 7))
        compared += 1
    return {"worst_rel": worst, "calls_compared": compared,
            "calls": len(calls), "logit_scale": scale_at,
            "worst_bf16_units": units}


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def mesh_serve_reference(workdir: str, floor: dict) -> dict:
    """(a) The three traffics on this process; each call's logits saved
    for the ranks.  Kernel 8 held against its plain version at the mesh's
    shapes: a decode step's plan restricted to the first rank's 192
    experts (local_plan)."""
    import os
    import torch
    from repro_torch.core import expert_parallel as ep_lib
    from repro_torch.core import router as router_lib
    from repro_torch.kernels import backend as backend_lib
    from repro_torch.models.transformer import _moe_args
    cfg, params = _mesh_params()
    out = {"expert_bytes": _expert_bytes(params)}
    for name, (sc_kw, trace) in _mesh_traffic().items():
        run = _mesh_serve_run(f"mesh one process {name}", cfg, params, sc_kw,
                              trace, gates=True)
        torch.save({k: run[k] for k in ("calls", "routes", "samples")},
                   os.path.join(workdir, f"ref_{name}.pt"))
        out[name] = {"streams": run["streams"], "summary": run["summary"]}
    # Kernel 8 on a rank's slab at the decode shape.
    a = _moe_args(cfg, decode=True)
    moe = params["blocks"]["periods"]["pos0"]["moe"]
    layer = {k: (v[0] if not isinstance(v, dict) else
                 {kk: vv[0] for kk, vv in v.items()}) for k, v in moe.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    x = torch.randn((N_REQUESTS, cfg.d_model), generator=gen,
                    device="cuda").to(layer["w1"].dtype)
    bk = backend_lib.resolve(a)
    dec = router_lib.build(a, topk_impl=bk.topk_impl).route(layer, x,
                                                            train=False)
    e_local = cfg.n_experts // MESH_SERVE[1]
    p = ep_lib.local_plan(dec.plan, 0, e_local)
    out["kernel8_mesh"] = _fused8_case(
        x, p, layer["w1"][:e_local], layer["w2"][:e_local],
        layer["w3"][:e_local], "mesh slab (192 experts, other rank's "
        "entries dropped)")
    # A rank's GMM on its slab of the dispatched buffer must give the
    # slab's rows of the whole call bit for bit (the serving schedule's
    # claim): both kernels, with the plan's rows.
    from repro_torch.kernels import gmm as gmm_lib
    buf = bk.dispatch(x, dec, a)
    for kernel in ("stream", "tile"):
        for half in (slice(0, e_local), slice(e_local, cfg.n_experts)):
            whole = gmm_lib.gmm(buf, layer["w1"], activation="silu",
                                rows=dec.rows, kernel=kernel)
            slab = gmm_lib.gmm(buf[half], layer["w1"][half],
                               activation="silu", rows=dec.rows[half],
                               kernel=kernel)
            check(bool(torch.equal(whole[half], slab)),
                  f"gmm {kernel}: a slab's rows differ from the whole "
                  "call's")
    out["gmm_slab_bitwise"] = True
    log("gmm stream / tile: each rank's slab of the decode buffer equals "
        "the whole call's rows bit for bit")
    out["tp_kernels"] = check_mesh_tp_kernels(x, dec, buf, layer)
    del params, layer, moe, buf
    log("mesh serve (a) one process " + json.dumps(
        {k: out[k]["summary"] for k in MESH_TRAFFIC}))
    return out


def _expert_bytes(params) -> int:
    """Bytes of the flat MoE's FFN leaves (w1, w2, w3) a process holds."""
    return sum(t.numel() * t.element_size()
               for layer in params["blocks"]["periods"].values()
               for k, t in layer["moe"].items() if k in ("w1", "w2", "w3"))


def check_mesh_tp_kernels(x, dec, buf, layer) -> dict:
    """(c)'s kernels at its shapes, on layer 0's weights: a rank's d_ff
    slice (the first 1024 of 2048 columns).  Kernel 6's f32 output (the
    down-projection of the decode buffer's up-projected slice, with the
    plan's rows, the streaming and the tiled kernel) against its plain
    version within GMM_F32_TOL of the output's scale, its bf16 output
    the f32 output's cast bit for bit; kernel 8 on the decode plan with
    the sliced weights against its plain version (two bf16 units)."""
    import torch
    from repro_torch.kernels import gmm as gmm_lib
    half = layer["w1"].shape[-1] // MESH_TP[0]
    w1, w3 = (layer[k][..., :half].contiguous() for k in ("w1", "w3"))
    w2 = layer["w2"][:, :half].contiguous()
    rows = dec.rows
    h = gmm_lib.gmm(buf, w1, activation="silu", rows=rows)
    h = (h.float() * gmm_lib.gmm(buf, w3, rows=rows).float()).to(h.dtype)
    want = gmm_lib.gmm_plain(h, w2, rows=rows, out_dtype=torch.float32)
    scale = float(want.abs().max())
    used = int((rows > 0).sum())
    e, c, _ = h.shape
    d = w2.shape[-1]
    b, by = bound_ms(used * half * d * 2 + e * c * half * 2 + e * c * d * 4,
                     2 * int(rows.sum()) * half * d, "bfloat16")
    out = {"scale": scale, "used_experts": used, "bound_ms": b,
           "bound_by": by}
    for kernel in ("stream", "tile"):
        def fn(kernel=kernel):
            return gmm_lib.gmm(h, w2, rows=rows, kernel=kernel,
                               out_dtype=torch.float32)
        got = fn()
        err = max_err(got, want)
        check(got.dtype == torch.float32 and err <= GMM_F32_TOL * scale,
              f"gmm {kernel} f32 output on a d_ff slice: {err} from its "
              f"plain version (tol {GMM_F32_TOL * scale})")
        cast = gmm_lib.gmm(h, w2, rows=rows, kernel=kernel)
        check(bool(torch.equal(cast, got.to(cast.dtype))),
              f"gmm {kernel}: the bf16 output is not the f32 output's cast")
        sym = f"gmm_{kernel}_kernel"
        out[kernel] = dict(max_abs_err=err, tol=GMM_F32_TOL * scale,
                           ms=cuda_ms(fn),
                           bf16_ms=cuda_ms(lambda k=kernel: gmm_lib.gmm(
                               h, w2, rows=rows, kernel=k)),
                           dev_ms=device_ms(fn, (sym,)).get(sym))
    out["plain_ms"] = cuda_ms(lambda: gmm_lib.gmm_plain(
        h, w2, rows=rows, out_dtype=torch.float32), reps=3, warmup=1)
    # The library's product on the same bf16 operands with an f32 result
    # (every expert: bmm reads no rows), through bmm's out_dtype where
    # this torch has it.
    try:
        torch.bmm(h[:1], w2[:1], out_dtype=torch.float32)
        out["library"] = "torch.bmm(out_dtype=torch.float32)"
        out["library_ms"] = cuda_ms(lambda: torch.bmm(
            h, w2, out_dtype=torch.float32))
    except (TypeError, RuntimeError):
        out["library"] = "torch.bmm(...).float()"
        out["library_ms"] = cuda_ms(lambda: torch.bmm(h, w2).float())
    log("mesh serve (c) gmm f32 output, d_ff slice [384, 8, 1024] x "
        "[384, 1024, 7168], rows: " + json.dumps(out))
    out["kernel8"] = _fused8_case(x, dec.plan, w1, w2, w3,
                                  f"d_ff slice ({half} of {2 * half})")
    return out


def _mesh_serve_rank(rank: int, world: int, model: int, workdir: str,
                     tp: bool = False) -> None:
    """One rank of phase 24 (a spawned process); ``tp``: part (c)."""
    import os
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    tag = "tp" if tp else "ep"
    dist.init_process_group(
        "gloo",
        init_method=f"file://{os.path.join(workdir, f'store_serve_{tag}')}",
        rank=rank, world_size=world)
    try:
        out = _mesh_serve_rank_body(rank, model, workdir, tp)
        with open(os.path.join(workdir, f"serve_{tag}_rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _mesh_serve_rank_body(rank: int, model: int, workdir: str,
                          tp: bool = False) -> dict:
    import os
    import torch
    from repro_torch.common import param as pm
    from repro_torch.core import expert_parallel as ep_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.sharding.context import MeshContext
    ctx = MeshContext.for_mesh(make_host_mesh(model, device="cuda"),
                               "decode_std")
    res = {"rank": rank, "mesh": ctx.sizes}
    t0 = time.perf_counter()
    cfg, params = _mesh_params(
        cut=lambda d, t: ctx.shard_leaf(t, ctx.resolve(d.shape, d.axes)))
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = ep_lib.serve_layout(params, lm.lm_defs(cfg), ctx)
    torch.cuda.synchronize()
    res["serve_layout_s"] = time.perf_counter() - t0
    res["param_gib"] = pm.param_bytes(params) / 2**30
    res["expert_bytes"] = _expert_bytes(params)
    torch.cuda.empty_cache()
    clock = _CollectiveClock()
    if tp:
        return _mesh_tp_runs(res, ctx, cfg, params, workdir, clock)
    for name, (sc_kw, trace) in _mesh_traffic().items():
        clock.ms, clock.bytes, clock.calls = {}, {}, {}
        clock.on = True
        with clock.in_decode() as dec:
            run = _mesh_serve_run(f"mesh rank {rank} {name}", cfg, params,
                                  sc_kw, trace, ctx=ctx)
        clock.on = False
        ref = torch.load(os.path.join(workdir, f"ref_{name}.pt"),
                         weights_only=False)["calls"]
        errs = _logit_errs(run["calls"], ref, run["first_slot"],
                           run["n_local"])
        check(errs["worst_rel"] <= MESH_LOGIT_TOL,
              f"mesh rank {rank} {name}: logits {errs['worst_rel']:.4g} of "
              f"the scale from one process (tol {MESH_LOGIT_TOL})")
        check(errs["calls_compared"] > 0,
              f"mesh rank {rank} {name}: no call compared")
        res[name] = dict(run["summary"], streams=run["streams"],
                         logits=errs, collective_ms=dict(clock.ms),
                         collective_bytes=dict(clock.bytes),
                         collective_calls=dict(clock.calls),
                         decode_collectives=dec)
        del ref, run
    return res


def _mesh_tp_runs(res, ctx, cfg, params, workdir, clock) -> dict:
    """(c) on one rank: each traffic with its inputs and routing pinned
    to (a)'s, its logits within MIXER_LOGIT_UNITS bf16 units of (a)'s
    on every call.  The fused traffic is held to (a)'s unfused run, as
    phase 29 holds jamba's: one process's fused decode routes inside
    kernel 7, with no top-k call to pin.  Each greedy token the rank
    picks is one process's or a near tie of its logits, where prompts
    are whole."""
    import os
    import torch
    for name, (sc_kw, trace) in _mesh_traffic().items():
        what = f"mesh tp rank {res['rank']} {name}"
        ref = torch.load(os.path.join(
            workdir, f"ref_{'serve' if name == 'fused' else name}.pt"),
            weights_only=False)
        pin = _TopkPin([c for call in ref["routes"] for c in call])
        run = _mesh_serve_run(what, cfg, params, sc_kw, trace, ctx=ctx,
                              follow=ref["samples"], pin=pin, clock=clock)
        errs = _logit_errs(run["calls"], ref["calls"], run["first_slot"],
                           run["n_local"])
        check(errs["calls_compared"] == len(ref["calls"]),
              f"{what}: {errs['calls_compared']} of {len(ref['calls'])} "
              "calls compared")
        check(errs["worst_bf16_units"] <= MIXER_LOGIT_UNITS,
              f"{what}: logits {errs['worst_bf16_units']:.3g} bf16 units "
              f"({errs['worst_rel']:.4g} of the scale) from one process "
              f"(tol {MIXER_LOGIT_UNITS} units)")
        # A chunk call that ends no prompt samples nothing, so the
        # samples pair with the calls only where prompts are whole.
        greedy = (None if sc_kw.get("prefill_chunk")
                  else _greedy_errs(run, ref))
        check(greedy is None or greedy["worst_gap_ratio"] <= 1.0,
              f"{what}: a greedy token differs from one process's beyond "
              f"a near tie ({json.dumps(greedy)})")
        check(pin.worst_ratio <= 1.0,
              f"{what}: a routing flip is no near tie (the recorded gap "
              f"{pin.worst_ratio:.3g} x twice the gate logits' difference)")
        check(sum(pin.flips) <= MIXER_MAX_FLIPS,
              f"{what}: {sum(pin.flips)} routing flips pinned (at most "
              f"{MIXER_MAX_FLIPS})")
        dec = run["decode_collectives"]
        res[name] = dict(run["summary"], streams=run["streams"],
                         logits=errs, greedy=greedy,
                         routing_flips=pin.flips,
                         flip_gap_ratio=pin.worst_ratio,
                         collective_ms=dict(clock.ms),
                         collective_bytes=dict(clock.bytes),
                         collective_calls=dict(clock.calls),
                         decode_collectives=dec,
                         decode_collective_share=(
                             sum(dec["ms"].values())
                             / run["summary"]["decode_ms_total"]))
        del ref, run
    return res


def _mesh_spawn(workdir: str, mesh: tuple, tp: bool) -> list:
    """The ranks of (b) or (c) on ``mesh``; their reports in rank
    order."""
    import os
    import torch.multiprocessing as mp
    data, model = mesh
    world = data * model
    try:
        mp.spawn(_mesh_serve_rank, args=(world, model, workdir, tp),
                 nprocs=world, join=True)
    except Exception as err:       # a rank failed: the phase fails
        raise SmokeFailure(f"mesh serve ranks {mesh}: {err}")
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"serve_{'tp' if tp else 'ep'}_rank"
                                        f"{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def phase_mesh_serve(floor: dict) -> dict:
    """Phase 24: (a) one process, (b) two ranks on mesh MESH_SERVE, (c)
    two ranks on MESH_TP."""
    import gc
    import torch
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        out["one"] = mesh_serve_reference(workdir, floor)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = _mesh_spawn(workdir, MESH_SERVE, False)
        out["spawn_wall_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        tp = _mesh_spawn(workdir, MESH_TP, True)
        out["tp_spawn_wall_s"] = time.perf_counter() - t1
    for name in MESH_TRAFFIC:
        one = out["one"][name]["streams"]
        for r in ranks:
            r[name]["stream_agreement"] = stream_agreement(r[name]["streams"],
                                                           one)
            check(r[name]["streams"] == ranks[0][name]["streams"],
                  f"mesh {name}: the ranks sampled different streams")
        log(f"mesh serve (b) {name} " + json.dumps(
            [{k: v for k, v in r[name].items() if k != "streams"}
             for r in ranks]))
    out["ranks"] = ranks
    want = out["one"]["expert_bytes"]
    for r in tp:
        check(r["expert_bytes"] * MESH_TP[0] == want,
              f"mesh tp rank {r['rank']}: {r['expert_bytes']} expert bytes, "
              f"one process {want}")
    for name in MESH_TRAFFIC:
        one = out["one"][name]["streams"]
        for r in tp:
            r[name]["stream_agreement"] = stream_agreement(r[name]["streams"],
                                                           one)
            check(r[name]["streams"] == tp[0][name]["streams"],
                  f"mesh tp {name}: the ranks sampled different streams")
            check(r[name]["stats"] == tp[0][name]["stats"],
                  f"mesh tp {name}: the ranks' engine stats differ")
        r0 = tp[0][name]
        log(f"mesh serve (c) {name} " + json.dumps(
            [{k: v for k, v in r[name].items() if k != "streams"}
             for r in tp]))
        log(f"mesh serve (c) {name} on {MESH_TP}: decode step "
            f"{r0['decode_step_ms_median']:.2f} ms a rank (one process "
            f"{out['one'][name]['summary']['decode_step_ms_median']:.2f}); "
            "collectives in decode (calls, bytes, share) "
            f"{json.dumps(r0['decode_collectives']['op_calls'])}, "
            f"{json.dumps(r0['decode_collectives']['bytes'])}, "
            f"{r0['decode_collective_share']:.3f}; peak "
            + ", ".join(f"{r[name]['peak_gib']:.2f}" for r in tp)
            + " GiB a rank; logits "
            + ", ".join(f"{r[name]['logits']['worst_bf16_units']:.3g}"
                        for r in tp)
            + f" bf16 units; stream agreement {r0['stream_agreement']:.3f}; "
            f"greedy {json.dumps(r0['greedy'])}; routing flips "
            f"{sum(r0['routing_flips'])} (worst gap ratio "
            f"{r0['flip_gap_ratio']:.3g})")
    log(f"mesh serve (c) resident experts a rank "
        + ", ".join(f"{r['expert_bytes']}" for r in tp)
        + f" B of one process's {want} (param GiB a rank "
        + ", ".join(f"{r['param_gib']:.2f}" for r in tp) + ")")
    out["tp"] = tp
    out["wall_s"] = time.perf_counter() - t0
    log(f"mesh serve phase {out['wall_s']:.1f} s ((c)'s ranks "
        f"{out['tp_spawn_wall_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 25: the GPipe pipeline
# ---------------------------------------------------------------------------

# qwen3-1.7b at full width in f32 (dense, homogeneous: no full-width
# MoE transformer pipelines on one card, PERF.md section 7), cut 28 ->
# PP_QWEN_LAYERS layers (to pay for phase 24 (c): the two ranks' first
# pipelined step took 26-33 s at 28 layers, PERF.md section 6), with
# PP_STEPS 1 (2 until phase 30 needed the time),
# pipelined over (stage 2, model 1) with PP_MICRO microbatches of the
# global batch PP_B x PP_S: the loss and every gradient against one
# process's lm_loss on the same weights, then PP_STEPS steps of
# make_pipeline_train_step (factored Adam), the last one's forward ticks
# timed.  Then the kimi-k2 family at --reduce widths (PP_KIMI_LAYERS
# layers) on (stage 2, model 2), four ranks: (c) the cuda backend
# against ref (loss, gradients) and exact launches a step; in the same
# ranks, after (c), (d) the row split: the reduced kimi with one row a
# microbatch (PP_ROW_B rows in as many microbatches), each row whole on
# both model ranks and its MoE layers splitting its tokens, at capacity
# factor PP_ROW_CF (no shard drops: the flat MoE's capacity is per
# shard), cuda against ref, the ranks' mean loss against one process's
# lm_loss (the mean over the microbatches, each with the pipeline's
# draws of it), exact launches; (e) the slice: moa-demo's period-1
# variant (every layer an MoA mixer and an MoE FFN) at its own widths
# in f32, PP_MICRO microbatches of PP_MOA_B x PP_MOA_S, MoA dropping at
# its own router's factor PP_MOA_CF (its global plan: one process's
# drops), the flat MoE FFN at PP_MOA_FFN_CF: the mean loss and every
# gradient leaf against one process's lm_loss on the card, cuda
# against ref, exact launches; then the reduced kimi with a (2, 4)
# hierarchical MoE one step, cuda against ref.  The one-process runs
# of (d) and (e) are on this process, before the spawn.
PP_B, PP_S, PP_MICRO, PP_STEPS = 4, 1024, 4, 1
PP_QWEN_LAYERS = 8
PP_MESH, PP_KIMI_MESH = (2, 1), (2, 2)
PP_KIMI_LAYERS, PP_KIMI_B, PP_KIMI_S = 4, 8, 32
# One process against the ranks, f32 with TF32 off: the loss within
# PP_LOSS_TOL relative, each gradient leaf within PP_GRAD_TOL normwise
# (the ranks reduce the embedding's and the softmax's gradients in
# other orders); cuda against ref on the reduced kimi within
# PP_KIMI_TOL (the GMM's 3xTF32 against f32 matmuls).
PP_LOSS_TOL, PP_GRAD_TOL, PP_KIMI_TOL = 1e-5, 1e-4, 1e-4
PP_ROW_B, PP_ROW_CF = 4, 8.0
PP_MOA_B, PP_MOA_S, PP_MOA_CF, PP_MOA_FFN_CF = 8, 128, 1.0, 4.0
PP_MOA_GATES = (("blocks", "periods", "pos0", "moe", "gate", "wg"),
                ("blocks", "periods", "pos0", "moa", "gate", "wg"))
PP_HMOE = (2, 4)


def _pp_qwen_cfg():
    import torch
    from repro_torch.configs.base import get_config
    return get_config(QWEN, n_layers=PP_QWEN_LAYERS,
                      param_dtype=torch.float32, compute_dtype=torch.float32)


def _pp_batch(vocab, b, s):
    from repro_torch.data.pipeline import DataConfig, batch_at
    return batch_at(DataConfig(vocab_size=vocab, seq_len=s, batch_size=b,
                               seed=SEED), 0, device="cuda")


def _pp_cut(pp, n_stages):
    """materialize's cut for the pipeline layout: a stacked [L, ...]
    block leaf read as [n_stages, L / n_stages, ...] with a leading
    stage axis, then each leaf this rank's slice by the pipeline plan."""
    def cut(d, t):
        shape, axes = d.shape, d.axes
        if axes[0] == "layers":
            shape = (n_stages, shape[0] // n_stages) + shape[1:]
            axes = ("stage",) + axes
            t = t.reshape(shape)
        return pp.shard_leaf(t, pp.resolve(shape, axes))
    return cut


def _as_pipeline_tree(params):
    return dict(params, blocks=params["blocks"]["periods"]["pos0"])


def pp_reference(workdir: str) -> dict:
    """(a) qwen3 f32 on this process: lm_loss of the global batch and its
    gradients (saved in the pipeline layout for the ranks)."""
    import os
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models import lm
    cfg = _pp_qwen_cfg()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    for p in pm.tree_leaves(params):
        p.requires_grad_(True)
    batch = _pp_batch(cfg.vocab_size, PP_B, PP_S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, m = lm.lm_loss(params, batch, cfg, train=False)
    loss.backward()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    n_stages = PP_MESH[0]

    def restack(t):
        return t.reshape((n_stages, t.shape[0] // n_stages) + t.shape[1:])
    grads = _as_pipeline_tree(pm.tree_map(lambda p: p.grad.detach().cpu(),
                                          params))
    grads["blocks"] = pm.tree_map(restack, grads["blocks"])
    torch.save(grads, os.path.join(workdir, "pp_ref_grads.pt"))
    out = {"loss": float(loss.detach()), "xent": float(m["xent"].detach()),
           "fwd_bwd_ms": step_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "parameters": sum(p.numel() for p in pm.tree_leaves(params))}
    log("pipeline (a) one process " + json.dumps(out))
    del params, grads, loss
    return out


class _TickClock:
    """Wraps MeshContext.shift and pipeline_stack_apply while on: a
    device sync and a host time stamp when each forward tick's shift has
    delivered its input (each tick begins with one shift) and at the end
    of the forward ticks (the outputs' stage sum), so a tick's time is
    its own work and the wait for the next tick's input."""

    def __init__(self):
        import torch
        from repro_torch.sharding.context import MeshContext
        from repro_torch.train import pipeline as pp_lib
        real_shift, real_apply = MeshContext.shift, pp_lib.pipeline_stack_apply
        self.stamps, self.on = [], False
        clock = self

        def stamp():
            if clock.on:
                torch.cuda.synchronize()
                clock.stamps.append(time.perf_counter())

        def shift(ctx, x, axis, step=1):
            out = real_shift(ctx, x, axis, step)
            stamp()
            return out

        def apply(*args, **kw):
            out = real_apply(*args, **kw)
            stamp()
            return out
        MeshContext.shift = shift
        pp_lib.pipeline_stack_apply = apply


def _pp_rank(rank: int, world: int, model: int, workdir: str,
             which: str) -> None:
    """One rank of phase 25 (a spawned process)."""
    import os
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store_' + which)}",
        rank=rank, world_size=world)
    try:
        body = _pp_qwen_rank if which == "qwen" else _pp_kimi_rank
        out = body(rank, model, workdir)
        with open(os.path.join(workdir, f"{which}_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _pp_grads(pp, local, loss, defs):
    """``loss / world`` back-propagated, each gradient summed over the
    ranks that hold replicas of its leaf (make_pipeline_train_step's
    gradients)."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.train.trainer import _sum_replicas
    (loss / pp.world).backward()
    grads = pm.tree_map(lambda p: (torch.zeros_like(p) if p.grad is None
                                   else p.grad), local)
    _sum_replicas(pp, grads, pp.specs(defs))
    return grads


def _pp_qwen_rank(rank: int, model: int, workdir: str) -> dict:
    import math
    import os
    import torch
    from repro_torch.common import param as pm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.sharding.context import MeshContext
    from repro_torch.train import pipeline as pp_lib
    ctx = MeshContext.for_mesh(make_host_mesh(model, device="cuda"),
                               "dp_tp_ep")
    n_stages = ctx.sizes["data"]
    pp = pp_lib.pipeline_context(ctx)
    cfg = _pp_qwen_cfg()
    defs = pp_lib.pipeline_param_defs(cfg, n_stages)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    local = _as_pipeline_tree(pm.materialize(lm.lm_defs(cfg), gen, "cuda",
                                             cut=_pp_cut(pp, n_stages)))
    for p in pm.tree_leaves(local):
        p.requires_grad_(True)
    batch = _pp_batch(cfg.vocab_size, PP_B, PP_S)
    res = {"rank": rank, "mesh": ctx.sizes, "stage": pp.index(("data",))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, m = pp_lib.pipeline_lm_loss(local, batch, cfg, ctx=ctx,
                                      n_stages=n_stages, n_micro=PP_MICRO,
                                      train=False)
    grads = _pp_grads(pp, local, loss, defs)
    torch.cuda.synchronize()
    res["fwd_bwd_ms"] = 1e3 * (time.perf_counter() - t0)
    res["loss"] = float(m["loss"].detach())
    res["grads"] = _leaf_errs(pp, grads, torch.load(
        os.path.join(workdir, "pp_ref_grads.pt"), mmap=True,
        weights_only=True), defs)
    del grads
    for p in pm.tree_leaves(local):
        p.grad = None
    torch.cuda.empty_cache()
    oc = opt_lib.OptConfig(kind="factored")
    state = {"params": local, "opt": opt_lib.init(local, oc)}
    step = pp_lib.make_pipeline_train_step(cfg, oc, ctx=ctx,
                                           n_stages=n_stages,
                                           n_micro=PP_MICRO)
    ticks = _TickClock()
    losses, times = [], []
    for i in range(PP_STEPS):
        ticks.on = i == PP_STEPS - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, sm = step(state, batch, None)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        ticks.on = False
        losses.append(float(sm["loss"]))
        check(math.isfinite(losses[-1]), f"pipeline rank {rank}: loss "
              f"{losses[-1]} at step {i}")
    sid = res["stage"]
    stamps = ticks.stamps
    tick_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    live = [PP_MICRO > t - sid >= 0 for t in range(len(tick_ms))]
    res.update({
        "step_ms": times, "step_losses": losses,
        "forward_tick_ms": tick_ms, "forward_ms": sum(tick_ms),
        "forward_bubble_share": (sum(t for t, ok in zip(tick_ms, live)
                                     if not ok) / max(sum(tick_ms), 1e-9)),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    return res


def _pp_kimi_cfg(backend: str):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import reduced
    return reduced(get_config(ARCH)).replace(n_layers=PP_KIMI_LAYERS,
                                             kernel_backend=backend)


def pp_kimi_launches() -> dict:
    """One MoE layer's launches in a training step's forward and backward
    (lm_loss of the reduced kimi on this process, over its layers)."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    cfg = _pp_kimi_cfg("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = pm.materialize(lm.lm_defs(cfg), gen, "cuda")
    for p in pm.tree_leaves(params):
        p.requires_grad_(True)
    batch = _pp_batch(cfg.vocab_size, PP_KIMI_B, PP_KIMI_S)
    cuda_lib.reset_launch_counts()
    loss, _ = lm.lm_loss(params, batch, cfg, generator=gen)
    loss.backward()
    torch.cuda.synchronize()
    counts = cuda_lib.launch_counts()
    per = {k: v // cfg.n_layers for k, v in counts.items()}
    check(all(v == per[k] * cfg.n_layers for k, v in counts.items()),
          f"reduced kimi launches {counts} do not divide by its layers")
    return per


def _pp_kimi_rank(rank: int, model: int, workdir: str) -> dict:
    import torch
    from repro_torch.common import param as pm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.sharding.context import MeshContext
    from repro_torch.train import pipeline as pp_lib
    ctx = MeshContext.for_mesh(make_host_mesh(model, device="cuda"),
                               "dp_tp_ep")
    n_stages = ctx.sizes["data"]
    pp = pp_lib.pipeline_context(ctx)

    def run(backend):
        cfg = _pp_kimi_cfg(backend)
        defs = pp_lib.pipeline_param_defs(cfg, n_stages)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        local = _as_pipeline_tree(pm.materialize(
            lm.lm_defs(cfg), gen, "cuda", cut=_pp_cut(pp, n_stages)))
        for p in pm.tree_leaves(local):
            p.requires_grad_(True)
        batch = _pp_batch(cfg.vocab_size, PP_KIMI_B, PP_KIMI_S)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        loss, m = pp_lib.pipeline_lm_loss(local, batch, cfg, ctx=ctx,
                                          n_stages=n_stages,
                                          n_micro=PP_MICRO, generator=gen)
        return float(m["loss"].detach()), _pp_grads(pp, local, loss, defs)
    res = {"rank": rank, "mesh": ctx.sizes, **_pp_backends(run),
           "per_stage_layers": pp_lib.stages_for(_pp_kimi_cfg("cuda"),
                                                 n_stages)[0]}
    del res["grads"]
    res["slice"] = _pp_slice_rank(ctx, pp, n_stages, workdir)
    return res


def _pp_moa_cfg(backend: str):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.router import RouterSpec
    return get_config(MOA_ARCH, period=1, moa_positions=(0,),
                      moe_positions=(0,), param_dtype=torch.float32,
                      compute_dtype=torch.float32,
                      capacity_factor=PP_MOA_FFN_CF,
                      moa_router=RouterSpec(capacity_factor=PP_MOA_CF),
                      kernel_backend=backend)


def _pp_slice_cfg(name: str, backend: str):
    if name == "rows":
        return _pp_kimi_cfg(backend).replace(capacity_factor=PP_ROW_CF)
    return _pp_moa_cfg(backend)


def _pp_slice_case(name: str, backend: str, pp=None) -> tuple:
    """(d)'s ("rows") or (e)'s ("moa") config, parameters (whole, or
    with ``pp`` this rank's slices in the pipeline layout), global batch,
    the pipeline's draws and microbatch count."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models import lm
    from repro_torch.train import pipeline as pp_lib
    n_stages = PP_KIMI_MESH[0]
    cut = None if pp is None else _pp_cut(pp, n_stages)
    cfg = _pp_slice_cfg(name, backend)
    if name == "rows":
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = pm.materialize(lm.lm_defs(cfg), gen, "cuda", cut=cut)
        b, s, n_micro = PP_ROW_B, PP_KIMI_S, PP_ROW_B
    else:
        params = _seeded(lm.lm_defs(cfg), SEED + 30, PP_MOA_GATES,
                         cfg.d_model, cut)
        b, s, n_micro = PP_MICRO * PP_MOA_B, PP_MOA_S, PP_MICRO
    if pp is not None:
        params = _as_pipeline_tree(params)
    for p in pm.tree_leaves(params):
        p.requires_grad_(True)
    batch = _pp_batch(cfg.vocab_size, b, s)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    draws = pp_lib.make_draws(cfg, n_micro, n_stages, b // n_micro, s, gen,
                              "cuda")
    return cfg, params, batch, draws, n_micro


def pp_slice_reference(workdir: str) -> dict:
    """(d) and (e) on this process: the mean over the microbatches of
    lm_loss, microbatch mb's layer l drawing the pipeline's noise of
    (mb, l // per, l % per), back-propagated with the launches zeroed
    just before and read just after; (e)'s gradients saved in the
    pipeline layout for the ranks."""
    import os
    import torch
    from repro_torch.common import param as pm
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.train import pipeline as pp_lib
    n_stages = PP_KIMI_MESH[0]
    t0 = time.perf_counter()
    out = {}
    for name in ("rows", "moa"):
        cfg, params, batch, draws, n_micro = _pp_slice_case(name, "cuda")
        per = pp_lib.stages_for(cfg, n_stages)[0]
        b = batch["tokens"].shape[0] // n_micro
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        total = 0.0
        for mb in range(n_micro):
            d = {k: [v[mb][i // per][i % per] for i in range(cfg.n_layers)]
                 for k, v in draws.items()}
            loss, _ = lm.lm_loss(params, {k: v[mb * b:(mb + 1) * b]
                                          for k, v in batch.items()}, cfg,
                                 draws=d)
            total = total + loss
        loss = total / n_micro
        loss.backward()
        torch.cuda.synchronize()
        out[name] = {"loss": float(loss.detach()),
                     "launches": cuda_lib.launch_counts()}
        if name == "moa":
            grads = _as_pipeline_tree(pm.tree_map(
                lambda p: p.grad.detach().cpu(), params))
            grads["blocks"] = pm.tree_map(
                lambda t: t.reshape((n_stages, per) + t.shape[1:]),
                grads["blocks"])
            torch.save(grads, os.path.join(workdir, "pp_moa_grads.pt"))
        del params, loss, total
    out["s"] = time.perf_counter() - t0
    log("pipeline (d)/(e) one process " + json.dumps(out))
    return out


def _pp_backends(run) -> dict:
    """``run(backend) -> (loss, grads)`` for cuda and ref, the launches
    zeroed just before each and read just after: the cuda run's loss,
    launches and gradients against ref's."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.kernels import cuda_lib
    out = {}
    for backend in ("cuda", "ref"):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        loss, grads = run(backend)
        torch.cuda.synchronize()
        out[backend] = {"loss": loss, "launches": cuda_lib.launch_counts(),
                        "grads": pm.tree_map(lambda g: g.detach().clone(),
                                             grads)}
    return {"loss": {b: out[b]["loss"] for b in out},
            "loss_rel_err": abs(out["cuda"]["loss"] - out["ref"]["loss"])
            / abs(out["ref"]["loss"]),
            "grad_norm_rel": {
                name: norm_rel_err(g, r) for (name, g), r in zip(
                    _named_leaves(out["cuda"]["grads"]),
                    pm.tree_leaves(out["ref"]["grads"]))},
            "launches": out["cuda"]["launches"],
            "ref_launches": out["ref"]["launches"],
            "grads": out["cuda"]["grads"]}


def _pp_slice_rank(ctx, pp, n_stages: int, workdir: str) -> dict:
    """(d) and (e) on this rank (the one-process references beside the
    spawn), then the hierarchical kimi's step."""
    import os
    import torch
    from repro_torch.common import param as pm
    from repro_torch.models import lm
    from repro_torch.train import pipeline as pp_lib
    t0 = time.perf_counter()
    res = {}
    for name in ("rows", "moa"):
        cfg = _pp_slice_cfg(name, "cuda")
        defs = pp_lib.pipeline_param_defs(cfg, n_stages)

        def run(backend):
            cfg, local, batch, draws, n_micro = _pp_slice_case(
                name, backend, pp)
            loss, m = pp_lib.pipeline_lm_loss(
                local, batch, cfg, ctx=ctx, n_stages=n_stages,
                n_micro=n_micro, draws=draws)
            return float(m["loss"].detach()), _pp_grads(pp, local, loss,
                                                        defs)
        r = _pp_backends(run)
        grads = r.pop("grads")
        r["per_stage_layers"] = pp_lib.stages_for(cfg, n_stages)[0]
        if name == "moa":
            errs = _leaf_errs(pp, grads, torch.load(
                os.path.join(workdir, "pp_moa_grads.pt"), mmap=True,
                weights_only=True), defs)
            r["grads_vs_one"] = {k: e["norm_rel"] for k, e in errs.items()}
            r["finite"] = all(e["finite"] for e in errs.values())
        res[name] = r
        del grads

    def hmoe(backend):
        cfg = _pp_kimi_cfg(backend).replace(moe_hierarchical=PP_HMOE)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        local = _as_pipeline_tree(pm.materialize(
            lm.lm_defs(cfg), gen, "cuda", cut=_pp_cut(pp, n_stages)))
        for p in pm.tree_leaves(local):
            p.requires_grad_(True)
        batch = _pp_batch(cfg.vocab_size, PP_KIMI_B, PP_KIMI_S)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        loss, m = pp_lib.pipeline_lm_loss(local, batch, cfg, ctx=ctx,
                                          n_stages=n_stages,
                                          n_micro=PP_MICRO, generator=gen)
        return (float(m["loss"].detach()), _pp_grads(
            pp, local, loss, pp_lib.pipeline_param_defs(cfg, n_stages)))
    res["hmoe"] = _pp_backends(hmoe)
    del res["hmoe"]["grads"]
    res["s"] = time.perf_counter() - t0
    return res


def _pp_spawn(workdir: str, mesh: tuple, which: str) -> list:
    import os
    import torch.multiprocessing as mp
    data, model = mesh
    world = data * model
    try:
        mp.spawn(_pp_rank, args=(world, model, workdir, which), nprocs=world,
                 join=True)
    except Exception as err:           # a rank failed: the phase fails
        raise SmokeFailure(f"pipeline {which} ranks on {mesh}: {err}")
    reports = []
    for r in range(world):
        with open(os.path.join(workdir, f"{which}_rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def phase_pipeline() -> dict:
    """Phase 25: (a) qwen3 on one process, (b) its pipeline on PP_MESH,
    (c) the reduced kimi on PP_KIMI_MESH, cuda against ref."""
    import gc
    import torch
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        ref = pp_reference(workdir)
        gc.collect()
        torch.cuda.empty_cache()
        ranks = _pp_spawn(workdir, PP_MESH, "qwen")
    worst = {"loss_rel": 0.0, "grad_norm_rel": 0.0}
    for r in ranks:
        rel = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        worst["loss_rel"] = max(worst["loss_rel"], rel)
        check(rel <= PP_LOSS_TOL, f"pipeline rank {r['rank']}: loss "
              f"{r['loss']} vs one process {ref['loss']} (rel {rel:.3g})")
        for name, e in r["grads"].items():
            check(e["finite"], f"pipeline rank {r['rank']}: {name} not "
                  "finite")
            worst["grad_norm_rel"] = max(worst["grad_norm_rel"],
                                         e["norm_rel"])
            check(e["norm_rel"] <= PP_GRAD_TOL,
                  f"pipeline rank {r['rank']}: gradient {name} "
                  f"{e['norm_rel']:.3g} normwise from one process")
        r["grads"] = {k: e["norm_rel"] for k, e in r["grads"].items()}
    check(ranks[0]["step_losses"] == ranks[1]["step_losses"],
          "pipeline: the ranks' step losses differ")
    out["qwen"] = {"one": ref, "ranks": ranks, "worst": worst}
    log("pipeline (b) qwen3 " + json.dumps(out["qwen"]))
    per_layer = pp_kimi_launches()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        one = pp_slice_reference(workdir)
        gc.collect()
        torch.cuda.empty_cache()
        kimi = _pp_spawn(workdir, PP_KIMI_MESH, "kimi")
    for r in kimi:
        want = {k: v * PP_MICRO * r["per_stage_layers"]
                for k, v in per_layer.items()}
        check(r["launches"] == want, f"pipeline kimi rank {r['rank']}: "
              f"launches {r['launches']}, expected {want}")
        check(not r["ref_launches"], f"pipeline kimi rank {r['rank']}: the "
              f"ref backend launched {r['ref_launches']}")
        check(r["loss_rel_err"] <= PP_KIMI_TOL, f"pipeline kimi rank "
              f"{r['rank']}: cuda vs ref loss {r['loss_rel_err']:.3g}")
        for name, e in r["grad_norm_rel"].items():
            check(e <= PP_KIMI_TOL, f"pipeline kimi rank {r['rank']}: "
                  f"gradient {name} cuda vs ref {e:.3g} normwise")
    slices = [r.pop("slice") for r in kimi]
    out["kimi"] = {"per_layer_launches": per_layer, "ranks": kimi}
    log("pipeline (c) kimi " + json.dumps(out["kimi"]))
    out.update(check_pp_slice(one, slices, per_layer))
    out["wall_s"] = time.perf_counter() - t0
    log(f"pipeline phase {out['wall_s']:.1f} s")
    return out


def check_pp_slice(one: dict, ranks: list, per_layer: dict) -> dict:
    """Phase 25 (d) and (e)'s gates on the ranks' reports (``one``: the
    one-process runs): the ranks' mean loss against one process's,
    cuda against ref, the launches a step; (e)'s gradients against one
    process's; the hierarchical step cuda against ref.  Logs the table
    and the seconds the parts added."""
    out = {}
    for name, what in (("rows", "(d) one row a microbatch"),
                       ("moa", "(e) moa-demo period 1")):
        reps = [r[name] for r in ranks]
        mean = statistics.fmean(r["loss"]["cuda"] for r in reps)
        rel = abs(mean - one[name]["loss"]) / abs(one[name]["loss"])
        check(rel <= PP_LOSS_TOL, f"pipeline {what}: the ranks' mean loss "
              f"{mean} vs one process {one[name]['loss']} (rel {rel:.3g})")
        per = reps[0]["per_stage_layers"]
        if name == "rows":
            want = {k: v * PP_ROW_B * per for k, v in per_layer.items()}
        else:
            n = _pp_moa_cfg("cuda").n_layers
            check(all(v * per % n == 0
                      for v in one[name]["launches"].values()),
                  f"pipeline {what}: one process's launches "
                  f"{one[name]['launches']} do not divide by its layers")
            want = {k: v * per // n for k, v in one[name]["launches"].items()}
        worst = {"cuda_vs_ref_loss": 0.0, "cuda_vs_ref_grad": 0.0,
                 "vs_one_grad": 0.0}
        for i, r in enumerate(reps):
            check(r["launches"] == want, f"pipeline {what} rank {i}: "
                  f"launches {r['launches']}, expected {want}")
            check(not r["ref_launches"], f"pipeline {what} rank {i}: the ref "
                  f"backend launched {r['ref_launches']}")
            check(r["loss_rel_err"] <= PP_KIMI_TOL, f"pipeline {what} rank "
                  f"{i}: cuda vs ref loss {r['loss_rel_err']:.3g}")
            worst["cuda_vs_ref_loss"] = max(worst["cuda_vs_ref_loss"],
                                            r["loss_rel_err"])
            for leaf, e in r["grad_norm_rel"].items():
                check(e <= PP_KIMI_TOL, f"pipeline {what} rank {i}: "
                      f"gradient {leaf} cuda vs ref {e:.3g} normwise")
                worst["cuda_vs_ref_grad"] = max(worst["cuda_vs_ref_grad"],
                                                e)
            if name == "moa":
                check(r["finite"], f"pipeline {what} rank {i}: a gradient is "
                      "not finite")
                for leaf, e in r["grads_vs_one"].items():
                    check(e <= PP_GRAD_TOL, f"pipeline {what} rank {i}: "
                          f"gradient {leaf} {e:.3g} normwise from one "
                          "process")
                    worst["vs_one_grad"] = max(worst["vs_one_grad"], e)
        out[name] = {"one": one[name], "mean_loss": mean, "loss_rel": rel,
                     "launches": reps[0]["launches"], "worst": worst,
                     "ranks": reps}
        log(f"pipeline {what}: mean loss {mean} vs one process "
            f"{one[name]['loss']} (rel {rel:.3g}); worst "
            f"{json.dumps(worst)}; launches a rank {json.dumps(want)}")
    hm = [r["hmoe"] for r in ranks]
    for i, r in enumerate(hm):
        check(not r["ref_launches"], f"pipeline (e) hierarchical rank {i}: "
              f"the ref backend launched {r['ref_launches']}")
        check(r["loss_rel_err"] <= PP_KIMI_TOL, f"pipeline (e) hierarchical "
              f"rank {i}: cuda vs ref loss {r['loss_rel_err']:.3g}")
        for leaf, e in r["grad_norm_rel"].items():
            check(e <= PP_KIMI_TOL, f"pipeline (e) hierarchical rank {i}: "
                  f"gradient {leaf} cuda vs ref {e:.3g} normwise")
    out["hmoe"] = {"ranks": hm, "launches": hm[0]["launches"],
                   "worst_grad": max(max(r["grad_norm_rel"].values())
                                     for r in hm),
                   "worst_loss": max(r["loss_rel_err"] for r in hm)}
    log("pipeline (e) hierarchical kimi " + json.dumps(out["hmoe"]))
    slowest = max(r["s"] for r in ranks)
    out["added_s"] = one["s"] + slowest
    log(f"pipeline (d)/(e) added {out['added_s']:.1f} s (one process "
        f"{one['s']:.1f} s, the ranks' slowest {slowest:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 26: the roofline of every full-width path the smoke runs
# ---------------------------------------------------------------------------

# Every record is a cell of one card: the mesh (data 1, model 1) under
# the plan of its kind.  FlopCounterMode against the analytic FLOPs: the
# reference's band against XLA (tests/test_roofline.py).  The decode
# step's wire bytes on phase 24's mesh against the analytic's.
ROOF_MESH = {"data": 1, "model": 1}
ROOF_PLANS = {"train": "dp_tp_ep", "prefill": "prefill_tp",
              "decode": "decode_std"}
ROOF_FLOP_BAND = (0.7, 1.45)
ROOF_WIRE_TOL = 0.10


def flop_count(what: str, fn) -> dict:
    """FlopCounterMode's count of the aten products ``fn`` runs (the
    port's ctypes launches are invisible to it): the total and the top
    ops."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    by_op = counter.get_flop_counts().get("Global", {})
    top = sorted(((str(op), n) for op, n in by_op.items()),
                 key=lambda kv: -kv[1])[:6]
    out = {"flops": counter.get_total_flops(), "top_ops": top}
    log(f"{what}: FlopCounterMode " + json.dumps(out))
    return out


def roofline_record(path: str, cfg, kind: str, batch: int, seq: int,
                    ms: float, peak_gib: float) -> dict:
    """One path's roofline on this card: the analytic counts of one step
    (``launch/analytic.py``) at its own B and S (a decode step's S is
    its page length), the terms and bound (``launch/roofline.py``), and
    the step's measured median: bound_share = bound / measured, mfu =
    model FLOPs / (measured x the peak of the compute dtype); the
    resident estimate beside the measured peak."""
    import math
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import analytic, roofline
    plan = ROOF_PLANS[kind]
    ana = analytic.analyze_cell(cfg, ShapeSpec(path, kind, seq, batch),
                                ROOF_MESH, plan)
    rec = {"arch": cfg.name, "shape": path, "mesh": "h100", "plan": plan,
           "status": "ok", "kind": kind, "global_batch": batch,
           "seq_len": seq, "n_layers": cfg.n_layers, "n_devices": 1,
           "analytic": dict(flops_per_dev=ana.flops_per_dev,
                            hbm_bytes_per_dev=ana.hbm_bytes_per_dev,
                            wire_bytes_per_dev=ana.wire_bytes_per_dev,
                            **ana.detail)}
    ro = roofline.analyze(rec, cfg)
    bound = 1e3 * ro.bound_step_s
    rec["roofline"] = {
        "compute_s": ro.compute_s, "memory_s": ro.memory_s,
        "collective_s": ro.collective_s, "dominant": ro.dominant,
        "model_flops": ro.model_flops, "useful_ratio": ro.useful_ratio,
        "roofline_fraction": roofline.roofline_fraction(ro, 1)}
    rec.update(bound_ms=bound, measured_ms=ms, bound_share=bound / ms,
               mfu=ro.model_flops / (ms / 1e3 * ro.peak_flops),
               resident_gib=ana.detail["resident_bytes_per_dev"] / 2**30,
               measured_peak_bytes=peak_gib * 2**30)
    log("roofline " + json.dumps({k: rec[k] for k in (
        "arch", "shape", "kind", "global_batch", "seq_len", "n_layers",
        "bound_ms", "measured_ms", "bound_share", "mfu", "resident_gib")}
        | {"measured_peak_gib": peak_gib, "flops": ana.flops_per_dev,
           "hbm_bytes": ana.hbm_bytes_per_dev,
           "compute_ms": 1e3 * ro.compute_s, "memory_ms": 1e3 * ro.memory_s,
           "dominant": ro.dominant}))
    terms = (ana.flops_per_dev, ana.hbm_bytes_per_dev, ro.compute_s,
             ro.memory_s, bound, ms, rec["bound_share"], rec["mfu"],
             rec["resident_gib"])
    check(all(math.isfinite(t) and t > 0 for t in terms),
          f"roofline {path}: a term is not finite and positive {terms}")
    check(math.isfinite(ana.wire_bytes_per_dev),
          f"roofline {path}: wire bytes {ana.wire_bytes_per_dev}")
    return rec


def phase_roofline(paths: list, flops: dict, mesh: dict) -> dict:
    """Phase 26: arithmetic on the host over what earlier phases
    measured; times nothing.  (a) a roofline record of each path in
    ``paths`` ((name, cfg, kind, B, S, measured ms, measured peak GiB)),
    printed as a line, written as JSON lines under chiprun_out/ and as
    launch/report.py's tables; gate: bound <= measured (a bound above a
    measured time is a wrong count).  moa-demo is left out (the
    reference's analytic has no branch for the moa mixer) and so is the
    paper LM (the reference has no analyze_cell for PaperLMConfig).
    (b) FlopCounterMode's counts (``flops``: name -> (cfg, kind, B, S,
    count)) against the analytic FLOPs of the same step, within
    ROOF_FLOP_BAND.  (c) phase 24's collective bytes a decode step
    (rank 0, inside lm_decode calls) against the analytic wire bytes
    of the same cell on mesh (data 1, model 2) under decode_std, within
    ROOF_WIRE_TOL.  Both sides count what a rank sends: the analytic
    ring-algorithm bytes ((g-1)/g of an all-gather's result, 2(g-1)/g of
    an all-reduce's tensor), the clock each call's input; at g = 2 the
    two are the same bytes."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import analytic, report
    t0 = time.perf_counter()
    recs = [roofline_record(*p) for p in paths]
    for r in recs:
        check(r["bound_ms"] <= r["measured_ms"],
              f"roofline {r['shape']}: bound {r['bound_ms']:.4g} ms above "
              f"the measured {r['measured_ms']:.4g} ms")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "roofline.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    print(report.roofline_table(recs, "h100"), flush=True)
    print(report.dryrun_table(recs, "h100"), flush=True)
    ratios = {}
    for name, (cfg, kind, b, s, count) in flops.items():
        ana = analytic.analyze_cell(cfg, ShapeSpec(name, kind, s, b),
                                    ROOF_MESH, ROOF_PLANS[kind])
        ratios[name] = ana.flops_per_dev / count["flops"]
        log(f"roofline (b) {name}: analytic {ana.flops_per_dev:.6g} / "
            f"FlopCounterMode {count['flops']:.6g} = {ratios[name]:.4f}; "
            f"top ops {count['top_ops']}")
        lo, hi = ROOF_FLOP_BAND
        check(lo <= ratios[name] <= hi,
              f"roofline (b) {name}: analytic / counted FLOPs "
              f"{ratios[name]:.4f} outside {ROOF_FLOP_BAND}")
    wire = {}
    for traffic, fused in (("serve", False), ("fused", True)):
        dec = mesh["ranks"][0][traffic]["decode_collectives"]
        measured = sum(dec["bytes"].values()) / dec["calls"]
        ana = analytic.analyze_cell(
            _mesh_cfg().replace(fused_decode=fused),
            ShapeSpec("mesh decode", "decode", PROMPT_LEN + NEW_TOKENS,
                      N_REQUESTS), dict(zip(("data", "model"), MESH_SERVE)),
            "decode_std")
        wire[traffic] = {"measured_bytes": measured,
                         "by_op": {k: v / dec["calls"]
                                   for k, v in dec["bytes"].items()},
                         "decode_calls": dec["calls"],
                         "analytic_bytes": ana.wire_bytes_per_dev,
                         "ratio": ana.wire_bytes_per_dev / measured}
        log(f"roofline (c) {traffic} decode step on {MESH_SERVE}: "
            + json.dumps(wire[traffic]))
        check(abs(wire[traffic]["ratio"] - 1) <= ROOF_WIRE_TOL,
              f"roofline (c) {traffic}: analytic wire "
              f"{ana.wire_bytes_per_dev:.6g} B against the measured "
              f"{measured:.6g} B a decode step")
    wall = time.perf_counter() - t0
    log(f"roofline phase {wall:.2f} s")
    return {"records": recs, "flop_ratios": ratios, "wire": wire,
            "wall_s": wall}


def roofline_counts(served, qwen3) -> dict:
    """name -> (cfg, kind, B, S, FlopCounterMode count) of the two
    counted steps: phase 4's kimi-k2 prefill on "ref", phase 14's qwen3
    forward and backward."""
    from repro_torch.configs.base import get_config
    return {"kimi-k2 prefill (ref)": (get_config(ARCH, n_layers=N_LAYERS),
                                      "prefill", N_REQUESTS, PROMPT_LEN,
                                      served["flops"]),
            "qwen3-1.7b train": (get_config(QWEN), "train", QWEN_B, QWEN_S,
                                 qwen3["flops"])}


def roofline_paths(served, arctic, qwen3, gemma, falcon, jamba,
                   blockwise) -> list:
    """(name, cfg, kind, B, S, measured ms, measured peak GiB) of each
    full-width transformer path: a prefill is one request (B 1) at the
    engine's prefill length, a decode step the whole slot pool over its
    page length, a chunk call one 512-token row; phase 14b's qwen3
    prompt of LONG_S tokens."""
    from repro_torch.configs.base import get_config

    def serve(name, cfg, summary, slots, page, fused=None):
        out = [(f"{name} prefill", cfg, "prefill", 1,
                max(summary["prefill_lengths"]),
                summary["prefill_ms_median"],
                summary["max_memory_allocated_gib"]),
               (f"{name} decode", cfg, "decode", slots, page,
                summary["decode_step_ms_median"],
                summary["max_memory_allocated_gib"])]
        if fused is not None:
            out.append((f"{name} fused decode",
                        cfg.replace(fused_decode=True), "decode", slots,
                        page, fused["decode_step_ms_median"],
                        fused["max_memory_allocated_gib"]))
        return out

    def train(name, cfg, b, s, summary, key):
        return (f"{name} train", cfg, "train", b, s, summary[key],
                summary["max_memory_allocated_gib"])
    kimi = get_config(ARCH, n_layers=N_LAYERS)
    prefix = served["prefix"]["on"]
    gcfg = get_config(GEMMA, n_layers=gemma["summary"]["n_layers"])
    fcfg = get_config(FALCON)
    jcfg = get_config(JAMBA, n_layers=JAMBA_SERVE_LAYERS)
    js = jamba["summary"]
    return [
        *serve("kimi-k2", kimi, served["summary"], N_REQUESTS,
               PROMPT_LEN + NEW_TOKENS, served["fused"]["summary"]),
        ("kimi-k2 chunk", kimi, "prefill", 1, PREFIX_CHUNK,
         prefix["chunk_call_ms_median"], prefix["max_memory_allocated_gib"]),
        train("arctic-480b", get_config(ARCTIC, n_layers=ARCTIC_LAYERS),
              ARCTIC_B, ARCTIC_S, arctic["summary"],
              "step_ms_median_steps_2_to_6"),
        train("qwen3-1.7b", get_config(QWEN), QWEN_B, QWEN_S, qwen3,
              "step_ms_median_steps_2_to_4"),
        ("qwen3-1.7b prefill 32k", get_config(QWEN), "prefill", 1, LONG_S,
         blockwise["prefill_ms"], blockwise["max_memory_allocated_gib"]),
        *serve("gemma3-27b", gcfg, gemma["summary"], GEMMA_REQUESTS,
               GEMMA_PROMPT + GEMMA_NEW),
        train("gemma3-27b", get_config(GEMMA).replace(
            n_layers=gcfg.period), GEMMA_TRAIN_B, GEMMA_TRAIN_S,
            gemma["train"], "step_ms_median_steps_2_to_3"),
        *serve("falcon-mamba-7b", fcfg, falcon["summary"], SSM_REQUESTS,
               SSM_PROMPT + SSM_NEW),
        train("falcon-mamba-7b", get_config(
            FALCON, n_layers=FALCON_TRAIN_LAYERS), FALCON_TRAIN_B,
            FALCON_TRAIN_S,
              falcon["train"]["summary"], "step_ms_median_steps_2_on"),
        *serve("jamba-v0.1-52b", jcfg, js, SSM_REQUESTS,
               SSM_PROMPT + SSM_NEW, js["fused"]),
        train("jamba-v0.1-52b", get_config(JAMBA,
                                           n_layers=JAMBA_TRAIN_LAYERS),
              JAMBA_TRAIN_B, JAMBA_TRAIN_S, jamba["train"]["summary"],
              "step_ms_median_steps_2_on")]


# ---------------------------------------------------------------------------
# phase 27: the dry run (launch/steps, launch/dryrun) against the card
# ---------------------------------------------------------------------------

# (b): the dry run's peak over the card's, on every path, within this band.
DRYRUN_BAND = (0.85, 1.15)
# (b)'s card peaks, one a path, appended by the phases that hold the
# models, and the traces of dryrun_plan(), made before phase 2.
DRYRUN_PATHS: list = []
DRYRUN_TRACED: dict = {}
# (a): each kernel wrapper against its meta branch at each path's shapes:
# name -> (T, E, k, d, f, C, dtype, expert activation, the cases run).
META_TRAIN = ("topk_gating", "topk_gating_bwd", "dispatch", "combine", "gmm",
              "gmm_bwd", "dispatch_bwd", "combine_bwd")
META_SERVE = ("topk_gating", "dispatch", "combine", "gmm")
META_FUSED = ("fused_decode", "fused_routed")
META_SHAPES = {
    "MoE-256 train": (TRAIN_B * TRAIN_S, 256, 4, 512, 1024, 128, "float32",
                      "relu", META_TRAIN + ("dispatch_eblock",
                                            "combine_eblock")),
    "kimi-k2 prefill": (PROMPT_LEN, 384, 8, 7168, 2048, 8, "bfloat16",
                        "swiglu", META_SERVE),
    "kimi-k2 decode": (N_REQUESTS, 384, 8, 7168, 2048, 8, "bfloat16",
                       "swiglu", META_SERVE + META_FUSED),
    "kimi-k2 chunk": (2 * PREFIX_CHUNK, 384, 8, 7168, 2048, PREFIX_C,
                      "bfloat16", "swiglu", META_SERVE),
    "arctic-480b train": (ARCTIC_B * ARCTIC_S, 128, 2, 7168, 4864, ARCTIC_C,
                          "bfloat16", "swiglu", META_TRAIN),
    "jamba prefill": (SSM_PROMPT, 16, 2, 4096, 14336, JAMBA_PREFILL_C,
                      "bfloat16", "swiglu", META_SERVE),
    "jamba decode": (SSM_REQUESTS, 16, 2, 4096, 14336, JAMBA_DECODE_C,
                     "bfloat16", "swiglu", META_SERVE + META_FUSED),
    "jamba train": (JAMBA_TRAIN_B * JAMBA_TRAIN_S, 16, 2, 4096, 14336,
                    JAMBA_TRAIN_C, "bfloat16", "swiglu", META_TRAIN),
}


def _storage_bytes(tree) -> int:
    """Bytes the caching allocator holds for the storages of ``tree``."""
    from repro_torch.common.param import tree_leaves
    from repro_torch.launch.dryrun import alloc_bytes
    return sum({id(t.untyped_storage()): alloc_bytes(
        t.untyped_storage().nbytes()) for t in tree_leaves(tree)}.values())


def _card_args(spec, cfg, params) -> tuple:
    """``spec``'s arguments on the card: the phase's parameters, a fresh
    optimizer state (build_step's OptConfig), random tokens, zero
    caches."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.optim import optimizers as opt_lib
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)

    def card(t):
        if t.dtype == torch.int32:
            return torch.randint(1, cfg.vocab_size, t.shape, generator=gen,
                                 device="cuda", dtype=torch.int32)
        return torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype)
    if spec.kind == "train":
        return ({"params": params, "opt": opt_lib.init(
            params, opt_lib.OptConfig(kind="factored"))},
            {k: card(v) for k, v in spec.args[1].items()}, SEED)
    _, inputs, cache, *rest = spec.args
    cache = pm.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device="cuda"), cache)
    if spec.kind == "prefill":
        return (params, {k: card(v) for k, v in inputs.items()}, cache)
    return (params, card(inputs), cache, rest[0].to("cuda"))


# (b)'s traces are host work only (over a minute for falcon's 64-layer
# training step), run in this many spawned processes beside phase 1's
# kernel build, so that no timed phase shares the host with them but
# phase 2, whose times are the card's own, beside the LONG_S path's
# (finish_traces).
TRACE_WORKERS = 3
_TRACES: dict = {}


def trace_pool():
    """TRACE_WORKERS worker processes (spawned: no CUDA) that trace the
    (b) paths on ``meta``.  Stopped by :func:`stop_trace_pool`."""
    if "pool" not in _TRACES:
        import multiprocessing
        # The workers inherit sys.path, which main() gave ROOT / "src".
        _TRACES["pool"] = multiprocessing.get_context("spawn").Pool(
            TRACE_WORKERS)
    return _TRACES["pool"]


def stop_trace_pool() -> None:
    pool = _TRACES.pop("pool", None)
    if pool is not None:
        pool.terminate()
        pool.join()


def trace_path(path: str, cfg, kind: str, b: int, s: int) -> dict:
    """``launch/steps.py``'s step for (``kind``, B ``b`` x S ``s``) on one
    card (mesh (1, 1): no process group), traced on ``meta``: its dry-run
    record (``launch/dryrun.py::cell_record``)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, steps
    plan = ROOF_PLANS[kind]
    shape = ShapeSpec(path, kind, s, b)
    spec = steps.build_step(cfg, shape, None, plan=plan)
    tr = dryrun.trace_step(spec, flops=False)
    return dryrun.cell_record(
        {"arch": cfg.name, "shape": path, "mesh": "h100", "plan": plan,
         "kind": kind, "global_batch": b, "seq_len": s,
         "n_layers": cfg.n_layers}, cfg, shape, ROOF_MESH, plan, spec, tr)


def dryrun_peak(path: str, cfg, kind: str, b: int, s: int, params) -> None:
    """Phase 27 (b) for one single-card full-width path, run by the phase
    that holds its model: one call of ``launch/steps.py``'s step for
    (``kind``, B ``b`` x S ``s``) on the card, on the phase's
    ``params`` (a training step updates them), its peak the bytes of
    the parameters plus what ``max_memory_allocated`` rose by over the
    call from before its other arguments were made.  (path, card peak,
    the arguments of :func:`trace_path`) goes to DRYRUN_PATHS; phase 27
    traces them and gates the ratio."""
    import torch
    from repro_torch.common.param import tree_leaves
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps
    t0 = time.perf_counter()
    shape = ShapeSpec(path, kind, s, b)
    plan = ROOF_PLANS[kind]
    spec = steps.build_step(cfg, shape, None, plan=plan)
    for p in tree_leaves(params):
        p.grad = None
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = _card_args(spec, cfg, params)
    torch.cuda.reset_peak_memory_stats()
    out = spec.fn(*args)
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated() - base + _storage_bytes(params)
    del out, args
    for p in tree_leaves(params):
        p.grad = None
    torch.cuda.empty_cache()
    card_s = time.perf_counter() - t0
    log(f"dryrun (b) {path}: the card's step peak {card / 2**30:.3f} GiB "
        f"({spec.microbatches} microbatch(es), {card_s:.1f} s)")
    DRYRUN_PATHS.append((path, card, card_s, (path, cfg, kind, b, s)))


def dryrun_plan() -> list:
    """Phase 27 (b)'s paths as their phases run them, the arguments of
    :func:`trace_path`: the phases' configs and shapes (gemma3 served at
    all its layers, as ``build_gemma`` does when they fit)."""
    from repro_torch.configs.base import get_config
    kimi = get_config(ARCH, n_layers=N_LAYERS)
    gemma = get_config(GEMMA)
    falcon = get_config(FALCON)
    jamba = get_config(JAMBA, n_layers=JAMBA_SERVE_LAYERS)
    page, ssm_page = PROMPT_LEN + NEW_TOKENS, SSM_PROMPT + SSM_NEW
    return [
        ("kimi-k2 prefill", kimi, "prefill", 1, PROMPT_LEN),
        ("kimi-k2 decode", kimi, "decode", N_REQUESTS, page),
        ("kimi-k2 fused decode", kimi.replace(fused_decode=True), "decode",
         N_REQUESTS, page),
        ("arctic-480b train", get_config(ARCTIC, n_layers=ARCTIC_LAYERS),
         "train", ARCTIC_B, ARCTIC_S),
        ("qwen3-1.7b train", get_config(QWEN), "train", QWEN_B, QWEN_S),
        ("qwen3-1.7b prefill 32k", get_config(QWEN), "prefill", 1, LONG_S),
        ("gemma3-27b prefill", gemma, "prefill", 1, GEMMA_PROMPT),
        ("gemma3-27b decode", gemma, "decode", GEMMA_REQUESTS,
         GEMMA_PROMPT + GEMMA_NEW),
        ("gemma3-27b train", gemma.replace(n_layers=gemma.period), "train",
         GEMMA_TRAIN_B, GEMMA_TRAIN_S),
        ("falcon-mamba-7b prefill", falcon, "prefill", 1, SSM_PROMPT),
        ("falcon-mamba-7b decode", falcon, "decode", SSM_REQUESTS, ssm_page),
        ("falcon-mamba-7b train", get_config(
            FALCON, n_layers=FALCON_TRAIN_LAYERS), "train", FALCON_TRAIN_B,
         FALCON_TRAIN_S),
        ("jamba-v0.1-52b prefill", jamba, "prefill", 1, SSM_PROMPT),
        ("jamba-v0.1-52b decode", jamba, "decode", SSM_REQUESTS, ssm_page),
        ("jamba-v0.1-52b fused decode", jamba.replace(fused_decode=True),
         "decode", SSM_REQUESTS, ssm_page),
        ("jamba-v0.1-52b train", get_config(JAMBA,
                                            n_layers=JAMBA_TRAIN_LAYERS),
         "train", JAMBA_TRAIN_B, JAMBA_TRAIN_S)]


def start_traces() -> list:
    """Every path of :func:`dryrun_plan` sent to :func:`trace_pool`, the
    longest traces first: phase 14b's LONG_S-token prompt (83.2 s on
    the H100's host: 58,240 block pairs), then the training steps and
    the deepest paths: (arguments, pending record) in the plan's
    order."""
    plan = dryrun_plan()
    pool = trace_pool()
    order = sorted(plan, key=lambda a: (a[4] < LONG_S, a[2] != "train",
                                        -a[1].n_layers))
    pending = {a[0]: pool.apply_async(trace_path, a) for a in order}
    return [(a, pending[a[0]]) for a in plan]


def finish_traces(started: list, late: bool = False) -> list:
    """Waits for :func:`start_traces`' records (DRYRUN_TRACED: path ->
    (arguments, record)), but not, unless ``late``, for the LONG_S-token
    path's: its one worker (83-110 s of trace on the H100's hosts, the
    longest by far) runs on beside phase 2, whose times are the card's
    own, and main calls this again with ``late`` for it after phase 2,
    before any phase timed on the host.  Stops the workers once nothing
    is pending; returns what still is."""
    t0 = time.perf_counter()
    pending = []
    for args, rec in started:
        if args[4] >= LONG_S and not late:
            pending.append((args, rec))
        else:
            DRYRUN_TRACED[args[0]] = (args, rec.get(timeout=900))
    if not pending:
        stop_trace_pool()
    log(f"dryrun (b): {len(started) - len(pending)} paths traced on meta "
        f"in {TRACE_WORKERS} workers ({len(pending)} still tracing), "
        f"{sum(r['trace_s'] for _, r in DRYRUN_TRACED.values()):.1f} s of "
        f"traces; waited {time.perf_counter() - t0:.1f} s for them "
        + ("after phase 2" if late else "after the kernel build"))
    return pending


def dryrun_records() -> list:
    """Phase 27 (b): each path's trace joined with its card peak; a path
    whose phase ran other arguments than the plan's is traced now."""
    recs = []
    for path, card, card_s, args in DRYRUN_PATHS:
        planned, rec = DRYRUN_TRACED.get(path, (None, None))
        if planned != args:
            log(f"dryrun (b) {path}: the phase ran other arguments than "
                f"dryrun_plan()'s ({args[1].name}, {args[1].n_layers} "
                f"layers, {args[2]} {args[3]} x {args[4]}); traced now")
            rec = trace_path(*args)
        peak = rec["memory"]["peak_bytes_per_device"]
        resident = rec["analytic"]["resident_bytes_per_dev"]
        rec.update(measured_peak_bytes=card, peak_ratio=peak / card,
                   resident_ratio=resident / card, card_s=card_s)
        log(f"dryrun (b) {path}: dry run {peak / 2**30:.3f} GiB, card "
            f"{card / 2**30:.3f} GiB, ratio {rec['peak_ratio']:.4f}; "
            f"analytic resident {resident / 2**30:.3f} GiB, ratio "
            f"{rec['resident_ratio']:.4f}; at the peak "
            + json.dumps({k: round(v / 2**30, 3)
                          for k, v in rec["memory"].items()})
            + f"; trace {rec['trace_s']:.1f} s")
        recs.append(rec)
    return recs


def _meta_inputs(t, e, k, d, f, c, dtype_name, gen) -> dict:
    """A path's kernel inputs on the card: a top-k plan of random logits
    at capacity ``c``, the expert weights zero (the bytes, not the
    values, are under test), cotangents of the outputs."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.kernels.topk_gating import topk_gating_plain
    dt = getattr(torch, dtype_name)
    logits = torch.randn(t, e, device="cuda", generator=gen)
    w, idx, _ = topk_gating_plain(logits, k, k + 1)
    p = dsp.plan(idx[:, :k].contiguous(), w, e, c)

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device="cuda")
    return dict(logits=logits, w=p.weight, idx=idx, eidx=p.expert_index,
                pos=p.position, rows=dsp.filled_rows(p),
                x=torch.randn(t, d, device="cuda", generator=gen).to(dt),
                buf=z(e, c, d), w1=z(e, d, f), w2=z(e, f, d), w3=z(e, d, f),
                wg=z(d, e, dtype=torch.float32),
                valid=torch.ones(t, device="cuda"),
                dw=z(t, k, dtype=torch.float32),
                dvals=z(t, k + 1, dtype=torch.float32), dy=z(t, d),
                dbuf=z(e, c, d), dh=z(e, c, f))


def _meta_run(name, e, k, c, act, e_block):
    """The call of case ``name`` on a dict of inputs (any device)."""
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels import fused_decode as kf
    from repro_torch.kernels import gmm as kg
    from repro_torch.kernels import topk_gating as kt

    def grads(fn, inputs, cotangent):
        import torch
        inputs = [x.detach().requires_grad_(True) for x in inputs]
        return torch.autograd.grad(fn(*inputs), inputs, cotangent)
    gmm_act = "silu" if act == "swiglu" else act
    return {
        "topk_gating": lambda a: kt.topk_gating(a["logits"], k, k + 1),
        "topk_gating_bwd": lambda a: kt.topk_gating_bwd(
            a["w"], a["idx"], a["dw"], a["dvals"], e),
        "dispatch": lambda a: kd.dispatch(a["x"], a["eidx"], a["pos"],
                                          n_experts=e, capacity=c),
        "combine": lambda a: kd.combine(a["buf"], a["w"], a["eidx"],
                                        a["pos"]),
        "dispatch_eblock": lambda a: kd.dispatch_eblock(
            a["x"], a["eidx"], a["pos"], n_experts=e, capacity=c,
            e_block=e_block),
        "combine_eblock": lambda a: kd.combine_eblock(
            a["buf"], a["w"], a["eidx"], a["pos"], e_block=e_block),
        "gmm": lambda a: kg.gmm(a["buf"], a["w1"], activation=gmm_act,
                                rows=a["rows"]),
        "gmm_bwd": lambda a: grads(
            lambda x, w: kg.GMMFn.apply(x, w, gmm_act, a["rows"]),
            [a["buf"], a["w1"]], a["dh"]),
        "dispatch_bwd": lambda a: grads(
            lambda x: kd.DispatchFn.apply(x, a["eidx"], a["pos"], e, c,
                                          None), [a["x"]], a["dbuf"]),
        "combine_bwd": lambda a: grads(
            lambda buf, w: kd.CombineFn.apply(buf, w, a["eidx"], a["pos"],
                                              buf.dtype, None),
            [a["buf"], a["w"]], a["dy"]),
        "fused_decode": lambda a: kf.decode_step(
            a["x"], a["valid"], a["wg"], a["w1"], a["w2"], a["w3"], k=k,
            capacity=c, activation=act),
        "fused_routed": lambda a: kf.routed_apply(
            a["x"], a["eidx"], a["pos"], a["eidx"], a["pos"], a["w"],
            a["w1"], a["w2"], a["w3"], n_experts=e, capacity=c,
            activation=act),
    }[name]


def _out_specs(out) -> list:
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [(tuple(t.shape), str(t.dtype), tuple(t.stride())) for t in out]


def meta_branch_case(what: str, run, inputs: dict) -> dict:
    """``run(inputs)`` on the card, then on ``meta`` copies of the inputs
    in ``cuda_lib.meta_trace()`` under ``MemTrace``: the outputs' shapes,
    dtypes and strides, and the bytes allocated over the call (held
    after it and at its peak) must be equal."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import dryrun
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run(inputs)
    torch.cuda.synchronize()
    card = {"held": torch.cuda.memory_allocated() - base,
            "peak": torch.cuda.max_memory_allocated() - base,
            "outputs": _out_specs(out)}
    del out
    meta = {k: v.to("meta") for k, v in inputs.items()}
    mt = dryrun.MemTrace()
    mt.track(list(meta.values()), "inputs")
    b0 = mt.current
    with cuda_lib.meta_trace(), mt:
        out = run(meta)
    traced = {"held": mt.current - b0, "peak": mt.peak - b0,
              "outputs": _out_specs(out)}
    del out
    check(card == traced, f"dryrun (a) {what}: the card {card} against "
          f"the meta branch {traced}")
    return {"held": card["held"], "peak": card["peak"]}


def phase_meta_kernels() -> dict:
    """Phase 27 (a): every kernel wrapper (rows 1-8 and the VJPs B5-B8)
    against its meta branch at each path's shapes (META_SHAPES), and the
    fused kernels' host workspace mirror against the library."""
    import gc
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import fused_decode as kf
    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    out = {}
    for what, (t, e, k, d, f, c, dt, act, names) in META_SHAPES.items():
        inputs = _meta_inputs(t, e, k, d, f, c, dt, gen)
        row = {}
        for name in names:
            row[name] = meta_branch_case(f"{what} {name}", _meta_run(
                name, e, k, c, act, E_BLOCK), inputs)
        for decode, name in ((1, "fused_decode"), (0, "fused_routed")):
            if name not in names:
                continue
            args = (decode, t, k, d, d, f, e, c,
                    0 if decode else kf.MODES["ffn"], kf.ACTIVATIONS[act],
                    cuda_lib.DTYPE_CODES[getattr(torch, dt)])
            mirror, lib = kf.workspace_bytes(*args), kf._workspace_bytes(*args)
            check(mirror == lib, f"dryrun (a) {what} {name}: workspace "
                  f"mirror {mirror} bytes, the library {lib}")
            row[name]["workspace_bytes"] = lib
        out[what] = row
        log(f"dryrun (a) {what} (T {t}, E {e}, k {k}, d {d}, f {f}, C {c}, "
            f"{dt}): card = meta branch, bytes held / peak "
            + json.dumps(row))
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dryrun_mesh_cell(fused: bool):
    """Phase 27 (c): start ``python -m repro_torch.launch.dryrun`` on a
    fake (data 1, model 2) group at phase 24's decode cell (kimi-k2 cut
    to MESH_LAYERS layer, N_REQUESTS slots, pages of PROMPT_LEN +
    NEW_TOKENS); returns a function that waits for it and returns its
    record.  Host work only: it runs beside (a) on the card."""
    import os
    traffic = "fused" if fused else "serve"
    out = ROOT / "chiprun_out" / f"dryrun_mesh_{traffic}.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           ARCH, "--shape", f"decode:{N_REQUESTS}x{PROMPT_LEN + NEW_TOKENS}",
           "--mesh", "x".join(map(str, MESH_SERVE)), "--set",
           f"n_layers={MESH_LAYERS}", "--set",
           f"fused_decode={'true' if fused else 'false'}", "--out", str(out),
           "--force"]
    out.parent.mkdir(exist_ok=True)
    proc = subprocess.Popen(
        cmd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait() -> dict:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        log(f"dryrun (c) {' '.join(cmd[1:])}: exit {proc.returncode}\n"
            + stdout[-3000:] + stderr[-3000:])
        check(proc.returncode == 0, "dryrun (c): the dry-run CLI failed")
        with open(out) as f:
            rec = [json.loads(line) for line in f][-1]
        check(rec["status"] == "ok", f"dryrun (c): {rec.get('error')}")
        return rec
    return wait


def phase_dryrun(mesh: dict) -> dict:
    """Phase 27: (a) :func:`phase_meta_kernels`; (b) the dry run's peak
    (the trace workers') against the card's on every path of
    DRYRUN_PATHS, within DRYRUN_BAND, written to chiprun_out/dryrun.jsonl
    and as ``launch/report.py``'s tables; (c) the dry-run CLI's
    collective bytes a decode step on (1, 2), unfused and fused (run
    beside (a)), against phase 24's measured bytes and
    ``analyze_cell``'s wire bytes: equal."""
    from repro_torch.launch import dryrun, report
    t0 = time.perf_counter()
    cells = {"serve": dryrun_mesh_cell(False),
             "fused": dryrun_mesh_cell(True)}
    try:
        meta = phase_meta_kernels()
    finally:
        cell_recs = {traffic: wait() for traffic, wait in cells.items()}
    recs = dryrun_records()
    names = [a[0] for a in dryrun_plan()]
    check(sorted(r["shape"] for r in recs) == sorted(names),
          f"dryrun (b): records of {[r['shape'] for r in recs]}, "
          f"expected {names}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "dryrun.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    print(report.dryrun_table(recs, "h100"), flush=True)
    print(report.roofline_table(recs, "h100"), flush=True)
    for r in recs:
        log(f"dryrun (b) {r['shape']}: dry-run peak / card peak "
            f"{r['peak_ratio']:.4f}, analytic resident / card peak "
            f"{r['resident_ratio']:.4f}")
    lo, hi = DRYRUN_BAND
    for r in recs:
        check(lo <= r["peak_ratio"] <= hi,
              f"dryrun (b) {r['shape']}: dry-run peak / card peak "
              f"{r['peak_ratio']:.4f} outside {DRYRUN_BAND}")
    wire = {}
    for traffic, rec in cell_recs.items():
        dec = mesh["ranks"][0][traffic]["decode_collectives"]
        measured = sum(dec["bytes"].values()) / dec["calls"]
        traced = dryrun.collective_bytes(rec)
        ana = rec["analytic"]["wire_bytes_per_dev"]
        wire[traffic] = {"traced_bytes": traced, "measured_bytes": measured,
                         "analytic_bytes": ana,
                         "traced_by_op": rec["collectives"],
                         "peak_bytes_per_rank":
                             rec["memory"]["peak_bytes_per_device"]}
        log(f"dryrun (c) {traffic} decode step on {MESH_SERVE}: "
            + json.dumps(wire[traffic]))
        check(abs(traced - measured) <= 1e-9 * measured
              and abs(traced - ana) <= 1e-9 * ana,
              f"dryrun (c) {traffic}: traced {traced} B, measured "
              f"{measured} B, analytic {ana} B a decode step")
    wall = time.perf_counter() - t0
    log(f"dryrun phase {wall:.1f} s (the (b) paths' card calls "
        f"{sum(r['card_s'] for r in recs):.1f} s inside their phases, "
        f"their traces {sum(r['trace_s'] for r in recs):.1f} s beside "
        "the kernel build)")
    return {"meta": meta, "records": recs, "wire": wire, "wall_s": wall}


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
                            "jamba_", "mesh_"))}}


# ---------------------------------------------------------------------------
# phase 28: MoA and the hierarchical MoE on a mesh (their global plan)
# ---------------------------------------------------------------------------

# Two gloo ranks sharing the card, one spawn for the three parts, each
# held to one process on the same weights and draws (the references run
# first, on this process):
# (a) moa-demo at its published widths in f32 (as phase 25 runs qwen3),
# step 0 of B x S = MOA_TRAIN_B x MOA_TRAIN_S on meshes (1, 2) and (2, 1)
# at the config's own capacity factor, and on (1, 2) with MoA's tokens
# dropping (ROUTED_MOA_CASES): loss, metrics and every gradient leaf a
# rank holds to phase 23's DIST_* tolerances, fraction_dropped equal,
# MOA_TRAIN_LAUNCHES on every rank (the global plan launches what one
# process does);
# (b) moa-demo (bf16) served on (1, 2) under decode_std, phase 8's 8
# requests unfused and fused: streams equal to one process's, every
# call's logits within ROUTED_LOGIT_TOL (one bf16 unit) of the logit
# scale, exact launches (fused: kernel 8 twice a MoA layer, the MoE
# layers' top-k and kernel 8 "ffn" on the rank's experts);
# (c) moe-4096-h at full width (f32, vocab 32,000), step 0 of TRAIN_B x
# TRAIN_S on (1, 2), 8 groups a rank: loss, metrics and fraction_dropped
# as (a), every non-expert gradient and the expert gradients of each
# rank's first and last group (ROUTED_HMOE_GROUPS of the one process's,
# the only expert gradients moved to the host), HMOE_LAUNCHES on every
# rank; the step's collectives (calls, bytes, share of the step) printed.
# The references reach the ranks as one file in the phase's temporary
# directory (4.3 GB of expert gradients: the four groups).  The ranks
# start with the phase and warm up (ROUTED_WARMUP: a small moa-demo and
# hierarchical paper LM step on (1, 2), noiseless) while this process
# computes the references, so a fresh process's first-use costs (8-15 s
# of its first moa-demo step on the H100 host) fall outside the
# compared steps and beside the references.
ROUTED_WARMUP = {"b": 2, "s": 128, "hierarchical": (16, 4),
                 "vocab": 1024}
# (a)'s cases: (name, MoA's capacity factor (None: the config's), the
# meshes).  At moa-demo's own factor 2 no token drops; at MoA factor 1
# (its own router, moa_router) the MoA layers drop, the flat MoE FFN's
# per-shard capacity stays at the config's factor.
ROUTED_MOA_CASES = (("moa", None, ((1, 2), (2, 1))),
                    ("moa_drops", 1.0, ((1, 2),)))
ROUTED_SERVE_MESH = (1, 2)
ROUTED_LOGIT_TOL = 2.0 ** -7
ROUTED_TRAFFIC = ("serve", "fused")
ROUTED_HMOE_GROUPS = (0, 7, 8, 15)
# The metrics compared (the ranks' mean of a rank's perplexity is not
# the batch's).
ROUTED_METRICS = ("xent", "aux_loss", "cv_importance", "cv_load",
                  "max_over_mean_load")
MOA_GATES = (("blocks", "periods", "pos0", "moe", "gate", "wg"),
             ("blocks", "periods", "pos1", "moa", "gate", "wg"))
HMOE_GATES = (("moe", "gate_primary", "wg"), ("moe", "gate_secondary", "wg"))


def _seeded(defs, seed: int, gates, d_model: int, cut=None):
    """The tree of ``defs`` drawn from ``seed``, the ``gates`` (paths)
    redrawn after it with std d_model^-1/2; with ``cut`` each leaf is
    drawn whole and a rank's slice kept (the one process's draws)."""
    import torch
    from repro_torch.common import param as pm
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = pm.materialize(defs, gen, "cuda", cut=cut)
    for path in gates:
        d, node = defs, params
        for key in path[:-1]:
            d, node = d[key], node[key]
        d = d[path[-1]]
        t = torch.empty(d.shape, dtype=d.dtype, device="cuda")
        t.normal_(0.0, d_model ** -0.5, generator=gen)
        node[path[-1]] = t if cut is None else cut(d, t)
    return params


def _routed_moa_cfg(f32: bool, moa_cf=None):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.router import RouterSpec
    cfg = get_config(MOA_ARCH)
    if f32:
        cfg = cfg.replace(param_dtype=torch.float32,
                          compute_dtype=torch.float32)
    if moa_cf is not None:
        cfg = cfg.replace(moa_router=RouterSpec(capacity_factor=moa_cf))
    return cfg


def _routed_moa_params(f32: bool, cut=None, moa_cf=None):
    from repro_torch.models import lm
    cfg = _routed_moa_cfg(f32, moa_cf)
    return cfg, _seeded(lm.lm_defs(cfg), SEED + 28, MOA_GATES, cfg.d_model,
                        cut)


def _routed_moa_data():
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(vocab_size=_routed_moa_cfg(True).vocab_size,
                      seq_len=MOA_TRAIN_S, batch_size=MOA_TRAIN_B, seed=SEED)


def _routed_hmoe_params(cut=None):
    from repro_torch.configs.moe_paper import paper_config
    from repro_torch.models.paper_lm import paper_lm_defs
    cfg = paper_config(HMOE_CONFIG)
    return cfg, _seeded(paper_lm_defs(cfg), SEED + 29, HMOE_GATES,
                        cfg.d_model, cut)


def _routed_hmoe_data():
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.configs.moe_paper import paper_config
    return DataConfig(vocab_size=paper_config(HMOE_CONFIG).vocab_size,
                      seq_len=TRAIN_S, batch_size=TRAIN_B, seed=SEED)


def _routed_serve_launches(cfg):
    """(unfused a model call, fused a decode step on one process, on a
    mesh) for moa-demo: phase 8's tables; on a mesh each MoE layer's
    fused decode is its top-k and kernel 8 on the rank's experts."""
    from repro_torch.configs.base import layer_kinds
    kinds = layer_kinds(cfg)
    n_rep = cfg.n_layers // cfg.period
    n_moe = n_rep * sum(k.ffn == "moe" for k in kinds)
    n_moa = n_rep * sum(k.mixer == "moa" for k in kinds)
    unfused = {"topk_gating": n_moe + n_moa, "dispatch": n_moe + 2 * n_moa,
               "combine": n_moe + 2 * n_moa, "gmm": 3 * n_moe + 2 * n_moa}
    return (unfused, {"topk_gating": n_moa, "fused_routed": 2 * n_moa,
                      "fused_decode": n_moe},
            {"topk_gating": n_moe + n_moa,
             "fused_routed": n_moe + 2 * n_moa})


def _routed_traffic(cfg):
    """Phase 8's traffic: N_REQUESTS prompts of PROMPT_LEN, NEW_TOKENS
    greedy tokens, one step apart."""
    import numpy as np
    rs = np.random.RandomState(SEED + 1)
    prompts = [rs.randint(1, cfg.vocab_size, (PROMPT_LEN,))
               for _ in range(N_REQUESTS)]
    sc = dict(max_len=PROMPT_LEN + NEW_TOKENS, n_slots=N_REQUESTS)
    plain = [(p, NEW_TOKENS, i) for i, p in enumerate(prompts)]
    return {"serve": (sc, plain), "fused": (dict(sc, fused_decode=True),
                                            plain)}


def _to(tree, device):
    """A tree of dicts, lists and tensors (None kept) on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def _grad_step(loss_fn, params):
    """One forward and backward on this process with the launches
    zeroed just before and read just after: (loss, metrics, launches,
    ms)."""
    import torch
    from repro_torch.common.param import tree_leaves
    from repro_torch.kernels import cuda_lib
    for p in tree_leaves(params):
        p.requires_grad_(True)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    loss, metrics = loss_fn(params)
    loss.backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return (float(loss), {k: float(v.detach()) for k, v in metrics.items()},
            cuda_lib.launch_counts(), ms)


def routed_reference(path: str) -> dict:
    """The one-process runs of (a), (b) and (c) on this process; what
    the ranks compare with saved to ``path``."""
    import gc
    import torch
    from repro_torch.common.param import tree_map
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import lm, paper_lm
    from repro_torch.train.trainer import step_seed
    ref, out = {}, {}
    # (a) moa-demo f32.
    for name, moa_cf, _ in ROUTED_MOA_CASES:
        cfg, params = _routed_moa_params(True, moa_cf=moa_cf)
        gen = torch.Generator(device="cuda").manual_seed(step_seed(SEED, 0))
        draws = lm.make_draws(cfg, MOA_TRAIN_B, MOA_TRAIN_S, gen, "cuda")
        batch = batch_at(_routed_moa_data(), 0, device="cuda")
        loss, metrics, counts, ms = _grad_step(
            lambda p: lm.lm_loss(p, batch, cfg, draws=draws), params)
        check_launches(f"mesh routed (a) {name} one process", counts,
                       MOA_TRAIN_LAUNCHES)
        check((metrics["fraction_dropped"] > 0) == (moa_cf is not None),
              f"mesh routed (a) {name}: fraction_dropped "
              f"{metrics['fraction_dropped']}")
        ref[name] = {"loss": loss, "metrics": metrics,
                     "grads": tree_map(lambda p: p.grad.detach().cpu(),
                                       params),
                     "draws": _to(draws, "cpu")}
        out[name] = {"loss": loss, "metrics": metrics, "step_ms": ms,
                     "launches": counts}
        del params, draws, batch
    # (b) moa-demo bf16 served.
    cfg, params = _routed_moa_params(False)
    ref["serve"] = {}
    for name, (sc_kw, trace) in _routed_traffic(cfg).items():
        run = _mesh_serve_run(f"mesh routed (b) one process {name}", cfg,
                              params, sc_kw, trace,
                              launches=_routed_serve_launches(cfg))
        ref["serve"][name] = {"streams": run["streams"],
                              "calls": run["calls"]}
        out[f"serve_{name}"] = run["summary"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (c) moe-4096-h f32 at full width.
    cfg, params = _routed_hmoe_params()
    gen = torch.Generator(device="cuda").manual_seed(step_seed(SEED, 0))
    draws = paper_lm.make_draws(cfg, TRAIN_B, TRAIN_S, gen, "cuda")
    batch = batch_at(_routed_hmoe_data(), 0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    loss, metrics, counts, ms = _grad_step(
        lambda p: paper_lm.paper_lm_loss(p, batch, cfg, draws=draws), params)
    check_launches("mesh routed (c) moe-4096-h one process", counts,
                   HMOE_LAUNCHES)
    groups = torch.tensor(ROUTED_HMOE_GROUPS, device="cuda")

    def host(path, p):
        if path[-1] in ("w1", "w2") and path[0] == "moe":
            return p.grad.detach().index_select(0, groups).cpu()
        return p.grad.detach().cpu()
    ref["hmoe"] = {"loss": loss, "metrics": metrics,
                   "grads": _map_path(host, params),
                   "draws": _to(draws, "cpu")}
    out["hmoe"] = {"loss": loss, "metrics": metrics, "step_ms": ms,
                   "launches": counts,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("mesh routed one process " + json.dumps(out))
    del params, draws, batch, groups
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(ref, path)
    return out


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _routed_check(what: str, got: dict, ref: dict) -> dict:
    """Loss within DIST_LOSS_TOL, metrics within DIST_METRIC_TOL,
    fraction_dropped equal and every gradient within DIST_GRAD_TOL
    normwise; the worst of each."""
    worst = {"loss_rel": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
             "metric_rel": 0.0, "grad_norm_rel": 0.0}
    check(worst["loss_rel"] <= DIST_LOSS_TOL,
          f"{what}: loss {got['loss']} vs one process {ref['loss']}")
    check(got["metrics"]["fraction_dropped"]
          == ref["metrics"]["fraction_dropped"],
          f"{what}: fraction_dropped {got['metrics']['fraction_dropped']} "
          f"vs one process {ref['metrics']['fraction_dropped']}")
    for k in ROUTED_METRICS:
        want = ref["metrics"][k]
        err = abs(got["metrics"][k] - want) / max(abs(want), 1e-6)
        worst["metric_rel"] = max(worst["metric_rel"], err)
        check(err <= DIST_METRIC_TOL, f"{what}: {k} {got['metrics'][k]} "
                                      f"vs one process {want}")
    for name, e in got["grads"].items():
        check(e["finite"], f"{what}: gradient {name} not finite")
        check(e["norm"] > 0, f"{what}: one process's gradient {name} is 0")
        worst["grad_norm_rel"] = max(worst["grad_norm_rel"], e["norm_rel"])
        check(e["norm_rel"] <= DIST_GRAD_TOL, f"{what}: gradient {name} "
              f"{e['norm_rel']:.3g} normwise from one process")
    return worst


def _routed_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of phase 28 (a spawned process)."""
    import os
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store_routed')}",
        rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        _routed_warmup()
        warm_s = time.perf_counter() - t0
        path = os.path.join(workdir, "routed_ref.pt")
        while not os.path.exists(path):
            check(time.perf_counter() - t0 < 900,
                  "mesh routed: no reference file after 900 s")
            time.sleep(0.05)
        ref = torch.load(path, mmap=True, weights_only=False)
        out = _routed_rank_body(rank, ref)
        out["warmup_s"] = warm_s
        with open(os.path.join(workdir, f"routed_rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _routed_warmup() -> None:
    """One noiseless forward and backward of moa-demo f32 and of a small
    hierarchical paper LM on (1, 2) at ROUTED_WARMUP's size (nothing is
    compared or counted)."""
    import torch
    from repro_torch.common import param as pm
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, paper_lm
    from repro_torch.sharding.context import MeshContext
    w = ROUTED_WARMUP
    ctx = MeshContext.for_mesh(make_host_mesh(2, device="cuda"), "dp_tp_ep")

    def cut(d, t):
        return ctx.shard_leaf(t, ctx.resolve(d.shape, d.axes))
    cfg, params = _routed_moa_params(True, cut=cut)
    hcfg = paper_lm.PaperLMConfig(vocab_size=w["vocab"], variant="moe",
                                  n_experts=w["hierarchical"][0]
                                  * w["hierarchical"][1],
                                  hierarchical=w["hierarchical"])
    hdefs = paper_lm.paper_lm_defs(hcfg)
    hparams = pm.materialize(hdefs, torch.Generator(device="cuda"), "cuda",
                             cut=cut)
    for c, p, fn in ((cfg, params, lm.lm_loss),
                     (hcfg, hparams, paper_lm.paper_lm_loss)):
        for leaf in pm.tree_leaves(p):
            leaf.requires_grad_(True)
        batch = batch_at(DataConfig(vocab_size=min(c.vocab_size, w["vocab"]),
                                    seq_len=w["s"], batch_size=w["b"]), 0,
                         device="cuda")
        loss, _ = fn(p, {k: ctx.local_rows(v) for k, v in batch.items()}, c,
                     ctx=ctx)
        loss.backward()
    torch.cuda.synchronize()


def _routed_train(ctx, loss_fn, params, defs, batch, clock):
    """Step 0 on this rank (make_grad_fn: the trainer's gradients of the
    global ``batch``, of which the rank takes its rows), the launches
    zeroed just before and read just after, the collectives clocked:
    (grads, metrics, launches, ms)."""
    import torch
    from repro_torch.common.param import tree_leaves
    from repro_torch.kernels import cuda_lib
    from repro_torch.train.trainer import make_grad_fn
    for p in tree_leaves(params):
        p.requires_grad_(True)
    grads_fn = make_grad_fn(loss_fn, ctx=ctx, defs=defs)
    clock.ms, clock.bytes, clock.calls = {}, {}, {}
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    clock.on = True
    t0 = time.perf_counter()
    grads, metrics = grads_fn(params, batch, None)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    clock.on = False
    return grads, {k: float(v) for k, v in metrics.items()}, \
        cuda_lib.launch_counts(), ms


def _routed_rank_body(rank: int, ref: dict) -> dict:
    import gc
    import torch
    from repro_torch.core import expert_parallel as ep_lib
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, paper_lm
    from repro_torch.sharding.context import MeshContext

    clock = _CollectiveClock()
    res = {"rank": rank}

    def report(ms):
        return {"collective_ms": dict(clock.ms),
                "collective_bytes": dict(clock.bytes),
                "collective_calls": dict(clock.calls),
                "collective_share": sum(clock.ms.values()) / ms}

    # (a) moa-demo f32, step 0 on each mesh.
    for (name, moa_cf, meshes), (data, model) in (
            (case, mesh) for case in ROUTED_MOA_CASES for mesh in case[2]):
        ctx = MeshContext.for_mesh(make_host_mesh(model, device="cuda"),
                                   "dp_tp_ep")
        cfg, params = _routed_moa_params(True, cut=lambda d, t: ctx.shard_leaf(
            t, ctx.resolve(d.shape, d.axes)), moa_cf=moa_cf)
        defs = lm.lm_defs(cfg)
        draws = _to(ref[name]["draws"], "cuda")
        grads, metrics, counts, ms = _routed_train(
            ctx, lambda p, b, g: lm.lm_loss(p, b, cfg, draws=draws, ctx=ctx),
            params, defs, batch_at(_routed_moa_data(), 0, device="cuda"),
            clock)
        what = f"mesh routed (a) {name} ({data}, {model}) rank {rank}"
        check_launches(what, counts, MOA_TRAIN_LAUNCHES)
        got = {"loss": metrics["loss"], "metrics": metrics,
               "grads": _leaf_errs(ctx, grads, ref[name]["grads"], defs)}
        worst = _routed_check(what, got, ref[name])
        res[f"{name}_{data}x{model}"] = dict(
            metrics=metrics, launches=counts, step_ms=ms, worst=worst,
            grads={k: e["norm_rel"] for k, e in got["grads"].items()},
            **report(ms))
        del params, grads, draws
        gc.collect()
        torch.cuda.empty_cache()

    # (b) moa-demo bf16 served on ROUTED_SERVE_MESH.
    ctx = MeshContext.for_mesh(make_host_mesh(ROUTED_SERVE_MESH[1],
                                              device="cuda"), "decode_std")
    cfg, params = _routed_moa_params(False, cut=lambda d, t: ctx.shard_leaf(
        t, ctx.resolve(d.shape, d.axes)))
    params = ep_lib.serve_layout(params, lm.lm_defs(cfg), ctx)
    for name, (sc_kw, trace) in _routed_traffic(cfg).items():
        clock.ms, clock.bytes, clock.calls = {}, {}, {}
        clock.on = True
        run = _mesh_serve_run(f"mesh routed (b) rank {rank} {name}", cfg,
                              params, sc_kw, trace, ctx=ctx,
                              launches=_routed_serve_launches(cfg))
        clock.on = False
        one = ref["serve"][name]
        agree = stream_agreement(run["streams"], one["streams"])
        if agree != 1.0:
            _log_divergence(f"mesh routed (b) rank {rank} {name}",
                            run["streams"], one["streams"], one["calls"])
        check(agree == 1.0, f"mesh routed (b) rank {rank} {name}: streams "
                            f"agree {agree:.4f} with one process")
        errs = _logit_errs(run["calls"], one["calls"], run["first_slot"],
                           run["n_local"])
        check(errs["calls_compared"] > 0,
              f"mesh routed (b) rank {rank} {name}: no call compared")
        check(errs["worst_rel"] <= ROUTED_LOGIT_TOL,
              f"mesh routed (b) rank {rank} {name}: logits "
              f"{errs['worst_rel']:.4g} of the scale from one process (tol "
              f"{ROUTED_LOGIT_TOL})")
        res[f"serve_{name}"] = dict(
            run["summary"], stream_agreement=agree, logits=errs,
            collective_ms=dict(clock.ms), collective_bytes=dict(clock.bytes),
            collective_calls=dict(clock.calls))
        del run
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) moe-4096-h f32 at full width on (1, 2).
    ctx = MeshContext.for_mesh(make_host_mesh(2, device="cuda"), "dp_tp_ep")
    cfg, params = _routed_hmoe_params(cut=lambda d, t: ctx.shard_leaf(
        t, ctx.resolve(d.shape, d.axes)))
    defs = paper_lm.paper_lm_defs(cfg)
    draws = _to(ref["hmoe"]["draws"], "cuda")
    torch.cuda.reset_peak_memory_stats()
    grads, metrics, counts, ms = _routed_train(
        ctx, lambda p, b, g: paper_lm.paper_lm_loss(p, b, cfg, draws=draws,
                                                    ctx=ctx),
        params, defs, batch_at(_routed_hmoe_data(), 0, device="cuda"), clock)
    what = f"mesh routed (c) {HMOE_CONFIG} (1, 2) rank {rank}"
    check_launches(what, counts, HMOE_LAUNCHES)
    n_local = cfg.hierarchical[0] // ctx.size(["model"])
    g0 = ctx.index(["model"]) * n_local

    def expert(path, g, r):
        if path[0] != "moe" or path[-1] not in ("w1", "w2"):
            return None
        return [(f"group {g0 + i}", g[i], r[ROUTED_HMOE_GROUPS.index(g0 + i)])
                for i in (0, n_local - 1)]
    got = {"loss": metrics["loss"], "metrics": metrics,
           "grads": _leaf_errs(ctx, grads, ref["hmoe"]["grads"], defs,
                               expert)}
    worst = _routed_check(what, got, ref["hmoe"])
    res["hmoe"] = dict(
        metrics=metrics, launches=counts, step_ms=ms, worst=worst,
        grads={k: e["norm_rel"] for k, e in got["grads"].items()},
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, **report(ms))
    log(f"{what} collectives " + json.dumps(report(ms)))
    del params, grads, draws
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _log_divergence(what, streams, ref_streams, ref_calls) -> None:
    """The first token where a rank's stream leaves one process's, and
    the one process's gap there between its top two logits (a routing
    near tie, ROADMAP C.3, moves logits by about one bf16 unit: a
    sampled token whose gap is within that unit may flip)."""
    for r, (a, b) in enumerate(zip(streams, ref_streams)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                gaps = []
                for kind, _, _, logits in ref_calls:
                    if kind != "decode" or r >= logits.shape[0]:
                        continue
                    top = logits[r].float().topk(2).values
                    gaps.append(float((top[0] - top[1]).abs()
                                      / logits.abs().max()))
                log(f"{what}: request {r} token {i}: {x} against one "
                    f"process's {y}; its decode calls' smallest top-2 logit "
                    f"gap {min(gaps) if gaps else float('nan'):.3g} of the "
                    "scale")
                return


def phase_mesh_routed() -> dict:
    """Phase 28: the one-process references, then the two ranks."""
    import gc
    import os
    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    world = 2
    with tempfile.TemporaryDirectory() as workdir:
        procs = mp.spawn(_routed_rank, args=(world, workdir), nprocs=world,
                         join=False)
        try:
            path = os.path.join(workdir, "routed_ref.pt")
            out = routed_reference(path + ".tmp")
            gc.collect()
            torch.cuda.empty_cache()
            os.replace(path + ".tmp", path)
            out["reference_s"] = time.perf_counter() - t0
            while not procs.join():
                pass
        except Exception as err:       # a rank failed: the phase fails
            for proc in procs.processes:
                proc.terminate()
            if isinstance(err, SmokeFailure):
                raise
            raise SmokeFailure(f"mesh routed ranks: {err}")
        out["ranks_after_reference_s"] = (time.perf_counter() - t0
                                          - out["reference_s"])
        ranks = []
        for r in range(world):
            with open(os.path.join(workdir, f"routed_rank{r}.json")) as f:
                ranks.append(json.load(f))
    for key in ranks[0]:
        if key in ("rank", "warmup_s"):
            continue
        log(f"mesh routed {key} " + json.dumps(
            [{"rank": r["rank"], **r[key]} for r in ranks]))
    for name in ROUTED_TRAFFIC:
        check(ranks[0][f"serve_{name}"]["stats"]
              == ranks[1][f"serve_{name}"]["stats"],
              f"mesh routed (b) {name}: the ranks' engine stats differ")
    out["ranks"] = ranks
    out["wall_s"] = time.perf_counter() - t0
    log(f"mesh routed phase {out['wall_s']:.1f} s (the references "
        f"{out['reference_s']:.1f} s, then the ranks "
        f"{out['ranks_after_reference_s']:.1f} s; their warm-ups "
        + ", ".join(f"{r['warmup_s']:.1f}" for r in ranks) + " s)")
    return out


# ---------------------------------------------------------------------------
# phase 29: mamba mixers and sliding-window attention served on a mesh
# ---------------------------------------------------------------------------

# Three models served by ServeEngine(ctx=) on two gloo ranks sharing the
# card, bf16 at full width, each held to one process (this one) on the
# same weights (drawn from SEED, the MoE gates redrawn after the tree, as
# build_ssm draws them; a rank keeps its serving slices of each leaf) and
# the traffic of its own phase (all prompts at step 0, a slot each):
# (a) jamba-v0.1-52b cut to one period (JAMBA_TRAIN_LAYERS: 7 mamba, 1
# attention, 4 MoE layers of 16 experts top-2) on (1, 2): 8 experts a
# rank, the scan and conv states whole, the attention page's positions
# over model; phase 20's SSM_REQUESTS x SSM_PROMPT prompts and SSM_NEW
# tokens, unfused and fused;
# (b) falcon-mamba-7b cut to 4 layers on (2, 1): 2 slots a rank; phase
# 19's traffic;
# (c) gemma3-27b cut to one period (5 window layers, 1 global) on (1, 2):
# phase 16's GEMMA_REQUESTS x GEMMA_PROMPT prompts against its 1024-token
# window, so the ring wraps (512 ring slots a rank), GEMMA_NEW tokens.
# One process serves each model unfused; the ranks are handed its tokens
# (so every call's inputs are its), and jamba's ranks its kernel-1
# choices (_TopkPin).  The decode attention's merge rounds otherwise than
# one process (phase 24), by one or two bf16 units of the logits; one
# process's logits hold exact top-2 ties (bf16 logits), and a rounding
# that small tips some of jamba's top-2 routings (measured on one H100),
# after which no logit compares.  Gates: every call's logits within
# MIXER_LOGIT_UNITS bf16 units in the last place, at the binade of the
# call's logit scale, of one process's (ROUTED_LOGIT_TOL x the scale is
# one to two such units; the merge moved jamba's and gemma3's by 1.4 and
# 1.5, measured on one H100); each rank's own greedy tokens one
# process's, but where one process's gap to the rank's pick is within
# twice that call's logit difference (a near tie); each pinned routing
# flip a near tie of one process's gate logits (_TopkPin), and at most
# MIXER_MAX_FLIPS of them a run (4 a run of the ~17,000 rows routed, on
# one H100, 3x that allowed); the ranks' engine
# stats equal; a reshard a prompt; exact launches a rank (MESH_UNFUSED a
# model call and MESH_FUSED_DECODE["mesh"] a fused decode step, a MoE
# layer, for (a); none for (b) and (c)); kernels 1, 2, 4, 6 and 8
# against their plain versions at (a)'s mesh shapes.  The ranks start
# with the phase, build (a) and warm it up beside the references, then
# serve once the references are done.
MIXER_LOGIT_UNITS = 2
MIXER_MAX_FLIPS = 12
MIXER_MODELS = {"jamba": (JAMBA, JAMBA_TRAIN_LAYERS, (1, 2)),
                "falcon": (FALCON, 4, (2, 1)),
                "gemma": (GEMMA, 6, (1, 2))}


def _mixer_cfg(name: str):
    from repro_torch.configs.base import get_config
    arch, layers, _ = MIXER_MODELS[name]
    return get_config(arch, n_layers=layers)


def _mixer_params(name: str, cut=None):
    """``name``'s config and weights drawn from SEED, the MoE gates
    redrawn at std d^-1/2 in layer order (as build_ssm draws them); with
    ``cut`` a rank's slices (see _seeded)."""
    from repro_torch.configs.base import layer_kinds
    from repro_torch.models import lm
    cfg = _mixer_cfg(name)
    gates = tuple(("blocks", "periods", f"pos{p}", "moe", "gate", "wg")
                  for p, kind in enumerate(layer_kinds(cfg))
                  if kind.ffn == "moe")
    return cfg, _seeded(lm.lm_defs(cfg), SEED, gates, cfg.d_model, cut)


def _mixer_traffic(name: str, cfg) -> dict:
    """traffic -> (ServeConfig fields, [(prompt, new tokens, arrival)]):
    the prompts of phases 20, 19 and 16, all at step 0; a model with MoE
    layers also with fused decode (on the ranks)."""
    import numpy as np
    seed, n, plen, new = {
        "jamba": (SEED + 11, SSM_REQUESTS, SSM_PROMPT, SSM_NEW),
        "falcon": (SEED + 9, SSM_REQUESTS, SSM_PROMPT, SSM_NEW),
        "gemma": (SEED + 6, GEMMA_REQUESTS, GEMMA_PROMPT, GEMMA_NEW)}[name]
    rs = np.random.RandomState(seed)
    trace = [(rs.randint(1, cfg.vocab_size, (plen,)), new, 0)
             for _ in range(n)]
    sc = dict(max_len=plen + new, n_slots=n)
    out = {"serve": (sc, trace)}
    if cfg.n_experts:
        out["fused"] = (dict(sc, fused_decode=True), trace)
    return out


def _mixer_launches(cfg) -> tuple:
    """(unfused a model call, fused a decode step on one process, on a
    mesh): phase 24's tables a MoE layer."""
    from repro_torch.configs.base import layer_kinds
    n_moe = (cfg.n_layers // cfg.period) * sum(
        kind.ffn == "moe" for kind in layer_kinds(cfg))
    return tuple({k: n_moe * v for k, v in table.items()}
                 for table in (MESH_UNFUSED, MESH_FUSED_DECODE["one"],
                               MESH_FUSED_DECODE["mesh"]))


class _TopkPin:
    """Pins kernel 1's choices to a recorded run's (``choices``: the
    (indices, gate logits) of each of its ``ops.topk_gating`` calls, in
    order).  Each call launches the kernel and keeps its output where
    its top-k set is the recorded one; a row whose set differs (a flip)
    takes the recorded indices, its own logits gathered at them and
    their softmax as the weights.  A flip is a near tie only if the
    recorded run's gap between its weakest pick and the strongest of
    this run's other picks is at most twice the largest difference of
    the two runs' gate logits at those experts, on that row: no smaller
    drift of the gate's inputs can reorder them (in float64, where the
    difference of two float32 logits is exact, so a flip at an exact tie
    passes).  ``flips``: the flipped rows a call; ``worst_ratio``: the
    largest such gap over twice the difference (at most 1 where every
    flip is a near tie)."""

    def __init__(self, choices: list):
        self.choices = choices
        self.flips: list = []
        self.worst_ratio = 0.0

    @contextlib.contextmanager
    def pinned(self):
        import torch
        from repro_torch.kernels import ops
        real = ops.topk_gating
        counts, ratios = [], []

        def topk(logits, k, kk=None):
            w, idx, vals = real(logits, k, kk)
            n = len(counts)
            check(n < len(self.choices), "a pinned run made more top-k "
                                         "calls than the recorded one")
            want, rec = self.choices[n]
            want, rec = want.to(idx.device), rec.to(idx.device).double()
            check(want.shape == idx.shape, f"top-k call {n}: recorded "
                  f"{tuple(want.shape)}, made {tuple(idx.shape)}")
            g = logits.double()
            theirs_set = torch.zeros_like(g, dtype=torch.bool).scatter_(
                1, want[:, :k].long(), True)
            own_set = torch.zeros_like(theirs_set).scatter_(
                1, idx[:, :k].long(), True)
            flip = (theirs_set != own_set).any(dim=-1)
            inf = torch.tensor(float("inf"), device=g.device)
            gap = (torch.where(theirs_set, rec, inf).amin(dim=-1)
                   - torch.where(own_set & ~theirs_set, rec,
                                 -inf).amax(dim=-1))
            drift = torch.where(theirs_set | own_set, (g - rec).abs(),
                                0.0).amax(dim=-1)
            counts.append(flip.sum())
            ratios.append(torch.where(
                flip, gap / torch.clamp(2 * drift, min=1e-30), 0.0).amax())
            theirs = logits.float().gather(-1, want.long())
            row = flip[:, None]
            return (torch.where(row, torch.softmax(theirs[:, :k], dim=-1),
                                w),
                    torch.where(row, want, idx),
                    torch.where(row, theirs, vals))
        ops.topk_gating = topk
        try:
            yield self
        finally:
            ops.topk_gating = real
            self.flips = [int(c) for c in counts]
            self.worst_ratio = max((float(r) for r in ratios), default=0.0)


def _mesh_case(what, fn, plain, n_bytes, flops, dtype, tol=None,
               plain_reps=REPS) -> dict:
    """A kernel's wrapper ``fn`` against its plain version on the same
    inputs: bitwise, or within ``tol(plain output)``; both timed with
    CUDA events, beside the byte / operation bound."""
    got, want = fn(), plain()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    err = max(max_err(g, w) for g, w in zip(got, want))
    lim = 0.0 if tol is None else tol(want[0])
    check(err <= lim, f"mesh mixers {what}: {err} from its plain version "
                      f"(tol {lim})")
    b, by = bound_ms(n_bytes, flops, dtype)
    row = dict(max_abs_err=err, tol=lim, ms=cuda_ms(fn),
               plain_ms=cuda_ms(plain, reps=plain_reps, warmup=1),
               bound_ms=b, bound_by=by, shape=what)
    log(f"mesh mixers kernel {what}: " + json.dumps(row))
    return row


def check_mesh_jamba_kernels(cfg, params) -> dict:
    """Kernels 1, 2, 4, 6 and 8 at the shapes jamba's MoE layers give
    them on (1, 2), on its first MoE layer's weights: a SSM_PROMPT-token
    prefill and a decode step of SSM_REQUESTS slots, each routed whole
    on every rank (top-k [T, 16], dispatch / combine [T, 4096] <-> [16,
    C, 4096]), the three GMMs on rank 0's slab of 8 experts with the
    plan's rows (each rank's slab bit for bit the whole call's rows),
    and kernel 8 on the decode plan restricted to each rank's experts.
    Phase 2's tolerances (top-k values 1e-6, its indices, dispatch and
    combine bit for bit; the GMMs and kernel 8 two bf16 units); timed
    with CUDA events beside the plain versions."""
    import torch
    from repro_torch.core import expert_parallel as ep_lib
    from repro_torch.core import router as router_lib
    from repro_torch.kernels import backend as backend_lib
    from repro_torch.kernels import dispatch as dk
    from repro_torch.kernels import gmm as gk
    from repro_torch.kernels import topk_gating as tk
    from repro_torch.models.transformer import _moe_args
    layer = _layer(params["blocks"]["periods"]["pos1"]["moe"], 0)
    wg, w1, w2, w3 = (layer["gate"]["wg"], layer["w1"], layer["w2"],
                      layer["w3"])
    e, k, d, f = cfg.n_experts, cfg.moe_k, cfg.d_model, cfg.moe_d_ff
    ranks = MIXER_MODELS["jamba"][2][1]
    e_local = e // ranks
    a = _moe_args(cfg, decode=True)
    router = router_lib.build(a, topk_impl=backend_lib.resolve(a).topk_impl)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    out: dict = {}
    for label, t in (("prefill", SSM_PROMPT), ("decode", SSM_REQUESTS)):
        x = torch.randn(t, d, device="cuda", generator=gen).to(torch.bfloat16)
        logits = x.float() @ wg.float()
        out[f"topk_gating_{label}"] = _mesh_case(
            f"topk_gating [{t},{e}] k={k}",
            lambda: tk.topk_gating(logits, k, k + 1),
            lambda: tk.topk_gating_plain(logits, k, k + 1),
            t * e * 4 + t * k * 4 + t * (k + 1) * 8, 0, "float32",
            tol=lambda _: 1e-6)
        dec = router.route(layer, x, train=False)
        p, rows = dec.plan, dec.rows
        ei, po, w = (v.contiguous() for v in (p.expert_index, p.position,
                                              p.weight))
        cap = p.capacity
        kept = po < cap
        n_kept, rows_read = int(kept.sum()), int(kept.any(dim=1).sum())
        shape = f"[{t},{d}] <-> [{e},{cap},{d}]"
        out[f"dispatch_{label}"] = _mesh_case(
            f"dispatch {shape}",
            lambda: dk.dispatch(x, ei, po, n_experts=e, capacity=cap),
            lambda: dk.dispatch_plain(x, ei, po, None, e, cap),
            (rows_read * d + e * cap * d) * 2 + t * k * 8, 0, "bfloat16")
        buf = dk.dispatch(x, ei, po, n_experts=e, capacity=cap)
        ybuf = torch.randn(e, cap, d, device="cuda",
                           generator=gen).to(torch.bfloat16)
        out[f"combine_{label}"] = _mesh_case(
            f"combine {shape}", lambda: dk.combine(ybuf, w, ei, po),
            lambda: dk.combine_plain(ybuf, w, ei, po, x.dtype),
            n_kept * d * 2 + t * k * 12 + t * d * 2, 2 * n_kept * d,
            "bfloat16")
        h = gk.mask_rows(torch.randn(e, cap, f, device="cuda",
                                     generator=gen).to(torch.bfloat16), rows)
        calls = (("w1", buf, w1, "silu"), ("w3", buf, w3, "none"),
                 ("w2", h, w2, "none"))
        for r in range(ranks):
            half = slice(r * e_local, (r + 1) * e_local)
            for name, xi, wi, act in calls:
                whole = gk.gmm(xi, wi, activation=act, rows=rows)
                check(bool(torch.equal(whole[half], gk.gmm(
                    xi[half], wi[half], activation=act, rows=rows[half]))),
                      f"mesh mixers gmm {name} {label}: rank {r}'s slab "
                      "differs from the whole call's rows")
        slab, srows = slice(0, e_local), rows[:e_local]
        used, filled = int((srows > 0).sum()), int(srows.sum())
        for name, xi, wi, act in calls:
            kd, nd = wi.shape[1], wi.shape[2]
            out[f"gmm_{name}_{label}"] = _mesh_case(
                f"gmm {name} slab [{e_local},{cap},{kd}] x "
                f"[{e_local},{kd},{nd}] rows",
                lambda: gk.gmm(xi[slab], wi[slab], activation=act,
                               rows=srows),
                lambda: gk.gmm_plain(xi[slab], wi[slab], act, False, False,
                                     srows),
                (filled * kd + used * kd * nd + e_local * cap * nd) * 2,
                2 * filled * kd * nd, "bfloat16", tol=bf16_tol,
                plain_reps=3)
        if label == "decode":
            for r in range(ranks):
                e0 = r * e_local
                out[f"fused_routed_rank{r}"] = _fused8_case(
                    x, ep_lib.local_plan(p, e0, e_local),
                    w1[e0:e0 + e_local], w2[e0:e0 + e_local],
                    w3[e0:e0 + e_local],
                    f"jamba mesh slab of rank {r} ({e_local} experts)")
        del buf, ybuf, h
    torch.cuda.empty_cache()
    return out


def mixer_reference(workdir: str) -> dict:
    """Kernels at jamba's mesh shapes, then each model's unfused traffic
    on this process: its greedy tokens, every call's logits and kernel-1
    choices saved for the ranks, a file a model, then a file that says
    all are there."""
    import gc
    import os
    import torch
    out = {}
    for name in MIXER_MODELS:
        t0 = time.perf_counter()
        cfg, params = _mixer_params(name)
        if name == "jamba":
            out["kernels"] = check_mesh_jamba_kernels(cfg, params)
        sc_kw, trace = _mixer_traffic(name, cfg)["serve"]
        run = _mesh_serve_run(f"mesh mixers one process {name}", cfg,
                              params, sc_kw, trace,
                              launches=_mixer_launches(cfg),
                              gates=bool(cfg.n_experts))
        path = os.path.join(workdir, f"mixer_{name}.pt")
        torch.save({k: run[k] for k in ("calls", "routes", "samples")},
                   path + ".tmp")
        os.replace(path + ".tmp", path)
        out[name] = dict(run["summary"], reference_s=time.perf_counter() - t0)
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
    log("mesh mixers one process " + json.dumps(
        {k: v for k, v in out.items() if k != "kernels"}))
    return out


def _greedy_errs(run, ref) -> dict:
    """Each sampling's own greedy tokens of a rank's run against one
    process's, with the decode rows of the rank's slots: the tokens that
    differ, and of those the largest gap (one process's logit of its
    token less that of the rank's pick) over twice the call's largest
    logit difference (at most 1 where a near tie explains the pick)."""
    first, n = run["first_slot"], run["n_local"]
    out = {"tokens": 0, "differ": 0, "worst_gap_ratio": 0.0}
    for own, want, (kind, _, _, logits), (_, _, _, rlogits) in zip(
            run["samples"], ref["samples"], run["calls"], ref["calls"]):
        if len(want) != len(own):
            want, rlogits = want[first:first + n], rlogits[first:first + n]
        diff = float((logits - rlogits).abs().max())
        for row, (a, b) in enumerate(zip(own, want)):
            out["tokens"] += 1
            if a != b:
                gap = float(rlogits[row, b] - rlogits[row, a])
                out["differ"] += 1
                out["worst_gap_ratio"] = max(out["worst_gap_ratio"],
                                             gap / max(2 * diff, 1e-30))
    return out


def _mixer_build(name: str) -> tuple:
    """(ctx, cfg, params) of ``name`` on this rank: the serving layout
    drawn directly (the experts' slab of this rank, every other leaf
    whole), on the model's mesh under decode_std."""
    from repro_torch.core import expert_parallel as ep_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.sharding.context import MeshContext
    ctx = MeshContext.for_mesh(make_host_mesh(MIXER_MODELS[name][2][1],
                                              device="cuda"), "decode_std")

    def cut(d, t):
        slab = "expert_embed" in d.axes
        return ctx.shard_leaf(t, tuple(
            s if slab and ax == "experts" else ()
            for ax, s in zip(d.axes, ctx.resolve(d.shape, d.axes))))
    cfg, params = _mixer_params(name, cut=cut)
    return ctx, cfg, ep_lib.serve_layout(params, lm.lm_defs(cfg), ctx)


def _mixer_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of phase 29 (a spawned process)."""
    import os
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store_mixer')}",
        rank=rank, world_size=world)
    try:
        out = _mixer_rank_body(rank, workdir)
        with open(os.path.join(workdir, f"mixer_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _mixer_rank_body(rank: int, workdir: str) -> dict:
    import gc
    import os
    import numpy as np
    import torch
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    clock = _CollectiveClock()
    res = {"rank": rank}
    t0 = time.perf_counter()
    built = _mixer_build("jamba")
    ctx, cfg, params = built
    for sc_kw, trace in _mixer_traffic("jamba", cfg).values():
        ServeEngine(params, cfg, ServeConfig(**sc_kw), device="cuda",
                    ctx=ctx).generate(np.stack([p[:PROMPT_LEN]
                                                for p, _, _ in trace]), 2)
    torch.cuda.synchronize()
    res["warmup_s"] = time.perf_counter() - t0
    done = os.path.join(workdir, "mixer_done")
    while not os.path.exists(done):
        check(time.perf_counter() - t0 < 900,
              "mesh mixers: the references not done after 900 s")
        time.sleep(0.05)
    for name in MIXER_MODELS:
        ctx, cfg, params = built if name == "jamba" else _mixer_build(name)
        built = None
        ref = torch.load(os.path.join(workdir, f"mixer_{name}.pt"),
                         weights_only=False)
        for traffic, (sc_kw, trace) in _mixer_traffic(name, cfg).items():
            what = f"mesh mixers rank {rank} {name} {traffic}"
            pin = (_TopkPin([c for call in ref["routes"] for c in call])
                   if cfg.n_experts else None)
            run = _mesh_serve_run(what, cfg, params, sc_kw, trace, ctx=ctx,
                                  launches=_mixer_launches(cfg),
                                  follow=ref["samples"], pin=pin,
                                  clock=clock)
            dec = run["decode_collectives"]
            errs = _logit_errs(run["calls"], ref["calls"],
                               run["first_slot"], run["n_local"])
            check(errs["calls_compared"] == len(ref["calls"]),
                  f"{what}: {errs['calls_compared']} of "
                  f"{len(ref['calls'])} calls compared")
            check(errs["worst_bf16_units"] <= MIXER_LOGIT_UNITS,
                  f"{what}: logits {errs['worst_bf16_units']:.3g} bf16 units "
                  f"({errs['worst_rel']:.4g} of the scale) from one process "
                  f"(tol {MIXER_LOGIT_UNITS} units)")
            greedy = _greedy_errs(run, ref)
            check(greedy["worst_gap_ratio"] <= 1.0,
                  f"{what}: a greedy token differs from one process's "
                  f"beyond a near tie ({json.dumps(greedy)})")
            if pin is not None:
                check(pin.worst_ratio <= 1.0,
                      f"{what}: a routing flip is no near tie (the "
                      f"recorded gap {pin.worst_ratio:.3g} x twice the "
                      "gate logits' difference)")
                check(sum(pin.flips) <= MIXER_MAX_FLIPS,
                      f"{what}: {sum(pin.flips)} routing flips pinned "
                      f"(at most {MIXER_MAX_FLIPS})")
            s = run["summary"]
            res[f"{name}_{traffic}"] = dict(
                s, mesh=ctx.sizes, logits=errs, greedy=greedy,
                routing_flips=None if pin is None else pin.flips,
                flip_gap_ratio=None if pin is None else pin.worst_ratio,
                collective_ms=dict(clock.ms),
                collective_bytes=dict(clock.bytes),
                collective_calls=dict(clock.calls), decode_collectives=dec,
                decode_collective_share=(sum(dec["ms"].values())
                                         / s["decode_ms_total"]))
            del run
        del params, ref
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase_mesh_mixers() -> dict:
    """Phase 29: the references on this process (the ranks warming up
    beside them), then the two ranks."""
    import gc
    import os
    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    world = 2
    with tempfile.TemporaryDirectory() as workdir:
        procs = mp.spawn(_mixer_rank, args=(world, workdir), nprocs=world,
                         join=False)
        try:
            out = mixer_reference(workdir)
            gc.collect()
            torch.cuda.empty_cache()
            open(os.path.join(workdir, "mixer_done"), "w").close()
            out["reference_s"] = time.perf_counter() - t0
            while not procs.join():
                pass
        except Exception as err:       # a rank failed: the phase fails
            for proc in procs.processes:
                proc.terminate()
            if isinstance(err, SmokeFailure):
                raise
            raise SmokeFailure(f"mesh mixers ranks: {err}")
        out["ranks_after_reference_s"] = (time.perf_counter() - t0
                                          - out["reference_s"])
        ranks = []
        for r in range(world):
            with open(os.path.join(workdir, f"mixer_rank{r}.json")) as f:
                ranks.append(json.load(f))
    runs = [key for key in ranks[0] if key not in ("rank", "warmup_s")]
    for key in runs:
        check(ranks[0][key]["stats"] == ranks[1][key]["stats"],
              f"mesh mixers {key}: the ranks' engine stats differ")
        r0 = ranks[0][key]
        log(f"mesh mixers {key} " + json.dumps(
            [{"rank": r["rank"], **r[key]} for r in ranks]))
        log(f"mesh mixers {key} a rank: decode step "
            f"{r0['decode_step_ms_median']:.2f} ms (one process "
            f"{out[key.split('_')[0]]['decode_step_ms_median']:.2f}); "
            "collectives in decode (calls, bytes, share of the decode time) "
            f"{json.dumps(r0['decode_collectives']['op_calls'])}, "
            f"{json.dumps(r0['decode_collectives']['bytes'])}, "
            f"{r0['decode_collective_share']:.3f}; peak "
            + ", ".join(f"{r[key]['peak_gib']:.2f}" for r in ranks)
            + " GiB a rank; logits "
            + ", ".join(f"{r[key]['logits']['worst_rel']:.4g} "
                        f"({r[key]['logits']['worst_bf16_units']:.3g} bf16 "
                        "units)" for r in ranks)
            + f" of the scale; greedy {json.dumps(r0['greedy'])}; routing "
            f"flips {sum(r0['routing_flips'] or [])} (worst gap ratio "
            f"{r0['flip_gap_ratio']}); launches "
            + json.dumps(r0["launches"]))
    out["ranks"] = ranks
    out["wall_s"] = time.perf_counter() - t0
    log(f"mesh mixers phase {out['wall_s']:.1f} s (the references "
        f"{out['reference_s']:.1f} s, then the ranks "
        f"{out['ranks_after_reference_s']:.1f} s; their warm-ups "
        + ", ".join(f"{r['warmup_s']:.1f}" for r in ranks) + " s)")
    return out


# ---------------------------------------------------------------------------
# phase 30: the dense layers tensor-parallel (gemma3-27b one period on two
# gloo ranks whose row is whole on both)
# ---------------------------------------------------------------------------

# (data, model): the one B 1 x S 4096 row whole on both model ranks, as
# a (16, 16) rank holds its row of train_4k.
DENSE_TP_MESH = (1, 2)
# Step 0's loss against phase 17's one process (relative): one bf16 unit.
DENSE_TP_LOSS_TOL = 2.0 ** -8
# Each gradient leaf's norm on a rank's slice (relative), and the
# normwise error of a fixed sample of its elements, against one process:
# bf16 gradients whose partial sums meet in another order.  The first two
# card runs (64 samples a leaf): worst norm 0.0025 / 0.0036 (a q_norm
# scale's), worst sample 0.038 / 0.058 (the embedding's, whose sample is
# mostly rows no token of the batch reaches); the gates are about twice
# those, the sample now 4096 elements a leaf.
DENSE_TP_NORM_TOL = 0.01
DENSE_TP_SAMPLE_TOL = 0.1
DENSE_TP_SAMPLES = 4096
# Phase 17's one-process step 0 (its generator's state before the
# weights, the loss, each leaf's slice norms and samples a rank).
DENSE_TP_REF: dict = {}


def _dense_tp_slices(t, d, rank: int) -> object:
    """The slice of a leaf ``t`` (ParamDef ``d``) that rank ``rank`` of
    DENSE_TP_MESH holds by the dp_tp_ep plan (``MeshContext.shard``'s
    cut), as a view."""
    from repro_torch.sharding import partition
    sizes = dict(zip(("data", "model"), DENSE_TP_MESH))
    coords = {"data": rank // sizes["model"], "model": rank % sizes["model"]}
    spec = partition.resolve_spec(partition.PLANS["dp_tp_ep"], sizes,
                                  d.shape, d.axes)
    for dim, axes in enumerate(spec):
        if axes:
            n, idx = 1, 0
            for a in axes:
                n, idx = n * sizes[a], idx * sizes[a] + coords[a]
            m = t.shape[dim] // n
            t = t.narrow(dim, idx * m, m)
    return t


def _dense_tp_sample(g) -> tuple:
    """(f32 norm, a fixed sample of DENSE_TP_SAMPLES elements) of a
    gradient slice."""
    import torch
    flat = g.reshape(-1)
    idx = (torch.arange(DENSE_TP_SAMPLES, device=flat.device)
           * (flat.numel() - 1)) // (DENSE_TP_SAMPLES - 1)
    return float(g.float().norm()), flat[idx].float().cpu()


def dense_tp_reference(cfg, params, batch) -> None:
    """Phase 30's one-process reference, in phase 17 on its weights before
    its first step: step 0's gradient (``lm_loss``, one backward pass),
    and of each leaf, a rank's slice's norm and sample for each rank."""
    import math
    import torch
    from repro_torch.common.param import tree_leaves
    from repro_torch.models import lm
    t0 = time.perf_counter()
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, _ = lm.lm_loss(params, batch, cfg)
    loss.backward()
    leaves = {}
    defs = lm.lm_defs(cfg)
    for (path, d), p in zip(_named_leaves(defs), tree_leaves(params)):
        leaves[path] = [_dense_tp_sample(_dense_tp_slices(p.grad, d, r))
                        for r in range(math.prod(DENSE_TP_MESH))]
    for p in tree_leaves(params):
        p.grad = None
    torch.cuda.empty_cache()
    DENSE_TP_REF.update(loss=float(loss), leaves=leaves,
                        reference_s=time.perf_counter() - t0)
    log(f"dense tp reference: one process's step-0 loss {float(loss):.6f}, "
        f"{len(leaves)} leaves in {DENSE_TP_REF['reference_s']:.1f} s")


def dense_tp_all_reduces(cfg, seq: int, n_replicated: int) -> int:
    """The all-reduce calls of a rank's gradient step on DENSE_TP_MESH,
    derived from the code: the vocab-parallel embedding's exit (forward,
    backward); each layer's attention and FFN exits, forward and
    backward, and under remat the attention's again in the recompute
    (``torch.utils.checkpoint`` stops its recompute at the last tensor
    the backward pass saved, the FFN's second product, before the FFN's
    exit); each loss chunk's max and packed sum (forward, the
    checkpoint's recompute) and the sum's backward; the replica sum of
    each leaf whole on ``model``; the metrics' mean."""
    chunks = seq // min(512, seq)
    per_layer = 5 if cfg.remat else 4
    return 2 + cfg.n_layers * per_layer + chunks * 5 + n_replicated + 1


def _dense_tp_trace(path: str) -> None:
    """A spawned process (no CUDA): the rank's training step traced on
    ``meta`` under a fake DENSE_TP_MESH group (``launch/steps.py``'s
    step, as the dry run traces a cell); its record to ``path``."""
    from repro_torch.configs.base import get_config
    import os
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, steps
    cfg = get_config(GEMMA)
    cfg = cfg.replace(n_layers=cfg.period)
    spec = steps.build_step(
        cfg, ShapeSpec("gemma3-27b train tp", "train", GEMMA_TRAIN_S,
                       GEMMA_TRAIN_B),
        dryrun.fake_mesh(dict(zip(("data", "model"), DENSE_TP_MESH))))
    tr = dryrun.trace_step(spec, flops=False)
    with open(path + ".tmp", "w") as f:
        json.dump({k: tr[k] for k in ("memory", "collectives", "trace_s")},
                  f)
    os.replace(path + ".tmp", path)


def _dense_tp_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of phase 30 (a spawned process)."""
    import os
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store_tp')}",
        rank=rank, world_size=world)
    try:
        out = _dense_tp_rank_body(rank, workdir)
        with open(os.path.join(workdir, f"tp_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _dense_tp_rank_body(rank: int, workdir: str) -> dict:
    """The rank's slices drawn from phase 17's generator state (each leaf
    drawn whole, the rank's slice kept), the dense leaves the loss gets,
    then one training step (``make_train_step``'s gradients, then the
    update) under the collective recorder: loss, each leaf's slice
    against one process, the all-reduces, the card's peak."""
    import math
    import os
    import torch
    from repro_torch.common import param as pm
    from repro_torch.configs.base import get_config
    from repro_torch.core import expert_parallel as ep_lib
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, transformer
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.sharding.context import MeshContext, record_collectives
    from repro_torch.train.trainer import make_grad_fn, step_seed
    t0 = time.perf_counter()
    ref = torch.load(os.path.join(workdir, "tp_ref.pt"), weights_only=False)
    cfg = get_config(GEMMA)
    cfg = cfg.replace(n_layers=cfg.period)
    defs = lm.lm_defs(cfg)
    ctx = MeshContext.for_mesh(make_host_mesh(DENSE_TP_MESH[1],
                                              device="cuda"), "dp_tp_ep")
    gen = torch.Generator(device="cuda")
    gen.set_state(ref["gen_state"])
    local = pm.materialize(defs, gen, "cuda", cut=lambda d, t: ctx.shard_leaf(
        t, ctx.resolve(d.shape, d.axes)))
    for p in pm.tree_leaves(local):
        p.requires_grad_(True)
    torch.cuda.synchronize()
    res = {"rank": rank, "build_s": time.perf_counter() - t0}
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=GEMMA_TRAIN_S,
                    batch_size=GEMMA_TRAIN_B, seed=SEED)
    rows = ctx.split_rows(GEMMA_TRAIN_B, GEMMA_TRAIN_S)
    res["tp_axes"] = transformer.dense_tp(cfg, rows)
    with torch.no_grad():
        used = ep_lib.gather_on_use(local, defs, rows, tp=True)
    dense = {"used": 0, "whole": 0}
    for (path, d), t in zip(_named_leaves(defs), pm.tree_leaves(used)):
        if ep_lib._tp_dims(d, path.split(".")[-2], rows):
            dense["used"] += t.numel() * t.element_size()
            dense["whole"] += math.prod(d.shape) * t.element_size()
    res["dense_bytes"] = dense
    del used
    specs = ctx.specs(defs)
    res["replicated_leaves"] = sum(
        1 for s in pm.tree_leaves(specs)
        if "model" not in {a for axes in s for a in axes})
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    oc = opt_lib.OptConfig(kind="factored")
    opt = opt_lib.init(local, oc)
    batch = batch_at(dc, 0, device="cuda")
    grads_fn = make_grad_fn(lambda p, b, g: lm.lm_loss(p, b, cfg, generator=g,
                                                       ctx=ctx),
                            ctx=ctx, defs=defs)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t1 = time.perf_counter()
    with record_collectives() as table:
        grads, metrics = grads_fn(
            local, batch,
            torch.Generator(device="cuda").manual_seed(step_seed(SEED, 0)))
    torch.cuda.synchronize()
    res["grad_s"] = time.perf_counter() - t1
    res["collectives"] = table
    res["launches"] = cuda_lib.launch_counts()
    res["loss"] = float(metrics["loss"])
    worst = {"norm": 0.0, "sample": 0.0, "norm_leaf": None,
             "sample_leaf": None}
    for (path, _), g in zip(_named_leaves(defs), pm.tree_leaves(grads)):
        norm, sample = _dense_tp_sample(g)
        rnorm, rsample = ref["leaves"][path][rank]
        e_norm = abs(norm - rnorm) / max(rnorm, 1e-30)
        e_sample = float((sample - rsample).norm()) / max(
            float(rsample.norm()), 1e-30)
        if e_norm > worst["norm"]:
            worst.update(norm=e_norm, norm_leaf=path)
        if e_sample > worst["sample"]:
            worst.update(sample=e_sample, sample_leaf=path)
    res["grads"] = worst
    t1 = time.perf_counter()
    opt_lib.apply_updates(local, grads, opt, oc, ctx=ctx, defs=defs)
    torch.cuda.synchronize()
    res["update_s"] = time.perf_counter() - t1
    res["card_peak"] = (torch.cuda.max_memory_allocated() - base
                        + _storage_bytes(local))
    res["wall_s"] = time.perf_counter() - t0
    return res


def phase_dense_tp() -> dict:
    """Phase 30: gemma3-27b one period (5 windowed layers, 1 global) at
    full width, bf16, remat, factored Adam, B 1 x S 4096 on two gloo
    ranks sharing the card on (data 1, model 2): the row whole on both,
    so each runs its half of the query heads (16 of 32), key / value
    heads (8 of 16), d_ff (10,752 of 21,504) and vocabulary (131,072 of
    262,144).  Gates: each rank's dense leaves exactly half one
    process's bytes; step 0's loss within DENSE_TP_LOSS_TOL of phase
    17's one process, each gradient leaf's slice norm and sample within
    DENSE_TP_NORM_TOL / DENSE_TP_SAMPLE_TOL; the all-reduce calls of
    the gradient step exactly :func:`dense_tp_all_reduces`; no kernel
    launch (a dense model); each rank's card peak within DRYRUN_BAND of
    its step traced on meta."""
    import math
    import multiprocessing
    import os
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs.base import get_config
    t0 = time.perf_counter()
    check("leaves" in DENSE_TP_REF and "step0_loss" in DENSE_TP_REF,
          "dense tp: phase 17's one-process reference is missing")
    world = math.prod(DENSE_TP_MESH)
    cfg = get_config(GEMMA)
    cfg = cfg.replace(n_layers=cfg.period)
    with tempfile.TemporaryDirectory() as workdir:
        torch.save(DENSE_TP_REF, os.path.join(workdir, "tp_ref.pt"))
        trace_out = os.path.join(workdir, "tp_trace.json")
        tracer = multiprocessing.get_context("spawn").Process(
            target=_dense_tp_trace, args=(trace_out,))
        tracer.start()
        procs = mp.spawn(_dense_tp_rank, args=(world, workdir),
                         nprocs=world, join=False)
        try:
            while not procs.join():
                pass
        except Exception as err:       # a rank failed: the phase fails
            for proc in procs.processes:
                proc.terminate()
            tracer.terminate()
            raise SmokeFailure(f"dense tp ranks: {err}")
        tracer.join(timeout=300)
        check(tracer.exitcode == 0 and os.path.exists(trace_out),
              f"dense tp: the meta trace failed ({tracer.exitcode})")
        with open(trace_out) as f:
            traced = json.load(f)
        ranks = []
        for r in range(world):
            with open(os.path.join(workdir, f"tp_rank{r}.json")) as f:
                ranks.append(json.load(f))
    one = DENSE_TP_REF["step0_loss"]
    check(abs(DENSE_TP_REF["loss"] - one) <= DENSE_TP_LOSS_TOL * abs(one),
          f"dense tp: the reference's loss {DENSE_TP_REF['loss']} is not "
          f"phase 17's step 0 ({one})")
    peak_traced = traced["memory"]["peak_bytes_per_device"]
    act = ranks[0]["collectives"].get("all_reduce", {"calls": 0,
                                                     "bytes": 0})
    want_calls = dense_tp_all_reduces(cfg, GEMMA_TRAIN_S,
                                      ranks[0]["replicated_leaves"])
    # Each exit moves [B, S, d] in the compute dtype, 2 (g - 1) / g of it.
    g = DENSE_TP_MESH[1]
    exit_bytes = (GEMMA_TRAIN_B * GEMMA_TRAIN_S * cfg.d_model * 2
                  * 2 * (g - 1) / g)
    exits = 2 + cfg.n_layers * (5 if cfg.remat else 4)
    for r in ranks:
        what = f"dense tp rank {r['rank']}"
        check(r["tp_axes"] == {k: ["model"] for k in (
            "heads", "kv_heads", "mlp", "vocab")},
              f"{what}: tensor-parallel axes {r['tp_axes']}")
        check(2 * r["dense_bytes"]["used"] == r["dense_bytes"]["whole"],
              f"{what}: dense leaves {r['dense_bytes']} are not half")
        check(abs(r["loss"] - one) <= DENSE_TP_LOSS_TOL * abs(one),
              f"{what}: step-0 loss {r['loss']} against one process's "
              f"{one} (tol {DENSE_TP_LOSS_TOL} relative)")
        check(r["grads"]["norm"] <= DENSE_TP_NORM_TOL,
              f"{what}: gradient norm {r['grads']} (tol "
              f"{DENSE_TP_NORM_TOL})")
        check(r["grads"]["sample"] <= DENSE_TP_SAMPLE_TOL,
              f"{what}: gradient sample {r['grads']} (tol "
              f"{DENSE_TP_SAMPLE_TOL})")
        calls = r["collectives"].get("all_reduce", {}).get("calls", 0)
        check(calls == want_calls,
              f"{what}: {calls} all-reduces, {want_calls} derived")
        check(not any(r["launches"].values()),
              f"{what}: a dense model launched kernels: {r['launches']}")
        ratio = peak_traced / r["card_peak"]
        r["peak_ratio"] = ratio
        check(DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1],
              f"{what}: traced peak {peak_traced} / card peak "
              f"{r['card_peak']} = {ratio:.4f} outside {DRYRUN_BAND}")
    out = {"config": f"{GEMMA}, one period ({cfg.n_layers} layers), bf16, "
                     f"remat, B={GEMMA_TRAIN_B} x S={GEMMA_TRAIN_S}, "
                     f"factored Adam, mesh {DENSE_TP_MESH} over gloo",
           "one_process_loss": one, "reference_s":
           DENSE_TP_REF["reference_s"], "ranks": ranks,
           "all_reduce": {"calls": act["calls"], "calls_derived": want_calls,
                          "bytes": act["bytes"],
                          "exit_bytes_predicted": exits * exit_bytes},
           "traced": traced, "wall_s": time.perf_counter() - t0}
    log("dense tp " + json.dumps(out))
    log(f"dense tp: loss {[r['loss'] for r in ranks]} against one "
        f"process's {one:.6f}; gradients (worst norm, sample) "
        + ", ".join(f"{r['grads']['norm']:.3g} ({r['grads']['norm_leaf']}), "
                    f"{r['grads']['sample']:.3g} "
                    f"({r['grads']['sample_leaf']})" for r in ranks)
        + f"; all-reduces {act['calls']} (derived {want_calls}), "
        f"{act['bytes']:.0f} B a rank (the {exits} exits' predicted "
        f"{exits * exit_bytes:.0f}); dense bytes a rank "
        f"{ranks[0]['dense_bytes']}; peak a rank "
        + ", ".join(f"{r['card_peak'] / 2**30:.3f}" for r in ranks)
        + f" GiB, traced {peak_traced / 2**30:.3f} GiB (ratio "
        + ", ".join(f"{r['peak_ratio']:.4f}" for r in ranks)
        + f"); a rank's gradients {ranks[0]['grad_s']:.2f} s, update "
        f"{ranks[0]['update_s']:.2f} s, build {ranks[0]['build_s']:.1f} s; "
        f"phase {out['wall_s']:.1f} s")
    return out


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

    def lap(what: str) -> None:
        log(f"{what} done: {time.perf_counter() - t_start:.0f} s so far")
    try:
        traces = start_traces()
        setup = phase_setup()
        late_traces = finish_traces(traces)
        kernels = phase_kernels()
        finish_traces(late_traces, late=True)
        lap("kernels")
        served = run_serve(kernels["floor"])
        gc.collect()
        torch.cuda.empty_cache()
        log(f"serving model freed; {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB still allocated; {time.perf_counter() - t_start:.0f} s "
            "so far")
        moa = phase_moa()
        lap("moa")
        cfg, params = build_train_model()
        with tempfile.TemporaryDirectory() as workdir:
            trained = phase_train(cfg, params, workdir)
        eblock = phase_eblock(cfg, params)
        grads = phase_grads(cfg, params, trained["dc"])
        lap("train, eblock, grads")
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
        lap("hmoe")
        acfg, aparams = build_arctic()
        arctic = phase_arctic(acfg, aparams, kernels["floor"])
        lap("arctic")
        del aparams
        gc.collect()
        torch.cuda.empty_cache()
        qwen3 = phase_qwen3()
        lap("qwen3")
        gc.collect()
        torch.cuda.empty_cache()
        blockwise = phase_blockwise()
        lap("blockwise")
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            moa_train = phase_moa_train(kernels["floor"], workdir)
        lap("moa_train")
        gemma = phase_gemma_serve()
        gc.collect()
        torch.cuda.empty_cache()
        gemma["train"] = phase_gemma_train()
        lap("gemma3")
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as workdir:
            launchers = phase_launchers(workdir)
        lap("launchers")
        gc.collect()
        torch.cuda.empty_cache()
        falcon = phase_falcon_serve()
        lap("falcon serve")
        gc.collect()
        torch.cuda.empty_cache()
        jamba = phase_jamba_serve(kernels["floor"])
        gc.collect()
        torch.cuda.empty_cache()
        jamba["train"] = phase_jamba_train(kernels["floor"])
        lap("jamba")
        log_prefill_medians(setup["card"], served, gemma, jamba)
        gc.collect()
        torch.cuda.empty_cache()
        falcon["train"] = phase_falcon_train()
        lap("falcon train")
        gc.collect()
        torch.cuda.empty_cache()
        distributed = phase_distributed()
        lap("distributed")
        gc.collect()
        torch.cuda.empty_cache()
        mesh = phase_mesh_serve(kernels["floor"])
        lap("mesh serve")
        gc.collect()
        torch.cuda.empty_cache()
        pipeline = phase_pipeline()
        lap("pipeline")
        roof = phase_roofline(
            roofline_paths(served, arctic, qwen3, gemma, falcon, jamba,
                           blockwise),
            roofline_counts(served, qwen3), mesh)
        lap("roofline")
        gc.collect()
        torch.cuda.empty_cache()
        dry = phase_dryrun(mesh)
        lap("dryrun")
        gc.collect()
        torch.cuda.empty_cache()
        routed = phase_mesh_routed()
        lap("mesh routed")
        gc.collect()
        torch.cuda.empty_cache()
        mixers = phase_mesh_mixers()
        lap("mesh mixers")
        gc.collect()
        torch.cuda.empty_cache()
        dense_tp = phase_dense_tp()
        lap("dense tp")
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    finally:
        stop_trace_pool()
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
                "train_jamba": jamba["train"]["counts"],
                "train_dist_ep2": distributed["1x2"]["ranks"][0]["launches"],
                "train_dist_dp2": distributed["2x1"]["ranks"][0]["launches"],
                "serve_mesh": mesh["ranks"][0]["serve"]["launches"],
                "serve_mesh_fused": mesh["ranks"][0]["fused"]["launches"],
                "serve_mesh_prefix": mesh["ranks"][0]["prefix"]["launches"],
                "serve_mesh_tp": mesh["tp"][0]["serve"]["launches"],
                "serve_mesh_tp_fused": mesh["tp"][0]["fused"]["launches"],
                "serve_mesh_tp_prefix": mesh["tp"][0]["prefix"]["launches"],
                "train_pp_kimi": pipeline["kimi"]["ranks"][0]["launches"],
                "train_pp_rows": pipeline["rows"]["launches"],
                "train_pp_moa": pipeline["moa"]["launches"],
                "train_pp_hmoe": pipeline["hmoe"]["launches"],
                "train_mesh_moa_ep2": routed["ranks"][0]["moa_1x2"][
                    "launches"],
                "train_mesh_moa_dp2": routed["ranks"][0]["moa_2x1"][
                    "launches"],
                "train_mesh_moa_drops_ep2": routed["ranks"][0][
                    "moa_drops_1x2"]["launches"],
                "serve_mesh_moa": routed["ranks"][0]["serve_serve"][
                    "launches"],
                "serve_mesh_moa_fused": routed["ranks"][0]["serve_fused"][
                    "launches"],
                "train_mesh_hmoe": routed["ranks"][0]["hmoe"]["launches"],
                "serve_mesh_jamba": mixers["ranks"][0]["jamba_serve"][
                    "launches"],
                "serve_mesh_jamba_fused": mixers["ranks"][0]["jamba_fused"][
                    "launches"]}
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
    k8 = mesh["one"]["kernel8_mesh"]
    measured["fused_routed"].update(max_abs_err_mesh=k8["max_abs_err"],
                                    tol_mesh=k8["tol"], mesh_slab=k8)
    tpk = dict(mesh["one"]["tp_kernels"])
    measured["fused_routed"]["mesh_tp_slice"] = tpk.pop("kernel8")
    measured["gmm"]["mesh_tp_f32_out"] = tpk
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
    for key, r in mixers["kernels"].items():
        name = next(n for n in ("topk_gating", "dispatch", "combine", "gmm",
                                "fused_routed") if key.startswith(n))
        measured[name].setdefault("mesh_jamba", {})[key] = r
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

    def dist_worst(key):
        return max(distributed[m]["worst"][key] for m in ("1x2", "2x1"))

    def dist_step_ms(mesh):
        return distributed[mesh]["ranks"][0]["step_ms_steady"]

    def routed_worst(key):
        return max(r[path]["worst"][key] for r in routed["ranks"]
                   for path in ("moa_1x2", "moa_2x1", "moa_drops_1x2",
                                "hmoe"))
    obs = served["obs"]
    r0 = mixers["ranks"][0]
    mixer_runs = [k for k in r0 if k not in ("rank", "warmup_s")]
    mixer_units = max(r[k]["logits"]["worst_bf16_units"]
                      for r in mixers["ranks"] for k in mixer_runs)
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
        f"step {qwen3['step_ms_median_steps_2_to_4']:.1f} ms, 32k prefill "
        f"{blockwise['prefill_ms']:.1f} ms (chunks of {LONG_CHUNK} "
        f"{blockwise['chunked_prefill_ms']:.1f} ms), peak "
        f"{blockwise['max_memory_allocated_gib']:.2f} GiB; falcon "
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
        f"{obs['overhead']['traced_ms']:.2f} ms; distributed MoE-256 "
        f"step 0 worst loss rel err {dist_worst('loss_rel'):.3g}, "
        f"gradients normwise {dist_worst('grad_norm_rel'):.3g}, rank step "
        f"ms (1, 2) {dist_step_ms('1x2'):.1f} / (2, 1) "
        f"{dist_step_ms('2x1'):.1f}, phase {distributed['wall_s']:.0f} s; "
        "mesh serve (1, 2) decode step ms unfused / fused "
        f"{mesh['ranks'][0]['serve']['decode_step_ms_median']:.1f} / "
        f"{mesh['ranks'][0]['fused']['decode_step_ms_median']:.1f}, logits "
        "worst rel "
        f"{max(r[t]['logits']['worst_rel'] for r in mesh['ranks'] for t in MESH_TRAFFIC):.3g}"
        f"; (2, 1) experts over d_ff {mesh['tp'][0]['serve']['decode_step_ms_median']:.1f}"
        f" / {mesh['tp'][0]['fused']['decode_step_ms_median']:.1f}, logits "
        f"{max(r[t]['logits']['worst_bf16_units'] for r in mesh['tp'] for t in MESH_TRAFFIC):.3g}"
        f" bf16 units, phase {mesh['wall_s']:.0f} s; pipeline qwen3 loss rel "
        f"{pipeline['qwen']['worst']['loss_rel']:.3g}, gradients "
        f"{pipeline['qwen']['worst']['grad_norm_rel']:.3g}, step ms "
        f"{pipeline['qwen']['ranks'][0]['step_ms'][-1]:.1f}, phase "
        f"{pipeline['wall_s']:.0f} s; roofline: bound share "
        + ", ".join(f"{r['shape']} {r['bound_share']:.3f}"
                    for r in roof["records"])
        + "; FLOPs analytic / counted "
        + ", ".join(f"{k} {v:.3f}" for k, v in roof["flop_ratios"].items())
        + "; decode wire analytic / measured "
        + ", ".join(f"{k} {v['ratio']:.3f}" for k, v in roof["wire"].items())
        + "; dry-run peak / card peak "
        + ", ".join(f"{r['shape']} {r['peak_ratio']:.3f}"
                    for r in dry["records"])
        + f", phase {dry['wall_s']:.0f} s"
        + "; mesh routed (moa-demo (1, 2) / (2, 1), moe-4096-h (1, 2)) "
        f"step 0 worst loss rel {routed_worst('loss_rel'):.3g}, "
        f"gradients normwise {routed_worst('grad_norm_rel'):.3g}, "
        "moe-4096-h rank step ms "
        f"{routed['ranks'][0]['hmoe']['step_ms']:.1f} (collectives "
        f"{routed['ranks'][0]['hmoe']['collective_share']:.3f} of it), "
        "moa-demo served logits worst rel "
        f"{max(r['serve_' + t]['logits']['worst_rel'] for r in routed['ranks'] for t in ROUTED_TRAFFIC):.3g}"
        f", phase {routed['wall_s']:.0f} s"
        + "; mesh mixers decode step ms a rank / one process: "
        + ", ".join(f"{k} {r0[k]['decode_step_ms_median']:.1f} / "
                    f"{mixers[k.split('_')[0]]['decode_step_ms_median']:.1f}"
                    for k in mixer_runs)
        + f", logits worst {mixer_units:.3g} bf16 units"
        f", phase {mixers['wall_s']:.0f} s"
        + f"; {time.perf_counter() - t_start:.0f} s in all")
    print(setup["card"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
