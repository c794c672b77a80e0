// Fused top-k gating: kk rounds of masked row argmax, softmax over the
// top k, and the raw top-kk values; and its backward pass.
//
// Replaces the TPU kernel repro/kernels/topk_gating.py::_topk_kernel
// (pallas_call in _topk_raw).  Semantics kept exactly: each round takes
// the row maximum with ties to the LOWEST index (jnp.argmax), then masks
// the winner to NEG = -1e30 (a finite value, so a later round may pick it
// again only if every remaining logit is below -1e30, as on the TPU);
// the weights are the softmax of the first k values in f32.  Indices are
// written as int32 (the JAX version carries them as f32 across its VJP
// boundary; the port does not).
//
// Bound on the H100: bytes.  It reads T*E*4 bytes of logits and writes
// T*(k + 2*kk)*4; the arithmetic is kk*E compares per row.  Design: one
// warp per token row with the whole row in registers (E <= 32*VPL, 12
// values per lane for E = 384), so the logits are read from device memory
// exactly once, coalesced; each round is a per-lane scan plus a 5-step
// shuffle reduction whose comparator breaks ties on the lower index.
#include "common.cuh"

#include <limits.h>

#define TOPK_NEG (-1e30f)
#define TOPK_WARPS 4

template <int VPL>
__global__ void __launch_bounds__(32 * TOPK_WARPS)
topk_gating_kernel(const float* __restrict__ logits, float* __restrict__ w,
                   int* __restrict__ idx, float* __restrict__ vals, int T,
                   int E, int k, int kk) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * TOPK_WARPS + (threadIdx.x >> 5);
  if (row >= T) return;  // the whole warp leaves together
  const float* src = logits + (long long)row * E;
  float v[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int e = lane + 32 * j;
    v[j] = (e < E) ? src[e] : 0.f;
  }
  float my_val = 0.f;
  int my_idx = 0;
  for (int r = 0; r < kk; ++r) {
    // Lane-local best; INT_MAX marks "no candidate" (lanes past E).
    float best = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int e = lane + 32 * j;
      if (e < E && (bi == INT_MAX || v[j] > best)) {
        best = v[j];
        bi = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (oi != INT_MAX &&
          (bi == INT_MAX || ov > best || (ov == best && oi < bi))) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == r) {
      my_val = best;
      my_idx = bi;
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (lane + 32 * j == bi) v[j] = TOPK_NEG;
  }
  // Softmax over the first k values; the top-1 value is the maximum.
  const float mx = __shfl_sync(0xffffffffu, my_val, 0);
  const float p = (lane < k) ? expf(my_val - mx) : 0.f;
  float s = p;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane < k) w[(long long)row * k + lane] = p / s;
  if (lane < kk) {
    idx[(long long)row * kk + lane] = my_idx;
    vals[(long long)row * kk + lane] = my_val;
  }
}

template <int VPL>
static void launch_topk(const float* logits, float* w, int* idx, float* vals,
                        int T, int E, int k, int kk, cudaStream_t stream) {
  const dim3 grid((T + TOPK_WARPS - 1) / TOPK_WARPS);
  topk_gating_kernel<VPL><<<grid, 32 * TOPK_WARPS, 0, stream>>>(
      logits, w, idx, vals, T, E, k, kk);
}

extern "C" int repro_topk_gating(const float* logits, float* w, int* idx,
                                 float* vals, int T, int E, int k, int kk,
                                 cudaStream_t stream) {
  if (T <= 0) return 0;
  if (E <= 0 || k < 1 || kk < k || kk > 32 || kk > E || E > 32 * 32)
    return (int)cudaErrorInvalidValue;
  const int vpl = (E + 31) / 32;
  if (vpl <= 1) launch_topk<1>(logits, w, idx, vals, T, E, k, kk, stream);
  else if (vpl <= 2) launch_topk<2>(logits, w, idx, vals, T, E, k, kk, stream);
  else if (vpl <= 4) launch_topk<4>(logits, w, idx, vals, T, E, k, kk, stream);
  else if (vpl <= 8) launch_topk<8>(logits, w, idx, vals, T, E, k, kk, stream);
  else if (vpl <= 12) launch_topk<12>(logits, w, idx, vals, T, E, k, kk, stream);
  else if (vpl <= 16) launch_topk<16>(logits, w, idx, vals, T, E, k, kk, stream);
  else launch_topk<32>(logits, w, idx, vals, T, E, k, kk, stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward pass: replaces repro/kernels/topk_gating.py::_topk_bwd (the
// custom VJP at l.116, plain XLA on the TPU).  For each row:
//   s        = <w, dw>, summed over j = 0..k-1 in ascending order
//   dv_j     = w_j * (dw_j - s)                        (softmax Jacobian)
//   full_j   = dvals_j + dv_j  (j < k),  dvals_j  (k <= j < kk)
//   dlogits  = zeros [E] with full_j written at column idx_j
// Every product, difference and sum is rounded on its own (no fused
// multiply-add), so the result is bit-identical to the plain version.
//
// Bound on the H100: bytes.  The [T, E] f32 output is written once
// (4.2 MB at T = 4096, E = 256); the inputs are T*(2k + 2kk)*4 bytes.
// Design: one warp per token row.  The kk (index, value) pairs go to
// shared memory; each lane then writes its columns of the row exactly
// once, as 0 plus the values of the pairs that hit the column (the
// indices of a row are distinct, so at most one does), in coalesced
// 128-byte stores.  No memset, no read-modify-write, no atomics.
template <int ROWS>
__global__ void __launch_bounds__(32 * ROWS)
topk_gating_bwd_kernel(const float* __restrict__ w, const int* __restrict__ idx,
                       const float* __restrict__ dw,
                       const float* __restrict__ dvals,
                       float* __restrict__ dlogits, int T, int E, int k,
                       int kk) {
  __shared__ int s_idx[ROWS][32];
  __shared__ float s_val[ROWS][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int row = blockIdx.x * ROWS + wid;
  if (row >= T) return;  // the whole warp leaves together
  const float* wr = w + (long long)row * k;
  const float* dwr = dw + (long long)row * k;
  float s = 0.f;
  for (int j = 0; j < k; ++j) s = __fadd_rn(s, __fmul_rn(wr[j], dwr[j]));
  if (lane < kk) {
    float v = dvals[(long long)row * kk + lane];
    if (lane < k) v = __fadd_rn(v, __fmul_rn(wr[lane], __fsub_rn(dwr[lane], s)));
    s_idx[wid][lane] = idx[(long long)row * kk + lane];
    s_val[wid][lane] = v;
  }
  __syncwarp();
  float* out = dlogits + (long long)row * E;
  for (int e = lane; e < E; e += 32) {
    float acc = 0.f;
    for (int j = 0; j < kk; ++j)
      if (s_idx[wid][j] == e) acc = __fadd_rn(acc, s_val[wid][j]);
    out[e] = acc;
  }
}

extern "C" int repro_topk_gating_bwd(const float* w, const int* idx,
                                     const float* dw, const float* dvals,
                                     float* dlogits, int T, int E, int k,
                                     int kk, cudaStream_t stream) {
  if (T <= 0) return 0;
  if (E <= 0 || k < 1 || kk < k || kk > 32 || kk > E)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TOPK_WARPS - 1) / TOPK_WARPS);
  topk_gating_bwd_kernel<TOPK_WARPS><<<grid, 32 * TOPK_WARPS, 0, stream>>>(
      w, idx, dw, dvals, dlogits, T, E, k, kk);
  return (int)cudaGetLastError();
}
