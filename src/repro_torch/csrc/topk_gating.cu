// Fused top-k gating: kk rounds of masked row argmax, softmax over the
// top k, and the raw top-kk values; and its backward pass.
//
// Replaces the TPU kernel repro/kernels/topk_gating.py::_topk_kernel
// (pallas_call in _topk_raw).  Semantics kept exactly: each round takes
// the row maximum with ties to the LOWEST index (jnp.argmax), then masks
// the winner to NEG = -1e30 (a finite value, so a later round may pick it
// again only if every remaining logit is below -1e30, as on the TPU);
// the weights are the softmax of the first k values in f32, with the
// first value as its maximum.  Indices are written as int32 (the JAX
// version carries them as f32 across its VJP boundary; the port does
// not).
//
// Bound on the H100: bytes.  It reads T*E*4 bytes of logits and writes
// T*(k + 2*kk)*4; the arithmetic is kk*E compares per row.  At the
// serving shape (T = 8, E = 384, kk = 9) that is nanoseconds of traffic:
// the time is the launch and the kk dependent rounds of each row, so the
// design shortens the chain of a round.
//
// Design: one warp per token row, the whole row in registers (E <=
// 32*VPL, 12 values per lane at E = 384), read from device memory once,
// coalesced.  Each logit is held as a 32-bit order key (the float's bits
// flipped so that unsigned order is float order, -0 taken as +0), which
// lets the warp's maximum be one `redux.sync` instruction instead of a
// five-stage shuffle butterfly.  A round is then:
//   1. each lane's best (largest key, lowest slot on a tie) by a
//      tournament tree over its VPL keys: log2(VPL) levels;
//   2. the warp's largest key: __reduce_max_sync;
//   3. the lowest index among the lanes holding it: __reduce_min_sync;
//   4. the winner's key is set to NEG's key in the lane that owns it.
// The two other designs considered, and why not:
//   - sorting each lane's values once and advancing a head: in SIMT the
//     warp issues the winning lane's head update for all lanes, which
//     costs as much as the tree it saves, and the sort comes on top;
//   - splitting a row over several warps at small T: every round would
//     then need a cross-warp merge through shared memory and a barrier,
//     longer than the tree it shortens.
// Four rows share a block; at small T this leaves SMs idle, but a row's
// time is its own chain and four warps of a block run on the SM's four
// schedulers side by side.  The values written out are the keys decoded
// back, so a -0 logit comes back as +0 (equal as floats).
#include "common.cuh"

#define TOPK_NEG (-1e30f)
#define TOPK_WARPS 4

// Unsigned order of the key is the float order of the value (NaN aside).
static __device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.f));  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

static __device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The lane's best slot: the largest key, the lowest slot on a tie (the
// left operand of every comparison holds the lower slots).
template <int VPL>
static __device__ __forceinline__ void lane_best(const unsigned (&key)[VPL],
                                                 unsigned& best, int& slot) {
  unsigned kb[VPL];
  int jb[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    kb[j] = key[j];
    jb[j] = j;
  }
#pragma unroll
  for (int s = 1; s < VPL; s *= 2) {
#pragma unroll
    for (int j = 0; j + s < VPL; j += 2 * s) {
      if (kb[j + s] > kb[j]) {
        kb[j] = kb[j + s];
        jb[j] = jb[j + s];
      }
    }
  }
  best = kb[0];
  slot = jb[0];
}

template <int VPL>
__global__ void __launch_bounds__(32 * TOPK_WARPS)
topk_gating_kernel(const float* __restrict__ logits, float* __restrict__ w,
                   int* __restrict__ idx, float* __restrict__ vals, int T,
                   int E, int k, int kk) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * TOPK_WARPS + (threadIdx.x >> 5);
  if (row >= T) return;  // the whole warp leaves together
  const float* src = logits + (long long)row * E;
  // Key 0 lies below every real value's key (-inf's is 0x007fffff), so
  // a slot past E never wins.
  unsigned key[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int e = lane + 32 * j;
    key[j] = (e < E) ? order_key(src[e]) : 0u;
  }
  const unsigned neg = order_key(TOPK_NEG);
  unsigned my_key = 0u;
  int my_idx = 0;
  for (int r = 0; r < kk; ++r) {
    unsigned best;
    int slot;
    lane_best<VPL>(key, best, slot);
    const unsigned top = __reduce_max_sync(full, best);
    const unsigned mine = (best == top) ? (unsigned)(lane + 32 * slot) : 0xffffffffu;
    const int win = (int)__reduce_min_sync(full, mine);
    if (lane == r) {
      my_key = top;
      my_idx = win;
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (lane + 32 * j == win) key[j] = neg;
  }
  // Softmax over the first k values; the top-1 value is the maximum.
  const float my_val = key_value(my_key);
  const float mx = __shfl_sync(full, my_val, 0);
  const float p = (lane < k) ? expf(my_val - mx) : 0.f;
  float s = p;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(full, s, off);
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
//   s        = <w, dw>, summed over j = 0..k-1 in ascending order from +0
//   dv_j     = w_j * (dw_j - s)                        (softmax Jacobian)
//   full_j   = dvals_j + dv_j  (j < k),  dvals_j  (k <= j < kk)
//   dlogits  = zeros [E] plus full_j at column idx_j, over j ascending
// A row's indices repeat when fewer than kk of its logits lie above
// -1e30 (later rounds re-pick a masked winner); such a column is the
// sum from +0 over its j in ascending order, the order of the
// reference's .at[].add.  Every product, difference and sum is rounded
// on its own (no fused multiply-add), so the result is bit-identical to
// the plain version.
//
// Bound on the H100: bytes.  The [T, E] f32 output is written once
// (4.2 MB at T = 4096, E = 256); the inputs are T*(2k + 2kk)*4 bytes.
// Design: one warp per row, four rows a block.  Lane j < k reads w_j and
// dw_j, lane j < kk idx_j and dvals_j: one trip to memory for the row.
// s is lane j's product added in ascending j by k shuffles (every lane
// runs the same chain), then lane j < kk forms full_j.  A lane owns NQ
// pieces of PN contiguous columns (PN = 4, one 16-byte store, when
// E % 4 == 0 and the output is aligned; else single columns), piece q
// at lane*PN + q*32*PN, so each store instruction of the warp covers
// 32*PN contiguous columns.  The columns are built in registers: for
// each pair j, ascending, (idx_j, full_j) reaches every lane by shuffle
// and is added to the column it hits.  Rows longer than a tile of
// 32*PN*NQ columns (NQ <= 8) walk tiles.  No shared memory, no memset,
// no read-modify-write, no atomics.
template <int NQ, bool VEC>
__global__ void __launch_bounds__(32 * TOPK_WARPS)
topk_gating_bwd_kernel(const float* __restrict__ w, const int* __restrict__ idx,
                       const float* __restrict__ dw,
                       const float* __restrict__ dvals,
                       float* __restrict__ dlogits, int T, int E, int k,
                       int kk) {
  constexpr int PN = VEC ? 4 : 1;
  constexpr int TILE = 32 * PN * NQ;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * TOPK_WARPS + (threadIdx.x >> 5);
  if (row >= T) return;  // the whole warp leaves together
  float wj = 0.f, dwj = 0.f, vj = 0.f;
  int ij = -1;
  if (lane < k) {
    wj = w[(long long)row * k + lane];
    dwj = dw[(long long)row * k + lane];
  }
  if (lane < kk) {
    ij = idx[(long long)row * kk + lane];
    vj = dvals[(long long)row * kk + lane];
  }
  const float prod = __fmul_rn(wj, dwj);
  float s = 0.f;
  for (int j = 0; j < k; ++j) s = __fadd_rn(s, __shfl_sync(full, prod, j));
  if (lane < k) vj = __fadd_rn(vj, __fmul_rn(wj, __fsub_rn(dwj, s)));
  float* out = dlogits + (long long)row * E;
  for (int base = 0; base < E; base += TILE) {
    const int c0 = base + lane * PN;
    float acc[NQ * PN];
#pragma unroll
    for (int r = 0; r < NQ * PN; ++r) acc[r] = 0.f;
    for (int j = 0; j < kk; ++j) {
      const int rel = __shfl_sync(full, ij, j) - c0;
      const float v = __shfl_sync(full, vj, j);
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int r = 0; r < PN; ++r)
          if (rel == q * 32 * PN + r) acc[q * PN + r] = __fadd_rn(acc[q * PN + r], v);
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = c0 + q * 32 * PN;
      if (col >= E) continue;  // with PN = 4, E % 4 == 0: the piece fits
      if constexpr (VEC)
        *reinterpret_cast<float4*>(out + col) =
            make_float4(acc[q * 4], acc[q * 4 + 1], acc[q * 4 + 2], acc[q * 4 + 3]);
      else
        out[col] = acc[q];
    }
  }
}

template <int NQ>
static void launch_topk_bwd(bool vec, const float* w, const int* idx,
                            const float* dw, const float* dvals,
                            float* dlogits, int T, int E, int k, int kk,
                            cudaStream_t stream) {
  const dim3 grid((T + TOPK_WARPS - 1) / TOPK_WARPS);
  if (vec)
    topk_gating_bwd_kernel<NQ, true><<<grid, 32 * TOPK_WARPS, 0, stream>>>(
        w, idx, dw, dvals, dlogits, T, E, k, kk);
  else
    topk_gating_bwd_kernel<NQ, false><<<grid, 32 * TOPK_WARPS, 0, stream>>>(
        w, idx, dw, dvals, dlogits, T, E, k, kk);
}

extern "C" int repro_topk_gating_bwd(const float* w, const int* idx,
                                     const float* dw, const float* dvals,
                                     float* dlogits, int T, int E, int k,
                                     int kk, cudaStream_t stream) {
  if (T <= 0) return 0;
  if (E <= 0 || k < 1 || kk < k || kk > 32 || kk > E)
    return (int)cudaErrorInvalidValue;
  const bool vec = E % 4 == 0 && aligned16(dlogits);
  // Pieces a lane: the least power of two covering the row, at most 8.
  const int per_lane = (E + 32 * (vec ? 4 : 1) - 1) / (32 * (vec ? 4 : 1));
  if (per_lane <= 1) launch_topk_bwd<1>(vec, w, idx, dw, dvals, dlogits, T, E, k, kk, stream);
  else if (per_lane <= 2) launch_topk_bwd<2>(vec, w, idx, dw, dvals, dlogits, T, E, k, kk, stream);
  else if (per_lane <= 4) launch_topk_bwd<4>(vec, w, idx, dw, dvals, dlogits, T, E, k, kk, stream);
  else launch_topk_bwd<8>(vec, w, idx, dw, dvals, dlogits, T, E, k, kk, stream);
  return (int)cudaGetLastError();
}
