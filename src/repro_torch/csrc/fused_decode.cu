// Fused MoE decode: a whole MoE layer in one cooperative launch.
//
// Replaces two TPU kernels of repro/kernels/fused_decode.py:
//   * _decode_kernel (pallas_call in decode_step): clean-logit routing
//     (k rounds of row argmax, ties to the lowest index; softmax; x the
//     valid mask), capacity slots as an exclusive running count in flat
//     token-major order (zero-weight assignments take slot C), load and
//     overflow telemetry, scatter, per-expert FFN (relu or swiglu) and
//     the weighted combine;
//   * _routed_kernel (pallas_call in routed_apply): the same without the
//     routing, over explicit plans: scatter by (in_e, in_p), the FFN or
//     one grouped projection ("proj"), gather by (out_e, out_p, out_w).
// The TPU kernels kept every weight and the [E, C, d] buffers resident
// in VMEM for one grid step and walked all E experts.  The card has no
// VMEM and 132 SMs, so the design is different:
//
// Bound on the H100: bytes.  At kimi-k2's decode (T = 8, k = 8, E = 384,
// d = 7168, f = 2048, bf16) the work is 2 flops per weight element per
// routed row, and about 59 of the 384 experts receive a token.  The least
// the card can move is the used experts' weights (3 x d x f x 2 B each,
// ~5.2 GB) and the f32 gate (11 MB): ~1.56 ms at 3.35 TB/s.  Nothing
// else is large.  So the kernel reads only the used experts' weights,
// each element once, and never materialises the [E, C, d] buffers.
//
// One cooperative launch (grid = the blocks that fit on the card at
// once, cooperative_groups grid.sync() between phases); every phase
// walks its work items with a grid-stride loop:
//   1. gate partials: item = (32 experts, 8 tokens, 1024-row chunk of
//      d); each warp sums its rows in order, the warps are added in warp
//      order; the chunks are added in chunk order by phase 2.  No
//      atomics anywhere, so results repeat run to run.
//   2. block 0 alone: the logits, top-k, softmax, slot assignment, load /
//      overflow, the compact list of used experts (those with a filled
//      cell, ascending), and the cell -> token table (decode); for the
//      routed kernel only the list and the table, from the in-plan.
//   3. up-projection (w1, and w3 for swiglu, as separate items) or the
//      single projection: item = (used expert, 8-row tile of its cells,
//      256-column tile); x rows are gathered through the cell table.
//      The weight rows stream once per item with 16-byte loads, 8 warps
//      splitting K as in the GMM kernel (csrc/gmm.cu).
//   4. down-projection (FFN only), same items over d.
//   5. combine: y[t] = sum over j ascending of w_j * out[e_j, p_j] in f32
//      with separate multiply and add (no contraction), one write in the
//      output type.  An assignment whose cell is dropped or was never
//      filled adds nothing (the reference adds w * 0).
// The arithmetic and roundings are the reference's: gate dot in f32;
// FFN dots in f32 from dt inputs; silu(h) cast to dt, x w3 cast to dt,
// their product in f32 cast to dt; relu(h) cast to dt; the down
// projection in f32 cast to dt.  Only the order of the sums differs from
// the plain version (kernels/fused_decode.py).
#include "common.cuh"

#include <algorithm>
#include <cooperative_groups.h>
#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

#define FD_WARPS 8
#define FD_THREADS (32 * FD_WARPS)
#define FD_BM 8                      // rows (cells / tokens) per tile
#define FD_NPT 8                     // columns per lane
#define FD_BN (32 * FD_NPT)          // columns per tile
#define FD_KC 1024                   // K rows staged per step
#define FD_UNROLL 4
#define FD_NEG (-1e30f)
#define FD_MAX_E 8192                // block 0 keeps per-expert ints in smem

enum FdMode { FD_DECODE = 0, FD_ROUTED_FFN = 1, FD_ROUTED_PROJ = 2 };
enum FdActivation { FD_RELU = 0, FD_SWIGLU = 1 };

struct FusedParams {
  const void* x;
  const float* valid;    // decode: [T]
  const float* wg;       // decode: [d, E] f32
  const void* w1;        // [E, d_in, f] (proj: [E, d_in, d_out])
  const void* w2;        // [E, f, d_out]
  const void* w3;        // [E, d_in, f] (swiglu)
  const int* in_e;       // [T_in * k_in]
  const int* in_p;
  const int* out_e;      // [T_out * k_out]
  const int* out_p;
  const float* out_w;
  void* y;               // [T_out, d_out]
  float* load;           // decode: [E]
  float* overflow;       // decode: [E]
  // workspace
  float* part;           // decode: [n_chunks, T, E] gate partials
  float* logits;         // decode: [T, E]
  int* fe;               // decode: [T * k] routed experts
  int* fp;               // decode: [T * k] slots
  float* fw;             // decode: [T * k] kept combine weights
  int* uidx;             // [E] expert -> used index, -1 if unused
  int* nrows;            // [max_used] cells 0..nrows-1 computed
  int* used_e;           // [max_used]
  int* n_used;           // [1]
  int* slot_tok;         // [max_used, C] cell -> token row, -1 if empty
  void* hs;              // [max_used, C, f] act(x w1) (FFN)
  void* hg;              // [max_used, C, f] x w3 (swiglu)
  void* outb;            // [max_used, C, d_out]
  int T_in, k_in, T_out, k_out, d_in, d_out, f, E, C;
  int mode, act, n_chunks;
  int vec_up, vec_dn;
};

// Loads of data that this launch itself wrote (other blocks, earlier
// phases) go through L2 (ld.global.cg), never the non-coherent caches.
static __device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
static __device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  const unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(((uint32_t)bits) << 16);
}

static __device__ __forceinline__ float silu(float z) {
  return z * (1.f / (1.f + expf(-z)));
}

template <typename T>
static __device__ __forceinline__ void load_w(const T* row, int ncol, int N,
                                              bool vec, float out[FD_NPT]) {
  if (vec && ncol + FD_NPT <= N) {
    Vec8<T>::load(row + ncol, out);
  } else {
#pragma unroll
    for (int j = 0; j < FD_NPT; ++j)
      out[j] = (ncol + j < N) ? to_f<T>(row[ncol + j]) : 0.f;
  }
}

// One [8, K] x [K, 256] tile: rows staged by stage(r, k) as f32 into
// shared memory FD_KC at a time, W ([K, N] row-major) streamed once.
// Each warp takes K rows warp, warp + 8, ... with an FMA chain per
// output; the warps' sums are added in warp order and handed to
// store(r, n, value).  Called by every thread of the block.
template <typename T, typename Stage, typename Store>
static __device__ void row_tile(float (*xs)[FD_KC], float (*red)[FD_BN],
                                Stage stage, const T* __restrict__ W, int K,
                                int N, int n0, bool vec, Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncol = n0 + lane * FD_NPT;
  float acc[FD_BM][FD_NPT];
#pragma unroll
  for (int r = 0; r < FD_BM; ++r)
#pragma unroll
    for (int j = 0; j < FD_NPT; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FD_KC) {
    for (int i = threadIdx.x; i < FD_BM * FD_KC; i += FD_THREADS) {
      const int r = i / FD_KC, kk = i % FD_KC;
      xs[r][kk] = (k0 + kk < K) ? stage(r, k0 + kk) : 0.f;
    }
    __syncthreads();
    const int kend = min(FD_KC, K - k0);
    int kk = warp;
    for (; kk + (FD_UNROLL - 1) * FD_WARPS < kend; kk += FD_UNROLL * FD_WARPS) {
      float wv[FD_UNROLL][FD_NPT];
#pragma unroll
      for (int u = 0; u < FD_UNROLL; ++u)
        load_w<T>(W + (long long)(k0 + kk + u * FD_WARPS) * N, ncol, N, vec, wv[u]);
#pragma unroll
      for (int u = 0; u < FD_UNROLL; ++u)
#pragma unroll
        for (int r = 0; r < FD_BM; ++r) {
          const float xv = xs[r][kk + u * FD_WARPS];
#pragma unroll
          for (int j = 0; j < FD_NPT; ++j) acc[r][j] = fmaf(xv, wv[u][j], acc[r][j]);
        }
    }
    for (; kk < kend; kk += FD_WARPS) {
      float wv[FD_NPT];
      load_w<T>(W + (long long)(k0 + kk) * N, ncol, N, vec, wv);
#pragma unroll
      for (int r = 0; r < FD_BM; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int j = 0; j < FD_NPT; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < FD_BM; ++r) {
#pragma unroll
    for (int j = 0; j < FD_NPT; ++j) red[warp][lane * FD_NPT + j] = acc[r][j];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < FD_WARPS; ++q) s += red[q][threadIdx.x];
    store(r, n0 + threadIdx.x, s);
    __syncthreads();
  }
}

// Phase 1: gate partials part[chunk, t, e] = sum over the chunk's rows of
// x[t, row] * wg[row, e], in f32.
template <typename T>
static __device__ void gate_partials(const FusedParams& p, float (*xs)[FD_KC],
                                     float (*red)[FD_BN]) {
  const T* x = static_cast<const T*>(p.x);
  const int T_ = p.T_in, d = p.d_in, E = p.E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_eg = (E + 31) / 32, n_tt = (T_ + FD_BM - 1) / FD_BM;
  const int n_items = n_eg * n_tt * p.n_chunks;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int eg = it % n_eg, tt = (it / n_eg) % n_tt, ch = it / (n_eg * n_tt);
    const int d0 = ch * FD_KC, t0 = tt * FD_BM;
    const int rows = min(FD_KC, d - d0);
    for (int i = threadIdx.x; i < FD_BM * FD_KC; i += FD_THREADS) {
      const int r = i / FD_KC, kk = i % FD_KC;
      xs[r][kk] = (t0 + r < T_ && kk < rows)
                      ? to_f<T>(x[(long long)(t0 + r) * d + d0 + kk]) : 0.f;
    }
    __syncthreads();
    const int e = eg * 32 + lane;
    float acc[FD_BM];
#pragma unroll
    for (int r = 0; r < FD_BM; ++r) acc[r] = 0.f;
    if (e < E) {
      for (int i = warp; i < rows; i += FD_WARPS) {
        const float wv = __ldg(p.wg + (long long)(d0 + i) * E + e);
#pragma unroll
        for (int r = 0; r < FD_BM; ++r) acc[r] = fmaf(xs[r][i], wv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < FD_BM; ++r) red[warp][r * 32 + lane] = acc[r];
    __syncthreads();
    {
      const int r = threadIdx.x / 32, l = threadIdx.x % 32;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < FD_WARPS; ++q) s += red[q][r * 32 + l];
      const int t = t0 + r, ee = eg * 32 + l;
      if (t < T_ && ee < E) p.part[((long long)ch * T_ + t) * E + ee] = s;
    }
    __syncthreads();
  }
}

// Phase 2 (block 0), decode: logits, top-k rounds, softmax x valid, the
// slot of every assignment, load and overflow.  cnt is shared memory.
static __device__ void route_block(const FusedParams& p, int* cnt) {
  const int T_ = p.T_in, E = p.E, k = p.k_in, C = p.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < T_; t += FD_WARPS) {
    float* row = p.logits + (long long)t * E;
    for (int e = lane; e < E; e += 32) {
      float s = 0.f;
      for (int c = 0; c < p.n_chunks; ++c)
        s += __ldcg(p.part + ((long long)c * T_ + t) * E + e);
      row[e] = s;
    }
    __syncwarp();
    for (int r = 0; r < k; ++r) {
      // Lane-local best (ascending e, strict >: the lowest index wins a
      // tie), then a shuffle reduction that breaks ties the same way.
      float best = 0.f;
      int bi = -1;
      for (int e = lane; e < E; e += 32) {
        const float v = __ldcg(row + e);
        if (bi < 0 || v > best) { best = v; bi = e; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (oi >= 0 && (bi < 0 || ov > best || (ov == best && oi < bi))) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        p.fe[t * k + r] = bi;
        p.fw[t * k + r] = best;           // the raw value, until the softmax
        row[bi] = FD_NEG;
      }
      __syncwarp();
    }
    if (lane == 0) {
      // Softmax over the k values (the first is the maximum), summed in
      // ascending j; then x valid.
      const float mx = p.fw[t * k];
      float s = 0.f;
      for (int j = 0; j < k; ++j) {
        const float e = expf(p.fw[t * k + j] - mx);
        p.fw[t * k + j] = e;
        s += e;
      }
      const float v = p.valid[t];
      for (int j = 0; j < k; ++j) p.fw[t * k + j] = (p.fw[t * k + j] / s) * v;
    }
  }
  for (int e = threadIdx.x; e < E; e += FD_THREADS) cnt[e] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    // A positive assignment's slot is the number of positive assignments
    // to its expert earlier in flat token-major order.
    for (int a = 0; a < T_ * k; ++a) {
      const int e = p.fe[a];
      const float w = p.fw[a];
      int pos = C;
      if (w > 0.f) pos = cnt[e]++;
      p.fp[a] = pos;
      if (pos >= C) p.fw[a] = 0.f;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += FD_THREADS) {
    p.load[e] = (float)cnt[e];
    p.overflow[e] = (float)max(cnt[e] - C, 0);
  }
  __syncthreads();
}

// Phase 2 (block 0): the compact list of used experts and the cell ->
// token table of a plan.  rows is shared memory.
static __device__ void build_table(const FusedParams& p, const int* ie,
                                   const int* ip, int n_assign, int k,
                                   int* rows) {
  const int E = p.E, C = p.C;
  __shared__ int n_used_s;
  for (int e = threadIdx.x; e < E; e += FD_THREADS) rows[e] = 0;
  __syncthreads();
  for (int a = threadIdx.x; a < n_assign; a += FD_THREADS) {
    const int e = __ldcg(ie + a), c = __ldcg(ip + a);
    if (e >= 0 && e < E && c >= 0 && c < C) atomicMax(&rows[e], c + 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int e = 0; e < E; ++e) {
      if (rows[e] > 0) {
        p.used_e[n] = e;
        p.nrows[n] = rows[e];
        rows[e] = n++;
      } else {
        rows[e] = -1;
      }
    }
    n_used_s = n;
    *p.n_used = n;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += FD_THREADS) p.uidx[e] = rows[e];
  for (int i = threadIdx.x; i < n_used_s * C; i += FD_THREADS) p.slot_tok[i] = -1;
  __syncthreads();
  if (threadIdx.x == 0) {
    // In assignment order: a cell written twice keeps the later token,
    // as the reference's scatter loop does.
    for (int a = 0; a < n_assign; ++a) {
      const int e = __ldcg(ie + a), c = __ldcg(ip + a);
      if (e >= 0 && e < E && c >= 0 && c < C) p.slot_tok[rows[e] * C + c] = a / k;
    }
  }
  __syncthreads();
}

// Phase 3: up-projection(s) of the used experts' cells, or the single
// projection.
template <typename T>
static __device__ void up_phase(const FusedParams& p, float (*xs)[FD_KC],
                                float (*red)[FD_BN]) {
  const T* x = static_cast<const T*>(p.x);
  const bool proj = p.mode == FD_ROUTED_PROJ;
  const int K = p.d_in, N = proj ? p.d_out : p.f, C = p.C;
  const int mats = (!proj && p.act == FD_SWIGLU) ? 2 : 1;
  const int n_used = __ldcg(p.n_used);
  const int RT = (C + FD_BM - 1) / FD_BM, NT = (N + FD_BN - 1) / FD_BN;
  const int n_items = n_used * RT * NT * mats;
  __shared__ int tok_s[FD_BM];
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int nt = it % NT, rt = (it / NT) % RT, mat = (it / (NT * RT)) % mats;
    const int u = it / (NT * RT * mats);
    const int nrows = __ldcg(p.nrows + u);
    const int c0 = rt * FD_BM;
    if (c0 >= nrows) continue;                 // uniform across the block
    const int e = __ldcg(p.used_e + u);
    // The tile's token rows (-1: an empty cell or past the filled ones);
    // the previous item's last barrier protects tok_s.
    if (threadIdx.x < FD_BM)
      tok_s[threadIdx.x] = c0 + (int)threadIdx.x < nrows
                               ? __ldcg(p.slot_tok + (long long)u * C + c0 + threadIdx.x)
                               : -1;
    __syncthreads();
    const T* W = static_cast<const T*>(mat ? p.w3 : p.w1) + (long long)e * K * N;
    auto stage = [&](int r, int kg) -> float {
      const int t = tok_s[r];
      return t < 0 ? 0.f : to_f<T>(x[(long long)t * K + kg]);
    };
    T* dst = static_cast<T*>(proj ? p.outb : (mat ? p.hg : p.hs)) +
             ((long long)u * C + c0) * N;
    const int act = proj ? -1 : (mat ? -1 : p.act);
    auto store = [&](int r, int n, float z) {
      if (c0 + r >= nrows || n >= N) return;
      if (act == FD_RELU) z = fmaxf(z, 0.f);
      else if (act == FD_SWIGLU) z = silu(z);
      dst[(long long)r * N + n] = from_f<T>(z);
    };
    row_tile<T>(xs, red, stage, W, K, N, nt * FD_BN, p.vec_up != 0, store);
  }
}

// Phase 4 (FFN): down-projection of the hidden rows.
template <typename T>
static __device__ void down_phase(const FusedParams& p, float (*xs)[FD_KC],
                                  float (*red)[FD_BN]) {
  const int K = p.f, N = p.d_out, C = p.C;
  const bool gated = p.act == FD_SWIGLU;
  const int n_used = __ldcg(p.n_used);
  const int RT = (C + FD_BM - 1) / FD_BM, NT = (N + FD_BN - 1) / FD_BN;
  const int n_items = n_used * RT * NT;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int nt = it % NT, rt = (it / NT) % RT, u = it / (NT * RT);
    const int nrows = __ldcg(p.nrows + u);
    const int c0 = rt * FD_BM;
    if (c0 >= nrows) continue;
    const int e = __ldcg(p.used_e + u);
    const long long base = ((long long)u * C + c0) * K;
    const T* hs = static_cast<const T*>(p.hs) + base;
    const T* hg = static_cast<const T*>(p.hg) + base;
    auto stage = [&](int r, int kg) -> float {
      if (c0 + r >= nrows) return 0.f;
      const float s = ld_cg(hs + (long long)r * K + kg);
      if (!gated) return s;
      // (silu(h) in dt) * (g in dt) in f32, rounded to dt.
      return to_f<T>(from_f<T>(s * ld_cg(hg + (long long)r * K + kg)));
    };
    T* dst = static_cast<T*>(p.outb) + ((long long)u * C + c0) * N;
    auto store = [&](int r, int n, float z) {
      if (c0 + r < nrows && n < N) dst[(long long)r * N + n] = from_f<T>(z);
    };
    row_tile<T>(xs, red, stage, static_cast<const T*>(p.w2) + (long long)e * K * N,
                K, N, nt * FD_BN, p.vec_dn != 0, store);
  }
}

// Phase 5: the weighted combine.  Each thread owns 8 columns strided by
// the block width, so a warp's loads are contiguous.
template <typename T, typename TO>
static __device__ void combine_phase(const FusedParams& p, const int* oe,
                                     const int* op, const float* ow) {
  const int N = p.d_out, C = p.C, E = p.E, k = p.k_out;
  const int span = FD_THREADS * FD_NPT;
  const int NT = (N + span - 1) / span;
  const int n_items = p.T_out * NT;
  const T* outb = static_cast<const T*>(p.outb);
  TO* y = static_cast<TO*>(p.y);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int t = it / NT, n0 = (it % NT) * span + threadIdx.x;
    float acc[FD_NPT];
#pragma unroll
    for (int i = 0; i < FD_NPT; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int a = t * k + j;
      const int e = __ldcg(oe + a), c = __ldcg(op + a);
      if (e < 0 || e >= E || c < 0 || c >= C) continue;
      const int u = __ldcg(p.uidx + e);
      if (u < 0 || c >= __ldcg(p.nrows + u)) continue;   // never filled: adds 0
      const float w = __ldcg(ow + a);
      const T* src = outb + ((long long)u * C + c) * N;
#pragma unroll
      for (int i = 0; i < FD_NPT; ++i) {
        const int n = n0 + i * FD_THREADS;
        if (n < N) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, ld_cg(src + n)));
      }
    }
#pragma unroll
    for (int i = 0; i < FD_NPT; ++i) {
      const int n = n0 + i * FD_THREADS;
      if (n < N) y[(long long)t * N + n] = from_f<TO>(acc[i]);
    }
  }
}

// The phases, in order, with a grid-wide barrier between them.
template <typename T, typename TO>
static __device__ void fused_body(const FusedParams& p) {
  __shared__ __align__(16) float xs[FD_BM][FD_KC];
  __shared__ __align__(16) float red[FD_WARPS][FD_BN];
  cg::grid_group grid = cg::this_grid();
  int* ints = reinterpret_cast<int*>(&xs[0][0]);   // block 0, phase 2 only

  const int* oe = p.out_e;
  const int* op = p.out_p;
  const float* ow = p.out_w;
  if (p.mode == FD_DECODE) {
    gate_partials<T>(p, xs, red);
    grid.sync();
    if (blockIdx.x == 0) {
      route_block(p, ints);
      build_table(p, p.fe, p.fp, p.T_in * p.k_in, p.k_in, ints);
    }
    oe = p.fe;
    op = p.fp;
    ow = p.fw;
  } else if (blockIdx.x == 0) {
    build_table(p, p.in_e, p.in_p, p.T_in * p.k_in, p.k_in, ints);
  }
  grid.sync();
  up_phase<T>(p, xs, red);
  grid.sync();
  if (p.mode != FD_ROUTED_PROJ) {
    down_phase<T>(p, xs, red);
    grid.sync();
  }
  combine_phase<T, TO>(p, oe, op, ow);
}

// Kernel 7 and kernel 8 under their own names (profiles tell them apart).
template <typename T>
__global__ void __launch_bounds__(FD_THREADS, 2) fused_decode_kernel(FusedParams p) {
  fused_body<T, T>(p);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(FD_THREADS, 2) fused_routed_kernel(FusedParams p) {
  fused_body<T, TO>(p);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

struct Workspace {
  size_t part, logits, fe, fp, fw, uidx, nrows, used_e, n_used, slot_tok, hs, hg,
      outb, total;
};

static Workspace layout(int decode, int T_in, int k_in, int d_in, int d_out, int f,
                        int E, int C, int ffn, int gated, size_t elt) {
  Workspace w;
  const size_t n_chunks = decode ? (d_in + FD_KC - 1) / FD_KC : 0;
  const size_t n_assign = (size_t)T_in * k_in;
  const size_t max_used = std::min((size_t)E, n_assign);
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  w.part = take(decode ? n_chunks * T_in * E * sizeof(float) : 0);
  w.logits = take(decode ? (size_t)T_in * E * sizeof(float) : 0);
  w.fe = take(decode ? n_assign * sizeof(int) : 0);
  w.fp = take(decode ? n_assign * sizeof(int) : 0);
  w.fw = take(decode ? n_assign * sizeof(float) : 0);
  w.uidx = take((size_t)E * sizeof(int));
  w.nrows = take(max_used * sizeof(int));
  w.used_e = take(max_used * sizeof(int));
  w.n_used = take(sizeof(int));
  w.slot_tok = take(max_used * C * sizeof(int));
  w.hs = take(ffn ? max_used * C * f * elt : 0);
  w.hg = take(ffn && gated ? max_used * C * f * elt : 0);
  w.outb = take(max_used * C * d_out * elt);
  w.total = off;
  return w;
}

static void bind_workspace(FusedParams& p, void* ws, const Workspace& w) {
  char* b = static_cast<char*>(ws);
  p.part = reinterpret_cast<float*>(b + w.part);
  p.logits = reinterpret_cast<float*>(b + w.logits);
  p.fe = reinterpret_cast<int*>(b + w.fe);
  p.fp = reinterpret_cast<int*>(b + w.fp);
  p.fw = reinterpret_cast<float*>(b + w.fw);
  p.uidx = reinterpret_cast<int*>(b + w.uidx);
  p.nrows = reinterpret_cast<int*>(b + w.nrows);
  p.used_e = reinterpret_cast<int*>(b + w.used_e);
  p.n_used = reinterpret_cast<int*>(b + w.n_used);
  p.slot_tok = reinterpret_cast<int*>(b + w.slot_tok);
  p.hs = b + w.hs;
  p.hg = b + w.hg;
  p.outb = b + w.outb;
}

// Blocks of ``kernel`` that fit on device ``dev`` at once (0: no
// cooperative launch there), queried once per (kernel, device): the
// queries would otherwise cost host time on every decode step.
static cudaError_t grid_blocks(const void* kernel, int dev, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, dev);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FD_THREADS, 0);
  if (err != cudaSuccess) return err;
  *blocks = coop ? per_sm * sms : 0;
  cache[key] = *blocks;
  return cudaSuccess;
}

// One cooperative launch: as many blocks as fit on the card at once.
static int launch(const void* kernel, FusedParams& p, cudaStream_t stream) {
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = grid_blocks(kernel, dev, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(FD_THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static bool vec_ok(int N, const void* a, const void* b = nullptr) {
  return N % FD_NPT == 0 && aligned16(a) && (b == nullptr || aligned16(b));
}

static size_t elt_size(int dtype) { return dtype == REPRO_BF16 ? 2 : 4; }

// Bytes of workspace a call needs (decode = 1: repro_fused_decode with
// T_in = T, k_in = k, d_in = d_out = d; decode = 0: repro_fused_routed).
extern "C" int repro_fused_workspace_bytes(int decode, int T_in, int k_in, int d_in,
                                           int d_out, int f, int E, int C, int mode,
                                           int activation, int dtype,
                                           long long* bytes) {
  if (T_in < 0 || k_in < 1 || E < 1 || C < 1 || (dtype != REPRO_F32 && dtype != REPRO_BF16))
    return (int)cudaErrorInvalidValue;
  const int ffn = decode || mode == FD_ROUTED_FFN;
  *bytes = (long long)layout(decode, T_in, k_in, d_in, d_out, f, E, C, ffn,
                             ffn && activation == FD_SWIGLU, elt_size(dtype)).total;
  return 0;
}

// Kernel 7.  x [T, d] (dtype), valid [T] f32, wg [d, E] f32, w1/w3
// [E, d, f], w2 [E, f, d] (dtype); y [T, d] (dtype), load / overflow [E]
// f32; ws as repro_fused_workspace_bytes(1, T, k, d, d, f, E, C, ...).
extern "C" int repro_fused_decode(const void* x, const float* valid, const float* wg,
                                  const void* w1, const void* w2, const void* w3,
                                  void* y, float* load, float* overflow, void* ws,
                                  int T_, int d, int E, int f, int k, int C,
                                  int activation, int dtype, cudaStream_t stream) {
  if (T_ < 0 || d < 1 || f < 1 || E < 1 || E > FD_MAX_E || k < 1 || k > E || C < 1 ||
      (activation != FD_RELU && activation != FD_SWIGLU) ||
      (activation == FD_SWIGLU && w3 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return (int)cudaErrorInvalidValue;
  if (T_ == 0) return 0;
  FusedParams p = {};
  p.x = x; p.valid = valid; p.wg = wg; p.w1 = w1; p.w2 = w2; p.w3 = w3;
  p.y = y; p.load = load; p.overflow = overflow;
  p.T_in = T_; p.k_in = k; p.T_out = T_; p.k_out = k;
  p.d_in = d; p.d_out = d; p.f = f; p.E = E; p.C = C;
  p.mode = FD_DECODE; p.act = activation;
  p.n_chunks = (d + FD_KC - 1) / FD_KC;
  p.vec_up = vec_ok(f, w1, activation == FD_SWIGLU ? w3 : nullptr);
  p.vec_dn = vec_ok(d, w2);
  bind_workspace(p, ws, layout(1, T_, k, d, d, f, E, C, 1, activation == FD_SWIGLU,
                               elt_size(dtype)));
  if (dtype == REPRO_F32) return launch((const void*)fused_decode_kernel<float>, p, stream);
  return launch((const void*)fused_decode_kernel<__nv_bfloat16>, p, stream);
}

// Kernel 8.  x [T_in, d_in] (in_dtype); plans in_e / in_p [T_in, k_in]
// and out_e / out_p / out_w [T_out, k_out]; mode 1 (FFN: w1 / w3
// [E, d_in, f], w2 [E, f, d_out]) or 2 (proj: w1 [E, d_in, d_out]);
// weights in in_dtype; y [T_out, d_out] (out_dtype); ws as
// repro_fused_workspace_bytes(0, ...).
extern "C" int repro_fused_routed(const void* x, const int* in_e, const int* in_p,
                                  const int* out_e, const int* out_p, const float* out_w,
                                  const void* w1, const void* w2, const void* w3, void* y,
                                  void* ws, int T_in, int k_in, int T_out, int k_out,
                                  int d_in, int d_out, int f, int E, int C, int mode,
                                  int activation, int in_dtype, int out_dtype,
                                  cudaStream_t stream) {
  const bool ffn = mode == FD_ROUTED_FFN;
  if (T_in < 0 || T_out < 0 || k_in < 1 || k_out < 1 || d_in < 1 || d_out < 1 ||
      E < 1 || E > FD_MAX_E || C < 1 || (mode != FD_ROUTED_FFN && mode != FD_ROUTED_PROJ) ||
      (ffn && (f < 1 || w2 == nullptr)) ||
      (ffn && activation != FD_RELU && activation != FD_SWIGLU) ||
      (ffn && activation == FD_SWIGLU && w3 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (T_out == 0) return 0;
  FusedParams p = {};
  p.x = x; p.w1 = w1; p.w2 = w2; p.w3 = w3;
  p.in_e = in_e; p.in_p = in_p; p.out_e = out_e; p.out_p = out_p; p.out_w = out_w;
  p.y = y;
  p.T_in = T_in; p.k_in = k_in; p.T_out = T_out; p.k_out = k_out;
  p.d_in = d_in; p.d_out = d_out; p.f = ffn ? f : 0; p.E = E; p.C = C;
  p.mode = mode; p.act = ffn ? activation : -1;
  p.n_chunks = 0;
  p.vec_up = ffn ? vec_ok(f, w1, activation == FD_SWIGLU ? w3 : nullptr)
                 : vec_ok(d_out, w1);
  p.vec_dn = ffn ? vec_ok(d_out, w2) : 0;
  const bool gated = ffn && activation == FD_SWIGLU;
  typedef __nv_bfloat16 bf16;
  if (in_dtype == REPRO_F32) {
    bind_workspace(p, ws, layout(0, T_in, k_in, d_in, d_out, f, E, C, ffn, gated, 4));
    if (out_dtype == REPRO_F32)
      return launch((const void*)fused_routed_kernel<float, float>, p, stream);
    if (out_dtype == REPRO_BF16)
      return launch((const void*)fused_routed_kernel<float, bf16>, p, stream);
  } else if (in_dtype == REPRO_BF16) {
    bind_workspace(p, ws, layout(0, T_in, k_in, d_in, d_out, f, E, C, ffn, gated, 2));
    if (out_dtype == REPRO_F32)
      return launch((const void*)fused_routed_kernel<bf16, float>, p, stream);
    if (out_dtype == REPRO_BF16)
      return launch((const void*)fused_routed_kernel<bf16, bf16>, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}
