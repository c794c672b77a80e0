// Fused MoE decode: a whole MoE layer in one cooperative launch.
//
// Replaces two TPU kernels of repro/kernels/fused_decode.py:
//   * _decode_kernel (l.192, pallas_call in decode_step): clean-logit
//     routing (k rounds of row argmax, ties to the lowest index; softmax;
//     x the valid mask), capacity slots as an exclusive running count in
//     flat token-major order (zero-weight assignments take slot C), load
//     and overflow telemetry, scatter, per-expert FFN (relu or swiglu)
//     and the weighted combine;
//   * _routed_kernel (l.323, pallas_call in routed_apply): the same
//     without the routing, over explicit plans: scatter by (in_e, in_p),
//     the FFN or one grouped projection ("proj"), gather by (out_e,
//     out_p, out_w).
// The TPU kernels kept every weight and the [E, C, d] buffers resident
// in VMEM for one grid step and walked all E experts.  The card has no
// VMEM and 132 SMs, so the design is different.
//
// Bound on the H100: bytes.  At kimi-k2's decode (T = 8, k = 8, E = 384,
// d = 7168, f = 2048, bf16) the work is 2 flops per weight element per
// routed row, and a full pool of 8 slots routes to about 58 of the 384
// experts.  The least the card can move is the used experts' weights (3
// x d x f x 2 B each, ~5.1 GB) and the f32 gate (11 MB): ~1.56 ms at
// 3.35 TB/s.  Nothing else is large.  So the kernel reads only the used
// experts' weights, each element once per row tile of 64 cells (once in
// all at decode), and never materialises the [E, C, d] buffers.
//
// One cooperative launch; a block is 8 warps.  Decode has two grid-wide
// barriers, the routed kernel one:
//   1. (decode) gate partials: item = (32 experts, 8 tokens, 1024-row
//      chunk of d), a grid-stride loop on the CUDA cores in f32; each
//      warp sums its rows in order, the warps are added in warp order,
//      the chunks in chunk order by phase 2.                  grid.sync()
//   2. block 0 alone: (decode) the logits, top-k, softmax, the slot of
//      each assignment (each thread counts the earlier assignments to its
//      expert), load / overflow; then the compact list of used experts
//      (a block-wide scan, ascending), the cell -> token table (filled in
//      parallel: a cell written twice keeps the later assignment, by
//      atomicMax over assignment indices) and the work queue's counters
//      set to zero.                                           grid.sync()
//   3. a work queue: each block takes the next item from one atomic
//      ticket counter, in order: every up item, then every down item,
//      then every combine item.  The phases overlap instead of ending in
//      idle wave tails.
//      - up: item = (used expert u, row tile of up to 64 cells, 256
//        output columns); x w1 (and x w3 for swiglu in the same item),
//        or the single projection.  Epilogue: relu(h) cast to dt, or
//        silu(h) cast to dt times (x w3) cast to dt, in f32, cast to dt,
//        into the hidden buffer hs; "proj" writes the output buffer.
//        Done: one count on up_done[u, row tile].
//      - down (FFN): the same over w2 with hs as the rows; it first
//        waits until up_done[u, row tile] counts every column tile of
//        the hidden row.  Done: one count on dn_done[u, row tile].
//      - combine: y[t] = sum over j ascending of w_j * out[e_j, p_j] in
//        f32 with separate multiply and add (no contraction), one write
//        in the output type; it first waits for the row tiles its cells
//        lie in.  An assignment whose cell is dropped or was never
//        filled adds nothing (the reference adds w * 0).
//      Why the waits cannot deadlock: the launch is cooperative, so
//      every block is resident; tickets are handed out in increasing
//      order and a block takes a new one only when its item is done, so
//      the items a waiting item depends on (all with smaller tickets)
//      are already held by running blocks, and up items wait on nothing.
//      A count is published after the block's stores (barrier, then
//      __threadfence, then atomicAdd: the pattern of grid.sync()) and
//      read with ld.acquire.gpu; data written by other blocks is read
//      through L2 (ld.global.cg, cp.async.cg).
// bf16 up / down / proj items run on the tensor cores as csrc/gmm.cu's
// gmm_stream_kernel does: operands swapped so that the cells are the
// mma's N: out^T[256 cols, cells] = W^T x rows^T, mma.sync m16n8k16 with
// W^T as the 16-row A operand through ldmatrix.trans straight from W's
// stored [K, N] rows and the cells as 1-8 n8 tiles; each warp owns 32
// columns, so no sum crosses warps.  K moves in 32 x 256 weight slabs
// (one per matrix) with the rows' matching 32-wide chunk through a
// 4-stage cp.async ring (16-byte copies, the weight stream asking L2 for
// 256 bytes around each); the cells' rows are gathered through the
// cell -> token table (empty cells and cells past the filled ones
// zero-fill).  Ragged widths (not a multiple of 8, or of 256) take
// element loads and masked stores.  f32 items (the ragged f32 checks; no
// serve path runs f32 fused decode) stay on the CUDA cores: 8 warps
// split K with f32 FMAs over 8-row tiles and add their sums in warp
// order.
// The arithmetic and roundings are the reference's: gate dot in f32;
// FFN dots in f32 from dt inputs; silu(h) cast to dt, x w3 cast to dt,
// their product in f32 cast to dt; relu(h) cast to dt; the down
// projection in f32 cast to dt.  Only the order of the sums differs from
// the plain version (kernels/fused_decode.py); it is fixed, with no
// atomics in any sum, so a result repeats bit for bit.
#include "mma.cuh"

#include <algorithm>
#include <cooperative_groups.h>
#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

#define FD_WARPS 8
#define FD_THREADS (32 * FD_WARPS)
#define FD_BM 8                      // rows per CUDA-core tile (gate, f32)
#define FD_NPT 8                     // columns per lane
#define FD_BN (32 * FD_NPT)          // columns per item
#define FD_KC 1024                   // K rows staged per step (CUDA cores)
#define FD_UNROLL 4
#define FD_NEG (-1e30f)
#define FD_MAX_E 8192                // block 0 keeps per-expert ints in smem
#define FD_RT 64                     // cells per row tile
#define FD_BK 32                     // K per slab (tensor cores)
#define FD_STAGES 4
#define FD_LD_W (FD_BN + 8)          // padded slab rows (bank conflicts)
#define FD_LD_X (FD_BK + 8)
#define FD_W_ELEMS (FD_BK * FD_LD_W)
#define FD_X_ELEMS (FD_RT * FD_LD_X)
// Dynamic shared memory: the CUDA-core staging (gate, f32 items, block
// 0's per-expert ints) or the bf16 ring, whichever is larger.
#define FD_BASE_BYTES ((FD_BM * FD_KC + FD_WARPS * FD_BN) * 4)
#define FD_RING_BYTES(mats) (FD_STAGES * (FD_X_ELEMS + (mats) * FD_W_ELEMS) * 2)

enum FdMode { FD_DECODE = 0, FD_ROUTED_FFN = 1, FD_ROUTED_PROJ = 2 };
enum FdActivation { FD_RELU = 0, FD_SWIGLU = 1 };
enum FdEpilogue { EPI_NONE = 0, EPI_RELU = 1, EPI_SWIGLU = 2 };

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
  void* hs;              // [max_used, C, f] the gated / activated hidden rows
  void* outb;            // [max_used, C, d_out]
  int* ticket;           // [1] the work queue's next item
  int* up_done;          // [max_used, RT] up items done per row tile
  int* dn_done;          // [max_used, RT] down items done per row tile
  int T_in, k_in, T_out, k_out, d_in, d_out, f, E, C;
  int mode, act, n_chunks, RT, max_used;
  int vec_up, vec_dn;
};

// Loads of data that this launch itself wrote (other blocks, earlier
// phases) go through L2 (ld.global.cg), never the non-coherent caches.
static __device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
static __device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  const unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(((uint32_t)bits) << 16);
}
static __device__ __forceinline__ bf16 ldcg_bf16(const bf16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
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
  // A positive assignment's slot is the number of positive assignments
  // to its expert earlier in flat token-major order: each thread counts
  // them for its own assignments.
  const int n = T_ * k;
  for (int a = threadIdx.x; a < n; a += FD_THREADS) {
    const int e = __ldcg(p.fe + a);
    int pos = C;
    if (__ldcg(p.fw + a) > 0.f) {
      pos = 0;
      for (int b = 0; b < a; ++b)
        pos += __ldcg(p.fe + b) == e && __ldcg(p.fw + b) > 0.f;
      atomicAdd(&cnt[e], 1);
    }
    p.fp[a] = pos;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < n; a += FD_THREADS)
    if (p.fp[a] >= C) p.fw[a] = 0.f;      // this thread's own slot
  for (int e = threadIdx.x; e < E; e += FD_THREADS) {
    p.load[e] = (float)cnt[e];
    p.overflow[e] = (float)max(cnt[e] - C, 0);
  }
  __syncthreads();
}

// Exclusive scan of one int per thread over the block; *total gets the
// sum.  Called by every thread.
static __device__ int block_scan(int v, int* total) {
  __shared__ int warp_sum[FD_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int s = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  if (lane == 31) warp_sum[warp] = s;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < FD_WARPS; ++w) {
    const int ws = warp_sum[w];
    before += w < warp ? ws : 0;
    all += ws;
  }
  *total = all;
  __syncthreads();                        // warp_sum is free again
  return before + s - v;
}

// Phase 2 (block 0): the compact list of used experts, the cell -> token
// table of a plan, and the work queue's counters set to zero.  rows is
// shared memory.
static __device__ void build_table(const FusedParams& p, const int* ie,
                                   const int* ip, int n_assign, int k,
                                   int* rows) {
  const int E = p.E, C = p.C;
  __shared__ int n_used_s;
  for (int e = threadIdx.x; e < E; e += FD_THREADS) rows[e] = 0;
  for (int i = threadIdx.x; i < p.max_used * p.RT; i += FD_THREADS) {
    p.up_done[i] = 0;
    p.dn_done[i] = 0;
  }
  if (threadIdx.x == 0) *p.ticket = 0;
  __syncthreads();
  for (int a = threadIdx.x; a < n_assign; a += FD_THREADS) {
    const int e = __ldcg(ie + a), c = __ldcg(ip + a);
    if (e >= 0 && e < E && c >= 0 && c < C) atomicMax(&rows[e], c + 1);
  }
  __syncthreads();
  // Each thread owns a run of experts; a scan of the runs' counts gives
  // each used expert its index, in ascending expert order.
  const int per = (E + FD_THREADS - 1) / FD_THREADS;
  const int e0 = min(E, (int)threadIdx.x * per), e1 = min(E, e0 + per);
  int mine = 0;
  for (int e = e0; e < e1; ++e) mine += rows[e] > 0;
  int n_used = 0;
  int at = block_scan(mine, &n_used);
  for (int e = e0; e < e1; ++e) {
    if (rows[e] > 0) {
      p.used_e[at] = e;
      p.nrows[at] = rows[e];
      rows[e] = at++;
    } else {
      rows[e] = -1;
    }
  }
  if (threadIdx.x == 0) {
    n_used_s = n_used;
    *p.n_used = n_used;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += FD_THREADS) p.uidx[e] = rows[e];
  for (int i = threadIdx.x; i < n_used_s * C; i += FD_THREADS) p.slot_tok[i] = -1;
  __syncthreads();
  // A cell written twice keeps the later assignment, so the later token,
  // as the reference's scatter loop does: the largest assignment index
  // wins, then becomes its token.
  for (int a = threadIdx.x; a < n_assign; a += FD_THREADS) {
    const int e = __ldcg(ie + a), c = __ldcg(ip + a);
    if (e >= 0 && e < E && c >= 0 && c < C) atomicMax(&p.slot_tok[rows[e] * C + c], a);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_used_s * C; i += FD_THREADS) {
    const int a = __ldcg(p.slot_tok + i);
    if (a >= 0) p.slot_tok[i] = a / k;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The work queue's counters
// ---------------------------------------------------------------------------

static __device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One finished item: every thread's stores, then one count (called by
// every thread of the block).
static __device__ __forceinline__ void publish(int* ctr) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1);
  }
}

// Thread 0 only: wait until *ctr reaches want.  The caller's barrier
// then hands the acquired data to the block.
static __device__ __forceinline__ void wait_for(const int* ctr, int want) {
  while (ld_acquire(ctr) < want) __nanosleep(64);
}

// ---------------------------------------------------------------------------
// Items
// ---------------------------------------------------------------------------

// One item on the tensor cores (bf16): for the cells c < ncells of a row
// tile (row c at rowp[c], null: zeros) and the 256 columns n0.., out[c,
// n] = rows[c] . W[:, n] (and rows[c] . W1[:, n] for swiglu), K deep,
// the epilogue applied, written to dst[c * N + n].  ring holds
// FD_STAGES stages of stage_elems elements: [FD_RT][FD_LD_X] rows, then
// MATS [FD_BK][FD_LD_W] weight slabs.  Called by every thread.
template <int MATS>
static __device__ void tc_item(bf16* ring, int stage_elems,
                               const bf16* const* rowp, int ncells,
                               const bf16* W0, const bf16* W1, int K, int N,
                               int n0, bool vec, int epi, bf16* dst) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nct = (ncells + 7) / 8;       // n8 tiles of cells in use
  const bf16* Wm[2] = {W0, W1};

  auto load_slab = [&](int stage, int kt) {
    bf16* Xs = ring + stage * stage_elems;
    const int k0 = kt * FD_BK;
    constexpr int CPR = FD_BK / 8;        // 16-byte chunks per row
    if (vec) {
#pragma unroll
      for (int m = 0; m < MATS; ++m)
        load_tile<bf16, FD_BK, FD_BN, FD_LD_W, FD_THREADS, true, true>(
            Xs + FD_X_ELEMS + m * FD_W_ELEMS, Wm[m] + (long long)k0 * N + n0, N,
            K - k0, N - n0, tid);
      if (tid < nct * 8 * CPR) {
        const int r = tid / CPR, c = (tid % CPR) * 8;
        const bf16* src = rowp[r];
        const bool ok = src != nullptr && k0 + c < K;
        cp_async16<false>(smem_u32(Xs + r * FD_LD_X + c), ok ? src + k0 + c : W0, ok);
      }
    } else {
#pragma unroll
      for (int m = 0; m < MATS; ++m)
        load_tile<bf16, FD_BK, FD_BN, FD_LD_W, FD_THREADS, false>(
            Xs + FD_X_ELEMS + m * FD_W_ELEMS, Wm[m] + (long long)k0 * N + n0, N,
            K - k0, N - n0, tid);
      for (int i = tid; i < nct * 8 * FD_BK; i += FD_THREADS) {
        const int r = i / FD_BK, c = i % FD_BK;
        const bf16* src = rowp[r];
        Xs[r * FD_LD_X + c] = (src != nullptr && k0 + c < K) ? ldcg_bf16(src + k0 + c)
                                                             : from_f<bf16>(0.f);
      }
    }
  };

  float acc[MATS][2][8][4];
#pragma unroll
  for (int m = 0; m < MATS; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int ct = 0; ct < 8; ++ct)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][i][ct][v] = 0.f;

  const int q = lane >> 3, r = lane & 7;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (K + FD_BK - 1) / FD_BK;
#pragma unroll
  for (int s = 0; s < FD_STAGES - 1; ++s) {
    if (s < nk) load_slab(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FD_STAGES - 2>();
    __syncthreads();   // slab kt landed; slab kt-1's stage is free
    const int next = kt + FD_STAGES - 1;
    if (next < nk) load_slab(next % FD_STAGES, next);
    cp_async_commit();
    const bf16* Xs = ring + (kt % FD_STAGES) * stage_elems;
#pragma unroll
    for (int kk = 0; kk < FD_BK; kk += 16) {
      uint32_t a[MATS][2][4];
#pragma unroll
      for (int m = 0; m < MATS; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i)   // A = W^T: W's rows are the k axis
          ldsm_x4_t(a[m][i], smem_u32(Xs + FD_X_ELEMS + m * FD_W_ELEMS +
                                      (kk + r + (q >> 1) * 8) * FD_LD_W +
                                      warp * 32 + i * 16 + (q & 1) * 8));
#pragma unroll
      for (int ct = 0; ct < 8; ++ct) {
        if (ct < nct) {   // B = rows^T: row c holds column c
          const bf16* xr = Xs + (ct * 8 + g) * FD_LD_X + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
          for (int m = 0; m < MATS; ++m) {
            mma_bf16(acc[m][0][ct], a[m][0], b0, b1);
            mma_bf16(acc[m][1][ct], a[m][1], b0, b1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[m][i][ct] = out^T rows n (g, g+8) x columns c (2t, 2t+1).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ct = 0; ct < 8; ++ct)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int n = n0 + warp * 32 + i * 16 + g + (v >> 1) * 8;
        const int c = ct * 8 + 2 * t + (v & 1);
        if (c >= ncells || n >= N) continue;
        float z = acc[0][i][ct][v];
        if constexpr (MATS == 2) {
          // (silu(h) in dt) * (x w3 in dt) in f32, rounded to dt.
          z = to_f<bf16>(from_f<bf16>(silu(z))) *
              to_f<bf16>(from_f<bf16>(acc[1][i][ct][v]));
        } else if (epi == EPI_RELU) {
          z = fmaxf(z, 0.f);
        }
        dst[(long long)c * N + n] = from_f<bf16>(z);
      }
}

// The same item on the CUDA cores (f32): 8-row tiles through row_tile;
// swiglu runs W1 over the tile after W0, each thread combining the
// hidden value it wrote itself.
template <typename T>
static __device__ void cc_item(unsigned char* smem, const T* const* rowp,
                               int ncells, const T* W0, const T* W1, int K,
                               int N, int n0, bool vec, int epi, T* dst) {
  float (*xs)[FD_KC] = reinterpret_cast<float (*)[FD_KC]>(smem);
  float (*red)[FD_BN] =
      reinterpret_cast<float (*)[FD_BN]>(smem + FD_BM * FD_KC * sizeof(float));
  for (int cs = 0; cs < ncells; cs += FD_BM) {
    auto stage = [&](int r, int kg) -> float {
      const T* src = rowp[cs + r];
      return src != nullptr ? ld_cg(src + kg) : 0.f;
    };
    T* d = dst + (long long)cs * N;
    auto store = [&](int r, int n, float z) {
      if (cs + r >= ncells || n >= N) return;
      if (epi == EPI_RELU) z = fmaxf(z, 0.f);
      else if (epi == EPI_SWIGLU) z = silu(z);
      d[(long long)r * N + n] = from_f<T>(z);
    };
    row_tile<T>(xs, red, stage, W0, K, N, n0, vec, store);
    if (epi == EPI_SWIGLU) {
      auto gate = [&](int r, int n, float z) {
        if (cs + r >= ncells || n >= N) return;
        T* at = d + (long long)r * N + n;
        *at = from_f<T>(to_f<T>(*at) * to_f<T>(from_f<T>(z)));
      };
      row_tile<T>(xs, red, stage, W1, K, N, n0, vec, gate);
    }
  }
}

// An up item (x w1 [and x w3], or the projection) or a down item (hs
// w2) of used expert u / expert e, cells c0.. of its row tile.
template <typename T>
static __device__ void ffn_item(const FusedParams& p, unsigned char* smem,
                                const T* const* rowp, int ncells, int u, int e,
                                int c0, int nt, bool up) {
  const bool proj = p.mode == FD_ROUTED_PROJ;
  const bool gated = !proj && p.act == FD_SWIGLU;
  const int K = up ? p.d_in : p.f;
  const int N = up && !proj ? p.f : p.d_out;
  const long long w_off = (long long)e * K * N;
  const T* W0 = static_cast<const T*>(up ? p.w1 : p.w2) + w_off;
  const T* W1 = up && gated ? static_cast<const T*>(p.w3) + w_off : nullptr;
  const int epi = !up || proj ? EPI_NONE : gated ? EPI_SWIGLU : EPI_RELU;
  T* dst = static_cast<T*>(up && !proj ? p.hs : p.outb) + ((long long)u * p.C + c0) * N;
  const bool vec = (up ? p.vec_up : p.vec_dn) != 0;
  const int n0 = nt * FD_BN;
  if constexpr (sizeof(T) == 2) {
    bf16* ring = reinterpret_cast<bf16*>(smem);
    const int stage_elems = FD_X_ELEMS + (gated ? 2 : 1) * FD_W_ELEMS;
    if (epi == EPI_SWIGLU)
      tc_item<2>(ring, stage_elems, rowp, ncells, W0, W1, K, N, n0, vec, epi, dst);
    else
      tc_item<1>(ring, stage_elems, rowp, ncells, W0, W1, K, N, n0, vec, epi, dst);
  } else {
    cc_item<T>(smem, rowp, ncells, W0, W1, K, N, n0, vec, epi, dst);
  }
}

// A combine item: token t, FD_THREADS * FD_NPT columns.  Each thread owns
// 8 columns strided by the block width, so a warp's loads are
// contiguous.  It first waits for the row tiles of the cells it reads.
template <typename T, typename TO>
static __device__ void combine_item(const FusedParams& p, int it, int NTc,
                                    const int* oe, const int* op,
                                    const float* ow, const int* done,
                                    int want) {
  const int N = p.d_out, C = p.C, E = p.E, k = p.k_out;
  const int t = it / NTc, n0 = (it % NTc) * FD_THREADS * FD_NPT + threadIdx.x;
  if (threadIdx.x == 0) {
    for (int j = 0; j < k; ++j) {
      const int a = t * k + j;
      const int e = __ldcg(oe + a), c = __ldcg(op + a);
      if (e < 0 || e >= E || c < 0 || c >= C) continue;
      const int u = __ldcg(p.uidx + e);
      if (u < 0 || c >= __ldcg(p.nrows + u)) continue;
      wait_for(done + u * p.RT + c / FD_RT, want);
    }
    __threadfence();
  }
  __syncthreads();
  const T* outb = static_cast<const T*>(p.outb);
  TO* y = static_cast<TO*>(p.y);
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

// Phase 3: the work queue.  Tickets [0, n_up) are up items, then n_dn
// down items, then the combine items; an item's index runs over (used
// expert, row tile, column tile), column tile fastest.
template <typename T, typename TO>
static __device__ void work_queue(const FusedParams& p, unsigned char* smem,
                                  const int* oe, const int* op, const float* ow) {
  __shared__ int ticket_s;
  __shared__ const T* rowp[FD_RT];
  const bool proj = p.mode == FD_ROUTED_PROJ;
  const int RT = p.RT;
  const int NTu = ((proj ? p.d_out : p.f) + FD_BN - 1) / FD_BN;
  const int NTd = proj ? 0 : (p.d_out + FD_BN - 1) / FD_BN;
  const int NTc = (p.d_out + FD_THREADS * FD_NPT - 1) / (FD_THREADS * FD_NPT);
  const int n_used = __ldcg(p.n_used);
  const int n_up = n_used * RT * NTu, n_dn = n_used * RT * NTd;
  const int total = n_up + n_dn + p.T_out * NTc;
  for (;;) {
    __syncthreads();                      // the previous item is done
    if (threadIdx.x == 0) ticket_s = atomicAdd(p.ticket, 1);
    __syncthreads();
    const int tk = ticket_s;
    if (tk >= total) break;
    if (tk >= n_up + n_dn) {
      combine_item<T, TO>(p, tk - n_up - n_dn, NTc, oe, op, ow,
                          proj ? p.up_done : p.dn_done, proj ? NTu : NTd);
      continue;
    }
    const bool up = tk < n_up;
    const int it = up ? tk : tk - n_up;
    const int NT = up ? NTu : NTd;
    const int nt = it % NT, ur = it / NT, u = ur / RT, c0 = (ur % RT) * FD_RT;
    const int ncells = min(FD_RT, __ldcg(p.nrows + u) - c0);
    if (ncells <= 0) continue;            // past the filled cells: no work
    if (!up && threadIdx.x == 0) {
      wait_for(p.up_done + ur, NTu);      // the whole hidden row tile
      __threadfence();
    }
    if (threadIdx.x < FD_RT) {
      const int i = threadIdx.x;
      const T* src = nullptr;
      if (i < ncells) {
        const long long cell = (long long)u * p.C + c0 + i;
        if (!up) {
          src = static_cast<const T*>(p.hs) + cell * p.f;
        } else {
          const int tok = __ldcg(p.slot_tok + cell);
          if (tok >= 0) src = static_cast<const T*>(p.x) + (long long)tok * p.d_in;
        }
      }
      rowp[i] = src;
    }
    __syncthreads();
    ffn_item<T>(p, smem, rowp, ncells, u, __ldcg(p.used_e + u), c0, nt, up);
    publish((up ? p.up_done : p.dn_done) + ur);
  }
}

// The phases, in order.
template <typename T, typename TO>
static __device__ void fused_body(const FusedParams& p) {
  extern __shared__ __align__(16) unsigned char fd_smem[];
  float (*xs)[FD_KC] = reinterpret_cast<float (*)[FD_KC]>(fd_smem);
  float (*red)[FD_BN] =
      reinterpret_cast<float (*)[FD_BN]>(fd_smem + FD_BM * FD_KC * sizeof(float));
  int* ints = reinterpret_cast<int*>(fd_smem);   // block 0, phase 2 only
  cg::grid_group grid = cg::this_grid();

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
  work_queue<T, TO>(p, fd_smem, oe, op, ow);
}

// Kernel 7 and kernel 8 under their own names (profiles tell them apart).
// One block an SM (the ring takes up to 152 KB), so up to 255 registers.
template <typename T>
__global__ void __launch_bounds__(FD_THREADS, 1) fused_decode_kernel(FusedParams p) {
  fused_body<T, T>(p);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(FD_THREADS, 1) fused_routed_kernel(FusedParams p) {
  fused_body<T, TO>(p);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

struct Workspace {
  size_t part, logits, fe, fp, fw, uidx, nrows, used_e, n_used, slot_tok, hs,
      outb, ticket, up_done, dn_done, total;
};

static int row_tiles(int C) { return (C + FD_RT - 1) / FD_RT; }

static Workspace layout(int decode, int T_in, int k_in, int d_in, int d_out, int f,
                        int E, int C, int ffn, size_t elt) {
  Workspace w;
  const size_t n_chunks = decode ? (d_in + FD_KC - 1) / FD_KC : 0;
  const size_t n_assign = (size_t)T_in * k_in;
  const size_t max_used = std::min((size_t)E, n_assign);
  const size_t n_ctr = max_used * row_tiles(C);
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
  w.outb = take(max_used * C * d_out * elt);
  w.ticket = take(sizeof(int));
  w.up_done = take(n_ctr * sizeof(int));
  w.dn_done = take(n_ctr * sizeof(int));
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
  p.outb = b + w.outb;
  p.ticket = reinterpret_cast<int*>(b + w.ticket);
  p.up_done = reinterpret_cast<int*>(b + w.up_done);
  p.dn_done = reinterpret_cast<int*>(b + w.dn_done);
}

// Blocks of ``kernel`` that fit on device ``dev`` at once with ``smem``
// bytes of dynamic shared memory each (0: no cooperative launch there),
// queried once per (kernel, device, bytes): the queries would otherwise
// cost host time on every decode step.  The kernel is first allowed the
// largest dynamic shared memory any launch asks for.
static cudaError_t grid_blocks(const void* kernel, int dev, int smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, dev, smem);
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
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FD_RING_BYTES(2));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FD_THREADS, smem);
  if (err != cudaSuccess) return err;
  *blocks = coop ? per_sm * sms : 0;
  cache[key] = *blocks;
  return cudaSuccess;
}

// One cooperative launch of at most ``want`` blocks (the most items any
// phase can have), never more than fit on the card at once.
static int launch(const void* kernel, FusedParams& p, int smem, int want,
                  cudaStream_t stream) {
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = grid_blocks(kernel, dev, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  blocks = std::min(blocks, std::max(want, 1));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(FD_THREADS), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The sizes the kernel derives from the shapes: row tiles, the largest
// used-expert count, the 16-byte load paths, the dynamic shared memory,
// and the most work items of any phase (the grid's upper bound).
static void plan_launch(FusedParams& p, int bf16_in, const void* w_in2,
                        int* smem, int* want) {
  const bool proj = p.mode == FD_ROUTED_PROJ;
  const bool gated = !proj && p.act == FD_SWIGLU;
  const int n_up_cols = proj ? p.d_out : p.f;
  p.RT = row_tiles(p.C);
  p.max_used = std::min(p.E, p.T_in * p.k_in);
  p.vec_up = n_up_cols % 8 == 0 && p.d_in % 8 == 0 && aligned16(p.x) &&
             aligned16(p.w1) && (!gated || aligned16(w_in2));
  p.vec_dn = !proj && p.d_out % 8 == 0 && p.f % 8 == 0 && aligned16(p.w2);
  *smem = bf16_in ? std::max(FD_BASE_BYTES, FD_RING_BYTES(gated ? 2 : 1))
                  : FD_BASE_BYTES;
  const int NTu = (n_up_cols + FD_BN - 1) / FD_BN;
  const int NTd = proj ? 0 : (p.d_out + FD_BN - 1) / FD_BN;
  const int NTc = (p.d_out + FD_THREADS * FD_NPT - 1) / (FD_THREADS * FD_NPT);
  int items = std::max(p.max_used * p.RT * std::max(NTu, NTd), p.T_out * NTc);
  if (p.mode == FD_DECODE)
    items = std::max(items, ((p.E + 31) / 32) * ((p.T_in + FD_BM - 1) / FD_BM) * p.n_chunks);
  *want = items;
}

static size_t elt_size(int dtype) { return dtype == REPRO_BF16 ? 2 : 4; }

// Bytes of workspace a call needs (decode = 1: repro_fused_decode with
// T_in = T, k_in = k, d_in = d_out = d; decode = 0: repro_fused_routed).
extern "C" int repro_fused_workspace_bytes(int decode, int T_in, int k_in, int d_in,
                                           int d_out, int f, int E, int C, int mode,
                                           int activation, int dtype,
                                           long long* bytes) {
  (void)activation;
  if (T_in < 0 || k_in < 1 || E < 1 || C < 1 || (dtype != REPRO_F32 && dtype != REPRO_BF16))
    return (int)cudaErrorInvalidValue;
  const int ffn = decode || mode == FD_ROUTED_FFN;
  *bytes = (long long)layout(decode, T_in, k_in, d_in, d_out, f, E, C, ffn,
                             elt_size(dtype)).total;
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
  int smem = 0, want = 0;
  plan_launch(p, dtype == REPRO_BF16, w3, &smem, &want);
  bind_workspace(p, ws, layout(1, T_, k, d, d, f, E, C, 1, elt_size(dtype)));
  if (dtype == REPRO_F32)
    return launch((const void*)fused_decode_kernel<float>, p, smem, want, stream);
  return launch((const void*)fused_decode_kernel<bf16>, p, smem, want, stream);
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
  if (in_dtype != REPRO_F32 && in_dtype != REPRO_BF16) return (int)cudaErrorInvalidValue;
  if (out_dtype != REPRO_F32 && out_dtype != REPRO_BF16) return (int)cudaErrorInvalidValue;
  FusedParams p = {};
  p.x = x; p.w1 = w1; p.w2 = w2; p.w3 = w3;
  p.in_e = in_e; p.in_p = in_p; p.out_e = out_e; p.out_p = out_p; p.out_w = out_w;
  p.y = y;
  p.T_in = T_in; p.k_in = k_in; p.T_out = T_out; p.k_out = k_out;
  p.d_in = d_in; p.d_out = d_out; p.f = ffn ? f : 0; p.E = E; p.C = C;
  p.mode = mode; p.act = ffn ? activation : -1;
  p.n_chunks = 0;
  int smem = 0, want = 0;
  plan_launch(p, in_dtype == REPRO_BF16, w3, &smem, &want);
  bind_workspace(p, ws, layout(0, T_in, k_in, d_in, d_out, f, E, C, ffn,
                               elt_size(in_dtype)));
  const void* kernel;
  if (in_dtype == REPRO_F32)
    kernel = out_dtype == REPRO_F32 ? (const void*)fused_routed_kernel<float, float>
                                    : (const void*)fused_routed_kernel<float, bf16>;
  else
    kernel = out_dtype == REPRO_F32 ? (const void*)fused_routed_kernel<bf16, float>
                                    : (const void*)fused_routed_kernel<bf16, bf16>;
  return launch(kernel, p, smem, want, stream);
}
