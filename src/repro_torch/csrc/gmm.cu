// Grouped (per-expert) matmul [E, C, K] x [E, K, N] -> [E, C, N] with an
// f32 accumulator and a fused none / relu / silu epilogue; either operand
// may be read transposed in place (the backward pass, at the end).
//
// Replaces the TPU kernel repro/kernels/gmm.py::_gmm_kernel (pallas_call
// in _gmm_raw), which tiled (E, C, N, K) on the 128x128 MXU and
// zero-padded ragged C/K/N with copies.  Here the ragged edges are masked
// inside the kernel, and there are no padding copies.
//
// Bound on the H100: bytes.  On the serving path C is small (C = 8 at
// kimi-k2's decode and short prefills: capacity_for rounds k*T*1.25/E up
// to 8), so the work is 2*C = 16 flops per weight element and the kernel
// must stream all E*K*N weights once: 33.8 GB per kimi-k2 MoE layer,
// about 10 ms at 3.35 TB/s.  A 128-row MMA tile would waste 15/16 of its
// work, so the design is a weight-streaming kernel on the CUDA cores:
//   * block = (expert, 8-row C tile, 256-column N tile), 8 warps;
//   * each lane owns 8 consecutive columns and loads them with one
//     16-byte access per weight row (a warp reads 512 contiguous bytes of
//     bf16), four rows in flight per warp;
//   * the warps split K (warp w takes rows w, w+8, ...); the 8 x 256 f32
//     accumulators of a warp stay in registers (64 per thread), and the
//     warps' partial sums are added in warp order through shared memory,
//     so the result does not depend on scheduling;
//   * the C tile of x is staged in shared memory as f32, 1024 K at a time
//     (one barrier per 128 weight rows of each warp).
// f32 inputs use exact f32 fused multiply-add, never TF32; bf16 inputs
// are widened to f32 exactly before the same FMA.  Making this kernel
// fast (tensor cores at larger C, skipping experts with no tokens) is
// later work.
#include "common.cuh"

#define GMM_WARPS 8
#define GMM_THREADS (32 * GMM_WARPS)
#define GMM_BM 8
#define GMM_NPT 8
#define GMM_BN (32 * GMM_NPT)
#define GMM_KC 1024
#define GMM_UNROLL 4

enum GmmActivation { GMM_NONE = 0, GMM_RELU = 1, GMM_SILU = 2 };

template <typename T>
static __device__ __forceinline__ void load_row(const T* row, int ncol, int N,
                                                bool vec, float out[GMM_NPT]) {
  if (vec && ncol + GMM_NPT <= N) {
    Vec8<T>::load(row + ncol, out);
  } else {
#pragma unroll
    for (int j = 0; j < GMM_NPT; ++j)
      out[j] = (ncol + j < N) ? to_f<T>(row[ncol + j]) : 0.f;
  }
}

static __device__ __forceinline__ float epilogue(float z, int activation) {
  if (activation == GMM_RELU) return fmaxf(z, 0.f);
  if (activation == GMM_SILU) return z * (1.f / (1.f + expf(-z)));
  return z;
}

template <typename T>
__global__ void __launch_bounds__(GMM_THREADS, 2)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int C, int K, int N, int activation,
           bool vec) {
  __shared__ float xs[GMM_BM][GMM_KC];
  __shared__ float red[GMM_WARPS][GMM_BN];
  const int n0 = blockIdx.x * GMM_BN;
  const int c0 = blockIdx.y * GMM_BM;
  const long long e = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncol = n0 + lane * GMM_NPT;
  const T* xe = x + e * C * K;
  const T* we = w + e * K * N;

  float acc[GMM_BM][GMM_NPT];
#pragma unroll
  for (int r = 0; r < GMM_BM; ++r)
#pragma unroll
    for (int j = 0; j < GMM_NPT; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GMM_KC) {
    for (int i = threadIdx.x; i < GMM_BM * GMM_KC; i += GMM_THREADS) {
      const int r = i / GMM_KC, kk = i % GMM_KC;
      const int c = c0 + r, kg = k0 + kk;
      xs[r][kk] = (c < C && kg < K) ? to_f<T>(xe[(long long)c * K + kg]) : 0.f;
    }
    __syncthreads();
    const int kend = min(GMM_KC, K - k0);
    int kk = warp;
    for (; kk + (GMM_UNROLL - 1) * GMM_WARPS < kend; kk += GMM_UNROLL * GMM_WARPS) {
      float wv[GMM_UNROLL][GMM_NPT];
#pragma unroll
      for (int u = 0; u < GMM_UNROLL; ++u)
        load_row<T>(we + (long long)(k0 + kk + u * GMM_WARPS) * N, ncol, N, vec, wv[u]);
#pragma unroll
      for (int u = 0; u < GMM_UNROLL; ++u) {
#pragma unroll
        for (int r = 0; r < GMM_BM; ++r) {
          const float xv = xs[r][kk + u * GMM_WARPS];
#pragma unroll
          for (int j = 0; j < GMM_NPT; ++j) acc[r][j] = fmaf(xv, wv[u][j], acc[r][j]);
        }
      }
    }
    for (; kk < kend; kk += GMM_WARPS) {
      float wv[GMM_NPT];
      load_row<T>(we + (long long)(k0 + kk) * N, ncol, N, vec, wv);
#pragma unroll
      for (int r = 0; r < GMM_BM; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int j = 0; j < GMM_NPT; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
      }
    }
    __syncthreads();
  }

  // Add the warps' partial sums in warp order, one C row at a time.
#pragma unroll
  for (int r = 0; r < GMM_BM; ++r) {
#pragma unroll
    for (int j = 0; j < GMM_NPT; ++j) red[warp][lane * GMM_NPT + j] = acc[r][j];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < GMM_WARPS; ++q) s += red[q][threadIdx.x];
    const int c = c0 + r, n = n0 + threadIdx.x;
    if (c < C && n < N) out[(e * C + c) * N + n] = from_f<T>(epilogue(s, activation));
    __syncthreads();
  }
}

template <typename T>
static int run_gmm(const void* x, const void* w, void* out, int E, int C,
                   int K, int N, int activation, cudaStream_t stream) {
  if (E == 0 || C == 0 || N == 0) return 0;
  const bool vec = N % GMM_NPT == 0 && aligned16(w);
  const dim3 grid((N + GMM_BN - 1) / GMM_BN, (C + GMM_BM - 1) / GMM_BM, E);
  gmm_kernel<T><<<grid, GMM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, K, N, activation, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Transposed operand layouts: the backward pass of the TPU kernel's
// custom VJP (repro/kernels/gmm.py::_gmm_bwd, l.283), which runs the
// same kernel on swapped operands:
//   dx = gmm(dz, w^T)   w stored [E, K, N], read as [E, N, K]   (TW = 1)
//   dw = gmm(x^T, dz)   x stored [E, C, K], read as [E, K, C]   (TX = 1)
// The operands are read in place through the layout flags: no
// transposed copy is ever made (one transposed weight is 1 GB at the
// paper's MoE-256 and 33.8 GB at kimi-k2).
//
// Bound on the H100: operations.  In training C = 128 rows per expert,
// so the work is 2*C flops per weight element and the products are
// compute-bound: one step's expert FFN at MoE-256 is 7 launches of
// about 34 GFLOP, 0.5 ms each at the f32 rate of the CUDA cores
// (67 TFLOP/s).  Design, simple first: a classic shared-memory tiled
// matmul.  A block computes a 64 x 64 output tile of one expert with 256
// threads, 4 x 4 outputs per thread; each 16-deep K slab of both
// operands is staged in shared memory as f32, loaded so that
// neighbouring threads read neighbouring addresses whichever dimension
// of the stored operand is contiguous.  Each output is one thread's f32
// FMA chain over K in ascending order (exact f32, never TF32; bf16 is
// widened exactly first), so the result is deterministic.  Ragged edges
// are masked with zeros.  Tensor cores (wgmma) are later work.
#define GT_BM 64
#define GT_BN 64
#define GT_BK 16
#define GT_THREADS 256
#define GT_PAD 4

template <typename T, bool TX, bool TW>
__global__ void __launch_bounds__(GT_THREADS)
gmm_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int M, int K, int N, int activation) {
  __shared__ __align__(16) float As[GT_BK][GT_BM + GT_PAD];
  __shared__ __align__(16) float Bs[GT_BK][GT_BN + GT_PAD];
  const int n0 = blockIdx.x * GT_BN;
  const int m0 = blockIdx.y * GT_BM;
  const long long e = blockIdx.z;
  const T* xe = x + e * M * K;
  const T* we = w + e * K * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GT_BK) {
#pragma unroll
    for (int r = 0; r < (GT_BM * GT_BK) / GT_THREADS; ++r) {
      const int l = tid + r * GT_THREADS;
      int m, kk;
      if (TX) { kk = l / GT_BM; m = l % GT_BM; }   // stored [K, M]: m contiguous
      else    { m = l / GT_BK; kk = l % GT_BK; }   // stored [M, K]: k contiguous
      const int mg = m0 + m, kg = k0 + kk;
      float v = 0.f;
      if (mg < M && kg < K)
        v = to_f<T>(TX ? xe[(long long)kg * M + mg] : xe[(long long)mg * K + kg]);
      As[kk][m] = v;
    }
#pragma unroll
    for (int r = 0; r < (GT_BN * GT_BK) / GT_THREADS; ++r) {
      const int l = tid + r * GT_THREADS;
      int n, kk;
      if (TW) { n = l / GT_BK; kk = l % GT_BK; }   // stored [N, K]: k contiguous
      else    { kk = l / GT_BN; n = l % GT_BN; }   // stored [K, N]: n contiguous
      const int ng = n0 + n, kg = k0 + kk;
      float v = 0.f;
      if (ng < N && kg < K)
        v = to_f<T>(TW ? we[(long long)ng * K + kg] : we[(long long)kg * N + ng]);
      Bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GT_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(e * M + m) * N + n] = from_f<T>(epilogue(acc[i][j], activation));
    }
  }
}

template <typename T, bool TX, bool TW>
static int run_gmm_tiled(const void* x, const void* w, void* out, int E,
                         int M, int K, int N, int activation,
                         cudaStream_t stream) {
  if (E == 0 || M == 0 || N == 0) return 0;
  const dim3 grid((N + GT_BN - 1) / GT_BN, (M + GT_BM - 1) / GT_BM, E);
  gmm_tiled_kernel<T, TX, TW><<<grid, GT_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      M, K, N, activation);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_gmm(const void* x, const void* w, void* out, int E, int C,
                        int K, int N, int activation, int trans_x, int trans_w,
                        cudaStream_t stream) {
  // Both flags 0: the weight-streaming kernel above, unchanged.  The
  // backward pass never reads both operands transposed.
  if (!trans_x && !trans_w) return run_gmm<T>(x, w, out, E, C, K, N, activation, stream);
  if (trans_x && trans_w) return (int)cudaErrorInvalidValue;
  if (trans_x) return run_gmm_tiled<T, true, false>(x, w, out, E, C, K, N, activation, stream);
  return run_gmm_tiled<T, false, true>(x, w, out, E, C, K, N, activation, stream);
}

// x is [E, C, K] (trans_x = 0) or stored [E, K, C] (trans_x = 1); w is
// [E, K, N] (trans_w = 0) or stored [E, N, K] (trans_w = 1), at most one
// of the two transposed; out is [E, C, N].  E, C, K, N are the logical
// sizes.
extern "C" int repro_gmm(const void* x, const void* w, void* out, int E,
                         int C, int K, int N, int activation, int dtype,
                         int trans_x, int trans_w, cudaStream_t stream) {
  if (E < 0 || C < 0 || K < 0 || N < 0 || E > 65535 || activation < GMM_NONE ||
      activation > GMM_SILU)
    return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_F32)
    return dispatch_gmm<float>(x, w, out, E, C, K, N, activation, trans_x, trans_w, stream);
  if (dtype == REPRO_BF16)
    return dispatch_gmm<__nv_bfloat16>(x, w, out, E, C, K, N, activation, trans_x,
                                       trans_w, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
