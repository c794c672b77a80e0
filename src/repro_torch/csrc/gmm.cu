// Grouped (per-expert) matmul [E, C, K] x [E, K, N] -> [E, C, N] with an
// f32 accumulator and a fused none / relu / silu epilogue.
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

extern "C" int repro_gmm(const void* x, const void* w, void* out, int E,
                         int C, int K, int N, int activation, int dtype,
                         cudaStream_t stream) {
  if (E < 0 || C < 0 || K < 0 || N < 0 || E > 65535 || activation < GMM_NONE ||
      activation > GMM_SILU)
    return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_F32)
    return run_gmm<float>(x, w, out, E, C, K, N, activation, stream);
  if (dtype == REPRO_BF16)
    return run_gmm<__nv_bfloat16>(x, w, out, E, C, K, N, activation, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
