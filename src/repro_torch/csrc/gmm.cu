// Grouped (per-expert) matmul [E, C, K] x [E, K, N] -> [E, C, N] with an
// f32 accumulator and a fused none / relu / silu epilogue, on the tensor
// cores.  Either operand may be read transposed in place (the backward
// pass).  Two kernels, chosen per call by the wrapper
// (kernels/gmm.py::kernel_for):
//
//   gmm_stream_kernel   bf16, forward layout, C <= 64 rows per expert:
//                       serving (decode and prefill buckets), moa-demo.
//   gmm_tile_kernel     every other call: f32 at any C (training), bf16
//   gmm_tile_bwd_kernel above 64 rows; _bwd is the transposed layouts.
//
// Both take an optional rows[E] (int32, on the device): the count of
// filled leading rows of each expert's x (its stored dimension 1, the
// C rows of a dispatch buffer).  Rows at or beyond rows[e] are never
// read and add nothing: output rows there come out as exact zeros (for
// dw = x^T dz, the reduction stops there); an expert with rows[e] == 0
// reads no weights.  Sums run in a fixed order with no atomics and no
// split-K, so a result repeats bit for bit.
//
// PTX used: cp.async (16-byte, zero-filling), ldmatrix(.trans), and
// mma.sync m16n8k16 bf16 / m16n8k8 tf32 with f32 accumulators.
#include "mma.cuh"

enum GmmActivation { GMM_NONE = 0, GMM_RELU = 1, GMM_SILU = 2 };
// Kernel codes; kernels/gmm.py KERNELS mirrors them.
enum GmmKernel { GMM_STREAM = 1, GMM_TILE = 2 };
#define GMM_STREAM_MAX_C 64

static __device__ __forceinline__ float epilogue(float z, int activation) {
  if (activation == GMM_RELU) return fmaxf(z, 0.f);
  if (activation == GMM_SILU) return z * (1.f / (1.f + expf(-z)));
  return z;
}

// ---------------------------------------------------------------------------
// PTX wrappers (the bf16 ones, cp.async, ldmatrix and load_tile are in
// mma.cuh)
// ---------------------------------------------------------------------------

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate.
static __device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: v = hi + lo with hi = tf32(v) (round to nearest) and lo = v -
// hi (exact in f32); the tensor core reads lo as tf32, dropping its low
// 13 bits, ~2^-22 of v.  A product is then hi*hi + hi*lo + lo*hi (lo*lo,
// ~2^-22 relative, is dropped).
static __device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                                  uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// The tiled product: gmm_tile_kernel (forward layout) and
// gmm_tile_bwd_kernel (transposed layouts).
//
// Replaces the TPU kernel repro/kernels/gmm.py::_gmm_kernel (l.232,
// pallas_call in _gmm_raw) where C is large, and the products of its
// custom VJP repro/kernels/gmm.py::_gmm_bwd (l.283), which run the same
// kernel on swapped operands:
//   dx = gmm(dz, w^T)   w stored [E, K, N], read as [E, N, K]   (TW)
//   dw = gmm(x^T, dz)   x stored [E, C, K], read as [E, K, C]   (TX)
// read in place: no transposed copy is made.
//
// Bound on the H100: operations.  Training MoE-256 gives C = 128 rows an
// expert, 2*C flops per weight element; one step's expert FFN is 7
// products of 34.4 GFLOP in f32.  The CUDA cores' f32 rate (67 TFLOP/s)
// would hold each to 0.51 ms.  The tensor cores run TF32 at 495 TFLOP/s,
// but TF32 keeps ~11 bits, far from the reference's f32; so f32 runs as
// 3xTF32 (each operand split into hi + lo, three tensor-core products),
// ~2^-21 relative per product, and its floor is 3 x 34.4 GFLOP at 495
// TFLOP/s = 0.21 ms a product.  That rate is wgmma's; mma.sync, used
// here, runs well below it (wgmma is this kernel's next redesign).
// bf16 operands go to the bf16 mma.
//
// Design: a block computes a 128 x 64 output tile of one expert with 4
// warps (2 x 2), each a 64 x 32 warp tile of 4 x 4 mma tiles; three
// blocks share an SM, which leaves each thread 168 registers, enough for
// the 3xTF32 fragments without spills.  K moves in slabs of 64 bytes
// (16 f32 / 32 bf16) through a 3-stage cp.async ring, one barrier a
// slab.  Each operand lands in shared memory in its stored layout (its
// contiguous dimension along the shared row, padded one 16-byte chunk
// or 8 elements against bank conflicts), so both stored layouts load
// with 16-byte accesses along their contiguous dimension; fragments
// come out with ldmatrix (.trans where the stored layout is the
// fragment's transpose) for bf16, with ldmatrix or conflict-free 32-bit
// loads for f32.  Ragged M / N / K edges are zero-filled in the loads
// and masked at the store: no padding copies.  Rows past rows[e] are
// neither loaded nor multiplied (16-row tiles past it are skipped).
// ---------------------------------------------------------------------------

#define GT_WARPS_M 2
#define GT_WARPS_N 2
#define GT_BM (64 * GT_WARPS_M)
#define GT_BN (32 * GT_WARPS_N)
#define GT_STAGES 3
#define GT_MIN_BLOCKS 3
#define GT_THREADS (32 * GT_WARPS_M * GT_WARPS_N)
#define GT_MT 4   // m16 tiles per warp
#define GT_NT 4   // n8 tiles per warp

template <typename T>
struct TileShape {
  static constexpr int BK = 64 / sizeof(T);          // K per slab
  static constexpr int LD_K = BK + 16 / sizeof(T);   // [BM or BN rows][BK]
  static constexpr int LD_WA = GT_BM + 8;            // [BK rows][BM]
  static constexpr int LD_WB = GT_BN + 8;            // [BK rows][BN]
};

template <typename T, bool TX, bool TW>
struct TileSmem {
  using S = TileShape<T>;
  static constexpr int A = TX ? S::BK * S::LD_WA : GT_BM * S::LD_K;
  static constexpr int B = TW ? GT_BN * S::LD_K : S::BK * S::LD_WB;
  static constexpr int STAGE = A + B;
  static constexpr int BYTES = GT_STAGES * STAGE * (int)sizeof(T);
};

// One slab of f32 on the tensor cores, 3xTF32.  For each output tile
// the slab's products (2 k8 steps x 3) start from a zero accumulator
// and are added to the f32 sum with an ordinary (round-to-nearest) add:
// the tensor cores' own accumulation does not round to nearest, and
// summed into one accumulator its error grows with the number of
// additions at the sum's magnitude (3K/8 of them over K), far past
// f32's at K = 1024.  Fragments of an operand stored with k contiguous
// ([m][k] / [n][k]) come out with ldmatrix (an 8 x 8 b16 matrix is 8
// rows of 4 f32, and lane l receives row l/4, f32 column l%4: the tf32
// fragment's layout); the others with conflict-free 32-bit loads.
template <bool TX, bool TW>
static __device__ __forceinline__ void tile_slab(const float* As,
                                                 const float* Bs,
                                                 float acc[GT_MT][GT_NT][4],
                                                 int wm, int wn, int lane,
                                                 int mrows) {
  using S = TileShape<float>;
  constexpr int KS = S::BK / 8;   // k8 steps per slab
  if (mrows <= 0) return;         // none of this warp's rows count
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r = lane & 7;
  uint32_t bh[KS][GT_NT][2], bl[KS][GT_NT][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int jj = 0; jj < GT_NT / 2; ++jj) {
      const int nb = wn * 32 + jj * 16, kk = ks * 8;
      float v[4];   // b0, b1 of n-tile 2jj, then of 2jj + 1
      if (TW) {     // stored [n][k]
        uint32_t u[4];
        ldsm_x4(u, smem_u32(Bs + (nb + r + (q >> 1) * 8) * S::LD_K + kk +
                            (q & 1) * 4));
#pragma unroll
        for (int z = 0; z < 4; ++z) v[z] = __uint_as_float(u[z]);
      } else {      // stored [k][n]
#pragma unroll
        for (int z = 0; z < 4; ++z)
          v[z] = Bs[(kk + t + (z & 1) * 4) * S::LD_WB + nb + (z >> 1) * 8 + g];
      }
#pragma unroll
      for (int z = 0; z < 4; ++z)
        split_tf32(v[z], bh[ks][2 * jj + (z >> 1)][z & 1],
                   bl[ks][2 * jj + (z >> 1)][z & 1]);
    }
#pragma unroll
  for (int i = 0; i < GT_MT; ++i) {
    if (i * 16 >= mrows) break;   // rows past rows[e]: nothing to add
    const int mb = wm * 64 + i * 16;
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kk = ks * 8;
      float a[4];   // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      if (TX) {     // stored [k][m]
#pragma unroll
        for (int z = 0; z < 4; ++z)
          a[z] = As[(kk + t + (z >> 1) * 4) * S::LD_WA + mb + g + (z & 1) * 8];
      } else {      // stored [m][k]
        uint32_t u[4];
        ldsm_x4(u, smem_u32(As + (mb + r + (q & 1) * 8) * S::LD_K + kk +
                            (q >> 1) * 4));
#pragma unroll
        for (int z = 0; z < 4; ++z) a[z] = __uint_as_float(u[z]);
      }
#pragma unroll
      for (int z = 0; z < 4; ++z) split_tf32(a[z], ah[ks][z], al[ks][z]);
    }
#pragma unroll
    for (int j = 0; j < GT_NT; ++j) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_tf32(d, al[ks], bh[ks][j][0], bh[ks][j][1]);
        mma_tf32(d, ah[ks], bl[ks][j][0], bl[ks][j][1]);
        mma_tf32(d, ah[ks], bh[ks][j][0], bh[ks][j][1]);
      }
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[i][j][z] += d[z];
    }
  }
}

// One slab of bf16 on the tensor cores.
template <bool TX, bool TW>
static __device__ __forceinline__ void tile_slab(const __nv_bfloat16* As,
                                                 const __nv_bfloat16* Bs,
                                                 float acc[GT_MT][GT_NT][4],
                                                 int wm, int wn, int lane,
                                                 int mrows) {
  using S = TileShape<__nv_bfloat16>;
  if (mrows <= 0) return;         // none of this warp's rows count
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < S::BK; kk += 16) {
    uint32_t a[GT_MT][4], b[GT_NT][2];
#pragma unroll
    for (int i = 0; i < GT_MT; ++i) {
      const int mb = wm * 64 + i * 16;
      if (TX)   // stored [k][m]: the fragment's transpose
        ldsm_x4_t(a[i], smem_u32(As + (kk + r + (q >> 1) * 8) * S::LD_WA + mb +
                                 (q & 1) * 8));
      else
        ldsm_x4(a[i], smem_u32(As + (mb + r + (q & 1) * 8) * S::LD_K + kk +
                               (q >> 1) * 8));
    }
#pragma unroll
    for (int jj = 0; jj < GT_NT / 2; ++jj) {
      const int nb = wn * 32 + jj * 16;
      uint32_t v[4];
      if (TW)   // stored [n][k]
        ldsm_x4(v, smem_u32(Bs + (nb + r + (q >> 1) * 8) * S::LD_K + kk +
                            (q & 1) * 8));
      else      // stored [k][n]
        ldsm_x4_t(v, smem_u32(Bs + (kk + r + (q & 1) * 8) * S::LD_WB + nb +
                              (q >> 1) * 8));
      b[2 * jj][0] = v[0];
      b[2 * jj][1] = v[1];
      b[2 * jj + 1][0] = v[2];
      b[2 * jj + 1][1] = v[3];
    }
#pragma unroll
    for (int i = 0; i < GT_MT; ++i) {
      if (i * 16 >= mrows) break;   // rows past rows[e]: nothing to add
#pragma unroll
      for (int j = 0; j < GT_NT; ++j)
        mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
}

template <typename T, bool TX, bool TW, bool VEC>
static __device__ __forceinline__ void tile_body(const T* __restrict__ x,
                                                 const T* __restrict__ w,
                                                 T* __restrict__ out,
                                                 const int* __restrict__ rows,
                                                 int M, int K, int N,
                                                 int activation) {
  using S = TileShape<T>;
  using Sm = TileSmem<T, TX, TW>;
  extern __shared__ __align__(16) unsigned char gmm_smem[];
  T* smem = reinterpret_cast<T*>(gmm_smem);
  const int n0 = blockIdx.x * GT_BN;
  const int m0 = blockIdx.y * GT_BM;
  const long long e = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / GT_WARPS_N, wn = warp % GT_WARPS_N;
  // rows[e] bounds x's rows (its stored dimension 1): the output rows
  // (forward, TW) or the reduction (TX).
  const int lim = rows ? max(rows[e], 0) : (TX ? K : M);
  const int Me = TX ? M : min(M, lim);
  const int Ke = TX ? min(K, lim) : K;
  T* oe = out + e * M * N;
  if (m0 >= Me) {   // no filled row in this tile: zeros, nothing read
    for (int i = tid; i < GT_BM * GT_BN; i += GT_THREADS) {
      const int m = m0 + i / GT_BN, n = n0 + i % GT_BN;
      if (m < M && n < N) oe[(long long)m * N + n] = from_f<T>(0.f);
    }
    return;
  }
  const T* xe = x + e * M * K;
  const T* we = w + e * K * N;

  auto load_slab = [&](int stage, int kt) {
    T* As = smem + stage * Sm::STAGE;
    T* Bs = As + Sm::A;
    const int k0 = kt * S::BK;
    if (TX)
      load_tile<T, S::BK, GT_BM, S::LD_WA, GT_THREADS, VEC>(
          As, xe + (long long)k0 * M + m0, M, Ke - k0, Me - m0, tid);
    else
      load_tile<T, GT_BM, S::BK, S::LD_K, GT_THREADS, VEC>(
          As, xe + (long long)m0 * K + k0, K, Me - m0, Ke - k0, tid);
    if (TW)
      load_tile<T, GT_BN, S::BK, S::LD_K, GT_THREADS, VEC>(
          Bs, we + (long long)n0 * K + k0, K, N - n0, Ke - k0, tid);
    else
      load_tile<T, S::BK, GT_BN, S::LD_WB, GT_THREADS, VEC>(
          Bs, we + (long long)k0 * N + n0, N, Ke - k0, N - n0, tid);
  };

  float acc[GT_MT][GT_NT][4];
#pragma unroll
  for (int i = 0; i < GT_MT; ++i)
#pragma unroll
    for (int j = 0; j < GT_NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int nk = (Ke + S::BK - 1) / S::BK;
  const int mrows = Me - m0 - wm * 64;   // this warp's rows that count
#pragma unroll
  for (int s = 0; s < GT_STAGES - 1; ++s) {
    if (s < nk) load_slab(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GT_STAGES - 2>();
    __syncthreads();   // slab kt landed; slab kt-1's stage is free
    const int next = kt + GT_STAGES - 1;
    if (next < nk) load_slab(next % GT_STAGES, next);
    cp_async_commit();
    const T* As = smem + (kt % GT_STAGES) * Sm::STAGE;
    tile_slab<TX, TW>(As, As + Sm::A, acc, wm, wn, lane, mrows);
  }
  cp_async_wait<0>();

  // acc[i][j] = rows (g, g+8) x columns (2t, 2t+1) of mma tile (i, j).
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < GT_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < GT_NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t + c;
          if (n < N)
            oe[(long long)m * N + n] = from_f<T>(
                m < Me ? epilogue(acc[i][j][2 * h + c], activation) : 0.f);
        }
    }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(GT_THREADS, GT_MIN_BLOCKS)
gmm_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, const int* __restrict__ rows, int M,
                int K, int N, int activation) {
  tile_body<T, false, false, VEC>(x, w, out, rows, M, K, N, activation);
}

template <typename T, bool TX, bool TW, bool VEC>
__global__ void __launch_bounds__(GT_THREADS, GT_MIN_BLOCKS)
gmm_tile_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, const int* __restrict__ rows, int M,
                    int K, int N, int activation) {
  tile_body<T, TX, TW, VEC>(x, w, out, rows, M, K, N, activation);
}

// Opt a kernel into more than 48 KB of dynamic shared memory and the
// largest shared-memory carveout, once per instantiation.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, bool TX, bool TW, bool VEC>
static int run_tile(const void* x, const void* w, void* out, const int* rows,
                    int E, int M, int K, int N, int activation,
                    cudaStream_t stream) {
  constexpr int bytes = TileSmem<T, TX, TW>::BYTES;
  const dim3 grid((N + GT_BN - 1) / GT_BN, (M + GT_BM - 1) / GT_BM, E);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if constexpr (!TX && !TW) {
    static const cudaError_t ready = allow_smem(gmm_tile_kernel<T, VEC>, bytes);
    if (ready != cudaSuccess) return (int)ready;
    gmm_tile_kernel<T, VEC><<<grid, GT_THREADS, bytes, stream>>>(
        xp, wp, op, rows, M, K, N, activation);
  } else {
    static const cudaError_t ready =
        allow_smem(gmm_tile_bwd_kernel<T, TX, TW, VEC>, bytes);
    if (ready != cudaSuccess) return (int)ready;
    gmm_tile_bwd_kernel<T, TX, TW, VEC><<<grid, GT_THREADS, bytes, stream>>>(
        xp, wp, op, rows, M, K, N, activation);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The streaming product: gmm_stream_kernel (bf16, forward layout, C <= 64).
//
// Replaces the TPU kernel repro/kernels/gmm.py::_gmm_kernel (l.232,
// pallas_call in _gmm_raw) on the serving path, where it tiled (E, C, N,
// K) on the 128x128 MXU with C zero-padded to the tile.
//
// Bound on the H100: bytes.  Serving gives C = 8 rows an expert (decode
// and the prefill buckets: capacity_for rounds up to 8), 2*C flops per
// weight element, so the card's least time is that of reading every
// weight once: 11.3 GB a call, 3.4 ms, at kimi-k2 over all 384 experts;
// over only the experts that hold a token (rows), far less.
//
// Design: operands swapped so that C is the mma's N dimension:
// out^T[N, C] = W^T[N, K] x^T[K, C].  The weight tile is the 16-row A
// operand, loaded with ldmatrix.trans straight from W's stored [K, N]
// rows; the C rows of x are the n = 8 B operand (C above 8 loops n8
// tiles over the same weight tile).  So the arithmetic runs on the
// tensor cores and the kernel is held by bytes alone.  A block (8
// warps) owns one expert and 256 output columns over all of K and
// streams 64 x 256 weight slabs (32 KB) with x's matching 64-wide chunk
// through a 4-stage cp.async ring: each weight element is read once,
// with 16-byte accesses that ask L2 for 256 bytes around them (each
// slab row is 512 contiguous bytes), and up to three slabs are in
// flight per block.  Each warp owns 32 columns; no reduction across
// warps.  An expert with rows[e] == 0 writes zeros and reads nothing;
// n8 tiles at or beyond rows[e] are skipped.
// ---------------------------------------------------------------------------

#define GS_BN 256   // columns per block, one warp per 32
#define GS_STAGES 4
#define GS_BK 64
#define GS_THREADS GS_BN
#define GS_LD_W (GS_BN + 8)
#define GS_LD_X (GS_BK + 8)

template <int NC>
struct StreamSmem {
  static constexpr int W = GS_BK * GS_LD_W;
  static constexpr int X = NC * 8 * GS_LD_X;
  static constexpr int STAGE = W + X;
  static constexpr int BYTES = GS_STAGES * STAGE * 2;
};

template <int NC, bool VEC>
__global__ void __launch_bounds__(GS_THREADS)
gmm_stream_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ rows, int C, int K, int N,
                  int activation) {
  using T = __nv_bfloat16;
  using Sm = StreamSmem<NC>;
  extern __shared__ __align__(16) unsigned char gmm_smem[];
  T* smem = reinterpret_cast<T*>(gmm_smem);
  const int n0 = blockIdx.x * GS_BN;
  const long long e = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ce = rows ? min(C, max(rows[e], 0)) : C;
  T* oe = out + e * C * N;
  if (Ce == 0) {   // an expert with no token: zeros, no weight read
    for (int i = tid; i < C * GS_BN; i += GS_THREADS) {
      const int c = i / GS_BN, n = n0 + i % GS_BN;
      if (n < N) oe[(long long)c * N + n] = from_f<T>(0.f);
    }
    return;
  }
  const int nct = (Ce + 7) / 8;   // n8 tiles of x in use
  const T* xe = x + e * C * K;
  const T* we = w + e * K * N;

  auto load_slab = [&](int stage, int kt) {
    T* Ws = smem + stage * Sm::STAGE;
    T* Xs = Ws + Sm::W;
    const int k0 = kt * GS_BK;
    load_tile<T, GS_BK, GS_BN, GS_LD_W, GS_THREADS, VEC, true>(
        Ws, we + (long long)k0 * N + n0, N, K - k0, N - n0, tid);
    load_tile<T, NC * 8, GS_BK, GS_LD_X, GS_THREADS, VEC>(
        Xs, xe + k0, K, Ce, K - k0, tid);
  };

  float acc[2][NC][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int q = lane >> 3, r = lane & 7;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (K + GS_BK - 1) / GS_BK;
#pragma unroll
  for (int s = 0; s < GS_STAGES - 1; ++s) {
    if (s < nk) load_slab(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GS_STAGES - 2>();
    __syncthreads();
    const int next = kt + GS_STAGES - 1;
    if (next < nk) load_slab(next % GS_STAGES, next);
    cp_async_commit();
    const T* Ws = smem + (kt % GS_STAGES) * Sm::STAGE;
    const T* Xs = Ws + Sm::W;
#pragma unroll
    for (int kk = 0; kk < GS_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)   // A = W^T: W's rows are the k axis
        ldsm_x4_t(a[i], smem_u32(Ws + (kk + r + (q >> 1) * 8) * GS_LD_W +
                                 warp * 32 + i * 16 + (q & 1) * 8));
#pragma unroll
      for (int ct = 0; ct < NC; ++ct) {
        if (ct < nct) {   // B = x^T: x's row c holds column c
          const T* xr = Xs + (ct * 8 + g) * GS_LD_X + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
          mma_bf16(acc[0][ct], a[0], b0, b1);
          mma_bf16(acc[1][ct], a[1], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[i][ct] = out^T rows n (g, g+8) x columns c (2t, 2t+1).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ct = 0; ct < NC; ++ct)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int n = n0 + warp * 32 + i * 16 + g + (v >> 1) * 8;
        const int c = ct * 8 + 2 * t + (v & 1);
        if (c < C && n < N)
          oe[(long long)c * N + n] = from_f<T>(
              c < Ce ? epilogue(acc[i][ct][v], activation) : 0.f);
      }
}

template <int NC, bool VEC>
static int run_stream(const void* x, const void* w, void* out, const int* rows,
                      int E, int C, int K, int N, int activation,
                      cudaStream_t stream) {
  constexpr int bytes = StreamSmem<NC>::BYTES;
  static const cudaError_t ready =
      allow_smem(gmm_stream_kernel<NC, VEC>, bytes);
  if (ready != cudaSuccess) return (int)ready;
  const dim3 grid((N + GS_BN - 1) / GS_BN, E);
  gmm_stream_kernel<NC, VEC><<<grid, GS_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      rows, C, K, N, activation);
  return (int)cudaGetLastError();
}

template <bool VEC>
static int dispatch_stream(const void* x, const void* w, void* out,
                           const int* rows, int E, int C, int K, int N,
                           int activation, cudaStream_t stream) {
  if (C <= 8) return run_stream<1, VEC>(x, w, out, rows, E, C, K, N, activation, stream);
  if (C <= 16) return run_stream<2, VEC>(x, w, out, rows, E, C, K, N, activation, stream);
  if (C <= 32) return run_stream<4, VEC>(x, w, out, rows, E, C, K, N, activation, stream);
  return run_stream<8, VEC>(x, w, out, rows, E, C, K, N, activation, stream);
}

template <typename T, bool VEC>
static int dispatch_tile(const void* x, const void* w, void* out,
                         const int* rows, int E, int C, int K, int N,
                         int activation, int trans_x, int trans_w,
                         cudaStream_t stream) {
  if (trans_x)
    return run_tile<T, true, false, VEC>(x, w, out, rows, E, C, K, N, activation, stream);
  if (trans_w)
    return run_tile<T, false, true, VEC>(x, w, out, rows, E, C, K, N, activation, stream);
  return run_tile<T, false, false, VEC>(x, w, out, rows, E, C, K, N, activation, stream);
}

template <typename T>
static int dispatch_gmm(const void* x, const void* w, void* out,
                        const int* rows, int E, int C, int K, int N,
                        int activation, int trans_x, int trans_w, int kernel,
                        cudaStream_t stream) {
  if (E == 0 || C == 0 || N == 0) return 0;
  // 16-byte chunks need each operand's contiguous dimension to be a
  // whole number of chunks and both bases aligned.
  constexpr int CE = 16 / sizeof(T);
  const int x_inner = trans_x ? C : K, w_inner = trans_w ? K : N;
  const bool vec = x_inner % CE == 0 && w_inner % CE == 0 && aligned16(x) &&
                   aligned16(w);
  if (kernel == GMM_STREAM) {
    if constexpr (sizeof(T) == 2) {
      return vec ? dispatch_stream<true>(x, w, out, rows, E, C, K, N, activation, stream)
                 : dispatch_stream<false>(x, w, out, rows, E, C, K, N, activation, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  return vec ? dispatch_tile<T, true>(x, w, out, rows, E, C, K, N, activation,
                                      trans_x, trans_w, stream)
             : dispatch_tile<T, false>(x, w, out, rows, E, C, K, N, activation,
                                       trans_x, trans_w, stream);
}

// x is [E, C, K] (trans_x = 0) or stored [E, K, C] (trans_x = 1); w is
// [E, K, N] (trans_w = 0) or stored [E, N, K] (trans_w = 1), at most one
// of the two transposed; out is [E, C, N].  E, C, K, N are the logical
// sizes.  rows is null or [E] int32: x's rows (its stored dimension 1)
// at or beyond rows[e] are taken as zero and not read.  kernel is
// GMM_STREAM (bf16, forward layout, C <= GMM_STREAM_MAX_C) or GMM_TILE.
extern "C" int repro_gmm(const void* x, const void* w, void* out,
                         const int* rows, int E, int C, int K, int N,
                         int activation, int dtype, int trans_x, int trans_w,
                         int kernel, cudaStream_t stream) {
  const bool transposed = trans_x || trans_w;
  if (E < 0 || C < 0 || K < 0 || N < 0 || E > 65535 || activation < GMM_NONE ||
      activation > GMM_SILU || (trans_x && trans_w))
    return (int)cudaErrorInvalidValue;
  if (kernel == GMM_STREAM &&
      (dtype != REPRO_BF16 || transposed || C > GMM_STREAM_MAX_C))
    return (int)cudaErrorInvalidValue;
  if (kernel != GMM_STREAM && kernel != GMM_TILE)
    return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_F32)
    return dispatch_gmm<float>(x, w, out, rows, E, C, K, N, activation, trans_x,
                               trans_w, kernel, stream);
  if (dtype == REPRO_BF16)
    return dispatch_gmm<__nv_bfloat16>(x, w, out, rows, E, C, K, N, activation,
                                       trans_x, trans_w, kernel, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
