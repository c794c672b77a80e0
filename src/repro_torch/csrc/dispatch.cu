// Capacity-buffer dispatch ([T, d] -> [E, C, d]) and weighted combine
// ([E, C, d] -> [T, d]), in the resident regime and the expert-blocked
// one (at the end of the file).
//
// dispatch replaces repro/kernels/dispatch.py::_dispatch_kernel
// (pallas_call in _dispatch_raw): the buffer starts at zero and
// assignment a = t*k + j copies x[t] * scale[a] into buf[eidx[a],
// pos[a]] when pos[a] < C; a dropped (pos >= C) or padded assignment
// writes nothing.  combine replaces _combine_kernel (pallas_call in
// _combine_raw): y[t] = sum over j = 0..k-1, in ascending order, of
// w[t, j] * buf[eidx, pos] accumulated in f32 from +0, a slot with
// pos >= C contributing nothing, then one write in the output type.  The
// products and sums are rounded separately (no fused multiply-add), so
// the result is bit-identical to the plain PyTorch version.
//
// Bound on the H100: bytes.  dispatch writes the whole E*C*d buffer and
// reads the kept rows; combine reads the kept slots and writes T*d.  The
// TPU kernels walked the assignment list one row at a time on one core.
// Here every assignment of dispatch is its own block, with 16-byte
// accesses (8 elements per thread); the zeroing is one cudaMemsetAsync
// before the copy.  Kept slots are unique, so the copy blocks never race.
// The combine's design is in its own section below.
#include "common.cuh"

#include <atomic>
#include <climits>

#define DC_THREADS 128

static __device__ __forceinline__ bool kept_slot(int e, int p, int E, int C) {
  return p >= 0 && p < C && e >= 0 && e < E;
}

template <typename T>
__global__ void __launch_bounds__(DC_THREADS)
dispatch_kernel(const T* __restrict__ x, const int* __restrict__ eidx,
                const int* __restrict__ pos, const float* __restrict__ scale,
                T* __restrict__ buf, int k, int d, int E, int C, bool vec) {
  const int a = blockIdx.x;
  const int e = eidx[a], p = pos[a];
  if (!kept_slot(e, p, E, C)) return;
  const float s = scale ? scale[a] : 1.f;
  const T* src = x + (long long)(a / k) * d;
  T* dst = buf + ((long long)e * C + p) * d;
  if (vec) {
    for (int i = threadIdx.x * 8; i < d; i += DC_THREADS * 8) {
      float v[8];
      Vec8<T>::load(src + i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], s);
      Vec8<T>::store(dst + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += DC_THREADS)
      dst[i] = from_f<T>(__fmul_rn(to_f<T>(src[i]), s));
  }
}

template <typename T>
static int run_dispatch(const void* x, const int* eidx, const int* pos,
                        const float* scale, void* buf, int T_, int k, int d,
                        int E, int C, cudaStream_t stream) {
  const size_t bytes = (size_t)E * C * d * sizeof(T);
  if (bytes) {
    const cudaError_t err = cudaMemsetAsync(buf, 0, bytes, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = (long long)T_ * k;
  if (n == 0 || d == 0) return 0;
  const bool vec = d % 8 == 0 && aligned16(x) && aligned16(buf);
  dispatch_kernel<T><<<(unsigned)n, DC_THREADS, 0, stream>>>(
      static_cast<const T*>(x), eidx, pos, scale, static_cast<T*>(buf), k, d,
      E, C, vec);
  return (int)cudaGetLastError();
}

extern "C" int repro_dispatch(const void* x, const int* eidx, const int* pos,
                              const float* scale, void* buf, int T_, int k,
                              int d, int E, int C, int dtype,
                              cudaStream_t stream) {
  if (T_ < 0 || k < 1 || d < 0 || E < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_F32)
    return run_dispatch<float>(x, eidx, pos, scale, buf, T_, k, d, E, C, stream);
  if (dtype == REPRO_BF16)
    return run_dispatch<__nv_bfloat16>(x, eidx, pos, scale, buf, T_, k, d, E, C, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Combine.  At decode a token's row is short work (k = 8 slots of d =
// 7168 bf16) and there are only T = 8 tokens, so one block per token
// would leave 124 of the 132 SMs idle and each thread with one load in
// flight at a time.  The design:
//
// * A token's row is cut into chunks over a 2-D grid: blockIdx.x is the
//   token (up to 2^31 - 1 rows, as MoA's [T*k, 1] assignment views need),
//   blockIdx.y the chunk of 8 * blockDim.x elements, 8 per thread.  The
//   host picks blockDim.x in {128, 64, 32}: no wider than the row needs
//   (so no thread idles at d = 512), and narrower until the grid has two
//   blocks per SM or the width is one warp.  T = 8, d = 7168 gives 224
//   blocks of 32 threads; the training shape (T = 4096, d = 512) 4096
//   blocks of 64.
// * Every k-slot load of a chunk is in flight before the sum.  Lane j of
//   each warp reads triple j (eidx, pos, w) of a group of G slots once
//   and the warp shares it by shuffles; then all G loads are issued (a
//   dropped or invalid slot reads nothing), and only then are they added
//   in ascending j.  G is a template parameter (2, 4 or 8, the least
//   that covers k) so the group is unrolled; k > 8 walks groups of 8 in a
//   runtime loop, the order of the sum unchanged.  One G = 8 kernel for
//   every k was slower at k = 2 (+0.5 us) and k = 4 (+1.1 us, the
//   training shape, where its registers fit fewer blocks on an SM), and
//   level with a G = 1 kernel at k = 1, which so runs G = 2 (L2-cold
//   device times on an H100 SXM).
// * The vector path (d % 8 == 0 and 16-byte aligned buffers) reads
//   16-byte pieces, and the pieces of one load instruction are
//   contiguous across the warp: a thread's 8 elements are one piece of 8
//   in bf16, two pieces of 4 a block-width of pieces apart in f32 (eight
//   consecutive f32 a thread would leave every instruction half of each
//   32-byte sector).  Otherwise each thread takes 8 single elements a
//   block-width apart, still coalesced.
//
// Each output element is one thread's fixed-order sum: no atomics, and a
// launch repeats bit for bit.
#define CB_MAX_THREADS 128
#define CB_PER_THREAD 8

// N consecutive elements <-> N floats, for the pieces of the vector path:
// 4 f32 (16 bytes) or 8 bf16 (16 bytes) in; 4 or 8 of either type out.
template <int N, typename T> struct Piece;
template <> struct Piece<4, float> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Piece<4, __nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* in) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
  }
};
template <typename T> struct Piece<8, T> {
  static __device__ __forceinline__ void load(const T* p, float* out) { Vec8<T>::load(p, out); }
  static __device__ __forceinline__ void store(T* p, const float* in) { Vec8<T>::store(p, in); }
};

// A thread's elements of a row chunk: NP pieces of PN (vector path) or 8
// single elements (scalar path), piece / element q at i0 + q * step.
template <typename TI, bool VEC> struct Chunk {
  static constexpr int PN = VEC ? 16 / (int)sizeof(TI) : 1;
  static constexpr int NP = CB_PER_THREAD / PN;
  long long i0;
  int step;
  __device__ __forceinline__ Chunk()
      : i0((long long)blockIdx.y * blockDim.x * CB_PER_THREAD +
           (long long)threadIdx.x * PN),
        step(blockDim.x * PN) {}
};

// The G slot rows at element offsets off[j] (-1: none), this thread's
// elements of each, all loads issued before any is used; zeros for a
// missing row and past d.
template <typename TI, int G, bool VEC>
static __device__ __forceinline__ void load_group(
    const TI* __restrict__ buf, const Chunk<TI, VEC>& ch,
    const long long (&off)[G], int d, float (&v)[G][CB_PER_THREAD]) {
  constexpr int PN = Chunk<TI, VEC>::PN, NP = Chunk<TI, VEC>::NP;
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const long long i = ch.i0 + (long long)q * ch.step;
      const bool live = off[j] >= 0 && i < d;
      if constexpr (VEC) {
        if (live) {
          Piece<PN, TI>::load(buf + off[j] + i, &v[j][q * PN]);
        } else {
#pragma unroll
          for (int r = 0; r < PN; ++r) v[j][q * PN + r] = 0.f;
        }
      } else {
        v[j][q] = live ? to_f<TI>(buf[off[j] + i]) : 0.f;
      }
    }
  }
}

// This thread's elements of one output row, in the output type.
template <typename TI, typename TO, bool VEC>
static __device__ __forceinline__ void store_chunk(
    TO* __restrict__ out, const Chunk<TI, VEC>& ch,
    const float (&acc)[CB_PER_THREAD], int d) {
  constexpr int PN = Chunk<TI, VEC>::PN, NP = Chunk<TI, VEC>::NP;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const long long i = ch.i0 + (long long)q * ch.step;
    if (i >= d) continue;
    if constexpr (VEC)
      Piece<PN, TO>::store(out + i, &acc[q * PN]);
    else
      out[i] = from_f<TO>(acc[q]);
  }
}

template <typename TI, typename TO, int G, bool VEC>
__global__ void __launch_bounds__(CB_MAX_THREADS)
combine_kernel(const TI* __restrict__ buf, const float* __restrict__ w,
               const int* __restrict__ eidx, const int* __restrict__ pos,
               TO* __restrict__ y, int k, int d, int E, int C) {
  const long long t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const Chunk<TI, VEC> ch;
  float acc[CB_PER_THREAD];
#pragma unroll
  for (int q = 0; q < CB_PER_THREAD; ++q) acc[q] = 0.f;
  for (int j0 = 0; j0 < k; j0 += G) {
    long long my_off = -1;  // element offset of the slot's row, -1: skip
    float my_w = 0.f;
    if (lane < G && j0 + lane < k) {
      const long long a = t * k + j0 + lane;
      const int e = eidx[a], p = pos[a];
      if (kept_slot(e, p, E, C)) {
        my_off = ((long long)e * C + p) * d;
        my_w = w[a];
      }
    }
    long long off[G];
    float wt[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      off[j] = __shfl_sync(0xffffffffu, my_off, j);
      wt[j] = __shfl_sync(0xffffffffu, my_w, j);
    }
    float v[G][CB_PER_THREAD];
    load_group<TI, G, VEC>(buf, ch, off, d, v);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (off[j] < 0) continue;  // the same for the whole block
#pragma unroll
      for (int q = 0; q < CB_PER_THREAD; ++q)
        acc[q] = __fadd_rn(acc[q], __fmul_rn(wt[j], v[j][q]));
    }
  }
  store_chunk<TI, TO, VEC>(y + t * d, ch, acc, d);
}

// SMs of the current device, queried once per device: the attribute
// query would otherwise cost host time on every launch.
#define CB_MAX_DEVICES 64
static cudaError_t sm_count(int* n) {
  static std::atomic<int> cache[CB_MAX_DEVICES];  // 0: not queried yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < CB_MAX_DEVICES && (*n = cache[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < CB_MAX_DEVICES)
    cache[dev].store(*n, std::memory_order_relaxed);
  return err;
}

// Threads per combine block: no wider than a row needs, and narrower
// while the grid has fewer than two blocks per SM.
static int combine_threads(long long T_, int d, int n_sms) {
  const long long per_row = ((long long)d + CB_PER_THREAD - 1) / CB_PER_THREAD;
  int threads = CB_MAX_THREADS;
  while (threads > 32) {
    const long long chunks = (per_row + threads - 1) / threads;
    if (threads / 2 < per_row && T_ * chunks >= 2LL * n_sms) break;
    threads /= 2;
  }
  return threads;
}

template <typename TI, typename TO, int G>
static void launch_combine(dim3 grid, int threads, bool vec, const void* buf,
                           const float* w, const int* eidx, const int* pos,
                           void* y, int k, int d, int E, int C,
                           cudaStream_t stream) {
  const TI* b = static_cast<const TI*>(buf);
  TO* out = static_cast<TO*>(y);
  if (vec)
    combine_kernel<TI, TO, G, true><<<grid, threads, 0, stream>>>(
        b, w, eidx, pos, out, k, d, E, C);
  else
    combine_kernel<TI, TO, G, false><<<grid, threads, 0, stream>>>(
        b, w, eidx, pos, out, k, d, E, C);
}

template <typename TI, typename TO>
static int run_combine(const void* buf, const float* w, const int* eidx,
                       const int* pos, void* y, int T_, int k, int d, int E,
                       int C, cudaStream_t stream) {
  if (T_ == 0 || d == 0) return 0;
  int n_sms = 0;
  const cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  const int threads = combine_threads(T_, d, n_sms);
  const long long span = (long long)threads * CB_PER_THREAD;
  const long long chunks = ((long long)d + span - 1) / span;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)T_, (unsigned)chunks);
  const bool vec = d % 8 == 0 && aligned16(buf) && aligned16(y);
  if (k <= 2)
    launch_combine<TI, TO, 2>(grid, threads, vec, buf, w, eidx, pos, y, k, d, E, C, stream);
  else if (k <= 4)
    launch_combine<TI, TO, 4>(grid, threads, vec, buf, w, eidx, pos, y, k, d, E, C, stream);
  else
    launch_combine<TI, TO, 8>(grid, threads, vec, buf, w, eidx, pos, y, k, d, E, C, stream);
  return (int)cudaGetLastError();
}

extern "C" int repro_combine(const void* buf, const float* w, const int* eidx,
                             const int* pos, void* y, int T_, int k, int d,
                             int E, int C, int in_dtype, int out_dtype,
                             cudaStream_t stream) {
  if (T_ < 0 || k < 1 || d < 0 || E < 1 || C < 1) return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf16;
  if (in_dtype == REPRO_F32 && out_dtype == REPRO_F32)
    return run_combine<float, float>(buf, w, eidx, pos, y, T_, k, d, E, C, stream);
  if (in_dtype == REPRO_F32 && out_dtype == REPRO_BF16)
    return run_combine<float, bf16>(buf, w, eidx, pos, y, T_, k, d, E, C, stream);
  if (in_dtype == REPRO_BF16 && out_dtype == REPRO_F32)
    return run_combine<bf16, float>(buf, w, eidx, pos, y, T_, k, d, E, C, stream);
  if (in_dtype == REPRO_BF16 && out_dtype == REPRO_BF16)
    return run_combine<bf16, bf16>(buf, w, eidx, pos, y, T_, k, d, E, C, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Expert-blocked dispatch: replaces repro/kernels/dispatch.py::
// _dispatch_eblock_kernel (pallas_call in _dispatch_eblock_raw).  The TPU
// kept one [e_block, C, d] slab in VMEM and walked its slot table
// serially.  Here the slot table (btok[e*C + p]: the token row feeding
// slot p of expert e, or -1; bscale: its scale) is built by the wrapper
// with plain index ops, as XLA built it for the TPU, and every buffer row
// (e, p) is one block that writes the row exactly once: x[btok] * bscale,
// or zeros for an empty slot.  So there is no memset, no race and no
// atomics, and the output is bit-identical to the resident dispatch
// above (the same product, rounded the same way).  The slab only orders
// the walk: blockIdx.y is the slab, blockIdx.x the row inside it.
//
// Bound on the H100: bytes.  It writes the whole E*C*d buffer once
// (64 MiB at [256, 128, 512] f32) and reads the kept rows of x.
template <typename T>
__global__ void __launch_bounds__(DC_THREADS)
dispatch_eblock_kernel(const T* __restrict__ x, const int* __restrict__ btok,
                       const float* __restrict__ bscale, T* __restrict__ buf,
                       int d, long long rows_per_slab, long long n_rows,
                       bool vec) {
  const long long r = (long long)blockIdx.y * rows_per_slab + blockIdx.x;
  if (r >= n_rows) return;
  const int tok = btok[r];
  T* dst = buf + r * d;
  if (tok < 0) {
    if (vec) {
      const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = threadIdx.x * 8; i < d; i += DC_THREADS * 8) Vec8<T>::store(dst + i, z);
    } else {
      for (int i = threadIdx.x; i < d; i += DC_THREADS) dst[i] = from_f<T>(0.f);
    }
    return;
  }
  const float s = bscale[r];
  const T* src = x + (long long)tok * d;
  if (vec) {
    for (int i = threadIdx.x * 8; i < d; i += DC_THREADS * 8) {
      float v[8];
      Vec8<T>::load(src + i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], s);
      Vec8<T>::store(dst + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += DC_THREADS)
      dst[i] = from_f<T>(__fmul_rn(to_f<T>(src[i]), s));
  }
}

template <typename T>
static int run_dispatch_eblock(const void* x, const int* btok,
                               const float* bscale, void* buf, int d, int E,
                               int C, int e_block, cudaStream_t stream) {
  const long long n_rows = (long long)E * C;
  if (n_rows == 0 || d == 0) return 0;
  const long long rows_per_slab = (long long)e_block * C;
  const int n_slabs = (E + e_block - 1) / e_block;
  if (rows_per_slab > 0x7fffffffLL || n_slabs > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = d % 8 == 0 && aligned16(x) && aligned16(buf);
  const dim3 grid((unsigned)rows_per_slab, (unsigned)n_slabs);
  dispatch_eblock_kernel<T><<<grid, DC_THREADS, 0, stream>>>(
      static_cast<const T*>(x), btok, bscale, static_cast<T*>(buf), d,
      rows_per_slab, n_rows, vec);
  return (int)cudaGetLastError();
}

extern "C" int repro_dispatch_eblock(const void* x, const int* btok,
                                     const float* bscale, void* buf, int d,
                                     int E, int C, int e_block, int dtype,
                                     cudaStream_t stream) {
  if (d < 0 || E < 1 || C < 1 || e_block < 1) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_F32)
    return run_dispatch_eblock<float>(x, btok, bscale, buf, d, E, C, e_block, stream);
  if (dtype == REPRO_BF16)
    return run_dispatch_eblock<__nv_bfloat16>(x, btok, bscale, buf, d, E, C, e_block, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Expert-blocked combine: replaces repro/kernels/dispatch.py::
// _combine_eblock_kernel (pallas_call in _combine_eblock_raw).  The TPU
// walked the expert slabs innermost and kept a [block_t, d] f32 sum in
// scratch across them.  The sum's order is the point: for each slab b
// in ascending order, a partial sum starts at +0 and takes w[t, j] *
// buf[e, p] over j ascending, counting only the kept assignments whose
// expert lies in the slab (b = e / e_block); the partial is then added
// to the token's f32 total, and a slab with no hit adds nothing.  Each
// product and sum is rounded on its own, so the result is bit-identical
// to the plain version; with e_block >= E there is one slab, and it is
// bit-identical to the resident combine.  For k >= 3 the grouping by
// slab changes the order of the sum against the resident combine (as
// on the TPU).
//
// Bound on the H100: bytes.  It reads the kept slots and writes T*d.
// The design is the resident combine's (2-D grid of token x d-chunk,
// width from combine_threads, f32 pieces contiguous across the warp, a
// group's G loads in flight before its sum), with one step before the
// loads: the block sorts its token's kept slots by (slab, j).  Thread j
// reads triple j (eidx, pos and w in one trip) into shared memory with
// its key, the slab times k plus j (unique); a slot's place is the
// number of smaller keys, and the place -> slot table is all that is
// sorted.  The group walk then runs over the table, and the sum needs
// one more register set: the running partial, flushed into the total
// where the slab changes.  k > G walks groups of the table in order;
// the order of the sum is the same.  The launch bounds state one block
// an SM as the minimum: without it ptxas spilled a few bytes in some
// instantiations, far below the register limit; with it none spills.
template <typename TI, typename TO, int G, bool VEC>
__global__ void __launch_bounds__(CB_MAX_THREADS, 1)
combine_eblock_kernel(const TI* __restrict__ buf, const float* __restrict__ w,
                      const int* __restrict__ eidx, const int* __restrict__ pos,
                      TO* __restrict__ y, int k, int d, int E, int C,
                      int e_block) {
  // By slot j: sort key, row offset, weight, slab; by place: the slot.
  extern __shared__ __align__(16) unsigned char cbe_smem[];
  long long* s_key = reinterpret_cast<long long*>(cbe_smem);
  long long* s_off = s_key + k;
  float* s_w = reinterpret_cast<float*>(s_off + k);
  int* s_slab = reinterpret_cast<int*>(s_w + k);
  int* s_slot = s_slab + k;
  const long long t = blockIdx.x;
  int n_kept = 0;
  for (int j0 = 0; j0 < k; j0 += blockDim.x) {  // the same trips in every thread
    const int j = j0 + threadIdx.x;
    bool kept = false;
    if (j < k) {
      const long long a = t * k + j;
      const int e = eidx[a], p = pos[a];
      const float wa = w[a];
      kept = kept_slot(e, p, E, C);
      const int b = kept ? e / e_block : 0;
      s_key[j] = kept ? (long long)b * k + j : LLONG_MAX;
      s_off[j] = ((long long)e * C + p) * d;
      s_w[j] = wa;
      s_slab[j] = b;
    }
    n_kept += __syncthreads_count(kept);
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const long long key = s_key[j];
    if (key == LLONG_MAX) continue;
    int r = 0;
#pragma unroll 8
    for (int i = 0; i < k; ++i) r += s_key[i] < key;
    s_slot[r] = j;
  }
  __syncthreads();

  const Chunk<TI, VEC> ch;
  const int lane = threadIdx.x & 31;
  float total[CB_PER_THREAD], part[CB_PER_THREAD];
#pragma unroll
  for (int q = 0; q < CB_PER_THREAD; ++q) total[q] = part[q] = 0.f;
  int slab = -1;  // the running partial's slab
  for (int r0 = 0; r0 < n_kept; r0 += G) {
    // Lane j reads place r0 + j of the table and the warp shares it by
    // shuffles, as in the resident combine.  (Read by every thread, the
    // table let the compiler chain each slot's reads into its row load
    // and issue the rows one after another.)
    long long my_off = -1;
    float my_w = 0.f;
    int my_sb = -1;
    if (lane < G && r0 + lane < n_kept) {
      const int slot = s_slot[r0 + lane];
      my_off = s_off[slot];
      my_w = s_w[slot];
      my_sb = s_slab[slot];
    }
    long long off[G];
    float wt[G];
    int sb[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      off[j] = __shfl_sync(0xffffffffu, my_off, j);
      wt[j] = __shfl_sync(0xffffffffu, my_w, j);
      sb[j] = __shfl_sync(0xffffffffu, my_sb, j);
    }
    float v[G][CB_PER_THREAD];
    load_group<TI, G, VEC>(buf, ch, off, d, v);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (off[j] < 0) continue;  // past the table's end: the same for the block
      const int bj = sb[j];
      if (bj != slab) {
        // A new slab: the finished partial joins the total (at the
        // first kept slot, +0 joins +0).
#pragma unroll
        for (int q = 0; q < CB_PER_THREAD; ++q) {
          total[q] = __fadd_rn(total[q], part[q]);
          part[q] = 0.f;
        }
        slab = bj;
      }
#pragma unroll
      for (int q = 0; q < CB_PER_THREAD; ++q)
        part[q] = __fadd_rn(part[q], __fmul_rn(wt[j], v[j][q]));
    }
  }
#pragma unroll
  for (int q = 0; q < CB_PER_THREAD; ++q) total[q] = __fadd_rn(total[q], part[q]);
  store_chunk<TI, TO, VEC>(y + t * d, ch, total, d);
}

// Shared memory of the sort: 28 bytes a slot, within the 48 KB a
// launch gets without an opt-in.
#define CBE_SMEM_PER_SLOT 28
#define CBE_MAX_SMEM (48 * 1024)

template <typename TI, typename TO, int G>
static void launch_combine_eblock(dim3 grid, int threads, size_t smem,
                                  bool vec, const void* buf, const float* w,
                                  const int* eidx, const int* pos, void* y,
                                  int k, int d, int E, int C, int e_block,
                                  cudaStream_t stream) {
  const TI* b = static_cast<const TI*>(buf);
  TO* out = static_cast<TO*>(y);
  if (vec)
    combine_eblock_kernel<TI, TO, G, true><<<grid, threads, smem, stream>>>(
        b, w, eidx, pos, out, k, d, E, C, e_block);
  else
    combine_eblock_kernel<TI, TO, G, false><<<grid, threads, smem, stream>>>(
        b, w, eidx, pos, out, k, d, E, C, e_block);
}

template <typename TI, typename TO>
static int run_combine_eblock(const void* buf, const float* w, const int* eidx,
                              const int* pos, void* y, int T_, int k, int d,
                              int E, int C, int e_block, cudaStream_t stream) {
  if (T_ == 0 || d == 0) return 0;
  const size_t smem = (size_t)k * CBE_SMEM_PER_SLOT;
  if (smem > CBE_MAX_SMEM) return (int)cudaErrorInvalidValue;
  int n_sms = 0;
  const cudaError_t err = sm_count(&n_sms);
  if (err != cudaSuccess) return (int)err;
  const int threads = combine_threads(T_, d, n_sms);
  const long long span = (long long)threads * CB_PER_THREAD;
  const long long chunks = ((long long)d + span - 1) / span;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)T_, (unsigned)chunks);
  const bool vec = d % 8 == 0 && aligned16(buf) && aligned16(y);
  if (k <= 2)
    launch_combine_eblock<TI, TO, 2>(grid, threads, smem, vec, buf, w, eidx, pos, y, k, d, E, C, e_block, stream);
  else if (k <= 4)
    launch_combine_eblock<TI, TO, 4>(grid, threads, smem, vec, buf, w, eidx, pos, y, k, d, E, C, e_block, stream);
  else
    launch_combine_eblock<TI, TO, 8>(grid, threads, smem, vec, buf, w, eidx, pos, y, k, d, E, C, e_block, stream);
  return (int)cudaGetLastError();
}

extern "C" int repro_combine_eblock(const void* buf, const float* w,
                                    const int* eidx, const int* pos, void* y,
                                    int T_, int k, int d, int E, int C,
                                    int e_block, int in_dtype, int out_dtype,
                                    cudaStream_t stream) {
  if (T_ < 0 || k < 1 || d < 0 || E < 1 || C < 1 || e_block < 1)
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf16;
  if (in_dtype == REPRO_F32 && out_dtype == REPRO_F32)
    return run_combine_eblock<float, float>(buf, w, eidx, pos, y, T_, k, d, E, C, e_block, stream);
  if (in_dtype == REPRO_F32 && out_dtype == REPRO_BF16)
    return run_combine_eblock<float, bf16>(buf, w, eidx, pos, y, T_, k, d, E, C, e_block, stream);
  if (in_dtype == REPRO_BF16 && out_dtype == REPRO_F32)
    return run_combine_eblock<bf16, float>(buf, w, eidx, pos, y, T_, k, d, E, C, e_block, stream);
  if (in_dtype == REPRO_BF16 && out_dtype == REPRO_BF16)
    return run_combine_eblock<bf16, bf16>(buf, w, eidx, pos, y, T_, k, d, E, C, e_block, stream);
  return (int)cudaErrorInvalidValue;
}
