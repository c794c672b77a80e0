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
// w[t, j] * buf[eidx, pos] accumulated in f32, a slot with pos >= C
// contributing nothing, then one write in the output type.  The
// products and sums are rounded separately (no fused multiply-add), so
// the result is bit-identical to the plain PyTorch version.
//
// Bound on the H100: bytes.  dispatch writes the whole E*C*d buffer and
// reads the kept rows; combine reads the kept slots and writes T*d.  The
// TPU kernels walked the assignment list one row at a time on one core;
// here every assignment (dispatch) or token (combine) is its own block,
// so all rows move in parallel with 16-byte accesses (8 elements per
// thread).  The zeroing is one cudaMemsetAsync before the copy.  Kept
// slots are unique, so the copy blocks never race, and combine reduces
// within a thread in a fixed order: deterministic, no atomics.
#include "common.cuh"

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

template <typename TI, typename TO>
__global__ void __launch_bounds__(DC_THREADS)
combine_kernel(const TI* __restrict__ buf, const float* __restrict__ w,
               const int* __restrict__ eidx, const int* __restrict__ pos,
               TO* __restrict__ y, int k, int d, int E, int C, bool vec) {
  const int t = blockIdx.x;
  if (vec) {
    for (int i = threadIdx.x * 8; i < d; i += DC_THREADS * 8) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < k; ++j) {
        const int a = t * k + j;
        const int e = eidx[a], p = pos[a];
        if (!kept_slot(e, p, E, C)) continue;
        const float wt = w[a];
        float v[8];
        Vec8<TI>::load(buf + ((long long)e * C + p) * d + i, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(wt, v[q]));
      }
      Vec8<TO>::store(y + (long long)t * d + i, acc);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += DC_THREADS) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j) {
        const int a = t * k + j;
        const int e = eidx[a], p = pos[a];
        if (!kept_slot(e, p, E, C)) continue;
        acc = __fadd_rn(acc, __fmul_rn(w[a], to_f<TI>(buf[((long long)e * C + p) * d + i])));
      }
      y[(long long)t * d + i] = from_f<TO>(acc);
    }
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

template <typename TI, typename TO>
static int run_combine(const void* buf, const float* w, const int* eidx,
                       const int* pos, void* y, int T_, int k, int d, int E,
                       int C, cudaStream_t stream) {
  if (T_ == 0 || d == 0) return 0;
  const bool vec = d % 8 == 0 && aligned16(buf) && aligned16(y);
  combine_kernel<TI, TO><<<T_, DC_THREADS, 0, stream>>>(
      static_cast<const TI*>(buf), w, eidx, pos, static_cast<TO*>(y), k, d, E,
      C, vec);
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
// scratch across them.  Blocks here cannot carry a sum from one launch
// step to the next, so one block owns one token and walks the slabs
// itself, in ascending order: for each slab a partial sum starts at 0 and
// takes w[t, j] * buf[e, p] over j ascending, counting only the kept
// assignments whose expert lies in the slab; the partial is then added to
// the token's f32 total.  Each product and sum is rounded on its own, so
// the result is bit-identical to the plain version.  For k >= 3 the
// grouping by slab changes the order of the sum, so it is close to, not
// bit-equal with, the resident combine (as on the TPU).
//
// Bound on the H100: bytes.  It reads the kept slots and writes T*d.
template <typename TI, typename TO>
__global__ void __launch_bounds__(DC_THREADS)
combine_eblock_kernel(const TI* __restrict__ buf, const float* __restrict__ w,
                      const int* __restrict__ eidx, const int* __restrict__ pos,
                      TO* __restrict__ y, int k, int d, int E, int C,
                      int e_block, bool vec) {
  const int t = blockIdx.x;
  const int n_slabs = (E + e_block - 1) / e_block;
  if (vec) {
    for (int i = threadIdx.x * 8; i < d; i += DC_THREADS * 8) {
      float total[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int b = 0; b < n_slabs; ++b) {
        const int lo = b * e_block, hi = lo + e_block;
        float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        bool hit = false;
        for (int j = 0; j < k; ++j) {
          const int a = t * k + j;
          const int e = eidx[a], p = pos[a];
          if (!kept_slot(e, p, E, C) || e < lo || e >= hi) continue;
          hit = true;
          const float wt = w[a];
          float v[8];
          Vec8<TI>::load(buf + ((long long)e * C + p) * d + i, v);
#pragma unroll
          for (int q = 0; q < 8; ++q) part[q] = __fadd_rn(part[q], __fmul_rn(wt, v[q]));
        }
        // A slab without hits adds +0, which leaves the total unchanged.
        if (hit) {
#pragma unroll
          for (int q = 0; q < 8; ++q) total[q] = __fadd_rn(total[q], part[q]);
        }
      }
      Vec8<TO>::store(y + (long long)t * d + i, total);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += DC_THREADS) {
      float total = 0.f;
      for (int b = 0; b < n_slabs; ++b) {
        const int lo = b * e_block, hi = lo + e_block;
        float part = 0.f;
        bool hit = false;
        for (int j = 0; j < k; ++j) {
          const int a = t * k + j;
          const int e = eidx[a], p = pos[a];
          if (!kept_slot(e, p, E, C) || e < lo || e >= hi) continue;
          hit = true;
          part = __fadd_rn(part, __fmul_rn(w[a], to_f<TI>(buf[((long long)e * C + p) * d + i])));
        }
        if (hit) total = __fadd_rn(total, part);
      }
      y[(long long)t * d + i] = from_f<TO>(total);
    }
  }
}

template <typename TI, typename TO>
static int run_combine_eblock(const void* buf, const float* w, const int* eidx,
                              const int* pos, void* y, int T_, int k, int d,
                              int E, int C, int e_block, cudaStream_t stream) {
  if (T_ == 0 || d == 0) return 0;
  const bool vec = d % 8 == 0 && aligned16(buf) && aligned16(y);
  combine_eblock_kernel<TI, TO><<<T_, DC_THREADS, 0, stream>>>(
      static_cast<const TI*>(buf), w, eidx, pos, static_cast<TO*>(y), k, d, E,
      C, e_block, vec);
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
