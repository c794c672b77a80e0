// Tensor-core and async-copy helpers shared by the bf16 weight streams
// (csrc/gmm.cu, csrc/fused_decode.cu): cp.async (16-byte, zero-filling,
// optional L2 256-byte prefetch), ldmatrix(.trans), mma.sync m16n8k16
// bf16 with f32 accumulators, and a tile loader into shared memory.
#pragma once

#include "common.cuh"

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread).
// L2_256: ask L2 to fetch the surrounding 256 bytes (the weight stream,
// whose rows are read 512 contiguous bytes at a time).
template <bool L2_256>
static __device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                                  bool valid) {
  const int n = valid ? 16 : 0;
  if (L2_256)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8q..8q+7 give the row addresses of
// matrix q.  Plain: r[q] = M_q[lane/4][2(lane%4) .. +1];  trans: r[q] =
// M_q[2(lane%4) .. +1][lane/4].
static __device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

static __device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
static __device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A ROWS x COLS tile of a row-major matrix (row stride ld elements; the
// tile's origin at g; rlim valid rows and clim valid columns from it)
// into shared memory with row stride SLD; everything out of range reads
// as zero.  VEC: 16-byte cp.async chunks, which needs ld, the origin's
// column and the base pointer 16-byte aligned (a chunk is then wholly in
// or wholly out of range).  Otherwise element loads through registers,
// for ragged or unaligned operands.
template <typename T, int ROWS, int COLS, int SLD, int THREADS, bool VEC,
          bool L2_256 = false>
static __device__ __forceinline__ void load_tile(T* s, const T* g, long long ld,
                                                 int rlim, int clim, int tid) {
  if constexpr (VEC) {
    constexpr int CE = 16 / sizeof(T);
    constexpr int CPR = COLS / CE;
    constexpr int TOTAL = ROWS * CPR;
#pragma unroll
    for (int j = 0; j < (TOTAL + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS;
      if (TOTAL % THREADS == 0 || i < TOTAL) {
        const int r = i / CPR, c = (i % CPR) * CE;
        const bool ok = r < rlim && c < clim;
        cp_async16<L2_256>(smem_u32(s + r * SLD + c), ok ? g + r * ld + c : g,
                           ok);
      }
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      s[r * SLD + c] = (r < rlim && c < clim) ? g[r * ld + c] : from_f<T>(0.f);
    }
  }
}
