// The GMM's C entry point: checks a call and routes it to its kernel
// group (gmm.cuh has the kernels and their design notes).
#include "gmm.cuh"

// x is [E, C, K] (trans_x = 0) or stored [E, K, C] (trans_x = 1); w is
// [E, K, N] (trans_w = 0) or stored [E, N, K] (trans_w = 1), at most one
// of the two transposed; out is [E, C, N].  E, C, K, N are the logical
// sizes.  rows is null or [E] int32: x's rows (its stored dimension 1)
// at or beyond rows[e] are taken as zero and not read.  kernel is
// GMM_STREAM (bf16, forward layout, C <= GMM_STREAM_MAX_C) or GMM_TILE.
// out_dtype is out's type: dtype, or REPRO_F32 for bf16 operands in the
// forward layout (the f32 accumulator stored without the cast).
extern "C" int repro_gmm(const void* x, const void* w, void* out,
                         const int* rows, int E, int C, int K, int N,
                         int activation, int dtype, int out_dtype, int trans_x,
                         int trans_w, int kernel, cudaStream_t stream) {
  const bool transposed = trans_x || trans_w;
  if (E < 0 || C < 0 || K < 0 || N < 0 || E > 65535 || activation < GMM_NONE ||
      activation > GMM_SILU || (trans_x && trans_w))
    return (int)cudaErrorInvalidValue;
  if (out_dtype != dtype &&
      (dtype != REPRO_BF16 || out_dtype != REPRO_F32 || transposed))
    return (int)cudaErrorInvalidValue;
  if (kernel == GMM_STREAM &&
      (dtype != REPRO_BF16 || transposed || C > GMM_STREAM_MAX_C))
    return (int)cudaErrorInvalidValue;
  if ((kernel != GMM_STREAM && kernel != GMM_TILE) ||
      (dtype != REPRO_F32 && dtype != REPRO_BF16))
    return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0 || N == 0) return 0;
  // 16-byte chunks need each operand's contiguous dimension to be a
  // whole number of chunks and both bases aligned.
  const int chunk = dtype == REPRO_F32 ? 4 : 8;
  const int x_inner = trans_x ? C : K, w_inner = trans_w ? K : N;
  const bool vec = x_inner % chunk == 0 && w_inner % chunk == 0 &&
                   aligned16(x) && aligned16(w);
  const bool out_f32 = out_dtype != dtype;
  if (kernel == GMM_STREAM)
    return gmm_launch_stream(x, w, out, rows, E, C, K, N, activation, out_f32,
                             vec, stream);
  if (transposed)
    return gmm_launch_tile_bwd(x, w, out, rows, E, C, K, N,
                               activation, dtype, trans_x, vec, stream);
  return gmm_launch_tile(x, w, out, rows, E, C, K, N, activation, dtype,
                         out_f32, vec, stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
