// The streaming GMM kernel's instantiations (gmm.cuh): bf16 operands,
// the forward layout, C <= GMM_STREAM_MAX_C, a bf16 or an f32 store.
#include "gmm.cuh"

int gmm_launch_stream(const void* x, const void* w, void* out, const int* rows,
                      int E, int C, int K, int N, int activation, bool out_f32,
                      bool vec, cudaStream_t stream) {
  if (out_f32)
    return vec ? dispatch_stream<float, true>(x, w, out, rows, E, C, K, N, activation, stream)
               : dispatch_stream<float, false>(x, w, out, rows, E, C, K, N, activation, stream);
  return vec ? dispatch_stream<__nv_bfloat16, true>(x, w, out, rows, E, C, K, N, activation, stream)
             : dispatch_stream<__nv_bfloat16, false>(x, w, out, rows, E, C, K, N, activation, stream);
}
