// The tiled GMM kernel's forward-layout instantiations (gmm.cuh): f32
// (3xTF32), bf16, and bf16 operands with an f32 store.
#include "gmm.cuh"

template <typename T, typename O>
static int tile_fwd(const void* x, const void* w, void* out, const int* rows,
                    int E, int C, int K, int N, int activation, bool vec,
                    cudaStream_t stream) {
  return vec ? run_tile<T, O, false, false, true>(x, w, out, rows, E, C, K, N, activation, stream)
             : run_tile<T, O, false, false, false>(x, w, out, rows, E, C, K, N, activation, stream);
}

int gmm_launch_tile(const void* x, const void* w, void* out, const int* rows,
                    int E, int C, int K, int N, int activation, int dtype,
                    bool out_f32, bool vec, cudaStream_t stream) {
  if (dtype == REPRO_F32)
    return tile_fwd<float, float>(x, w, out, rows, E, C, K, N, activation, vec, stream);
  if (out_f32)
    return tile_fwd<__nv_bfloat16, float>(x, w, out, rows, E, C, K, N, activation, vec, stream);
  return tile_fwd<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, E, C, K, N, activation, vec, stream);
}
