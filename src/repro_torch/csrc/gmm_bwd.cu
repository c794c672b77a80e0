// The tiled GMM kernel's transposed-layout instantiations (gmm.cuh),
// the backward pass's products: f32 (3xTF32) and bf16, x or w read
// transposed in place.
#include "gmm.cuh"

template <typename T>
static int tile_bwd(const void* x, const void* w, void* out, const int* rows,
                    int E, int C, int K, int N, int activation, int trans_x,
                    bool vec, cudaStream_t stream) {
  if (trans_x)
    return vec ? run_tile<T, T, true, false, true>(x, w, out, rows, E, C, K, N, activation, stream)
               : run_tile<T, T, true, false, false>(x, w, out, rows, E, C, K, N, activation, stream);
  return vec ? run_tile<T, T, false, true, true>(x, w, out, rows, E, C, K, N, activation, stream)
             : run_tile<T, T, false, true, false>(x, w, out, rows, E, C, K, N, activation, stream);
}

int gmm_launch_tile_bwd(const void* x, const void* w, void* out,
                        const int* rows, int E, int C, int K, int N,
                        int activation, int dtype, int trans_x, bool vec,
                        cudaStream_t stream) {
  if (dtype == REPRO_F32)
    return tile_bwd<float>(x, w, out, rows, E, C, K, N, activation, trans_x, vec, stream);
  return tile_bwd<__nv_bfloat16>(x, w, out, rows, E, C, K, N, activation, trans_x, vec, stream);
}
