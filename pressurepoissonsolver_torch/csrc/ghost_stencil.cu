// Ghost-closure 5-point star stencil on a batch of 2D patches, for Hopper
// (sm_90a), in float and double.
//
// Replaces pressurepoissonsolver_tpu/ops/pallas_stencil.py::_kernel_2d (the
// Pallas TPU kernel launched by _build_call / FusedStencil2D).  Same algebra
// as level_ops._star_stencil:
//
//   out = h2x * (lo_x - 2 u + hi_x) + h2y * (lo_y - 2 u + hi_y)
//
// where a neighbour that falls outside the patch is the ghost value
// coef[side] * u_b + 2 * gf[side] (u_b = the boundary cell itself).
//
// Layout: u, out [P, n, n] (x fastest); gf [P, 4, n] with sides x_lo, x_hi,
// y_lo, y_hi -- the x faces are indexed by row y, the y faces by column x;
// coef [P, 4]; h2 [P, 2] = (1/hx^2, 1/hy^2).  Any n >= 1.
//
// What bounds it on the H100: bytes.  It does 10-13 flops per cell against
// 2 * sizeof(T) bytes of compulsory traffic (read u once, write out once),
// far below the card's flop/byte balance, so the floor is
// 2 * P * n^2 * sizeof(T) / 3.35 TB/s (34 MB, about 10 us, for the f32 field
// of 1048 patches of 64 x 64).  Design: one block per (patch, tile of
// consecutive cells); a thread per cell, neighbouring threads on
// neighbouring addresses, so every load and the store coalesce.  The x
// neighbours come from the same or adjacent cache lines and the y
// neighbours (one row away) from L1/L2, so device memory sees each cell of u
// about once.  Unlike the TPU kernel, no placement matmul is needed to put
// the face terms on the boundary cells: each thread writes its own cell and
// reads its own gf entry when it sits on a face.  The kernel allocates
// nothing, launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__global__ void ghost_stencil_2d_kernel(const T* __restrict__ u,
                                        const T* __restrict__ gf,
                                        const T* __restrict__ coef,
                                        const T* __restrict__ h2,
                                        T* __restrict__ out, int n) {
  const int cells = n * n;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  const int64_t p = blockIdx.x;
  const int y = c / n;
  const int x = c - y * n;
  const T* up = u + p * cells;
  const T* g = gf + p * 4 * n;
  const T* cp = coef + p * 4;
  const T two = T(2);
  const T uc = up[c];
  const T lo_x = x > 0 ? up[c - 1] : cp[0] * uc + two * g[y];
  const T hi_x = x < n - 1 ? up[c + 1] : cp[1] * uc + two * g[n + y];
  const T lo_y = y > 0 ? up[c - n] : cp[2] * uc + two * g[2 * n + x];
  const T hi_y = y < n - 1 ? up[c + n] : cp[3] * uc + two * g[3 * n + x];
  out[p * cells + c] = (lo_x - two * uc + hi_x) * h2[2 * p] +
                       (lo_y - two * uc + hi_y) * h2[2 * p + 1];
}

template <typename T>
int launch(const void* u, const void* gf, const void* coef, const void* h2,
           void* out, long long P, int n, void* stream) {
  if (P <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int cells = n * n;
  // a whole number of warps, at most 256 threads, tiling the patch's cells
  const int threads = cells >= 256 ? 256 : ((cells + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>(P), (cells + threads - 1) / threads);
  ghost_stencil_2d_kernel<T><<<grid, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(gf),
      static_cast<const T*>(coef), static_cast<const T*>(h2),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pps_ghost_stencil_2d_f32(const void* u, const void* gf,
                                        const void* coef, const void* h2,
                                        void* out, long long P, int n,
                                        void* stream) {
  return launch<float>(u, gf, coef, h2, out, P, n, stream);
}

extern "C" int pps_ghost_stencil_2d_f64(const void* u, const void* gf,
                                        const void* coef, const void* h2,
                                        void* out, long long P, int n,
                                        void* stream) {
  return launch<double>(u, gf, coef, h2, out, P, n, stream);
}

extern "C" const char* pps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
