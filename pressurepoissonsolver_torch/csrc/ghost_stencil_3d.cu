// Ghost-closure 7-point star stencil on a batch of 3D patches, for Hopper
// (sm_90a), in float and double.
//
// Replaces pressurepoissonsolver_tpu/ops/pallas_stencil.py::_kernel_3d (the
// Pallas TPU kernel launched by _build_call_3d / FusedStencil3D).  Same
// algebra as level_ops._star_stencil at D=3:
//
//   out = h2x (lo_x - 2 u + hi_x) + h2y (lo_y - 2 u + hi_y)
//       + h2z (lo_z - 2 u + hi_z)
//
// where a neighbour that falls outside the patch is the ghost value
// coef[side] * u_b + 2 * gf[side] (u_b = the boundary cell itself).
//
// Layout: u, out [P, n, n, n] (z, y, x; x fastest); gf [P, 6, n*n] with
// sides x_lo, x_hi, y_lo, y_hi, z_lo, z_hi, flattened as extract_faces
// does: x faces at z*n + y, y faces at z*n + x, z faces at y*n + x;
// coef [P, 6]; h2 [P, 3] = (1/hx^2, 1/hy^2, 1/hz^2).  Any n >= 1 with
// n^3 <= 65535 * 256 (the grid's y limit).
//
// What bounds it on the H100: bytes.  It does about 14 flops per cell
// against a compulsory (2 n^3 + 6 n^2) * sizeof(T) bytes per patch (read u
// and gf once, write out once), far below the card's flop/byte balance.
// At the 3D bench shape (P=624, n=32) that is 178.9 MB in f32 and
// 357.8 MB in f64, so the floor at 3.35 TB/s is about 53 us (f32) and
// 107 us (f64); the fields exceed the 50 MB L2, so the kernel streams from
// device memory.  Design: one block per (patch, tile of 256 consecutive
// cells), a thread per cell, neighbouring threads on neighbouring
// addresses, so the loads of u and the store coalesce.  The +-x neighbours
// come from the same cache lines, the +-y (n cells away) and +-z (n^2
// cells away) neighbours from L1/L2, so device memory sees each cell of u
// about once.  Unlike the TPU kernel, which broadcasts the z faces, pads
// the y faces and spreads the x faces onto their lanes with a one-hot
// matmul, each boundary thread here reads its own gf entry.  The kernel
// allocates nothing, launches on the caller's stream and does not
// synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__global__ void ghost_stencil_3d_kernel(const T* __restrict__ u,
                                        const T* __restrict__ gf,
                                        const T* __restrict__ coef,
                                        const T* __restrict__ h2,
                                        T* __restrict__ out, int n) {
  const int m = n * n;
  const int cells = m * n;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  const int64_t p = blockIdx.x;
  const int z = c / m;
  const int r = c - z * m;  // y * n + x
  const int y = r / n;
  const int x = r - y * n;
  const T* up = u + p * cells;
  const T* g = gf + p * 6 * m;
  const T* cp = coef + p * 6;
  const T* hp = h2 + p * 3;
  const T two = T(2);
  const T uc = up[c];
  const T lo_x = x > 0 ? up[c - 1] : cp[0] * uc + two * g[z * n + y];
  const T hi_x = x < n - 1 ? up[c + 1] : cp[1] * uc + two * g[m + z * n + y];
  const T lo_y = y > 0 ? up[c - n] : cp[2] * uc + two * g[2 * m + z * n + x];
  const T hi_y =
      y < n - 1 ? up[c + n] : cp[3] * uc + two * g[3 * m + z * n + x];
  const T lo_z = z > 0 ? up[c - m] : cp[4] * uc + two * g[4 * m + r];
  const T hi_z = z < n - 1 ? up[c + m] : cp[5] * uc + two * g[5 * m + r];
  out[p * cells + c] = (lo_x - two * uc + hi_x) * hp[0] +
                       (lo_y - two * uc + hi_y) * hp[1] +
                       (lo_z - two * uc + hi_z) * hp[2];
}

template <typename T>
int launch(const void* u, const void* gf, const void* coef, const void* h2,
           void* out, long long P, int n, void* stream) {
  if (P <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int cells = n * n * n;
  // a whole number of warps, at most 256 threads, tiling the patch's cells
  const int threads = cells >= 256 ? 256 : ((cells + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>(P), (cells + threads - 1) / threads);
  ghost_stencil_3d_kernel<T><<<grid, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(gf),
      static_cast<const T*>(coef), static_cast<const T*>(h2),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pps_ghost_stencil_3d_f32(const void* u, const void* gf,
                                        const void* coef, const void* h2,
                                        void* out, long long P, int n,
                                        void* stream) {
  return launch<float>(u, gf, coef, h2, out, P, n, stream);
}

extern "C" int pps_ghost_stencil_3d_f64(const void* u, const void* gf,
                                        const void* coef, const void* h2,
                                        void* out, long long P, int n,
                                        void* stream) {
  return launch<double>(u, gf, coef, h2, out, P, n, stream);
}

extern "C" const char* pps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
