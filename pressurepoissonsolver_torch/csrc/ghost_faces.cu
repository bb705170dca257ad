// The face term of the split ghost-closure stencil, for Hopper (sm_90a), in
// float and double, 2D and 3D:
//
//   out[cell] += 2 * sum over the patch sides s the cell lies on of
//                h2[axis(s)] * gf[s][face index of the cell]
//
// which turns the no-gf stencil (ghost coef * u_b) into the stencil with the
// ghost coef * u_b + 2 * gf.  It is the counterpart of the XLA face-pad sum
// the JAX halo engine adds after its exchange-independent base
// (pressurepoissonsolver_tpu/parallel/halo.py::_stencil_local,
// ops/level_ops.py::_face_pad_sum): the sides are summed in its order
// (x_lo, x_hi, y_lo, y_hi[, z_lo, z_hi]) and the sum is doubled and added
// once, so a corner cell rounds as it does there.
//
// Layout as the stencil kernels': out [P, n, n] or [P, n, n, n] (x fastest),
// gf [P, 2D, n^(D-1)] (2D: x faces by row y, y faces by column x; 3D: x faces
// at z*n + y, y faces at z*n + x, z faces at y*n + x), h2 [P, D].
//
// Design: one thread per boundary cell of a patch (a block row of the grid
// per patch, 32-bit indices within it), so each cell is read and written
// once and no two threads touch one cell: the result does not depend on the
// schedule.  Per patch the boundary cells are
// numbered z planes first (3D: the planes z = 0 and z = n-1 whole), then,
// per inner plane, the rows y = 0 and y = n-1 whole and the cells x = 0 and
// x = n-1 of the inner rows.  What bounds it: bytes (gf read once, each
// boundary cell of out read and written once); it does no more than 7
// flops per cell.  On the card the x-face cells of the inner rows set its
// time, not those bytes: each lies a row from the next and costs a memory
// transaction of its own (3D f32 at the bench shape: 21% of the element
// bound, PERF.md).  The kernel allocates nothing, launches on the caller's
// stream and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// boundary cells of an n x n plane: its ring
__host__ __device__ inline long long ring(int n) {
  return n == 1 ? 1 : 4LL * n - 4;
}

// boundary cells of a patch
template <int D>
__host__ __device__ inline long long boundary(int n) {
  if (D == 2) return ring(n);
  return n == 1 ? 1 : 2LL * n * n + (n - 2) * ring(n);
}

// the k-th cell of a plane's ring: rows 0 and n-1 whole, then the two end
// cells of each inner row
__device__ inline void ring_cell(int n, int k, int& y, int& x) {
  if (k < n) {
    y = 0;
    x = k;
  } else if (k < 2 * n) {
    y = n - 1;
    x = k - n;
  } else {
    k -= 2 * n;
    y = 1 + k / 2;
    x = k % 2 ? n - 1 : 0;
  }
}

// blockIdx.y strides over the patches, the x blocks and threads over a
// patch's boundary cells: every index within a patch is a 32-bit int
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ghost_faces_kernel(T* __restrict__ out, const T* __restrict__ gf,
                       const T* __restrict__ h2, int n, long long P) {
  const int nb = static_cast<int>(boundary<D>(n));
  const int m = D == 2 ? n : n * n;
  const int plane = n * n;
  const int r = static_cast<int>(ring(n));
  for (long long p = blockIdx.y; p < P; p += gridDim.y) {
    const T* g = gf + p * 2 * D * m;
    const T hx = h2[p * D], hy = h2[p * D + 1];
    const T hz = D == 3 ? h2[p * D + 2] : T(0);
    T* op = out + p * m * n;
    for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < nb;
         b += gridDim.x * blockDim.x) {
      int z = 0, y, x;
      if (D == 3 && n > 1) {
        if (b < 2 * plane) {
          z = b < plane ? 0 : n - 1;
          const int c = b - (z == 0 ? 0 : plane);
          y = c / n;
          x = c - y * n;
        } else {
          const int c = b - 2 * plane;
          z = 1 + c / r;
          ring_cell(n, c - (z - 1) * r, y, x);
        }
      } else {
        ring_cell(n, b, y, x);
      }
      const int fx = D == 2 ? y : z * n + y;
      const int fy = D == 2 ? x : z * n + x;
      T acc = T(0);
      if (x == 0) acc += hx * g[fx];
      if (x == n - 1) acc += hx * g[m + fx];
      if (y == 0) acc += hy * g[2 * m + fy];
      if (y == n - 1) acc += hy * g[3 * m + fy];
      if (D == 3) {
        if (z == 0) acc += hz * g[4 * m + y * n + x];
        if (z == n - 1) acc += hz * g[5 * m + y * n + x];
      }
      op[(z * n + y) * n + x] += T(2) * acc;
    }
  }
}

template <typename T, int D>
int launch(void* out, const void* gf, const void* h2, long long P, int n,
           void* stream) {
  if (P <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const long long nb = boundary<D>(n);
  const dim3 grid(static_cast<unsigned>((nb + kThreads - 1) / kThreads),
                  static_cast<unsigned>(P < 65535 ? P : 65535));
  ghost_faces_kernel<T, D><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(out), static_cast<const T*>(gf), static_cast<const T*>(h2),
      n, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pps_ghost_faces_2d_f32(void* out, const void* gf, const void* h2,
                                      long long P, int n, void* stream) {
  return launch<float, 2>(out, gf, h2, P, n, stream);
}

extern "C" int pps_ghost_faces_2d_f64(void* out, const void* gf, const void* h2,
                                      long long P, int n, void* stream) {
  return launch<double, 2>(out, gf, h2, P, n, stream);
}

extern "C" int pps_ghost_faces_3d_f32(void* out, const void* gf, const void* h2,
                                      long long P, int n, void* stream) {
  return launch<float, 3>(out, gf, h2, P, n, stream);
}

extern "C" int pps_ghost_faces_3d_f64(void* out, const void* gf, const void* h2,
                                      long long P, int n, void* stream) {
  return launch<double, 3>(out, gf, h2, P, n, stream);
}

extern "C" const char* pps_ghost_faces_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
