// The FAC multigrid's grid transfers between two 2D levels of n x n patches,
// for Hopper (sm_90a), in float and double, n a multiple of 4: the
// cell-averaging restriction and the prolongation added into a fine field,
// each one pass over its output driven by the transfer's int32 slot tables
// (ops/transfer.py, gmg.Transfer).
//
// Restriction, per coarse slot c (rtab[c] = the fine slots of its four
// orthant children, x half in bit 0 and y half in bit 1, then its
// pass-through fine slot; -1 where there is none):
//
//   * a parent (a child in some orthant): each orthant block of the slot is
//     the 2 x 2 average of its child, ((a + b) + (c + d)) / 4 with a, b from
//     fine row 2j and c, d from row 2j + 1 (GMG::AvgRstr); an orthant
//     without a child is 0;
//   * a pass-through slot: its fine patch, copied;
//   * a padded slot: 0.
//
// Prolong-add, per fine slot i (ptab[i] = its parent's coarse slot, -1 for a
// padded slot, and its orthant, -1 for a pass-through slot):
//
//   out = u + P(parent), P the parent's orthant block injected (constant,
//   GMG::DrctIntp: fine cell (y, x) reads parent cell ((y + hy n) / 2,
//   (x + hx n) / 2)) or interpolated (linear, GMG::TriLinIntp: two taps an
//   axis, 3/4 at the nearest parent cell and 1/4 at the next one toward the
//   fine cell, or 5/4 and -1/4 away from it where that cell lies outside
//   the patch; x first, then y, as gmg._linear_prolong_matrix applies them
//   axis by axis); the whole parent patch for a pass-through slot; nothing
//   for a padded one.
//
// Each output is written by exactly one thread, with no atomics: the result
// is the same in every run.  Sums are taken in the plain chain's order (the
// per-axis products of gmg.Transfer), so the f64 restriction and the
// constant prolong-add equal it bit for bit; the plain chain's f32 Kronecker
// form (n <= PPS_KRON_MAX_N) sums the same products associated through
// [n^2, n^2] matrices, so the f32 restriction and the linear prolongation
// agree with it to rounding.
//
// It replaces no TPU kernel: the JAX package's gmg.Transfer
// (pressurepoissonsolver_tpu/gmg.py:133-430) runs these transfers as XLA ops
// (row gathers of whole patches, per-orthant Kronecker or per-axis matmuls,
// concatenations and a routing gather), which the port's plain chain
// follows.  On the H100 that chain costs about 15 launches a transfer and,
// at the large levels, four to five times the bytes the transfer needs.
//
// What bounds it on the H100: bytes.  A restriction reads the fine field
// once and writes the coarse one once; a prolong-add reads u and the coarse
// field and writes out, with a flop or a few a cell.  The design moves those
// bytes once, in wide accesses, with many in flight:
//
// * a thread owns V consecutive output cells of one row (a 16-byte vector
//   in f32 when n is a multiple of 8, and in f64; 8 bytes in f32 otherwise),
//   and the neighbouring threads own the neighbouring vectors of the row,
//   the rows of the patch, then the next patches: a warp reads and writes
//   contiguous lines;
// * a restricted vector reads 2V fine cells from each of the two fine rows
//   (two 16-byte loads a row at V = 4 in f32) and a prolonged one V cells of
//   u and V / 2 parent cells (constant) or a 2 x 4 window of them (linear,
//   served by L1 across the threads of a row);
// * the grid is persistent, the blocks the card holds at once, each thread
//   walking over the vectors by a grid stride: at the large levels every
//   thread has many independent loads in flight, and a small level (16
//   parents) is one short wave;
// * the slot tables are read by every thread of a patch, from L1.
//
// Full precision: no fast math; the prolongation's products and sums in the
// field's type (the compiler may contract a product and a sum to an FMA).
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// K consecutive elements at p (K * sizeof(T) bytes, p aligned to the lesser
// of that and 16)
template <int K>
__device__ __forceinline__ void ldv(const float* __restrict__ p, float* v) {
  if constexpr (K == 1) {
    v[0] = p[0];
  } else if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x;
      v[k + 1] = t.y;
      v[k + 2] = t.z;
      v[k + 3] = t.w;
    }
  }
}

template <int K>
__device__ __forceinline__ void ldv(const double* __restrict__ p, double* v) {
  if constexpr (K == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const double2 t = *reinterpret_cast<const double2*>(p + k);
      v[k] = t.x;
      v[k + 1] = t.y;
    }
  }
}

template <int K>
__device__ __forceinline__ void stv(float* __restrict__ p, const float* v) {
  if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    static_assert(K == 4, "a float vector of 2 or 4");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int K>
__device__ __forceinline__ void stv(double* __restrict__ p, const double* v) {
  static_assert(K == 2, "a double vector of 2");
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// where output vector `it` lies: its slot, row and first column
struct Place {
  long long slot;
  int row, col;
};

template <int V>
__device__ __forceinline__ Place place(long long it, int n) {
  const int per_row = n / V;
  const long long per_slot = static_cast<long long>(n) * per_row;
  Place p;
  p.slot = it / per_slot;
  const int r = static_cast<int>(it - p.slot * per_slot);
  p.row = r / per_row;
  p.col = (r - p.row * per_row) * V;
  return p;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    restrict_kernel(const T* __restrict__ fine, const int* __restrict__ rtab,
                    T* __restrict__ out, long long Pc, int n) {
  const long long nn = static_cast<long long>(n) * n;
  const long long items = Pc * (nn / V);
  const int h = n / 2;
  for (long long it = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Place q = place<V>(it, n);
    const int hy = q.row >= h, hx = q.col >= h;
    const int* tab = rtab + q.slot * 5;
    const int child = tab[2 * hy + hx];
    T o[V];
    if (child >= 0) {
      const T* f = fine + child * nn + static_cast<long long>(2 * (q.row - hy * h)) * n +
                   2 * (q.col - hx * h);
      T a[2 * V], b[2 * V];
      ldv<2 * V>(f, a);
      ldv<2 * V>(f + n, b);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        o[k] = T(0.25) * ((a[2 * k] + a[2 * k + 1]) + (b[2 * k] + b[2 * k + 1]));
      }
    } else {
      const int pt = tab[4];
      if (pt >= 0) {
        ldv<V>(fine + pt * nn + static_cast<long long>(q.row) * n + q.col, o);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = T(0);
      }
    }
    stv<V>(out + q.slot * nn + static_cast<long long>(q.row) * n + q.col, o);
  }
}

// the two taps of fine cell i of an axis in the half `half` of its parent:
// the parent cells c (weight wc) and o (weight wo)
template <typename T>
__device__ __forceinline__ void taps(int i, int half, int n, int& c, int& o, T& wc, T& wo) {
  c = half * (n / 2) + (i >> 1);
  const int d = (i & 1) ? 1 : -1;
  if (c + d >= 0 && c + d < n) {
    o = c + d;
    wc = T(0.75);
    wo = T(0.25);
  } else {
    o = c - d;
    wc = T(1.25);
    wo = T(-0.25);
  }
}

template <typename T, int V, bool LINEAR>
__global__ void __launch_bounds__(kThreads)
    prolong_kernel(const T* __restrict__ coarse, const T* __restrict__ u,
                   const int* __restrict__ ptab, T* __restrict__ out, long long Pf, int n) {
  const long long nn = static_cast<long long>(n) * n;
  const long long items = Pf * (nn / V);
  for (long long it = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Place q = place<V>(it, n);
    const long long at = q.slot * nn + static_cast<long long>(q.row) * n + q.col;
    const int parent = ptab[2 * q.slot];
    const int orth = ptab[2 * q.slot + 1];
    T v[V], add[V];
    ldv<V>(u + at, v);
    if (parent < 0) {
#pragma unroll
      for (int k = 0; k < V; ++k) add[k] = T(0);
    } else if (orth < 0) {
      ldv<V>(coarse + parent * nn + static_cast<long long>(q.row) * n + q.col, add);
    } else {
      const T* p = coarse + parent * nn;
      const int hy = orth >> 1, hx = orth & 1;
      if constexpr (!LINEAR) {
        T w[V / 2];
        ldv<V / 2>(p + static_cast<long long>((q.row + hy * n) >> 1) * n +
                       ((q.col + hx * n) >> 1),
                   w);
#pragma unroll
        for (int k = 0; k < V; ++k) add[k] = w[k >> 1];
      } else {
        int cy, oy;
        T wcy, woy;
        taps(q.row, hy, n, cy, oy, wcy, woy);
        const T* rc = p + static_cast<long long>(cy) * n;
        const T* ro = p + static_cast<long long>(oy) * n;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          int cx, ox;
          T wcx, wox;
          taps(q.col + k, hx, n, cx, ox, wcx, wox);
          const T tc = wcx * rc[cx] + wox * rc[ox];
          const T to = wcx * ro[cx] + wox * ro[ox];
          add[k] = wcy * tc + woy * to;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = v[k] + add[k];
    stv<V>(out + at, v);
  }
}

// the grid of a launch over `items` output vectors: the blocks the card holds
// at once of `kernel` (found at its first launch on a device, an eager one: a
// capture's warm-up runs first, and kept in `per_sm` and `sms`), or fewer
template <typename K>
int grid_for(K kernel, long long items, int* per_sm, int* sms, unsigned& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm[dev] = blocks > 0 ? blocks : 1;
  }
  const long long need = (items + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(per_sm[dev]) * sms[dev];
  grid = static_cast<unsigned>(need < most ? need : most);
  return 0;
}

template <typename T, int V>
int restrict_n(const void* fine, const void* rtab, void* out, long long Pc, int n,
               void* stream) {
  static int per_sm[kMaxDevices], sms[kMaxDevices];
  const long long items = Pc * (static_cast<long long>(n) * n / V);
  if (items == 0) return static_cast<int>(cudaGetLastError());
  unsigned grid = 0;
  const int rc = grid_for(restrict_kernel<T, V>, items, per_sm, sms, grid);
  if (rc != 0) return rc;
  restrict_kernel<T, V><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fine), static_cast<const int*>(rtab), static_cast<T*>(out), Pc, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool LINEAR>
int prolong_n(const void* coarse, const void* u, const void* ptab, void* out, long long Pf,
              int n, void* stream) {
  static int per_sm[kMaxDevices], sms[kMaxDevices];
  const long long items = Pf * (static_cast<long long>(n) * n / V);
  if (items == 0) return static_cast<int>(cudaGetLastError());
  unsigned grid = 0;
  const int rc = grid_for(prolong_kernel<T, V, LINEAR>, items, per_sm, sms, grid);
  if (rc != 0) return rc;
  prolong_kernel<T, V, LINEAR><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coarse), static_cast<const T*>(u), static_cast<const int*>(ptab),
      static_cast<T*>(out), Pf, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int prolong_v(int linear, const void* coarse, const void* u, const void* ptab, void* out,
              long long Pf, int n, void* stream) {
  return linear ? prolong_n<T, V, true>(coarse, u, ptab, out, Pf, n, stream)
                : prolong_n<T, V, false>(coarse, u, ptab, out, Pf, n, stream);
}

}  // namespace

// dtype: 0 float, 1 double.  n a positive multiple of 4.  fine [Pf, n, n],
// rtab int32 [Pc, 5], out [Pc, n, n]; every pointer 16-byte aligned.
extern "C" int pps_transfer_restrict(int dtype, const void* fine, const void* rtab, void* out,
                                     long long Pc, int n, void* stream) {
  if (n <= 0 || n % 4 != 0 || Pc < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return n % 8 == 0 ? restrict_n<float, 4>(fine, rtab, out, Pc, n, stream)
                      : restrict_n<float, 2>(fine, rtab, out, Pc, n, stream);
  }
  if (dtype == 1) return restrict_n<double, 2>(fine, rtab, out, Pc, n, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// linear: 0 constant injection, 1 linear interpolation.  coarse [Pc, n, n],
// u and out [Pf, n, n], ptab int32 [Pf, 2]; every pointer 16-byte aligned.
extern "C" int pps_transfer_prolong_add(int dtype, int linear, const void* coarse,
                                        const void* u, const void* ptab, void* out,
                                        long long Pf, int n, void* stream) {
  if (n <= 0 || n % 4 != 0 || Pf < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return n % 8 == 0 ? prolong_v<float, 4>(linear, coarse, u, ptab, out, Pf, n, stream)
                      : prolong_v<float, 2>(linear, coarse, u, ptab, out, Pf, n, stream);
  }
  if (dtype == 1) return prolong_v<double, 2>(linear, coarse, u, ptab, out, Pf, n, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pps_transfer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
