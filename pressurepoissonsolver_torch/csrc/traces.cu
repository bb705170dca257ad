// The per-side interface traces gf[R, n] of a 2D level of n x n patches, for
// Hopper (sm_90a), in float and double: every output row, a (patch, side)
// pair, in one pass that reads the field u directly through the level's
// int32 contribution tables (ops/traces.py, built once by Level and
// ActiveSmoother).
//
// Tables.  Row r's entries are ent[rowptr[r] .. rowptr[r + 1]), each a source
// face row of u and a case of the level's interpolation:
//
//   ent = src << 5 | case << 1 | template,   src = patch * 4 * depth + face,
//   face = side * depth + d (side 0 / 1 the x-low / x-high column, 2 / 3 the
//   y-low / y-high row, d cells inward, as ops.level_ops.extract_faces),
//
// and the palette of cases: cw[case] the weight of a scalar case (normal,
// c2c: a multiple of the identity), or, for a template case (f2f, f2c, c2f:
// the dense case template ops.level_ops.Level._case_T), per output element
// j its kt nonzero taps, weights tw[case, j, t] and source elements
// ti[case, j, t], in ascending source order (a pad tap has weight 0).  The
// palette comes in float64 holding the level's dtype's values (the plain
// chain casts its weights to the field's dtype, and so does the kernel).
//
// Per output row the kernel computes what the plain chain does
// (Level._gf_parts, Level._gf_faces, ActiveSmoother._gamma_faces): the
// scalar entries' products summed in table order, plus the template entries'
// values, each the sum of its taps' products, summed in table order:
//
//   gf[r, j] = (sum_scalar cw[c] * face[j]) + (sum_template sum_t tw * face[ti])
//
// A direct side of the apply is one scalar entry (the neighbour's boundary
// row, 1/2), of the sweep two (own and neighbour); a refinement side holds
// its interface's scalar and template contributions; a side without an
// interface none (a zero row).
//
// It replaces no TPU kernel: the JAX package builds these traces with XLA
// ops (a stack of the faces, row gathers, a case-template matmul,
// concatenations and elementwise passes), which the port's plain chain
// follows.  On the H100 that chain costs 5 to 20 launches a build and about
// ten times the bytes a build needs.
//
// What bounds it on the H100: bytes.  A build reads the boundary of every
// source patch (its four boundary rows and columns touch every 32-byte
// sector of an f32 16 x 16 patch), writes gf once and reads the tables once.
// The design:
//
// * a thread owns V consecutive elements of one output row (a 16-byte
//   vector in f32 when n is a multiple of 4, and in f64 when n is even), and
//   the neighbouring threads own the rest of the row, then the next rows: a
//   warp writes contiguous lines and reads one row's entries from L1;
// * a source row of u (a y side) is read in V-wide vectors, a source column
//   (an x side) element by element, n apart, and a template's taps at once:
//   the loads of an entry are independent of each other;
// * the chain of dependent loads is kept short: the next entry's code is
//   loaded with the current entry's values, the next item's row bounds
//   with the current item, and the first item's under the palette's
//   staging (a small level is one wave of one item a thread, whose time is
//   that chain);
// * the palette is staged in shared memory once per block;
// * the grid is persistent, the blocks the card holds at once, each thread
//   walking over the vectors by a grid stride.
//
// Each output element is written by exactly one thread, with no atomics:
// the result is the same in every run.  Products and sums are rounded one
// by one (no contraction to FMA), in the plain chain's order, so the kernel
// agrees with the plain chain to the rounding of its matmul.  The kernel
// allocates nothing, launches on the caller's stream and does not
// synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kMaxCases = 16;
constexpr int kMaxTaps = 4;  // a template's nonzeros in a row
constexpr int kMaxShared = 48 * 1024;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// K consecutive elements at p (K * sizeof(T) bytes, p aligned to that)
template <int K>
__device__ __forceinline__ void ldv(const float* __restrict__ p, float* v) {
  if constexpr (K == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int K>
__device__ __forceinline__ void ldv(const double* __restrict__ p, double* v) {
  if constexpr (K == 2) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int K>
__device__ __forceinline__ void stv(float* __restrict__ p, const float* v) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int K>
__device__ __forceinline__ void stv(double* __restrict__ p, const double* v) {
  if constexpr (K == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// bytes of the staged palette: the scalar weights (kMaxCases of them, so
// that the taps stay aligned), the tap weights and the tap sources
template <typename T>
constexpr long long palette_bytes(int ncase, int n, int kt) {
  return static_cast<long long>(kMaxCases) * sizeof(T) +
         static_cast<long long>(ncase) * n * kt * (sizeof(T) + sizeof(int));
}

// the source of entry `code` of an output row: its face row's first element
// in u, and whether it is a column (an x side: elements n apart)
template <typename T>
__device__ __forceinline__ const T* face_of(const T* __restrict__ u, int code, int n,
                                            long long nn, int depth_log2, bool& column) {
  const int src = code >> 5;
  const int face = src & ((1 << (2 + depth_log2)) - 1);
  const int side = face >> depth_log2;
  const int d = face & ((1 << depth_log2) - 1);
  const int line = (side & 1) ? n - 1 - d : d;  // the column or row read
  column = side < 2;
  return u + static_cast<long long>(src >> (2 + depth_log2)) * nn +
         (column ? line : static_cast<long long>(line) * n);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    traces_kernel(const T* __restrict__ u, const int* __restrict__ rowptr,
                  const int* __restrict__ ent, const double* __restrict__ cw,
                  const double* __restrict__ tw, const int* __restrict__ ti,
                  T* __restrict__ out, long long rows, int n, int depth_log2, int ncase,
                  int kt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int per_row = n / V;
  const long long items = rows * per_row;
  const long long nn = static_cast<long long>(n) * n;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long it = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  // the first item's entries, and its first entry's code, are loaded while
  // the palette is staged; every later item's while the one before runs
  int first = 0, last = 0;
  if (it < items) {
    const long long row = it / per_row;
    first = rowptr[row];
    last = rowptr[row + 1];
  }
  T* s_cw = reinterpret_cast<T*>(smem);
  T* s_tw = s_cw + kMaxCases;
  const int ntaps = ncase * n * kt;
  int* s_ti = reinterpret_cast<int*>(s_tw + ntaps);
  for (int i = threadIdx.x; i < ncase; i += blockDim.x) s_cw[i] = static_cast<T>(cw[i]);
  for (int i = threadIdx.x; i < ntaps; i += blockDim.x) {
    s_tw[i] = static_cast<T>(tw[i]);
    s_ti[i] = ti[i];
  }
  int code = first < last ? ent[first] : 0;
  __syncthreads();

  for (; it < items; it += step) {
    const long long row = it / per_row;
    const int j0 = static_cast<int>(it - row * per_row) * V;
    int next_first = 0, next_last = 0;
    if (it + step < items) {
      const long long next = (it + step) / per_row;
      next_first = rowptr[next];
      next_last = rowptr[next + 1];
    }
    T sc[V], tm[V];
#pragma unroll
    for (int k = 0; k < V; ++k) sc[k] = tm[k] = T(0);
    for (int q = first; q < last; ++q) {
      const int following = q + 1 < last ? ent[q + 1] : 0;  // in flight with this entry
      const int c = (code >> 1) & (kMaxCases - 1);
      bool column;
      const T* f = face_of(u, code, n, nn, depth_log2, column);
      if (!(code & 1)) {
        const T w = s_cw[c];
        T x[V];
        if (column) {
#pragma unroll
          for (int k = 0; k < V; ++k) x[k] = f[static_cast<long long>(j0 + k) * n];
        } else {
          ldv<V>(f + j0, x);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) sc[k] = add(sc[k], mul(w, x[k]));
      } else {
        const int stride = column ? n : 1;
        const int at = (c * n + j0) * kt;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          T x[kMaxTaps];
#pragma unroll
          for (int t = 0; t < kMaxTaps; ++t) {
            x[t] = t < kt ? f[static_cast<long long>(s_ti[at + k * kt + t]) * stride] : T(0);
          }
          T s = T(0);
#pragma unroll
          for (int t = 0; t < kMaxTaps; ++t) {
            if (t < kt) s = add(s, mul(s_tw[at + k * kt + t], x[t]));
          }
          tm[k] = add(tm[k], s);
        }
      }
      code = following;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) sc[k] = add(sc[k], tm[k]);
    stv<V>(out + row * n + j0, sc);
    first = next_first;
    last = next_last;
    code = first < last ? ent[first] : 0;
  }
}

// the grid of a launch over `items` output vectors with `smem` bytes of
// shared memory a block: the blocks the card holds at once (found at a
// device's first launch with that shared size, an eager one: a capture's
// warm-up runs first), or fewer
template <typename K>
int grid_for(K kernel, long long items, int smem, int* per_sm, int* sms, int* at_smem,
             unsigned& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0 || at_smem[dev] != smem) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm[dev] = blocks > 0 ? blocks : 1;
    at_smem[dev] = smem;
  }
  const long long need = (items + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(per_sm[dev]) * sms[dev];
  grid = static_cast<unsigned>(need < most ? need : most);
  return 0;
}

template <typename T, int V>
int traces_n(const void* u, const void* rowptr, const void* ent, const void* cw,
             const void* tw, const void* ti, void* out, long long rows, int n,
             int depth_log2, int ncase, int kt, void* stream) {
  static int per_sm[kMaxDevices], sms[kMaxDevices], at_smem[kMaxDevices];
  const long long items = rows * (n / V);
  if (items == 0) return static_cast<int>(cudaGetLastError());
  const int smem = static_cast<int>(palette_bytes<T>(ncase, n, kt));
  unsigned grid = 0;
  const int rc = grid_for(traces_kernel<T, V>, items, smem, per_sm, sms, at_smem, grid);
  if (rc != 0) return rc;
  traces_kernel<T, V><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const int*>(rowptr), static_cast<const int*>(ent),
      static_cast<const double*>(cw), static_cast<const double*>(tw),
      static_cast<const int*>(ti), static_cast<T*>(out), rows, n, depth_log2, ncase, kt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float, 1 double.  u [P, n, n]; rowptr int32 [rows + 1], ent int32
// [rowptr[rows]]; cw float64 [ncase], tw float64 and ti int32 [ncase, n, kt];
// out [rows, n]; depth = 1 << depth_log2 face rows a side; every pointer
// 16-byte aligned.
extern "C" int pps_traces(int dtype, const void* u, const void* rowptr, const void* ent,
                          const void* cw, const void* tw, const void* ti, void* out,
                          long long rows, int n, int depth_log2, int ncase, int kt,
                          void* stream) {
  if (n <= 0 || rows < 0 || depth_log2 < 0 || depth_log2 > 1 || ncase < 1 ||
      ncase > kMaxCases || kt < 1 || kt > kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    if (palette_bytes<float>(ncase, n, kt) > kMaxShared) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n % 4 == 0) {
      return traces_n<float, 4>(u, rowptr, ent, cw, tw, ti, out, rows, n, depth_log2, ncase,
                                kt, stream);
    }
    if (n % 2 == 0) {
      return traces_n<float, 2>(u, rowptr, ent, cw, tw, ti, out, rows, n, depth_log2, ncase,
                                kt, stream);
    }
    return traces_n<float, 1>(u, rowptr, ent, cw, tw, ti, out, rows, n, depth_log2, ncase, kt,
                              stream);
  }
  if (dtype == 1) {
    if (palette_bytes<double>(ncase, n, kt) > kMaxShared) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n % 2 == 0) {
      return traces_n<double, 2>(u, rowptr, ent, cw, tw, ti, out, rows, n, depth_log2, ncase,
                                 kt, stream);
    }
    return traces_n<double, 1>(u, rowptr, ent, cw, tw, ti, out, rows, n, depth_log2, ncase,
                               kt, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pps_traces_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
