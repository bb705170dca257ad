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
// coef [P, 4]; h2 [P, 2] = (1/hx^2, 1/hy^2).  Any n from 1 to 46340.
//
// What bounds it on the H100: bytes.  It does 10-13 flops per cell against
// 2 * sizeof(T) bytes of compulsory traffic (read u once, write out once),
// far below the card's flop/byte balance, so the floor is the bytes of u,
// gf, coef, h2 and out over 3.35 TB/s: 35.4 MB, 10.6 us, for the f32 field
// of 1048 patches of 64 x 64.  That field fits in the 50 MB L2, so a caller
// that has just written u finds it there; the floor is the cold case.
//
// Design: each thread owns a W-wide vector of a row (W = 16 bytes /
// sizeof(T): float4, double2) and marches along y over a chunk of kRows
// rows (2; at W=1, whose loads are narrower, 4 in float and 3 in double).  It issues every load of its chunk before any arithmetic (the rows
// y0-1 .. y0+kRows, the x-face entries of its rows when it
// is an end lane, the y-face vector when the chunk holds y=0 or y=n-1), so
// each thread has several 16-byte loads in flight; then each row computes
// from the registers.  Every load of u and every store of out is 16 bytes;
// each element of u comes from device memory once, and the halo rows at each
// chunk edge, which the neighbouring chunk also reads, from L2.
// Consecutive threads own consecutive vectors of a row, then the next chunk,
// then the next patch.  The +-x neighbours of a vector's end elements come
// from the neighbouring lanes by shuffle (one scalar load where a row
// crosses a warp boundary).  No shared memory and no barrier.  out is
// written with streaming stores.  coef and h2 are read once per thread; the
// only divisions are in the thread index set-up.
//
// n not a multiple of W, or u, gf or out not 16-byte aligned (a view at an
// element offset): the same kernel at W=1, one element per thread, chosen
// by pps_ghost_stencil_vector_width, which the wrapper calls to record the
// path of each launch.
//
// ptxas (sm_90a, CUDA 12.8): 58 registers at <float, 4> and <float, 1>, 64
// at <double, 2> and <double, 1>; no spills.  The chunk heights were chosen
// by timing 1 to 8 rows at the bench shape and at n=63 (PERF.md).
// The kernel allocates nothing, launches on the caller's stream and does
// not synchronise.
//
// No-gf mode: a null gf pointer means the ghost is coef * u_b and gf is not
// read (the template's G = false).  The sharded apply launches it on its
// own rows while the cut-face exchange is in flight and adds the face term
// 2 * h2 * gf afterwards, on the boundary cells.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// rows a thread marches: 2 on the vector path; at one element per thread,
// whose loads are narrower, 4 in float and 3 in double
template <typename T, int W>
constexpr int kRows = W > 1 ? 2 : sizeof(T) == 4 ? 4 : 3;

template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T a[W];
};

template <typename T, int W>
__device__ __forceinline__ Pack<T, W> load(const T* p) {
  return *reinterpret_cast<const Pack<T, W>*>(p);
}

// out is written once and not read again here: a streaming store, so that
// it does not evict the inputs' lines from the L2
template <typename T, int W>
__device__ __forceinline__ void store(T* p, const Pack<T, W>& v) {
  if constexpr (W * sizeof(T) == 16 && sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(v.a[0], v.a[1], v.a[2], v.a[3]));
  } else if constexpr (W * sizeof(T) == 16) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v.a[0], v.a[1]));
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) __stcs(p + i, v.a[i]);
  }
}

// the ghost vector coef * u_b + 2 * g
template <typename T, int W>
__device__ __forceinline__ Pack<T, W> ghost(T c, const Pack<T, W>& ub,
                                            const Pack<T, W>& g) {
  Pack<T, W> r;
#pragma unroll
  for (int i = 0; i < W; ++i) r.a[i] = c * ub.a[i] + T(2) * g.a[i];
  return r;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int vector_width(const void* u, const void* gf, const void* out, int n) {
  constexpr int w = 16 / sizeof(T);
  return n % w == 0 && aligned16(u) && aligned16(gf) && aligned16(out) ? w : 1;
}

// one thread per (patch, chunk of kRows<T, W> rows, vector of a row), vector
// fastest; G: gf is read (else the ghost is coef * u_b)
template <typename T, int W, bool G>
__global__ void __launch_bounds__(kThreads)
    ghost_stencil_2d_kernel(const T* __restrict__ u, const T* __restrict__ gf,
                            const T* __restrict__ coef,
                            const T* __restrict__ h2, T* __restrict__ out,
                            int n, int chunks, long long walkers) {
  using V = Pack<T, W>;
  const int nx = n / W;  // vectors per row
  const int lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const bool in = w < walkers;
  const long long t = in ? w / nx : 0;
  const int xv = in ? static_cast<int>(w - t * nx) : 0;
  const int y0 = static_cast<int>(t % chunks) * kRows<T, W>;
  const int64_t p = t / chunks;
  const int y1 = min(y0 + kRows<T, W>, n);
  const int x0 = xv * W;

  const T* up = u + p * n * n + x0;  // row y at up + y * n
  T* op = out + p * n * n + x0;
  const T* g = G ? gf + p * 4 * n : nullptr;
  const T* cp = coef + p * 4;
  const T c0 = cp[0], c1 = cp[1], c2 = cp[2], c3 = cp[3];
  const T hx = h2[2 * p], hy = h2[2 * p + 1];
  const T two = T(2);

  // every load of the chunk before any arithmetic: rows y0-1 .. y1, the
  // x-face entries of the end lanes, the y-face vectors of the first and
  // last rows of the patch
  V v[kRows<T, W> + 2];
#pragma unroll
  for (int k = 0; k < kRows<T, W> + 2; ++k) {
    const int y = y0 - 1 + k;
    v[k] = in && y >= 0 && y <= y1 && y < n ? load<T, W>(up + y * n) : V{};
  }
  T gx[kRows<T, W>];
#pragma unroll
  for (int k = 0; k < kRows<T, W>; ++k) {
    const int y = y0 + k;
    gx[k] = G && in && y < y1 && (xv == 0 || xv == nx - 1)
                ? g[(xv == 0 ? 0 : n) + y]
                : T(0);
  }
  const V gyl = G && in && y0 == 0 ? load<T, W>(g + 2 * n + x0) : V{};
  const V gyh = G && in && y1 == n ? load<T, W>(g + 3 * n + x0) : V{};

  // every lane of a warp takes the same steps, for the shuffles
#pragma unroll
  for (int k = 0; k < kRows<T, W>; ++k) {
    const int y = y0 + k;
    const V& c = v[k + 1];
    const T from_lo = __shfl_up_sync(kFull, c.a[W - 1], 1);
    const T from_hi = __shfl_down_sync(kFull, c.a[0], 1);
    if (in && y < y1) {
      T lox, hix;
      if (xv == 0)
        lox = c0 * c.a[0] + two * gx[k];
      else
        lox = lane ? from_lo : up[y * n - 1];
      if (xv == nx - 1)
        hix = c1 * c.a[W - 1] + two * (!G ? T(0) : xv == 0 ? g[n + y] : gx[k]);
      else
        hix = lane != 31 ? from_hi : up[y * n + W];
      const V loy = y == 0 ? ghost<T, W>(c2, c, gyl) : v[k];
      const V hiy = y == n - 1 ? ghost<T, W>(c3, c, gyh) : v[k + 2];
      V o;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const T uc = c.a[i];
        const T lx = i > 0 ? c.a[i - 1] : lox;
        const T rx = i < W - 1 ? c.a[i + 1] : hix;
        o.a[i] = (lx - two * uc + rx) * hx + (loy.a[i] - two * uc + hiy.a[i]) * hy;
      }
      store<T, W>(op + y * n, o);
    }
  }
}

template <typename T, int W, bool G>
int launch_width(const void* u, const void* gf, const void* coef,
                 const void* h2, void* out, long long P, int n,
                 cudaStream_t stream) {
  const int chunks = (n + kRows<T, W> - 1) / kRows<T, W>;
  const long long walkers = P * chunks * (n / W);
  const long long blocks = (walkers + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  ghost_stencil_2d_kernel<T, W, G>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(u), static_cast<const T*>(gf),
          static_cast<const T*>(coef), static_cast<const T*>(h2),
          static_cast<T*>(out), n, chunks, walkers);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* gf, const void* coef, const void* h2,
           void* out, long long P, int n, void* stream) {
  if (P <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (n > 46340) return cudaErrorInvalidValue;  // n * n fits an int
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = static_cast<int>(16 / sizeof(T));
  const bool vec = vector_width<T>(u, gf, out, n) > 1;
  if (gf == nullptr)
    return vec ? launch_width<T, V, false>(u, gf, coef, h2, out, P, n, s)
               : launch_width<T, 1, false>(u, gf, coef, h2, out, P, n, s);
  return vec ? launch_width<T, V, true>(u, gf, coef, h2, out, P, n, s)
             : launch_width<T, 1, true>(u, gf, coef, h2, out, P, n, s);
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

// elements per thread the launch above takes for these arguments
extern "C" int pps_ghost_stencil_vector_width(const void* u, const void* gf,
                                              const void* out, int n,
                                              int elem_bytes) {
  return elem_bytes == 4 ? vector_width<float>(u, gf, out, n)
                         : vector_width<double>(u, gf, out, n);
}

extern "C" const char* pps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
