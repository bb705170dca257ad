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
// coef [P, 6]; h2 [P, 3] = (1/hx^2, 1/hy^2, 1/hz^2).  Any n from 1 to 512.
//
// What bounds it on the H100: bytes.  It does about 14 flops per cell
// against a compulsory (2 n^3 + 6 n^2) * sizeof(T) bytes per patch (read u
// and gf once, write out once), far below the card's flop/byte balance: at
// the 3D bench shape (P=624, n=32) 178.9 MB in f32 and 357.8 MB in f64, a
// floor of 53 us and 107 us at 3.35 TB/s.  The fields exceed the 50 MB L2,
// so the kernel streams from device memory, and what it has to get right is
// few, wide memory instructions and enough bytes in flight.
//
// Design: a block owns a tile of the xy plane (whole rows; the whole plane
// when it has at most kTile threads) and a slab of kSlab z planes of one
// patch (thinner slabs when a launch has too few blocks to fill the card),
// and marches along z.  Each thread owns W elements of a row in each of R
// consecutive rows, 16 bytes of a plane: on the vector path W = 16 bytes /
// sizeof(T) (float4, double2) and R = 1.  The planes stream through a ring
// of kDepth + 2 slots in shared memory: while plane z computes, the block
// copies plane z + kDepth + 1 into the ring with cp.async, so the bytes in
// flight are set by the ring, not by the registers.  A plane's tile and its
// halo rows are one contiguous span of u, which the block's threads copy as
// 16-byte chunks.  Each element of u comes from device memory once, plus
// the plane below the slab (loaded into registers before the march), the
// one above it and a halo row at each edge of a y tile narrower than the
// patch, which the neighbouring blocks also read, mostly from L2.  A step
// reads the thread's rows at z and z+1 from the ring (one barrier per
// plane), keeps z-1 in registers, takes +-y from its own rows or the ring
// and +-x of a vector's end elements from the neighbouring lanes by shuffle
// (from the ring where a row crosses a warp, and always at W=1).  A
// plane's slot also holds its x-face entries (copied by the end lanes of
// the rows) and its y-face vectors (copied by rows y=0 and y=n-1); the z
// faces are read in the two steps that need them.  out is written with
// streaming stores.  coef is held in registers (float) or read where a
// ghost needs it (double); the only divisions are in the block and thread index set-up.  Consecutive blocks
// walk consecutive slabs of one patch, so the blocks in flight stream
// neighbouring memory.
//
// n not a multiple of the vector, or u, gf or out not 16-byte aligned (a
// view at an element offset): the same kernel at W=1, chosen by
// pps_ghost_stencil_vector_width, with R = 4 rows (float) or 2 (double) per
// thread, so that a step still moves 16 bytes per thread.  Its spans are
// copied as 16-byte chunks too: a span that does not start on a 16-byte
// boundary is copied from the boundary below it, and its first element
// sits `lead` elements into the slot.  The few bytes before and after the
// span that this copies lie in the same aligned 16 bytes as an element of
// u, so in u's allocation.
//
// ptxas (sm_90a, CUDA 12.8), under __launch_bounds__(512, 2): 60 registers
// at <float, 4>, 64 at <double, 2>, <float, 1> and <double, 1>; 8 bytes
// spilled at <float, 1>, none in the others.  The tile, slab and ring depth
// were chosen by timing variants at the bench shape (PERF.md).  The kernel allocates nothing,
// launches on the caller's stream and does not synchronise.
//
// No-gf mode: a null gf pointer means the ghost is coef * u_b and gf is not
// read (the template's G = false: no face entries are copied into the
// ring).  The sharded apply launches it on its own rows while the cut-face
// exchange is in flight and adds the face term 2 * h2 * gf afterwards, on
// the boundary cells.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kTile = 256;  // most vectors (threads) in a block's plane tile
constexpr int kSlab = 8;    // z planes a block marches
constexpr int kDepth = 3;   // planes in flight ahead of the two a step reads
constexpr int kSlots = kDepth + 2;

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

// asynchronous copy of B bytes from device to shared memory (cp.async)
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(B)
                 : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int vector_width(const void* u, const void* gf, const void* out, int n) {
  constexpr int w = 16 / sizeof(T);
  return n % w == 0 && aligned16(u) && aligned16(gf) && aligned16(out) ? w : 1;
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// bytes of a slot's span: rows + 2 rows of u and up to 16 bytes of lead and
// tail around them
template <typename T>
__host__ __device__ int span_bytes(int rows, int n) {
  return round16((rows + 2) * n * static_cast<int>(sizeof(T)) + 16);
}

// bytes of one slot of the shared ring: the span, the plane's y-face
// entries (2 n) and its x-face entries (2 rows)
template <typename T>
__host__ __device__ int slot_bytes(int rows, int n) {
  return span_bytes<T>(rows, n) + round16(2 * n * static_cast<int>(sizeof(T))) +
         round16(2 * rows * static_cast<int>(sizeof(T)));
}

// rows of the plane each thread owns: 16 bytes of a plane per thread on
// every path (1 on the vector path; 4 in f32 and 2 in f64 at W=1)
template <typename T, int W>
constexpr int kRowsPerThread = 16 / (static_cast<int>(sizeof(T)) * W);

// blockDim.x = n / W vectors times the tile's thread rows, rounded up to
// whole warps; grid = P * ytiles * slabs blocks, slab fastest; G: gf is read
// (else the ghost is coef * u_b)
template <typename T, int W, bool G>
__global__ void __launch_bounds__(kMaxThreads, 2)
    ghost_stencil_3d_kernel(const T* __restrict__ u, const T* __restrict__ gf,
                            const T* __restrict__ coef,
                            const T* __restrict__ h2, T* __restrict__ out,
                            int n, int rows, int ytiles, int slab,
                            int slabs) {
  using V = Pack<T, W>;
  constexpr int R = kRowsPerThread<T, W>;
  // <double, 1> reads h2 and the z faces where it uses them: held in
  // registers they would push it past the 64-register ceiling into spills
  constexpr bool kLean = sizeof(T) == 8 && W == 1;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nx = n / W;  // vectors per row
  const int m = n * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid / nx;  // thread row
  const int xv = tid - ty * nx;
  const int x0 = xv * W;
  int b = blockIdx.x;
  const int s = b % slabs;
  b /= slabs;
  const int y0 = (b % ytiles) * rows;  // the tile's first row
  const int yend = min(y0 + rows, n);  // and its end
  const int yt = y0 + ty * R;          // this thread's first row
  const int64_t p = b / ytiles;
  const bool live = yt < yend;
  const int r = live ? yt * n + x0 : 0;  // offset in the plane
  const int z0 = s * slab;
  const int z1 = min(z0 + slab, n);
  const int zlast = min(z1, n - 1);  // the last plane the slab reads
  // a slot holds rows ylo .. yend of its plane: the tile and its halo rows
  const int ylo = max(y0 - 1, 0);
  const int span = (min(yend + 1, n) - ylo) * n;
  const int me = live ? (yt - ylo) * n + x0 : 0;  // this vector in the span
  const int sb = slot_bytes<T>(rows, n);
  const int yf_at = span_bytes<T>(rows, n);
  const int xf_at = yf_at + round16(2 * n * static_cast<int>(sizeof(T)));

  const T* up = u + p * m * n;
  T* op = out + p * m * n;
  const T* g = G ? gf + p * 6 * m : nullptr;
  // coef is held in registers in float; in double, whose registers are
  // scarcer, it is read where a ghost needs it
  const T* cp = coef + p * 6;
  T cr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) cr[i] = sizeof(T) == 4 ? cp[i] : T(0);
  auto cf = [&](int i) { return sizeof(T) == 4 ? cr[i] : __ldg(cp + i); };
  const T* hp = h2 + p * 3;
  T hr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) hr[i] = kLean ? T(0) : hp[i];
  auto h = [&](int i) { return kLean ? __ldg(hp + i) : hr[i]; };
  const T two = T(2);

  // elements between the 16-byte boundary below plane q's span and its
  // first element (0 on the vector path, where u and n*sizeof(T) are
  // 16-byte aligned)
  auto lead = [&](int q) -> int {
    if constexpr (W > 1) return 0;
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(up + q * m + ylo * n) & 15u) / sizeof(T));
  };
  // plane q (q = z0 .. zlast) lives in slot (q - z0) % kSlots; the block
  // copies its span in 16-byte chunks, rows y=0 and y=n-1 the y-face
  // entries and the end lanes of a row the x-face entries.  One commit
  // group per plane, empty or not.
  auto issue = [&](int q) {
    if (q <= zlast) {
      unsigned char* slot = smem + (q - z0) % kSlots * sb;
      const int ld = lead(q);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          up + q * m + ylo * n - ld);
      const int chunks = ((ld + span) * static_cast<int>(sizeof(T)) + 15) / 16;
      for (int c = tid; c < chunks; c += blockDim.x)
        copy_async<16>(slot + 16 * c, src + 16 * c);
      T* yf = reinterpret_cast<T*>(slot + yf_at);
      T* xf = reinterpret_cast<T*>(slot + xf_at);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int y = yt + k;
        if (G && y < yend) {
          if (y == 0) copy_async<sizeof(V)>(yf + x0, g + 2 * m + q * n + x0);
          if (y == n - 1)
            copy_async<sizeof(V)>(yf + n + x0, g + 3 * m + q * n + x0);
          if (xv == 0) copy_async<sizeof(T)>(xf + y - y0, g + q * n + y);
          if (xv == nx - 1)
            copy_async<sizeof(T)>(xf + rows + y - y0, g + m + q * n + y);
        }
      }
    }
    commit_copies();
  };

  for (int q = z0; q <= z0 + kDepth; ++q) issue(q);
  // the plane below the slab, straight from device memory
  V zm[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    zm[k] = z0 > 0 && yt + k < yend ? load<T, W>(up + (z0 - 1) * m + r + k * n)
                                    : V{};

  for (int z = z0; z < z1; ++z) {
    // the z faces, read in the step that needs them (z = 0, z = n-1), so
    // that they hold no register across the loop
    V gz[R];
#pragma unroll
    for (int k = 0; k < R; ++k)
      gz[k] = G && !kLean && yt + k < yend && (z == 0 || z == n - 1)
                  ? load<T, W>(g + (z == 0 ? 4 : 5) * m + r + k * n)
                  : V{};
    // planes up to z+1 have landed; kDepth - 1 more may be in flight
    wait_copies<kDepth - 1>();
    __syncthreads();
    const unsigned char* slot = smem + (z - z0) % kSlots * sb;
    const T* t = reinterpret_cast<const T*>(slot) + lead(z) + me;
    const T* tp =
        reinterpret_cast<const T*>(smem + (z - z0 + 1) % kSlots * sb) +
        lead(z + 1) + me;
    V c[R], zp[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool in = yt + k < yend;
      c[k] = in ? load<T, W>(t + k * n) : V{};
      zp[k] = in && z + 1 < n ? load<T, W>(tp + k * n) : V{};
    }
    // into the slot of plane z-1, which every thread has finished with
    issue(z + kDepth + 1);
    const T* yf = reinterpret_cast<const T*>(slot + yf_at);
    const T* xf = reinterpret_cast<const T*>(slot + xf_at);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      // +-x: the neighbouring lanes' vectors; at W=1 the ring's elements,
      // which are as near and need no shuffle
      T from_lo = T(0), from_hi = T(0);
      if constexpr (W > 1) {
        from_lo = __shfl_up_sync(kFull, c[k].a[W - 1], 1);
        from_hi = __shfl_down_sync(kFull, c[k].a[0], 1);
      }
      const int y = yt + k;
      if (y < yend) {
        const T* tk = t + k * n;
        T lox, hix;
        if (xv == 0)
          lox = cf(0) * c[k].a[0] + two * (G ? xf[y - y0] : T(0));
        else
          lox = W > 1 && lane ? from_lo : tk[-1];
        if (xv == nx - 1)
          hix = cf(1) * c[k].a[W - 1] + two * (G ? xf[rows + y - y0] : T(0));
        else
          hix = W > 1 && lane != 31 ? from_hi : tk[W];
        // +-y: the thread's own rows, else the ring's (a halo row at the
        // tile's edge); rows are whole multiples of R within a tile
        const V loy = y == 0 ? ghost<T, W>(cf(2), c[k], G ? load<T, W>(yf + x0) : V{})
                      : k > 0 ? c[k - 1]
                              : load<T, W>(tk - n);
        const V hiy = y == n - 1
                          ? ghost<T, W>(cf(3), c[k], G ? load<T, W>(yf + n + x0) : V{})
                      : k < R - 1 ? c[k + 1]
                                  : load<T, W>(tk + n);
        const V loz =
            z == 0 ? ghost<T, W>(cf(4), c[k],
                                 G && kLean ? load<T, W>(g + 4 * m + r + k * n) : gz[k])
                   : zm[k];
        // (n = 1: the one plane needs both z faces)
        const V hiz =
            z == n - 1
                ? ghost<T, W>(cf(5), c[k],
                              G && (kLean || z == 0)
                                  ? load<T, W>(g + 5 * m + r + k * n)
                                  : gz[k])
                : zp[k];
        V o;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const T uc = c[k].a[i];
          const T lx = i > 0 ? c[k].a[i - 1] : lox;
          const T rx = i < W - 1 ? c[k].a[i + 1] : hix;
          o.a[i] = (lx - two * uc + rx) * h(0) +
                   (loy.a[i] - two * uc + hiy.a[i]) * h(1) +
                   (loz.a[i] - two * uc + hiz.a[i]) * h(2);
        }
        store<T, W>(op + z * m + r + k * n, o);
      }
      zm[k] = c[k];
    }
  }
  wait_copies<0>();  // no copy outlives the block
}

template <typename T, int W, bool G>
int launch_width(const void* u, const void* gf, const void* coef,
                 const void* h2, void* out, long long P, int n,
                 cudaStream_t stream) {
  constexpr int R = kRowsPerThread<T, W>;
  const int nx = n / W;
  // at most kTile threads of R rows each, whole rows, whole patch rows
  const int rows = std::min(n, std::max(1, kTile / nx) * R);
  const int threads = (nx * ((rows + R - 1) / R) + 31) / 32 * 32;
  const int ytiles = (n + rows - 1) / rows;
  // few patches: thinner slabs, so that the blocks fill the card rather than
  // march their planes one after another
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int slab = std::min(n, kSlab);
  while (slab > 1 && P * ytiles * ((n + slab - 1) / slab) < 2LL * sms) slab /= 2;
  const int slabs = (n + slab - 1) / slab;
  const long long blocks = P * ytiles * slabs;
  const int smem = kSlots * slot_bytes<T>(rows, n);
  if (threads > kMaxThreads || blocks > INT_MAX || smem > 227 * 1024)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ghost_stencil_3d_kernel<T, W, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ghost_stencil_3d_kernel<T, W, G>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(gf),
      static_cast<const T*>(coef), static_cast<const T*>(h2),
      static_cast<T*>(out), n, rows, ytiles, slab, slabs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* gf, const void* coef, const void* h2,
           void* out, long long P, int n, void* stream) {
  if (P <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (n > kMaxThreads) return cudaErrorInvalidValue;
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
