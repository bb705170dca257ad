// One block-Jacobi sweep of exact spectral patch solves on a batch of 2D
// patches, for Hopper (sm_90a), in float and double, at n = 8, 16 and 32.
// The file is built once per precision, float by default and double with
// -DPPS_SWEEP_F64 (ops/patch_sweep.py), so that the two builds of its
// three instances each run side by side.
//
// Per solved patch slot (SchurHelper::solveWithSolution,
// FftwPatchSolver.h:173-206):
//
//   1. fold: f - 2 * h2[axis] * gf[side] on the boundary cells, one term at a
//      time in the sides' order x_lo, x_hi, y_lo, y_hi, each product rounded
//      before it is subtracted (level_ops._fold_faces_flat);
//   2. the forward transforms of the slot's kinds, x then y;
//   3. the divide by lam_y[i] + lam_x[k], summed in f64 and cast afterwards
//      (the bit pattern of level_ops._denom_of), and the DC mode set to 0 for
//      an all-Neumann patch;
//   4. the inverse transforms, x then y, and the (2/n)^2 scale;
//   5. the write of u.
//
// Any other slot of the level (an active-set sweep's inactive patches) gets
// base[slot], or 0 without a base.  It replaces the plain chain of the sweep
// (ops/patch_sweep.py: _fold_faces_flat, _spectral_apply and _scatter): on
// the TPU the reference runs that chain as XLA ops, the products in the
// Kronecker form on the matrix unit (pressurepoissonsolver_tpu/ops/
// level_ops.py::_spectral_apply); it has no Pallas kernel of its own.
//
// Inputs: f, base, out [P, n, n] (x fastest) over the level's slots; per
// solve slot c (the slot itself, or inv[slot] with an active set: a solve
// slot when inv[slot] < ps), gf [ps, 4, n] (x faces by row y, y faces by
// column x; null: no fold), h2 [ps, 2], code[c] (3 bits each: forward kind
// of x, of y, inverse kind of x, of y; bit 12 the DC pin), lam_rows [ps, 2]
// (its rows of lam for x and y), lam [K, n] f64; tm [6, n, n] the transform
// matrices of the six kinds (transforms.transform_matrix, y = T x).
//
// What bounds it on the H100: bytes.  At n = 16 a solved cell reads f and
// writes u (8 bytes in f32), plus a quarter of a gf entry, while the four
// 16 x 16 products cost 4 * 2n = 128 flops: 15 flops a byte against the
// card's 67 TFLOP/s / 3.35 TB/s = 20.  The products' operands come from
// shared memory, 2 bytes a multiply-add at 4 x 4 thread tiles, so shared
// memory and the latency between the steps come next.  The design keeps
// every intermediate on chip and the arithmetic close to the loads:
//
// * a patch is TPP threads of one warp (n = 16: 16 threads, two patches a
//   warp), each holding a 4 x TN tile of the patch in registers; a product
//   reads its operands from shared memory as 16-byte vectors (4 elements of
//   a row; 4 + TN vectors give 16 * TN FMAs) and a thread keeps its sums;
// * between two products a tile goes to the patch's buffer in shared
//   memory, row-major or transposed, so that each product reads rows of
//   both operands; the six transform matrices sit beside the buffers, read
//   by every patch of the block;
// * rows are stored with their 4-element chunks permuted by the row's
//   4-row block (off() below), and the two patches of a warp lie half a
//   128-byte line apart, so that the row vectors one instruction reads or
//   writes fall in distinct banks; a thread's rows share one permutation,
//   so each address is a row base, an immediate and a chunk offset;
// * the threads of a patch synchronise with __syncwarp only: no block
//   barrier after the matrices are staged;
// * the grid is persistent (the blocks the card holds at once), each block
//   walking over groups of patches; a second buffer per patch is filled by
//   cp.async (f or base, the face entries and the slot's scalars) one group
//   ahead, so that device memory is read while the current group is solved.
//
// Larger thread tiles (fewer shared-memory bytes a multiply-add) and
// half-size products on the kinds with a mirror symmetry were measured
// slower: register pressure and the latency between steps outweighed them;
// so was a thread per row of the patch (the same matrix entry in every
// lane), with the entries as constant-bank operands of the FMAs or
// broadcast from shared memory (PERF.md, section 6).
//
// Full precision: IEEE division and no fast math, the products and sums in
// the field's type on the CUDA cores (FMA), summed along each axis in index
// order.  The plain chain's f32 Kronecker form (n <= PPS_KRON_MAX_N) sums
// the same products associated through [n^2, n^2] matrices, so the two agree
// to rounding, not bit for bit.  The kernel allocates nothing, launches on
// the caller's stream and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kKinds = 6;

// a solve slot's scalars, copied into shared memory with its tile
template <typename T>
struct Meta {
  int lx, ly;  // its rows of lam
  int code;    // its transforms (see the head of the file)
  int c;       // its solve slot; -1: not solved (written by the issuing lane)
  T hx, hy;    // its h2
};

template <typename T, int N>
struct Cfg {
  static constexpr int TM = 4;                // tile rows a thread holds
  static constexpr int TN = N == 32 ? 8 : 4;  // tile columns
  static constexpr int RB = N / TM;           // row blocks of a patch
  static constexpr int CB = N / TN;           // column blocks
  static constexpr int TPP = RB * CB;         // threads a patch
  static constexpr int PPW = 32 / TPP;        // patches a warp
  static constexpr int PPB = kThreads / 32 * PPW;
  static constexpr int NC = N / 4;            // 4-element chunks a row
  static constexpr int PAD = 64 / static_cast<int>(sizeof(T));  // half a line
  static constexpr int STRIDE = N * N + PAD;  // elements of a patch buffer
  static constexpr int GF = 4 * N;            // face entries of a slot
  // the ring's stages: the group being solved and the next one (a third
  // measured slower)
  static constexpr int STAGES = 2;
  static constexpr size_t SMEM =
      (static_cast<size_t>(STAGES) * PPB * (STRIDE + GF) + kKinds * N * N) * sizeof(T) +
      static_cast<size_t>(STAGES) * PPB * sizeof(Meta<T>);
  static_assert(TPP * PPW == 32, "a patch's threads lie in one warp");
};

// element offset of chunk ch (elements 4ch .. 4ch+3) of row r in a swizzled
// n x n tile: the chunk index is permuted by the row's 4-row block
template <int N>
__device__ __forceinline__ int off(int r, int ch) {
  return r * N + ((ch ^ ((r >> 2) & (N / 4 - 1))) << 2);
}

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

// asynchronous copies from device memory into shared memory (cp.async):
// BYTES of src, or zeros with fill = false
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(BYTES));
  }
}

// the 4 elements at src into dst (16 or 32 bytes)
template <typename T>
__device__ __forceinline__ void copy4_async(T* dst, const T* src) {
  copy_async<16>(dst, src);
  if constexpr (sizeof(T) == 8) copy_async<16>(dst + 2, src + 2);
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

template <typename T>
struct Args {
  const T* f;
  const T* gf;
  const T* h2;
  const int* code;
  const int* lam_rows;
  const double* lam;
  const T* tm;
  const long long* inv;
  const T* base;
  T* out;
  long long P;
  long long ps;
};

// a stage of the ring: per patch of the block its tile buffer (the tile as
// read, then the intermediates of its solve), its face entries and scalars
template <typename T, int N>
struct Stage {
  T* buf;
  T* gf;
  Meta<T>* meta;
};

// issue the copies of level slot p into stage s (this thread's part): its
// tile from f (a solve slot) or base (another slot; none without a base),
// and for a solve slot its face entries and, by the patch's first lane, its
// scalars
template <typename T, int N>
__device__ __forceinline__ void issue(const Args<T>& a, long long p, const Stage<T, N>& s,
                                      int r0, int c0) {
  using C = Cfg<T, N>;
  if (p >= a.P) return;
  const long long c = a.inv ? a.inv[p] : p;
  const bool solve = c < a.ps;
  if (r0 == 0 && c0 == 0) s.meta->c = solve ? static_cast<int>(c) : -1;
  const T* src = solve ? a.f : a.base;
  if (src) {
    src += p * N * N;
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
#pragma unroll
      for (int j = 0; j < C::TN; j += 4) {
        copy4_async(s.buf + off<N>(r0 + i, (c0 + j) >> 2), src + (r0 + i) * N + c0 + j);
      }
    }
  }
  if (!solve) return;
  if (r0 == 0 && c0 == 0) {
    copy_async<8>(&s.meta->lx, a.lam_rows + 2 * c);
    copy_async<4>(&s.meta->code, a.code + c);
    if (a.gf) copy_async<2 * sizeof(T)>(&s.meta->hx, a.h2 + 2 * c);
  }
  if (a.gf) {
    const T* g = a.gf + c * C::GF;
    if (c0 == 0 || c0 + C::TN == N) {
      const int side = c0 == 0 ? 0 : N;
#pragma unroll
      for (int i = 0; i < C::TM; i += 4) copy4_async(s.gf + side + r0 + i, g + side + r0 + i);
    }
    if (r0 == 0 || r0 + C::TM == N) {
      const int side = r0 == 0 ? 2 * N : 3 * N;
#pragma unroll
      for (int j = 0; j < C::TN; j += 4) copy4_async(s.gf + side + c0 + j, g + side + c0 + j);
    }
  }
}

// The chunk permutation of rows r0 .. r0 + 3 (r0 a multiple of 4): off()'s
// for those rows, so that an address in a tile is a row base, an immediate
// and one of NC chunk offsets
template <int N>
__device__ __forceinline__ int block_swz(int r0) {
  return (r0 >> 2) & (N / 4 - 1);
}

// acc[i][j] = sum over q of A[r0 + i][q] * B[c0 + j][q], both swizzled
// row-major n x n tiles in shared memory, q in index order
template <typename T, int N>
__device__ __forceinline__ void product(const T* A, const T* B, int r0, int c0,
                                        T (&acc)[Cfg<T, N>::TM][Cfg<T, N>::TN]) {
  using C = Cfg<T, N>;
  const T* a0 = A + r0 * N;
  const T* b0 = B + c0 * N;
  const int sa = block_swz<N>(r0), sb = block_swz<N>(c0);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = T(0);
  }
#pragma unroll
  for (int ch = 0; ch < C::NC; ++ch) {
    T av[C::TM][4], bv[C::TN][4];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) ld4(a0 + i * N + ((ch ^ sa ^ (i >> 2)) << 2), av[i]);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) ld4(b0 + j * N + ((ch ^ sb ^ (j >> 2)) << 2), bv[j]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = fmadd(av[i][q], bv[j][q], acc[i][j]);
      }
    }
  }
}

// the tile as rows r0.. of buf
template <typename T, int N>
__device__ __forceinline__ void put_rows(T* buf, int r0, int c0,
                                         const T (&t)[Cfg<T, N>::TM][Cfg<T, N>::TN]) {
  using C = Cfg<T, N>;
  T* b = buf + r0 * N;
  const int s = block_swz<N>(r0) ^ (c0 >> 2);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
#pragma unroll
    for (int j = 0; j < C::TN; j += 4) st4(b + i * N + ((s ^ (i >> 2) ^ (j >> 2)) << 2), &t[i][j]);
  }
}

// the tile transposed: its column j as row c0 + j of buf
template <typename T, int N>
__device__ __forceinline__ void put_cols(T* buf, int r0, int c0,
                                         const T (&t)[Cfg<T, N>::TM][Cfg<T, N>::TN]) {
  using C = Cfg<T, N>;
  T* b = buf + c0 * N;
  const int s = block_swz<N>(c0) ^ (r0 >> 2);
#pragma unroll
  for (int j = 0; j < C::TN; ++j) {
#pragma unroll
    for (int i = 0; i < C::TM; i += 4) {
      const T v[4] = {t[i][j], t[i + 1][j], t[i + 2][j], t[i + 3][j]};
      st4(b + j * N + ((s ^ (j >> 2) ^ (i >> 2)) << 2), v);
    }
  }
}

// the tile at rows r0.., columns c0.. of buf, into registers
template <typename T, int N>
__device__ __forceinline__ void get_rows(const T* buf, int r0, int c0,
                                         T (&t)[Cfg<T, N>::TM][Cfg<T, N>::TN]) {
  using C = Cfg<T, N>;
  const T* b = buf + r0 * N;
  const int s = block_swz<N>(r0) ^ (c0 >> 2);
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
#pragma unroll
    for (int j = 0; j < C::TN; j += 4) ld4(b + i * N + ((s ^ (i >> 2) ^ (j >> 2)) << 2), &t[i][j]);
  }
}

// the solve of the slot staged in s, written to level slot p
template <typename T, int N>
__device__ __forceinline__ void solve(const Args<T>& a, long long p, const Stage<T, N>& s,
                                      const T* tm, int r0, int c0, unsigned mask) {
  using C = Cfg<T, N>;
  constexpr int NN = N * N;
  const Meta<T> m = *s.meta;
  T acc[C::TM][C::TN];
  const bool xf = c0 == 0 || c0 + C::TN == N, yf = r0 == 0 || r0 + C::TM == N;
  if (a.gf && (xf || yf)) {
    // the fold, on this thread's own cells of the staged tile: x faces on
    // column 0 / n-1, then y faces on row 0 / n-1, one term at a time
    const int bx = c0 == 0 ? 0 : C::TN - 1;
    const int ay = r0 == 0 ? 0 : C::TM - 1;
    const T* gx = s.gf + (c0 == 0 ? 0 : N) + r0;
    const T* gy = s.gf + (r0 == 0 ? 2 * N : 3 * N) + c0;
    get_rows<T, N>(s.buf, r0, c0, acc);
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        if (xf && j == bx) acc[i][j] = sub_rn(acc[i][j], T(2) * mul_rn(m.hx, gx[i]));
        if (yf && i == ay) acc[i][j] = sub_rn(acc[i][j], T(2) * mul_rn(m.hy, gy[j]));
      }
    }
    put_rows<T, N>(s.buf, r0, c0, acc);
  }
  const T* fx = tm + (m.code & 7) * NN;
  const T* fy = tm + ((m.code >> 3) & 7) * NN;
  const T* ix = tm + ((m.code >> 6) & 7) * NN;
  const T* iy = tm + ((m.code >> 9) & 7) * NN;
  __syncwarp(mask);
  product<T, N>(s.buf, fx, r0, c0, acc);  // X[y][k]: f transformed along x
  __syncwarp(mask);
  put_cols<T, N>(s.buf, r0, c0, acc);  // X^T
  __syncwarp(mask);
  product<T, N>(fy, s.buf, r0, c0, acc);  // Y[i][k]: then along y
  const double* ly = a.lam + static_cast<long long>(m.ly) * N;
  const double* lx = a.lam + static_cast<long long>(m.lx) * N;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const double yv = __ldg(ly + r0 + i);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = acc[i][j] / static_cast<T>(yv + __ldg(lx + c0 + j));
  }
  if (((m.code >> 12) & 1) && r0 == 0 && c0 == 0) acc[0][0] = T(0);
  __syncwarp(mask);
  put_rows<T, N>(s.buf, r0, c0, acc);  // Z[i][k]
  __syncwarp(mask);
  product<T, N>(s.buf, ix, r0, c0, acc);  // W[i][j]: inverse along x
  __syncwarp(mask);
  put_cols<T, N>(s.buf, r0, c0, acc);  // W^T
  __syncwarp(mask);
  product<T, N>(iy, s.buf, r0, c0, acc);  // U[y][j]: inverse along y
  constexpr double kScale = (2.0 / N) * (2.0 / N);
  T* op = a.out + p * NN;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] *= static_cast<T>(kScale);
#pragma unroll
    for (int j = 0; j < C::TN; j += 4) st4(op + (r0 + i) * N + c0 + j, &acc[i][j]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
    patch_sweep_kernel(const Args<T> a) {
  using C = Cfg<T, N>;
  constexpr int NN = N * N;
  constexpr int S = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tm = reinterpret_cast<T*>(smem);        // [6][n][n], swizzled
  T* ring = tm + kKinds * NN;               // [S][PPB][STRIDE]
  T* gring = ring + S * C::PPB * C::STRIDE;  // [S][PPB][4n]
  Meta<T>* mring = reinterpret_cast<Meta<T>*>(gring + S * C::PPB * C::GF);  // [S][PPB]
  for (int e = threadIdx.x; e < kKinds * NN / 4; e += kThreads) {
    const int k = e / (NN / 4), r = (e % (NN / 4)) / C::NC, ch = e % C::NC;
    T v[4];
    ld4(a.tm + k * NN + r * N + 4 * ch, v);
    st4(tm + k * NN + off<N>(r, ch), v);
  }
  // lane = ((rb * PPW) + patch of the warp) * CB + cb: the lanes of one
  // instruction's quarter warp hold both patches of the warp (n = 16)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cb = lane % C::CB, pw = (lane / C::CB) % C::PPW, rb = lane / (C::CB * C::PPW);
  const int r0 = rb * C::TM, c0 = cb * C::TN;
  const int pb = warp * C::PPW + pw;  // the patch's place in the block
  auto stage = [&](long long it) {
    const int k = static_cast<int>(it % S) * C::PPB + pb;
    return Stage<T, N>{ring + k * C::STRIDE, gring + k * C::GF, mring + k};
  };
  const long long groups = (a.P + C::PPB - 1) / C::PPB;
  auto slot = [&](long long it) {  // the level slot of this patch at step it
    return (blockIdx.x + it * gridDim.x) * static_cast<long long>(C::PPB) + pb;
  };
  // the ring: the copies of steps it+1 .. it+S-1 are in flight while step
  // it is solved; each thread reads only what it copied until the
  // __syncwarp after its wait, which makes the others' copies visible
#pragma unroll
  for (int it = 0; it < S - 1; ++it) {
    issue<T, N>(a, slot(it), stage(it), r0, c0);
    commit_async();
  }
  __syncthreads();  // the transforms are staged
  for (long long it = 0; blockIdx.x + it * gridDim.x < groups; ++it) {
    __syncwarp();  // step it-1 is done with the stage step it+S-1 takes
    issue<T, N>(a, slot(it + S - 1), stage(it + S - 1), r0, c0);
    commit_async();
    wait_async<S - 1>();
    __syncwarp();
    const long long p = slot(it);
    const Stage<T, N> s = stage(it);
    const bool solved = p < a.P && s.meta->c >= 0;
    const unsigned mask = __ballot_sync(kFull, solved);
    if (solved) {
      solve<T, N>(a, p, s, tm, r0, c0, mask);
    } else if (p < a.P) {
      // another slot: its base, or 0
      T* op = a.out + p * NN;
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
#pragma unroll
        for (int j = 0; j < C::TN; j += 4) {
          T v[4] = {T(0), T(0), T(0), T(0)};
          if (a.base) ld4(s.buf + off<N>(r0 + i, (c0 + j) >> 2), v);
          st4(op + (r0 + i) * N + c0 + j, v);
        }
      }
    }
  }
  wait_async<0>();
}

constexpr int kMaxDevices = 64;

template <typename T, int N>
int launch(const Args<T>& a, void* stream) {
  using C = Cfg<T, N>;
  if (a.P <= 0) return static_cast<int>(cudaGetLastError());
  // the blocks one SM holds, per device, found at its first launch (an
  // eager one: a capture's warm-up runs first)
  static int per_sm[kMaxDevices];
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0) {
    if (C::SMEM > 48 * 1024) {
      err = cudaFuncSetAttribute(patch_sweep_kernel<T, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(C::SMEM));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, patch_sweep_kernel<T, N>,
                                                        kThreads, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm[dev] = blocks > 0 ? blocks : 1;
  }
  const long long groups = (a.P + C::PPB - 1) / C::PPB;
  const long long most = static_cast<long long>(per_sm[dev]) * sms[dev];
  const unsigned grid = static_cast<unsigned>(groups < most ? groups : most);
  patch_sweep_kernel<T, N><<<grid, kThreads, C::SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* f, const void* gf, const void* h2, const void* code,
             const void* lam_rows, const void* lam, const void* tm, const void* inv,
             long long ps, const void* base, void* out, long long P, int n, void* stream) {
  const Args<T> a{static_cast<const T*>(f),        static_cast<const T*>(gf),
                  static_cast<const T*>(h2),       static_cast<const int*>(code),
                  static_cast<const int*>(lam_rows), static_cast<const double*>(lam),
                  static_cast<const T*>(tm),       static_cast<const long long*>(inv),
                  static_cast<const T*>(base),     static_cast<T*>(out),
                  P,                               ps};
  switch (n) {
    case 8:
      return launch<T, 8>(a, stream);
    case 16:
      return launch<T, 16>(a, stream);
    case 32:
      return launch<T, 32>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#ifdef PPS_SWEEP_F64
extern "C" int pps_patch_sweep_f64(const void* f, const void* gf, const void* h2,
                                   const void* code, const void* lam_rows, const void* lam,
                                   const void* tm, const void* inv, long long ps,
                                   const void* base, void* out, long long P, int n,
                                   void* stream) {
  return dispatch<double>(f, gf, h2, code, lam_rows, lam, tm, inv, ps, base, out, P, n, stream);
}
#else
extern "C" int pps_patch_sweep_f32(const void* f, const void* gf, const void* h2,
                                   const void* code, const void* lam_rows, const void* lam,
                                   const void* tm, const void* inv, long long ps,
                                   const void* base, void* out, long long P, int n,
                                   void* stream) {
  return dispatch<float>(f, gf, h2, code, lam_rows, lam, tm, inv, ps, base, out, P, n, stream);
}
#endif

extern "C" const char* pps_patch_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
