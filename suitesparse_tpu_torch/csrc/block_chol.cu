// Batched Cholesky of small symmetric blocks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel suitesparse_tpu/cholesky/pallas_kernels.py
// :: _chol_kernel (launched there by _block_chol_call).  For each w of a
// batch of W symmetric Np x Np blocks S it computes
//
//     U = chol(S + diag(pe))^T
//
// upper triangular, with exact zeros below the diagonal.  pe puts a unit
// pivot on padded rows.  The rsqrt of the raw pivot is not clamped, so a
// non-positive pivot comes out as NaN (factorize_super scans for it), and
// no work is skipped on the strength of a value, so the NaN pattern is the
// plain version's.  No atomics: results repeat bit for bit.
//
// What bounds it on this card.  Per matrix the work is ~Np^3/3 flops
// against 2 Np^2 values moved (Np = 128: ~10 flop/byte in f32), so the
// roofline bound of a large batch is the bytes.  But the main path mostly
// launches W <= 4 matrices of Np = 128, which keep at most 4 of the 132
// SMs busy: there the time is the latency of one matrix's chain of
// dependent steps on one SM, and neither bound is near.  The design
// shortens that chain and keeps the copies off it.
//
// Design.  One thread block of 128 or 256 threads per matrix (Np >= 40),
// the matrix in dynamic shared memory (Np = 128: 64 KB in f32, 128 KB in
// f64).  Blocked
// right-looking panels of NB = kNB = 16 columns (a ragged last panel when NB
// does not divide Np), two block barriers a panel where the old kernel
// had two a column:
//   1. one warp factors the NB x NB diagonal block (factor_diag): lane i
//      keeps row i in registers, each pivot and the next two entries of
//      its column travel by __shfl_sync, the rest of the column through
//      shared memory a step later -- no block barrier inside;
//   2. the threads solve the panel rows below it, one row a thread, in
//      registers, against that triangle (TRSM); barrier;
//   3. a register-tiled SYRK updates the lower triangle of the trailing
//      block only: each thread a 4 x 4 tile and an NB-deep loop over the
//      panel, the triangle's tiles folded into a rectangle, whole tiles on
//      or above the diagonal and none below.  The same warps write the
//      panel's rows of U, final now, to global memory.  Meanwhile warp 0
//      applies the update to the next diagonal block and factors it (step
//      1 of the next panel, a look-ahead), so the pivot chain runs beside
//      the SYRK and not after it; barrier.
// The tile arrives by cp.async in two groups: the first NB rows, which the
// first diagonal block and its TRSM read, then the rest, which lands while
// warp 0 factors that block.  Np <= 32 is one diagonal block: one warp per
// matrix, several matrices a thread block, and only __syncwarp.  FMAs run
// on the CUDA cores in the working type (no TF32).  Tensor cores and a
// thread-block cluster that spreads one matrix over several SMs are later
// work.
//
// Layout.  Shared a[c * Np + r] holds L[r, c] for r >= c: row c of the
// tile is column c of L, which is row c of the output U = L^T.  The copies
// in and out are coalesced and 16 bytes a thread.  S is symmetric, so
// reading its row c as column c of the input is exact.  Entries of the
// tile below its diagonal (r < c) keep input values the factor never reads
// back into a result.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kMaxNp = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNB = 16;             // panel width at Np > 32
constexpr int kTile = 4;            // SYRK register tile: kTile x kTile
constexpr int kWarpsSmall = 4;      // matrices a thread block at Np <= 32
constexpr int kMaxDevices = 64;
constexpr int kOneWave = 128;       // W that fits one block an SM (132 SMs)

template <typename T>
__device__ __forceinline__ T rsqrt_t(T x);

template <>
__device__ __forceinline__ float rsqrt_t<float>(float x) { return rsqrtf(x); }

template <>
__device__ __forceinline__ double rsqrt_t<double>(double x) { return rsqrt(x); }

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// 16-byte vectors of T: V elements, at 16-byte aligned addresses
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<double> {
  static constexpr int V = 2;
  __device__ static void load(const double* p, double* v) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
  __device__ static void store(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// kTile consecutive values (16-byte aligned)
template <typename T>
__device__ __forceinline__ void load_tile_row(const T* p, T (&v)[kTile]) {
#pragma unroll
  for (int h = 0; h < kTile; h += Vec<T>::V) Vec<T>::load(p + h, v + h);
}

template <typename T>
__device__ __forceinline__ void store_tile_row(T* p, const T (&v)[kTile]) {
#pragma unroll
  for (int h = 0; h < kTile; h += Vec<T>::V) Vec<T>::store(p + h, v + h);
}

// Global -> shared copy of n values, U loads in flight a thread, 16 bytes
// each when `vec` (every matrix of a batch starts a multiple of 64 values
// after the first, so the base pointers decide for the whole batch).
template <typename T, int U>
__device__ __forceinline__ void copy_in(const T* __restrict__ src, T* dst,
                                        int n, int tid, int nt, bool vec) {
  if (vec) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    const int nv = n * (int)sizeof(T) / 16;
    for (int e = tid; e < nv; e += nt * U) {
      int4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e + u * nt < nv) v[u] = s[e + u * nt];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e + u * nt < nv) d[e + u * nt] = v[u];
    }
  } else {
    for (int e = tid; e < n; e += nt * U) {
      T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e + u * nt < n) v[u] = src[e + u * nt];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e + u * nt < n) dst[e + u * nt] = v[u];
    }
  }
}

// Global -> shared copy of n values (a multiple of 16 bytes, both ends
// 16-byte aligned) with cp.async: every copy in flight at once, nothing
// staged in registers.  The caller commits the group and waits for it.
template <typename T>
__device__ __forceinline__ void copy_in_async(const T* __restrict__ src,
                                              T* dst, int n, int tid,
                                              int nt) {
  const int4* s = reinterpret_cast<const int4*>(src);
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int nv = n * (int)sizeof(T) / 16;
  for (int e = tid; e < nv; e += nt)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d + 16u * e), "l"(s + e) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_in_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared -> global copy of rows [r0, r1) of U: row c keeps columns r >= c,
// zeros before.  The row of a linear index comes from a float reciprocal,
// exact here (the index is below 2^14 and at least 0.5 / row-length from
// a row's end), so no integer division runs per element.
template <typename T, int U>
__device__ __forceinline__ void copy_out(const T* a, T* __restrict__ dst,
                                         int Np, int r0, int r1, int tid,
                                         int nt, bool vec) {
  constexpr int V = Vec<T>::V;
  const int nvr = vec ? Np / V : Np;       // vectors (or values) a row
  const int nv = r1 * nvr;
  const float inv = 1.0f / (float)nvr;
  for (int e = r0 * nvr + tid; e < nv; e += nt * U) {
    T v[U][V];
    int c[U], q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = e + u * nt;
      if (i < nv) {
        c[u] = __float2int_rz(((float)i + 0.5f) * inv);
        if (vec) {
          q[u] = (i - c[u] * nvr) * V;
          Vec<T>::load(a + i * V, v[u]);
        } else {
          q[u] = i - c[u] * nvr;
          v[u][0] = a[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = e + u * nt;
      if (i < nv) {
        if (vec) {
#pragma unroll
          for (int h = 0; h < V; ++h)
            if (q[u] + h < c[u]) v[u][h] = T(0);
          Vec<T>::store(dst + i * V, v[u]);
        } else {
          dst[i] = q[u] >= c[u] ? v[u][0] : T(0);
        }
      }
    }
  }
}

// Step 1: one warp factors the w x w diagonal block at (k1, k1), w <= NB,
// with no block barrier.  Lane i < w keeps row i of the block's lower
// triangle, L[k1 + i, k1 + t] = a[(k1 + t) * ld + k1 + i], in registers.
// With kp >= 0 the block first takes the rank-NB update of the panel at
// kp (its look-ahead: the rest of that update runs on the other warps),
// each row split over two lanes when NB <= 16 so that no lane idles.
// Step j: the pivot comes from lane j by shuffle, every lane scales its
// entry of column j and writes it to row k1 + j of the tile (its place in
// U), and dinv[j] keeps rsqrt(pivot j) for the TRSM.  Only the next
// pivot is on the chain: lane j + 1 computes it from its own entry and
// sends it at once.  Column j's entries of rows j + 1 and j + 2 go by
// shuffle too, so the pivots never wait for shared memory; the rest of
// column j is read back after a __syncwarp and applied a step later.
// Every entry takes the columns in order, as in the plain version.  The
// loop has no branch: steps j >= w of a ragged block run on registers
// t >= w, which hold nothing that reaches a result, and store nothing.
template <typename T, int NB>
__device__ __forceinline__ void factor_diag(T* a, int ld, int k1, int w,
                                            int kp, T* dinv, int lane) {
  constexpr int V = Vec<T>::V;
  // the look-ahead update splits each row over SPLIT lanes of C columns
  constexpr int SPLIT = NB <= kWarp / 2 ? 2 : 1;
  constexpr int C = NB / SPLIT;
  const bool mine = lane < w;
  const int r = SPLIT == 1 ? lane : lane & (NB - 1);
  const int s0 = SPLIT == 1 ? 0 : ((lane / NB) & (SPLIT - 1)) * C;
  const bool live = r < w;
  T part[C];          // L[k1 + r, k1 + s0 + u]
#pragma unroll
  for (int u = 0; u < C; ++u)
    part[u] = (live && s0 + u < w) ? a[(k1 + s0 + u) * ld + k1 + r] : T(0);
  if (kp >= 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const T* pj = a + (kp + j) * ld + k1;     // pj[t] = L[k1 + t, kp + j]
      const T x = live ? pj[r] : T(0);
#pragma unroll
      for (int g = 0; g < C / V; ++g) {
        T v[V];
        Vec<T>::load(pj + s0 + g * V, v);
#pragma unroll
        for (int h = 0; h < V; ++h)
          part[g * V + h] = fma_t(-x, v[h], part[g * V + h]);
      }
    }
  }
  // lane i < NB gathers row i; other lanes hold copies that reach nothing
  T row[NB];
#pragma unroll
  for (int t = 0; t < NB; ++t)
    row[t] = t < C ? part[t]
                   : __shfl_sync(kFull, part[t % C], r + t / C * NB);
  T pv = __shfl_sync(kFull, row[0], 0);  // pivot j, sent by lane j
  T lp = T(0);        // this lane's entry of column j - 1
  T pend[NB];         // column j - 1 below row j + 1, read at step j - 1
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const T d = rsqrt_t(pv);
    const T l = row[j] * d;            // lane j: L[j, j]; lane i > j: L[i, j]
    if (j + 1 < NB) {
      pv = __shfl_sync(kFull, fma_t(-l, l, row[j + 1]), j + 1);
      row[j + 1] = fma_t(-l, __shfl_sync(kFull, l, j + 1), row[j + 1]);
    }
#pragma unroll
    for (int t = j + 2; t < NB; ++t)
      if (j >= 1) row[t] = fma_t(-lp, pend[t], row[t]);
    if (j + 2 < NB)
      row[j + 2] = fma_t(-l, __shfl_sync(kFull, l, j + 2), row[j + 2]);
    // u[t] = L[k1 + t, k1 + j]; steps past a ragged block's end read the
    // block's last row (inside the tile) and store nothing
    const T* u = a + (k1 + min(j, w - 1)) * ld + k1;
    if (j < w) {
      if (mine && lane >= j) a[(k1 + j) * ld + k1 + lane] = l;
      if (lane == 0) dinv[j] = d;
    }
    __syncwarp();
#pragma unroll
    for (int g = (j + 3) / V; g < NB / V; ++g) {
      T v[V];
      Vec<T>::load(u + g * V, v);
#pragma unroll
      for (int h = 0; h < V; ++h)
        if (g * V + h >= j + 3) pend[g * V + h] = v[h];
    }
    lp = l;
  }
}

// Step 2: rows i in [k0 + NB, Np) of the panel, one a thread:
// L[i, k0 + j] = (A[i, k0 + j] - sum_{t<j} L[i, k0 + t] L[k0 + j, k0 + t])
// * dinv[j], right-looking in registers against the factored triangle.
template <typename T, int NB>
__device__ __forceinline__ void trsm_rows(T* a, int ld, int k0, int Np,
                                          const T* dinv, int tid, int nt) {
  constexpr int V = Vec<T>::V;
  const T* u11 = a + k0 * ld + k0;     // u11[j * ld + t] = L[k0 + t, k0 + j]
  for (int i = k0 + NB + tid; i < Np; i += nt) {
    T x[NB];
#pragma unroll
    for (int t = 0; t < NB; ++t) x[t] = a[(k0 + t) * ld + i];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      x[j] *= dinv[j];
#pragma unroll
      for (int g = (j + 1) / V; g < NB / V; ++g) {
        T v[V];
        Vec<T>::load(u11 + j * ld + g * V, v);
#pragma unroll
        for (int h = 0; h < V; ++h)
          if (g * V + h > j) x[g * V + h] = fma_t(-x[j], v[h], x[g * V + h]);
      }
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) a[(k0 + t) * ld + i] = x[t];
  }
}

// Step 3: L[i, r] -= sum_j L[i, k0 + j] L[r, k0 + j] for k0 + NB <= r <= i,
// i.e. tile rows r (of U) against tile columns i, kTile x kTile a thread.
// The n tile rows of the triangle pair up, r with n - 1 - r, into n / 2
// rows of n + 1 tiles (n is even: Np - k0 - NB is a multiple of 8).  The
// first NB x NB diagonal block is left to factor_diag's look-ahead.
template <typename T, int NB>
__device__ __forceinline__ void syrk_lower(T* a, int ld, int k0, int Np,
                                           int tid, int nt) {
  const int c0 = k0 + NB;
  const int n = (Np - c0) / kTile;
  const int ntile = (n / 2) * (n + 1);
  const T* P = a + k0 * ld;            // P[j * ld + c] = L[c, k0 + j]
  for (int e = tid; e < ntile; e += nt) {
    const int p = e / (n + 1);         // once a tile, not in the k-loop
    const int q = e - p * (n + 1);
    int tr, tc;
    if (q < n - p) {
      tr = p;
      tc = p + q;
    } else {
      tr = n - 1 - p;
      tc = q - 1;
    }
    if (tc < NB / kTile) continue;     // inside the next diagonal block
    const int r0 = c0 + tr * kTile;
    const int i0 = c0 + tc * kTile;
    T c[kTile][kTile];
#pragma unroll
    for (int y = 0; y < kTile; ++y) load_tile_row(a + (r0 + y) * ld + i0, c[y]);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      T x[kTile], z[kTile];
      load_tile_row(P + j * ld + r0, x);
      load_tile_row(P + j * ld + i0, z);
#pragma unroll
      for (int y = 0; y < kTile; ++y)
#pragma unroll
        for (int b = 0; b < kTile; ++b) c[y][b] = fma_t(-x[y], z[b], c[y][b]);
    }
#pragma unroll
    for (int y = 0; y < kTile; ++y) store_tile_row(a + (r0 + y) * ld + i0, c[y]);
  }
}

// One thread block per matrix, NT threads, Np in [8, 128].  Per panel two
// block barriers: after the TRSM, and after the trailing update, which
// runs beside the next diagonal block's factor (warp 0).
template <typename T, int NB, int NT>
__global__ void __launch_bounds__(NT, 1)
    block_chol_panels(const T* __restrict__ S, const T* __restrict__ pe,
                      T* __restrict__ out, int Np, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  T* dinv = a + Np * Np;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const size_t w = blockIdx.x;
  const size_t nn = (size_t)Np * Np;
  const T pev = tid < Np ? pe[w * Np + tid] : T(0);
  const int nb0 = min(NB, Np);
  T* dst = out + w * nn;
  // the first nb0 rows of the tile (the first diagonal block and the rows
  // its TRSM solves) arrive first; the rest lands while warp 0 factors
  // that block
  if (vec) {
    copy_in_async(S + w * nn, a, nb0 * Np, tid, NT);
    copy_in_async(S + w * nn + nb0 * Np, a + nb0 * Np, (Np - nb0) * Np, tid,
                  NT);
    copy_in_wait<1>();
  } else {
    copy_in<T, 8>(S + w * nn, a, Np * Np, tid, NT, false);
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < nb0) a[lane * Np + lane] += pev;
    __syncwarp();
    factor_diag<T, NB>(a, Np, 0, nb0, -1, dinv, lane);
  }
  copy_in_wait<0>();
  __syncthreads();
  // the other diagonal entries: first read after the TRSM's barrier
  if (tid >= nb0 && tid < Np) a[tid * Np + tid] += pev;
  int k0 = 0;
  for (; k0 + NB < Np; k0 += NB) {
    trsm_rows<T, NB>(a, Np, k0, Np, dinv, tid, NT);
    __syncthreads();
    const int k1 = k0 + NB;
    if (warp == 0) {
      factor_diag<T, NB>(a, Np, k1, min(NB, Np - k1), k0, dinv, lane);
    } else {
      // rows [k0, k1) of U are final: written out beside the update
      copy_out<T, 2>(a, dst, Np, k0, k1, tid - kWarp, NT - kWarp, vec);
      syrk_lower<T, NB>(a, Np, k0, Np, tid - kWarp, NT - kWarp);
    }
    __syncthreads();
  }
  copy_out<T, 4>(a, dst, Np, k0, Np, tid, NT, vec);
}

// Np <= 32: one warp per matrix, kWarpsSmall matrices a thread block.
template <typename T, int NP>
__global__ void __launch_bounds__(kWarpsSmall * kWarp)
    block_chol_warps(const T* __restrict__ S, const T* __restrict__ pe,
                     T* __restrict__ out, int W, bool vec) {
  __shared__ __align__(16) T tiles[kWarpsSmall][NP * NP + NP];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const size_t w = (size_t)blockIdx.x * kWarpsSmall + warp;
  if (w >= (size_t)W) return;
  T* a = tiles[warp];
  const T pev = lane < NP ? pe[w * NP + lane] : T(0);
  copy_in<T, 8>(S + w * NP * NP, a, NP * NP, lane, kWarp, vec);
  __syncwarp();
  if (lane < NP) a[lane * NP + lane] += pev;
  __syncwarp();
  factor_diag<T, NP>(a, NP, 0, NP, -1, a + NP * NP, lane);
  __syncwarp();
  copy_out<T, 8>(a, out + w * NP * NP, NP, 0, NP, lane, kWarp, vec);
}

// The shared-memory attribute is per device and per kernel, so it is set
// once for each device an instantiation launches on (a second card needs
// its own call; a racing first call only sets it twice).  It is always
// the largest tile's size, so a launch at a smaller Np never lowers it
// under another's.
template <typename T, int NB, int NT>
cudaError_t launch_panels(const T* S, const T* pe, T* out, int W, int Np,
                          bool vec, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(block_chol_panels<T, NB, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(sizeof(T) * (kMaxNp * kMaxNp + NB)));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  const size_t smem = sizeof(T) * ((size_t)Np * Np + NB);
  block_chol_panels<T, NB, NT><<<W, NT, smem, stream>>>(S, pe, out, Np, vec);
  return cudaGetLastError();
}

template <typename T, int NP>
cudaError_t launch_warps(const T* S, const T* pe, T* out, int W, bool vec,
                         cudaStream_t stream) {
  const int blocks = (W + kWarpsSmall - 1) / kWarpsSmall;
  block_chol_warps<T, NP><<<blocks, kWarpsSmall * kWarp, 0, stream>>>(
      S, pe, out, W, vec);
  return cudaGetLastError();
}

// One warp a matrix up to Np = 32, else kNB-column panels, chosen by
// measurement on an H100 (PERF.md): over 256 threads in float32 while the
// batch fits one block an SM (the extra SYRK warps shorten each panel),
// else over 128 (the registers of 256 threads fill an SM, so a larger
// batch runs one block an SM); float64 always over 128.
template <typename T>
int launch(const T* S, const T* pe, T* out, int W, int Np, int dev,
           cudaStream_t stream) {
  if (W <= 0) return 0;
  if (Np <= 0 || Np > kMaxNp || Np % 8) return (int)cudaErrorInvalidValue;
  sstpu::OnDevice on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  const bool vec = ((reinterpret_cast<uintptr_t>(S) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaError_t err;
  switch (Np) {
    case 8: err = launch_warps<T, 8>(S, pe, out, W, vec, stream); break;
    case 16: err = launch_warps<T, 16>(S, pe, out, W, vec, stream); break;
    case 24: err = launch_warps<T, 24>(S, pe, out, W, vec, stream); break;
    case 32: err = launch_warps<T, 32>(S, pe, out, W, vec, stream); break;
    default:
      if constexpr (sizeof(T) == 4) {
        if (W <= kOneWave) {
          err = launch_panels<T, kNB, 256>(S, pe, out, W, Np, vec, stream);
          break;
        }
      }
      err = launch_panels<T, kNB, 128>(S, pe, out, W, Np, vec, stream);
      break;
  }
  return (int)err;
}

}  // namespace

extern "C" {

int sstpu_block_chol_f32(const float* S, const float* pe, float* out, int W,
                         int Np, int dev, void* stream) {
  return launch<float>(S, pe, out, W, Np, dev, (cudaStream_t)stream);
}

int sstpu_block_chol_f64(const double* S, const double* pe, double* out,
                         int W, int Np, int dev, void* stream) {
  return launch<double>(S, pe, out, W, Np, dev, (cudaStream_t)stream);
}

}  // extern "C"
