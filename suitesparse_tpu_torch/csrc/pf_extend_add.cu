// Extend-add of the pass-forward factor's pair projections, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The reference places each child's update
// into its parent's frame with XLA's one-hot products
// (suitesparse_tpu/cholesky/pf.py :: _pair_branch: R = Wh U, then
// einsum("pgfm,pghm->pfh", R, Wh) over the panel and the update slot),
// which ran on the card as float32 GEMMs some 20 times the factor's own
// flops.  Wh is an exact 0/1 one-hot, so the same function is a gather and
// a sum of at most G terms, as in CHOLMOD's relative-map assembly.  For
// every parent p of one pair instruction, over its children g < G:
//
//   panel[p][f, h]   -= sum_g U_g[idxf[p,g,f], idxf[p,g,h]]
//                       for f < Mft = Npt + Mbt, h < Npt;
//   slot[p][f-Npt, h-Npt] += the same sum, for Npt <= h <= f < Mft
//                       (the slot stays lower-canonical),
//
// where idxf = Mbc marks a frame row the child lacks: its term is 0.  With
// bf16 each placed value is rounded to bfloat16 first (a double through
// float, as torch rounds one), then summed in T: the reference's bfloat16
// placement, since the one-hot weights are exact.
//
// What bounds it.  No flops: it reads the child values it places and
// reads and writes the parent entries they reach.  A lap3d_64
// refactorization places 346M values into 343M parent entries: 4.17 GB
// in float32, 1.25 ms at the H100's 3.35 TB/s (tools/bench_extend_add.py
// counts them from the plan).  Most of its launches are small, so the
// latency of a launch and of a block's chain of loads, not the bytes, set
// their time.
//
// Design.  Results repeat bit for bit: no atomics, and one thread sums a
// parent entry's children in the order g = 0, 1, ...  An entry that no
// child reaches is not written (x - 0 = x).  A block owns a kTile x kTile
// tile of one parent's frame, loads each child's row and column indices
// of the tile into shared memory, skips a child that reaches no row or no
// column of it, and sums the others in registers, kPer entries a thread;
// its writes run along the parent's rows.  A tile strictly above the
// update slot's diagonal exits at once.  This one form serves every class:
// a second form for G = 1 that scattered each child entry to its parent
// entry (the row map inverted in shared memory) took 9.65 ms of a lap3d_64
// factor's pair instructions on an H100 against 8.29 ms for this form
// alone, and was dropped.  One grid covers every parent of the
// instruction.  A parent whose panel or slot lies past the buffer (offset
// -1: the plan's pad parents) is skipped there.  The kernel runs on the
// stream it is given, waits on nothing and allocates nothing, so it is
// captured into a CUDA graph like any launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                             // a block's tile
constexpr int kPer = kTile * kTile / kThreads;        // entries a thread
constexpr int kStride = kThreads / kTile;             // rows between them

template <typename T>
__device__ __forceinline__ T placed(T v, bool bf16) {
  if (!bf16) return v;
  return static_cast<T>(
      __bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
}

// block (x, y, p) owns frame rows [y * kTile, ...) and columns
// [x * kTile, ...) of parent p; thread t the column t % kTile and the
// rows t / kTile + kStride * k, k < kPer.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    extend_add_gather(T* F, const int* __restrict__ idxf,
                      const long long* __restrict__ coff,
                      const long long* __restrict__ pdst,
                      const long long* __restrict__ udst, int G, int Mbc,
                      int Npt, int Mbt, bool bf16) {
  __shared__ int ridx[kTile];
  __shared__ int cidx[kTile];
  const int p = blockIdx.z;
  const int Mft = Npt + Mbt;
  const int f0 = blockIdx.y * kTile, h0 = blockIdx.x * kTile;
  if (h0 >= Npt && f0 + kTile <= h0) return;   // above the slot's diagonal
  const long long pd = pdst[p];
  const long long ud = Mbt ? udst[p] : -1;
  if (pd < 0 && ud < 0) return;
  const int tid = threadIdx.x;
  const int c = tid % kTile, r0 = tid / kTile;
  const int h = h0 + c;
  // which of this thread's entries are destinations: a panel column, or
  // the slot's lower triangle
  unsigned dest = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int f = f0 + r0 + kStride * k;
    if (f < Mft && h < Mft && (h < Npt || f >= h)) dest |= 1u << k;
  }
  T acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = T(0);
  unsigned touched = 0;
  for (int g = 0; g < G; ++g) {
    const int* idx = idxf + ((size_t)p * G + g) * Mft;
    if (tid < kTile) {
      const int f = f0 + tid;
      ridx[tid] = f < Mft ? idx[f] : Mbc;
    } else if (tid < 2 * kTile) {
      const int hh = h0 + tid - kTile;
      cidx[tid - kTile] = hh < Mft ? idx[hh] : Mbc;
    }
    // each predicate reads the thread's own write; the barriers publish
    // the indices to the block
    const bool rows = __syncthreads_or(tid < kTile && ridx[tid] < Mbc);
    const bool cols = __syncthreads_or(tid >= kTile && tid < 2 * kTile &&
                                       cidx[tid - kTile] < Mbc);
    if (rows && cols) {
      const int b = cidx[c];
      if (b < Mbc) {
        const T* U = F + coff[(size_t)p * G + g];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int a = ridx[r0 + kStride * k];
          if ((dest >> k & 1u) && a < Mbc) {
            acc[k] += placed(U[(long long)a * Mbc + b], bf16);
            touched |= 1u << k;
          }
        }
      }
    }
    __syncthreads();            // before the next child's indices land
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (!(touched >> k & 1u)) continue;
    const int f = f0 + r0 + kStride * k;
    if (h < Npt) {
      if (pd >= 0) F[pd + (long long)f * Npt + h] -= acc[k];
    } else if (ud >= 0) {
      F[ud + (long long)(f - Npt) * Mbt + (h - Npt)] += acc[k];
    }
  }
}

template <typename T>
int launch(T* F, const int* idxf, const long long* coff,
           const long long* pdst, const long long* udst, int Pq, int G,
           int Mbc, int Npt, int Mbt, int bf16, int dev,
           cudaStream_t stream) {
  if (Pq <= 0 || G <= 0) return 0;
  if (Mbc <= 0 || Npt <= 0 || Mbt < 0 || Pq > 65535 || (Mbt && !udst))
    return (int)cudaErrorInvalidValue;
  sstpu::OnDevice on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  const int tiles = (Npt + Mbt + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, Pq);
  extend_add_gather<T><<<grid, kThreads, 0, stream>>>(
      F, idxf, coff, pdst, udst, G, Mbc, Npt, Mbt, bf16 != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sstpu_pf_extend_add_f32(float* F, const int* idxf, const long long* coff,
                            const long long* pdst, const long long* udst,
                            int Pq, int G, int Mbc, int Npt, int Mbt,
                            int bf16, int dev, void* stream) {
  return launch<float>(F, idxf, coff, pdst, udst, Pq, G, Mbc, Npt, Mbt,
                       bf16, dev, (cudaStream_t)stream);
}

int sstpu_pf_extend_add_f64(double* F, const int* idxf,
                            const long long* coff, const long long* pdst,
                            const long long* udst, int Pq, int G, int Mbc,
                            int Npt, int Mbt, int bf16, int dev,
                            void* stream) {
  return launch<double>(F, idxf, coff, pdst, udst, Pq, G, Mbc, Npt, Mbt,
                        bf16, dev, (cudaStream_t)stream);
}

}  // extern "C"
