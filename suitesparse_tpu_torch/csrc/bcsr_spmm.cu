// Block-sparse x dense product (uniform-slot BCSR), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel suitesparse_tpu/ops/spmv.py :: _bcsr_kernel
// (launched there by bcsr_spmm).  A is stored as nrb block rows of nslots
// 128 x 128 float32 blocks each; a row with fewer blocks is padded with an
// all-zero block whose column index is 0.  It computes
//
//     Y[r*128 : r*128+128, :] = sum over t of blocks[r*nslots+t] @ X[c*128 : c*128+128, :]
//
// with c = block_cols[r*nslots+t], summed in float32 in slot order, and
// writes the first m rows and k columns.  Every slot is computed, pad slots
// included (a zero block times X block 0), as the reference does.  X is
// taken as it is, (n, k) row-major at any k >= 1; rows past n read as zero.
//
// What bounds it on this card.  Each slot is a dense 128 x 128 x k product:
// 2*128*128*k flops against 64 KB of A and 512*k bytes of X, so at k = 128
// the block work (~20 GFLOP for lap3d_44's 4,662 slots) puts the bound on
// the float32 CUDA-core rate (67 TFLOP/s), and at k = 32 on the bytes of the
// blocks (305 MB over 3.35 TB/s).  Tensor cores are not used: the
// reference's sum is full float32, and TF32 would keep ~3 digits.
//
// Design.  One thread block per (block row, tile of 64 output columns),
// 128 threads, each holding an 8 x 8 tile of the 128 x 64 output in
// registers for the whole loop over the row's slots; the output is written
// once.  Per slot, the A block is staged through shared memory in 128 x 32
// panels (16.5 KB, padded to 33 floats a row so that neither the 16-byte
// global loads' stores nor the column reads conflict on a bank) beside the
// matching 32 x 64 panel of X; each thread then runs 8 x 8 fused
// multiply-adds per panel column.  The X panel's global loads are scalar
// because a row of X at an arbitrary k has no 16-byte alignment.  Double
// buffering the panels (cp.async or TMA), skipping pad slots, and the
// tensor cores at a precision that keeps the reference's sum are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kB = 128;       // block rows and columns (bm = bk)
constexpr int kTN = 64;       // output columns per thread block
constexpr int kKP = 32;       // depth of one staged panel
constexpr int kThreads = 128;
constexpr int kAStride = kKP + 1;

__global__ void __launch_bounds__(kThreads)
bcsr_spmm_kernel(const float* __restrict__ blocks,
                 const int32_t* __restrict__ block_cols,
                 const float* __restrict__ X, float* __restrict__ out,
                 int nslots, int m, int n, int k) {
  __shared__ float As[kB * kAStride];        // A panel, As[r * 33 + kk]
  __shared__ __align__(16) float Xs[kKP * kTN];  // X panel, Xs[kk * 64 + c]

  const int rb = blockIdx.x;
  const int n0 = blockIdx.y * kTN;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;     // 16 row groups of 8 rows
  const int tx = tid & 7;      // 8 column groups: columns tx*4 + {0..3, 32..35}

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < nslots; ++t) {
    const size_t slot = (size_t)rb * nslots + t;
    const float* A = blocks + slot * (kB * kB);
    const int xrow0 = block_cols[slot] * kB;
    for (int k0 = 0; k0 < kB; k0 += kKP) {
      // A panel: 128 rows x 32 columns, 8 float4 a row, 8 per thread
#pragma unroll
      for (int it = 0; it < (kB * kKP / 4) / kThreads; ++it) {
        const int idx = it * kThreads + tid;
        const int r = idx >> 3;
        const int c4 = (idx & 7) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>(A + r * kB + k0 + c4);
        float* dst = As + r * kAStride + c4;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      // X panel: rows xrow0 + k0 .. +32, columns n0 .. n0+64, zero outside
#pragma unroll
      for (int it = 0; it < (kKP * kTN) / kThreads; ++it) {
        const int idx = it * kThreads + tid;
        const int rr = idx / kTN;
        const int cc = idx - rr * kTN;
        const int gr = xrow0 + k0 + rr;
        const int gc = n0 + cc;
        Xs[idx] = (gr < n && gc < k) ? X[(size_t)gr * k + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKP; ++kk) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[(ty * 8 + i) * kAStride + kk];
        const float4 x0 =
            *reinterpret_cast<const float4*>(Xs + kk * kTN + tx * 4);
        const float4 x1 =
            *reinterpret_cast<const float4*>(Xs + kk * kTN + 32 + tx * 4);
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = rb * kB + ty * 8 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx * 4 + (j < 4 ? j : 28 + j);
      if (col < k) out[(size_t)row * k + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// blocks: (nrb * nslots, 128, 128) float32, 16-byte aligned; block_cols:
// (nrb * nslots,) int32 in [0, ceil(n / 128)); X: (n, k) float32; out:
// (m, k) float32, m <= nrb * 128; all on device `dev`.  Returns a
// cudaError_t (0 on success).
int sstpu_bcsr_spmm_f32(const float* blocks, const int32_t* block_cols,
                        const float* X, float* out, int nrb, int nslots,
                        int m, int n, int k, int dev, void* stream) {
  if (nrb <= 0 || m <= 0 || k <= 0) return 0;
  if (nslots <= 0 || n <= 0 || m > nrb * kB)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(blocks) % 16)
    return (int)cudaErrorMisalignedAddress;
  sstpu::OnDevice on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  const dim3 grid(nrb, (k + kTN - 1) / kTN);
  bcsr_spmm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      blocks, block_cols, X, out, nslots, m, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
