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
// non-positive pivot comes out as NaN (factorize_super scans for it).
//
// What bounds it on this card.  Per matrix the work is ~Np^3/3 flops
// against 2 Np^2 values moved: at most ~Np/12 flop per byte (Np = 128:
// ~10 in f32, ~5 in f64), below the H100's ridge (67 TFLOP/s f32 over
// 3.35 TB/s = 20 flop/byte), so the roofline bound is the bytes.  A
// column-by-column factorization reaches neither bound: it is a chain of
// Np dependent steps, each a shared-memory rank-1 update between two
// block barriers, and its time is the latency of that chain.
//
// Design.  One thread block per matrix of the batch.  The whole matrix
// lives in dynamic shared memory (Np = 128: 64 KB in f32, 128 KB in f64,
// both above the 48 KB static limit, hence the attribute below), so device
// memory is read once and written once and the dependency chain runs at
// shared-memory latency; blocks run independently across the SMs.
// Shortening the chain (register tiles, blocked panels whose trailing
// update runs on the tensor cores, several small matrices per block) is
// later work.
//
// Layout.  Shared a[c * Np + r] holds L[r, c] for r >= c: row c of the
// tile is column c of L, which is row c of the output U = L^T.  The load
// and the store are coalesced row copies, and each rank-1 update walks
// contiguous shared addresses across a warp.  S is symmetric, so reading
// its row c as column c of the input is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxNp = 128;

template <typename T>
__device__ __forceinline__ T rsqrt_t(T x);

template <>
__device__ __forceinline__ float rsqrt_t<float>(float x) { return rsqrtf(x); }

template <>
__device__ __forceinline__ double rsqrt_t<double>(double x) { return rsqrt(x); }

template <typename T>
__global__ void block_chol_kernel(const T* __restrict__ S,
                                  const T* __restrict__ pe,
                                  T* __restrict__ out, int Np) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int nn = Np * Np;
  const size_t w = blockIdx.x;
  const T* Sw = S + w * nn;
  const T* pw = pe + w * Np;
  T* ow = out + w * nn;

  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int c = e / Np;
    T v = Sw[e];
    if (e - c * Np == c) v += pw[c];
    a[e] = v;
  }
  __syncthreads();

  for (int k = 0; k < Np; ++k) {
    T* col = a + k * Np;               // col[r] = L[r, k], r >= k
    const T piv = col[k];
    const T d = rsqrt_t(piv);
    for (int r = k + 1 + threadIdx.x; r < Np; r += blockDim.x) col[r] *= d;
    __syncthreads();
    // every thread has read the pivot: its slot may now take L[k, k]
    if (threadIdx.x == 0) col[k] = piv * d;
    // rank-1 update of the trailing lower triangle:
    // L[i, j] -= L[i, k] L[j, k] for k < j <= i
    const int m = Np - k - 1;
    const T* lk = col + k + 1;
    T* trail = a + (k + 1) * Np + (k + 1);
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int jj = e / m;
      const int ii = e - jj * m;
      if (ii >= jj) trail[jj * Np + ii] -= lk[ii] * lk[jj];
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int c = e / Np;
    ow[e] = (e - c * Np >= c) ? a[e] : T(0);
  }
}

template <typename T>
int launch(const T* S, const T* pe, T* out, int W, int Np,
           cudaStream_t stream) {
  if (W <= 0) return 0;
  if (Np <= 0 || Np > kMaxNp || Np % 8) return (int)cudaErrorInvalidValue;
  const int threads = Np <= 16 ? 32 : (Np <= 32 ? 128 : 256);
  const size_t smem = sizeof(T) * Np * Np;
  // The attribute is per device, so it is set on every launch (cheap):
  // a process-wide flag would miss a second card or a racing first call.
  // It is always the largest tile's size, so a concurrent launch at a
  // smaller Np never lowers it under another's.
  cudaError_t err = cudaFuncSetAttribute(
      block_chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(T) * kMaxNp * kMaxNp));
  if (err != cudaSuccess) return (int)err;
  block_chol_kernel<T><<<W, threads, smem, stream>>>(S, pe, out, Np);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sstpu_block_chol_f32(const float* S, const float* pe, float* out, int W,
                         int Np, void* stream) {
  return launch<float>(S, pe, out, W, Np, (cudaStream_t)stream);
}

int sstpu_block_chol_f64(const double* S, const double* pe, double* out,
                         int W, int Np, void* stream) {
  return launch<double>(S, pe, out, W, Np, (cudaStream_t)stream);
}

const char* sstpu_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
