// Dispatch-floor probes, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU probe kernels of tools/microbench_dispatch.py:
//
//   sstpu_scale_blocks_f32   <- `kernel` (:69, pallas_call :74, in `pally`):
//       out = in * c over a grid of G blocks of 512 x 128 floats;
//   sstpu_scale_gather_f32   <- `vmk` (:92, pallas_call :107, in `vm`):
//       grid step i reads rows [offs[i], offs[i] + 512) of in, scales them
//       by c and writes the same rows of out (the offset table is read on
//       the device, as the TPU kernel reads its scalar-prefetched table).
//
// c is 1.0000001f, i.e. the float 1 + 2^-23, and the product is one IEEE
// float multiply (no fast-math, denormals kept), so both kernels equal
// numpy's x * np.float32(1.0000001) and the plain PyTorch versions bit for
// bit.
//
// What bounds it on this card.  One multiply per 8 bytes moved: a block is
// 256 KiB read and 256 KiB written, so G = 64 moves 33.55 MB (10.0 us at
// 3.35 TB/s) and G = 256 134.2 MB (40.1 us).  The bound is the bytes.
//
// Design.  The probes exist to measure the launch route every kernel of
// the port takes (an nvcc-built library called through ctypes on the
// current stream), so the kernels are as plain as a copy can be: `split`
// thread blocks per grid step (1 = the TPU's grid, one block a step), 256
// threads, each thread keeping four 16-byte loads in flight before it
// scales and stores them.  The grid's blocks run concurrently over the
// SMs, where the TPU's grid steps ran one after another, so a time per
// block here is not the TPU's serial cost per step.  Offsets that overlap
// would race; the wrapper refuses them on the host before upload.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 512;
constexpr int kCols = 128;
constexpr int kVec = kRows * kCols / 4;   // float4 per block: 16384
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr float kScale = 1.0000001f;      // == 1 + 2^-23

__device__ __forceinline__ float4 scale4(float4 v) {
  v.x *= kScale;
  v.y *= kScale;
  v.z *= kScale;
  v.w *= kScale;
  return v;
}

// n float4 from src to dst, scaled; n is a multiple of kThreads * kUnroll
__device__ __forceinline__ void scale_span(const float4* __restrict__ src,
                                           float4* __restrict__ dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * kThreads] = scale4(v[u]);
  }
}

__global__ void __launch_bounds__(kThreads)
scale_blocks_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                    int split) {
  const int step = blockIdx.x / split;
  const int part = blockIdx.x - step * split;
  const int n = kVec / split;
  const size_t off = (size_t)step * kVec + (size_t)part * n;
  scale_span(in + off, out + off, n);
}

__global__ void __launch_bounds__(kThreads)
scale_gather_kernel(const int* __restrict__ offs,
                    const float4* __restrict__ in, float4* __restrict__ out,
                    int rows, int split) {
  const int step = blockIdx.x / split;
  const int part = blockIdx.x - step * split;
  const int o = offs[step];
  // the host checked every offset; a row window outside the buffer is
  // skipped rather than read or written out of bounds
  if (o < 0 || o > rows - kRows) return;
  const int n = kVec / split;
  const size_t off = (size_t)o * (kCols / 4) + (size_t)part * n;
  scale_span(in + off, out + off, n);
}

bool split_ok(int split) {
  return split >= 1 && kVec % split == 0 &&
         (kVec / split) % (kThreads * kUnroll) == 0;
}

bool aligned(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

int sstpu_scale_blocks_f32(const float* in, float* out, int G, int split,
                           void* stream) {
  if (G <= 0) return 0;
  if (!split_ok(split) || !aligned(in) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  scale_blocks_kernel<<<G * split, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      split);
  return (int)cudaGetLastError();
}

int sstpu_scale_gather_f32(const int* offs, const float* in, float* out,
                           int G, int rows, int split, void* stream) {
  if (G <= 0) return 0;
  if (!split_ok(split) || !aligned(in) || !aligned(out) || rows < kRows)
    return (int)cudaErrorInvalidValue;
  scale_gather_kernel<<<G * split, kThreads, 0, (cudaStream_t)stream>>>(
      offs, reinterpret_cast<const float4*>(in),
      reinterpret_cast<float4*>(out), rows, split);
  return (int)cudaGetLastError();
}

const char* sstpu_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
