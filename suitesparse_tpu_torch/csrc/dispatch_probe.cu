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
// Design.  One copy engine serves both kernels.  The G blocks are cut into
// chunks of whole rows: 16 KiB, 16 a block, or for a launch with fewer
// chunks than the grid holds, halved down to 2 KiB (a one-block launch:
// 128 chunks).  A persistent grid of at most two CTAs an SM, and never
// more CTAs than chunks, walks them: chunk c goes to CTA c mod grid, so
// the chunks in flight at any moment are neighbours in memory.  Each CTA
// keeps a ring of kStages chunks in shared memory, filled by 1-D TMA bulk
// copies that complete on one mbarrier a stage (the counterpart of `vmk`'s
// make_async_copy and DMA semaphore).  Its threads scale a stage in place;
// one thread writes the stage back with a bulk store and refills the stage
// of the chunk before, once that chunk's store has read it.  Loads and
// stores carry an L2 evict-first policy, since every byte is touched once.
// For scale_gather the same thread reads each chunk's window from the
// device offset table as it issues the load, and skips a window outside
// the buffer; the wrapper refuses such tables, and overlapping windows
// (which would race), on the host before upload.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kRows = 512;
constexpr int kCols = 128;
constexpr int kBlockFloats = kRows * kCols;   // 256 KiB
constexpr int kMaxChunk = 4096;                // floats in a chunk: 16 KiB
constexpr int kMinChunk = 512;                 // 2 KiB
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 2;
constexpr int kMaxDevices = 64;
constexpr float kScale = 1.0000001f;                            // 1 + 2^-23

// the dynamic shared memory of one CTA
struct Ring {
  float4 data[kStages][kMaxChunk / 4];
  uint64_t full[kStages];   // mbarrier: the stage's load has landed
  long long pos[kStages];   // float offset of the stage's chunk; -1: skipped
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float4 scale4(float4 v) {
  v.x *= kScale;
  v.y *= kScale;
  v.z *= kScale;
  v.w *= kScale;
  return v;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// one chunk of `bytes` from global memory into a stage, completing on `bar`
__device__ __forceinline__ void load_chunk(float4* dst, const float* src,
                                           uint32_t bytes, uint64_t* bar,
                                           uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void store_chunk(float* dst, const float4* src,
                                            uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;"
      :: "l"(dst), "r"(smem(src)), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    scale_chunks(const float* __restrict__ in, float* __restrict__ out,
                 const int* __restrict__ offs, int nchunks, int chunk,
                 int rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Ring& r = *reinterpret_cast<Ring*>(smem_raw);
  const int tid = threadIdx.x;
  // this CTA's chunks: blockIdx.x + k * gridDim.x for k < mine
  const int mine = (nchunks - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int per_block = kBlockFloats / chunk;
  const uint32_t bytes = chunk * sizeof(float);
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));

  // thread 0: start the load of this CTA's k-th chunk into its stage
  auto issue = [&](int k) {
    const int s = k % kStages;
    const int c = (int)blockIdx.x + k * (int)gridDim.x;
    long long pos = (long long)c * chunk;
    if constexpr (kGather) {
      const int o = offs[c / per_block];
      pos = (o < 0 || o > rows - kRows)
                ? -1
                : (long long)o * kCols + (long long)(c % per_block) * chunk;
    }
    r.pos[s] = pos;
    if (pos < 0)   // nothing to move: complete the stage's phase empty
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                   :: "r"(smem(&r.full[s])) : "memory");
    else
      load_chunk(r.data[s], in + pos, bytes, &r.full[s], policy);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem(&r.full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kStages && k < mine; ++k) issue(k);
  }
  __syncthreads();

  for (int k = 0; k < mine; ++k) {
    const int s = k % kStages;
    bar_wait(&r.full[s], (k / kStages) & 1);
    const long long pos = r.pos[s];
    if (pos >= 0) {
      float4* v = r.data[s];
      for (int i = tid; i < chunk / 4; i += kThreads) v[i] = scale4(v[i]);
      // the bulk store reads the stage through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      if (pos >= 0)
        store_chunk(out + pos, r.data[s], bytes, policy);
      else
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // refill the stage of chunk k - 1 once its store (all but the newest
      // group) has read it
      if (k >= 1 && k - 1 + kStages < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        issue(k - 1 + kStages);
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The grid is sized from the SM count; that and the shared-memory attribute
// are read and set once for each device an instantiation launches on (a
// racing first call only does it twice).
template <bool kGather>
int launch(const float* in, float* out, const int* offs, int G, int rows,
           int dev, void* stream) {
  if (G <= 0) return 0;
  if (G > INT_MAX / (kBlockFloats / kMinChunk) || !aligned(in) ||
      !aligned(out))
    return (int)cudaErrorInvalidValue;
  sstpu::OnDevice on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  static std::atomic<int> sms[kMaxDevices];
  const bool cached = dev >= 0 && dev < kMaxDevices;
  int n = cached ? sms[dev].load(std::memory_order_acquire) : 0;
  if (n == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        scale_chunks<kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Ring));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (cached) sms[dev].store(n, std::memory_order_release);
  }
  const int ctas = kCtasPerSm * n;
  int chunk = kMaxChunk;
  while (chunk > kMinChunk && G * (kBlockFloats / chunk) < ctas) chunk /= 2;
  const int nchunks = G * (kBlockFloats / chunk);
  scale_chunks<kGather>
      <<<std::min(nchunks, ctas), kThreads, sizeof(Ring),
         (cudaStream_t)stream>>>(in, out, offs, nchunks, chunk, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sstpu_scale_blocks_f32(const float* in, float* out, int G, int dev,
                           void* stream) {
  return launch<false>(in, out, nullptr, G, 0, dev, stream);
}

int sstpu_scale_gather_f32(const int* offs, const float* in, float* out,
                           int G, int rows, int dev, void* stream) {
  if (G > 0 && rows < kRows) return (int)cudaErrorInvalidValue;
  return launch<true>(in, out, offs, G, rows, dev, stream);
}

}  // extern "C"
