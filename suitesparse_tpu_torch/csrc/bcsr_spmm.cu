// Block-sparse x dense product (uniform-slot BCSR), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel suitesparse_tpu/ops/spmv.py :: _bcsr_kernel
// (launched there by bcsr_spmm).  A is stored as nrb block rows of nslots
// 128 x 128 float32 blocks each; a row with fewer blocks is padded with an
// all-zero block whose column index is 0.  It computes
//
//     Y[r*128 : r*128+128, :] = sum over t of blocks[r*nslots+t] @ X[c*128 : c*128+128, :]
//
// with c = block_cols[r*nslots+t], accumulated in float32, and writes the
// first m rows and k columns.  Every slot is computed, pad slots included
// (a zero block times X block 0), as the reference does, so a NaN or Inf
// in X's first 128 rows reaches every row that has a pad slot.  X is taken
// as it is, (n, k) row-major at any k >= 1; rows past n read as zero.
//
// What bounds it on this card.  Each slot is a dense 128 x 128 x k product:
// 2*128*128*k flops against 64 KB of A and 512*k bytes of X.  At k = 32 the
// bytes of the blocks bound it (lap3d_44: 305 MB over 3.35 TB/s).  At
// k = 128 the float32 CUDA-core rate (67 TFLOP/s) would bound any FMA
// kernel at 0.29 ms, so the products run on the tensor cores, where the
// three TF32 products below (3 x 19.6 GFLOP over 495 TFLOP/s) and the
// bytes give bounds of about 0.12 ms each.
//
// Float32 accuracy on TF32 tensor cores (3xTF32).  Each operand v is split
// into hi = v with the low 13 mantissa bits cleared (truncation, so
// |hi| <= |v| and a finite v never becomes Inf) and lo = v - hi (exact),
// truncated to TF32 in turn; a*x is taken as a_lo*x_hi + a_hi*x_lo +
// a_hi*x_hi, accumulated in float32.  The dropped a_lo*x_lo and the
// truncation of lo leave at most 3 * 2^-20 of each product.  Plain TF32
// (a_hi*x_hi alone, ~2^-10) is never used.  The split keeps float32's
// classes: where v is not finite (lo = v - hi is then NaN) lo is 0, the
// cross terms take 0 for hi, and hi itself is v + hi (Inf stays Inf, a NaN
// becomes the canonical NaN, whose payload survives TF32), so only
// a_hi*x_hi carries Inf and NaN, as a*x does: Inf*0 is NaN, Inf*x is Inf.
// A panel's operands are first split the cheap way, which is right for
// finite values, and split again the careful way when a block-wide vote
// finds an Inf or NaN among them.
//
// Design.  One CTA of two warpgroups per (block row, column tile): each
// warpgroup owns 64 rows of the 128 x TN output tile in registers for the
// whole slot loop and multiplies with wgmma (m64nTNk8, TF32, A from
// registers, B from shared memory).  The column tile is as wide as k
// needs: 32 for k <= 32, 64 for k <= 64, 128 above (one tile up to
// k = 128, so every A block is read from device memory once and every X
// block once per block row; beyond, the tiles of a block row run next to
// each other and share A through L2).  The slot loop is never split
// between CTAs and nothing is atomic: every output has one fixed summation
// order, and a repeated product is bit-identical.  The slots are cut into
// panels of KK depth (the 128 x KK slice of the A block beside the KK x TN
// slice of X), streamed raw into a ring of shared-memory stages by
// cp.async (16-byte copies, the X panel too where k % 4 == 0 and X is
// 16-byte aligned; 4-byte copies otherwise, zero-filled past n and k), so
// that the next panels load while one is multiplied.  wgmma takes a TF32 B
// only K-major, and X's panel is N-major, so the block transposes it as it
// splits it: X_hi and X_lo (and X_hi with non-finite values zeroed, on the
// careful path) go to K-major 8 x 16-byte core matrices.  A's fragments are
// split in registers by the warps that own its rows.  Within an 8-deep
// step, fragment slot t stands for depth 2t and slot t + 4 for 2t + 1 (in
// A and X alike), so a thread's two A values of a row are adjacent and load
// as one 8-byte word; the row strides (KK + 8 for A, TN + 4 for X) keep the
// raw reads free of bank conflicts.  The panel depth, the number of stages
// and the tiling were chosen by timing variants on an H100, against an
// mma.sync design of the same split (PERF.md, section 6).

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kB = 128;        // block rows and columns (bm = bk)
constexpr int kThreads = 256;  // two warpgroups, 64 output rows each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr uint32_t kTf32 = 0xffffe000u;   // the bits TF32 keeps

template <int TN>
struct Tile {
  static constexpr int KK = TN == 128 ? 16 : 32;       // depth of a panel
  static constexpr int STAGES = TN == 64 ? 3 : 4;      // raw panels in flight
  static constexpr int SA = KK + 8;                    // raw A row stride
  static constexpr int SX = TN + 4;                    // raw X row stride
  static constexpr int AF = kB * SA;                   // floats of raw A
  static constexpr int RAW = AF + KK * SX;             // floats of a stage
  static constexpr int SPLIT = KK * TN;                // floats of X_hi
  static constexpr int STEPS = KK / 8;                 // 8-deep steps
  static constexpr int PANELS = kB / KK;               // panels of a slot
  // X items a panel: (step, depth parity, 32 columns)
  static constexpr int ITEMS = STEPS * 2 * (TN / 32);
  static constexpr int SMEM = (STAGES * RAW + 3 * SPLIT) * (int)sizeof(float);
  // the split arrays start 128-byte aligned
  static_assert((STAGES * RAW) % 32 == 0, "alignment of the split arrays");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kBytes (4 or 16) from src, zero-filled when !valid (src is then any
// valid address and is not read)
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// The split of a finite v: hi and lo, both TF32.  `bad` is set where v is
// Inf or NaN (v - hi is then NaN).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo,
                                      bool& bad) {
  hi = __float_as_uint(v) & kTf32;
  const float l = v - __uint_as_float(hi);   // exact for a finite v
  bad |= l != l;
  lo = __float_as_uint(l) & kTf32;
}

// The split of any v: as above where v is finite; where it is not, lo = 0,
// hic = 0 (hi for the two cross terms) and hi = v + hi.
__device__ __forceinline__ void split_any(float v, uint32_t& hi,
                                          uint32_t& lo, uint32_t& hic) {
  const uint32_t h = __float_as_uint(v) & kTf32;
  const float hf = __uint_as_float(h);
  const float l = v - hf;
  const bool finite = l == l;
  hi = finite ? h : __float_as_uint(v + hf);
  lo = finite ? __float_as_uint(l) & kTf32 : 0u;
  hic = finite ? h : 0u;
}

// wgmma descriptor of a K-major B with no swizzle: core matrices of 8 rows
// (columns of X) x 16 bytes (4 depths), 128 bytes apart along the depth
// (LBO) and 256 bytes apart along the columns (SBO)
__device__ __forceinline__ uint64_t desc(const float* p) {
  return ((smem_addr(p) & 0x3FFFFu) >> 4) | (uint64_t{128 >> 4} << 16)
         | (uint64_t{256 >> 4} << 32);
}

// keeps the compiler from moving accumulator registers across a wgmma
// fence or wait
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// commits the warpgroup's products and waits for them; A's registers are
// read by them until then, so they are kept live past the wait
template <int S>
__device__ __forceinline__ void commit_wait(const uint32_t (&x)[S][4],
                                            const uint32_t (&y)[S][4],
                                            const uint32_t (&z)[S][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" :: "r"(x[s][i]), "r"(y[s][i]), "r"(z[s][i]));
}

// D(64 x N) += A(64 x 8, registers) B(8 x N, shared memory), TF32 in,
// float32 sums, for the warpgroup
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int TN>
__device__ __forceinline__ void wgmma(float* d, const uint32_t* a,
                                      uint64_t b) {
  if constexpr (TN == 32)
    wgmma_n32(d, a, b);
  else if constexpr (TN == 64)
    wgmma_n64(d, a, b);
  else
    wgmma_n128(d, a, b);
}

// the offset (in floats) of X's (column nn, depth 2e + h) of step s in a
// split array: step s's block of TN x 8, core matrix (nn / 8, h), row nn % 8
template <int TN>
__device__ __forceinline__ int split_offset(int s, int h, int nn) {
  return s * TN * 8 + (nn >> 3) * 64 + h * 32 + (nn & 7) * 4;
}

template <int TN, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
bcsr_spmm_kernel(const float* __restrict__ blocks,
                 const int32_t* __restrict__ block_cols,
                 const float* __restrict__ X, float* __restrict__ out,
                 int nslots, int ntiles, int m, int n, int k) {
  using T = Tile<TN>;
  constexpr int ND = TN / 2;   // accumulators a thread
  extern __shared__ __align__(128) float smem[];
  float* Xh = smem + T::STAGES * T::RAW;
  float* Xl = Xh + T::SPLIT;
  float* Xc = Xl + T::SPLIT;

  const int tile = blockIdx.x % ntiles;
  const int rb = blockIdx.x / ntiles;
  const int n0 = tile * TN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;   // rows 16 warp .. 16 warp + 15 of the tile
  const int g = lane >> 2;     // fragment row group
  const int t = lane & 3;      // fragment thread in group
  const int npanels = nslots * T::PANELS;
  const float* A0 = blocks + (size_t)rb * nslots * (kB * kB);
  const int32_t* cols = block_cols + (size_t)rb * nslots;

  // start the copies of panel p into its stage
  auto load = [&](int p) {
    float* As = smem + (p % T::STAGES) * T::RAW;
    float* Xs = As + T::AF;
    const int slot = p / T::PANELS;
    const int k0 = (p % T::PANELS) * T::KK;
    const float* A = A0 + (size_t)slot * (kB * kB) + k0;
#pragma unroll
    for (int i = tid; i < kB * T::KK / 4; i += kThreads) {
      const int r = i / (T::KK / 4);
      const int c = (i % (T::KK / 4)) * 4;
      copy_async<16>(As + r * T::SA + c, A + r * kB + c, true);
    }
    const int xr0 = __ldg(cols + slot) * kB + k0;
    if constexpr (kVec) {
#pragma unroll
      for (int i = tid; i < T::KK * TN / 4; i += kThreads) {
        const int r = i / (TN / 4);
        const int c = (i % (TN / 4)) * 4;
        const int gr = xr0 + r, gc = n0 + c;
        const bool ok = gr < n && gc < k;
        copy_async<16>(Xs + r * T::SX + c, ok ? X + (size_t)gr * k + gc : X,
                       ok);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < T::KK * TN; i += kThreads) {
        const int r = i / TN;
        const int c = i % TN;
        const int gr = xr0 + r, gc = n0 + c;
        const bool ok = gr < n && gc < k;
        copy_async<4>(Xs + r * T::SX + c, ok ? X + (size_t)gr * k + gc : X,
                      ok);
      }
    }
  };

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < npanels) load(s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int p = 0; p < npanels; ++p) {
    asm volatile("cp.async.wait_group %0;" :: "n"(T::STAGES - 2) : "memory");
    // panel p has landed; the stage of panel p - 1 and the split arrays
    // are free (its products were waited for)
    __syncthreads();
    if (p + T::STAGES - 1 < npanels) load(p + T::STAGES - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");

    const float* As = smem + (p % T::STAGES) * T::RAW;
    const float* Xs = As + T::AF;
    bool bad = false;
    // X: lane -> column nn = 32 q + lane of item (s, h, q), depths
    // s*8 + 2e + h (e = 0..3) -> one 16-byte row of a core matrix
#pragma unroll
    for (int it = warp; it < T::ITEMS; it += kWarps) {
      const int q = it % (TN / 32);
      const int h = (it / (TN / 32)) % 2;
      const int s = it / (TN / 32) / 2;
      const int nn = 32 * q + lane;
      const float* x = Xs + (s * 8 + h) * T::SX + nn;
      uint4 vh, vl;
      split(x[0], vh.x, vl.x, bad);
      split(x[2 * T::SX], vh.y, vl.y, bad);
      split(x[4 * T::SX], vh.z, vl.z, bad);
      split(x[6 * T::SX], vh.w, vl.w, bad);
      const int off = split_offset<TN>(s, h, nn);
      *reinterpret_cast<uint4*>(Xh + off) = vh;
      *reinterpret_cast<uint4*>(Xl + off) = vl;
    }
    // A: fragment order (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
    // of the warp's 16 rows, step by step
    uint32_t ah[T::STEPS][4], al[T::STEPS][4];
    const float* a = As + (16 * warp + g) * T::SA + 2 * t;
#pragma unroll
    for (int s = 0; s < T::STEPS; ++s) {
      const float2 v0 = *reinterpret_cast<const float2*>(a + s * 8);
      const float2 v1 =
          *reinterpret_cast<const float2*>(a + s * 8 + 8 * T::SA);
      split(v0.x, ah[s][0], al[s][0], bad);
      split(v1.x, ah[s][1], al[s][1], bad);
      split(v0.y, ah[s][2], al[s][2], bad);
      split(v1.y, ah[s][3], al[s][3], bad);
    }
    // the split arrays are read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (__syncthreads_or(bad)) {
      // an Inf or NaN in the panel: split again, keeping classes
      uint32_t ac[T::STEPS][4];
#pragma unroll
      for (int it = warp; it < T::ITEMS; it += kWarps) {
        const int q = it % (TN / 32);
        const int h = (it / (TN / 32)) % 2;
        const int s = it / (TN / 32) / 2;
        const int nn = 32 * q + lane;
        const float* x = Xs + (s * 8 + h) * T::SX + nn;
        uint4 vh, vl, vc;
        split_any(x[0], vh.x, vl.x, vc.x);
        split_any(x[2 * T::SX], vh.y, vl.y, vc.y);
        split_any(x[4 * T::SX], vh.z, vl.z, vc.z);
        split_any(x[6 * T::SX], vh.w, vl.w, vc.w);
        const int off = split_offset<TN>(s, h, nn);
        *reinterpret_cast<uint4*>(Xh + off) = vh;
        *reinterpret_cast<uint4*>(Xl + off) = vl;
        *reinterpret_cast<uint4*>(Xc + off) = vc;
      }
#pragma unroll
      for (int s = 0; s < T::STEPS; ++s) {
        const float2 v0 = *reinterpret_cast<const float2*>(a + s * 8);
        const float2 v1 =
            *reinterpret_cast<const float2*>(a + s * 8 + 8 * T::SA);
        split_any(v0.x, ah[s][0], al[s][0], ac[s][0]);
        split_any(v1.x, ah[s][1], al[s][1], ac[s][1]);
        split_any(v0.y, ah[s][2], al[s][2], ac[s][2]);
        split_any(v1.y, ah[s][3], al[s][3], ac[s][3]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ND; ++i) fence_operand(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 0; s < T::STEPS; ++s) {
        wgmma<TN>(acc, al[s], desc(Xc + s * TN * 8));
        wgmma<TN>(acc, ac[s], desc(Xl + s * TN * 8));
        wgmma<TN>(acc, ah[s], desc(Xh + s * TN * 8));
      }
      commit_wait(al, ac, ah);
    } else {
#pragma unroll
      for (int i = 0; i < ND; ++i) fence_operand(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 0; s < T::STEPS; ++s) {
        wgmma<TN>(acc, al[s], desc(Xh + s * TN * 8));
        wgmma<TN>(acc, ah[s], desc(Xl + s * TN * 8));
        wgmma<TN>(acc, ah[s], desc(Xh + s * TN * 8));
      }
      commit_wait(al, ah, ah);
    }
    // the products are done with the split arrays and A's registers
#pragma unroll
    for (int i = 0; i < ND; ++i) fence_operand(acc[i]);
  }

  // accumulator j of a thread: row g (+ 8 for j % 4 >= 2) of the warp's
  // 16, column 8 (j / 4) + 2t (+ 1 for odd j)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rb * kB + 16 * warp + g + 8 * h;
    if (row >= m) continue;
    float* o = out + (size_t)row * k;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      const float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
      if (kVec) {   // k even, out 8-byte aligned: both or neither
        if (col < k)
          *reinterpret_cast<float2*>(o + col) = make_float2(y0, y1);
      } else {
        if (col < k) o[col] = y0;
        if (col + 1 < k) o[col + 1] = y1;
      }
    }
  }
}

template <int TN, bool kVec>
int launch(const float* blocks, const int32_t* block_cols, const float* X,
           float* out, int nrb, int nslots, int m, int n, int k, int dev,
           void* stream) {
  // the shared-memory attribute is set once for each device (a racing
  // first call only sets it twice)
  static std::atomic<bool> ready[kMaxDevices];
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (!cached || !ready[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcsr_spmm_kernel<TN, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<TN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (cached) ready[dev].store(true, std::memory_order_release);
  }
  const int ntiles = (k + TN - 1) / TN;
  const long long grid = (long long)nrb * ntiles;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  bcsr_spmm_kernel<TN, kVec>
      <<<(int)grid, kThreads, Tile<TN>::SMEM, (cudaStream_t)stream>>>(
          blocks, block_cols, X, out, nslots, ntiles, m, n, k);
  return (int)cudaGetLastError();
}

template <int TN>
int launch_tn(bool vec, const float* blocks, const int32_t* block_cols,
              const float* X, float* out, int nrb, int nslots, int m, int n,
              int k, int dev, void* stream) {
  return vec ? launch<TN, true>(blocks, block_cols, X, out, nrb, nslots, m,
                                n, k, dev, stream)
             : launch<TN, false>(blocks, block_cols, X, out, nrb, nslots, m,
                                 n, k, dev, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  if (!aligned16(blocks)) return (int)cudaErrorMisalignedAddress;
  sstpu::OnDevice on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  const bool vec = k % 4 == 0 && aligned16(X) && aligned16(out);
  if (k <= 32)
    return launch_tn<32>(vec, blocks, block_cols, X, out, nrb, nslots, m, n,
                         k, dev, stream);
  if (k <= 64)
    return launch_tn<64>(vec, blocks, block_cols, X, out, nrb, nslots, m, n,
                         k, dev, stream);
  return launch_tn<128>(vec, blocks, block_cols, X, out, nrb, nslots, m, n,
                        k, dev, stream);
}

}  // extern "C"
