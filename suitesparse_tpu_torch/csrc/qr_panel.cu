// Householder QR of one 32-column panel of the QR program's tall fronts,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference factors each bucket of fronts
// with XLA's dense QR (jnp.linalg.qr in qr_factorize's level loop,
// suitesparse_tpu/qr/spqr.py:366), and carries b through Q' afterwards.
// On the card cuSOLVER's geqrf walked the tall fronts' panels with its
// unblocked kernels; this kernel is the panel half of a blocked
// Householder QR (qr/spqr.py :: front_qr), whose trailing updates are
// float64 GEMMs.
//
// One launch factors columns p0 .. p0 + pb - 1 (pb <= 32) of every front
// of the launch, rows p0 .. FR - 1, in place in LAPACK's column-major
// layout: R on and above the diagonal, the Householder vectors below it
// (implicit unit leading entry), tau beside.  It also writes the panel's
// triangular factor T (larft: H_0 ... H_pb-1 = I - V T V') and V itself
// with its unit diagonal and zeros above, for the block reflector's GEMMs,
// and applies each reflector, once formed, to the front's right-hand sides
// B (FR x kb, row-major) in the same order as ormqr.
//
// What bounds it.  A panel of m rows is read and written once: 2 * 32 * m
// * 8 bytes, 20 MB for the 38,400-row root, ~6 us at 3.35 TB/s.  Its
// 4 * 32^2 * m flops are nothing on the card.  The 32 columns are a chain:
// column j's reflector needs the sums over every row of the previous
// update, so each column costs one pass over the rows and one reduction
// across the threads that hold them -- latency, not bytes or flops.
//
// Design.  The panel lives in registers for the whole launch: lane k of
// each warp holds column k, and a warp holds RPT consecutive rows; b's
// columns of the CTA's rows sit in shared memory, one a lane.  One pass
// per column applies reflector j to the rows and to b and, in the same
// sweep, accumulates what reflector j + 1 needs -- ||x||^2 below its
// diagonal, x' a_k for the later columns k, x' b_c for the right-hand
// sides -- and, for the earlier columns, the dots v_k' v_j of T's column
// j.  The values of the next pivot row travel with the sums.  One thread
// then forms dlarfg's beta = -sign(alpha) ||(alpha, x)||,
// tau = (beta - alpha) / beta and the scale 1 / (alpha - beta) of v from
// the sums alone, for the whole CTA.  The reduction is deterministic:
// per-warp partials in fixed slots, summed as a fixed tree, the CTAs'
// sums in rank order, no floating-point atomics; b's sums are separate
// values, never in the tree of the front's own columns, so R with b is R
// without.  How the rows are held follows the panel's height, given as G
// (CTAs a front) and RPT by the wrapper (qr/spqr.py :: panel_tiling, 8
// rows a thread while CTAs are free):
//   G = 1        one CTA of 16 warps; partials reduced through shared
//                memory;
//   G = 2..16    a thread-block cluster (non-portable above 8): each CTA
//                reduces its rows, and every CTA reads the G CTA sums from
//                the others' shared memory (distributed shared memory)
//                after a cluster barrier;
//   G > 16       a cooperative grid, at most one CTA an SM: the CTA sums
//                go through global memory (read past L1) behind a barrier
//                on a per-front counter; RPT grows to 32 once G reaches
//                the SM count, 67,584 rows on an H100.
// One CTA and a cluster always hold 8 rows a thread (kRptFree), so only
// the grid is built for more.  The cluster beats the grid at the same G
// on most of the heights it takes (768-2,048 rows: 7-15% a front_qr on
// an H100), not where many short fronts leave SMs to the cluster's
// placement (40 fronts of 384 rows, G = 3: the grid is 19% faster).
// Messages are double-buffered, so one barrier a column suffices.  The
// launch is an ordinary kernel node inside a captured CUDA graph (a
// cluster or cooperative launch attribute); it waits on nothing and
// allocates nothing (the wrapper gives the exchange buffer and the zeroed
// counters).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPanel = 32;                  // panel columns, one a lane
constexpr int kMaxB = 32;                   // right-hand sides carried
// one message: the column sums u (32), the next pivot row (32), b's sums
// (kMaxB) and b's pivot row (kMaxB)
constexpr int kU = 0, kRow = kPanel, kW = 2 * kPanel;
constexpr int kRowB = 2 * kPanel + kMaxB;
constexpr int kMsg = 2 * kPanel + 2 * kMaxB;
constexpr int kClusterMax = 16;             // non-portable above 8
constexpr int kRptFree = 8;                 // rows a thread while CTAs are free
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileLd = kPanel + 1;         // a warp's 8-row tile, padded

enum Mode { kCta = 0, kCluster = 1, kGrid = 2 };

struct Args {
  double* A;        // (fronts, FC, FR): each front column-major
  double* tau;      // (fronts, K)
  double* T;        // (fronts, tld, tld), row-major
  double* Vt;       // (fronts, tld, FR): the outer block's V', row j0 + c at c
  double* B;        // (fronts, FR, kb) or null
  double* msg;      // (2, G * nb, kMsg): the grid tier's messages
  unsigned* ctr;    // (nb,): the grid tier's barrier counters, zeroed
  int FR, FC, K, p0, pb, j0, tld, b0, G, kb;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// every CTA of front f has arrived `n` times: a release add and an
// acquire spin by one thread between two CTA barriers, on a counter of the
// front's own (the pattern of CUTLASS's generic barrier)
__device__ __forceinline__ void front_barrier(unsigned* ctr, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" : : "l"(ctr)
                 : "memory");
    while (ld_acquire(ctr) < n) {
    }
  }
  __syncthreads();
}

// reflector j's scalars from its pivot alpha and ||x||^2 below it (dlarfg:
// H = I when x is 0), into sc: tau, beta and the scale of v
__device__ __forceinline__ void reflector(double alpha, double xn2,
                                          double* sc) {
  double tau = 0.0, beta = alpha, scal = 0.0;
  if (xn2 != 0.0) {
    // one division for tau = (beta - alpha) / beta and 1 / (alpha - beta):
    // this thread's chain is every column's wait
    beta = -copysign(sqrt(fma(alpha, alpha, xn2)), alpha);
    const double d = alpha - beta, q = 1.0 / (beta * d);
    tau = -d * d * q;
    scal = beta * q;
  }
  sc[0] = tau;
  sc[1] = beta;
  sc[2] = scal;
}

// What one sweep of the rows needs of step j: H_j (td, tdb, scal, beta:
// this lane's tau (v_j' a), tau (v_j' b), the scale of v and the new
// pivot) and the lanes whose columns it reads (j and the next pivot's)
struct Step {
  int j, jl, jn, lane;
  bool next, bmine;
  double td, tdb, scal, beta;
};

// Apply H_j to a warp's RPT rows (x, this lane's column) and to b (bcol),
// and sum what H_(j+1) needs (acc on lanes > j, accb: b's sums, apart) and
// T's column j (acc on lanes < j: v_lane' v_j).  WHOLE: every row lies
// below the next pivot, so no row needs a test.  No branch but the next
// pivot row's, so the rows' shuffles overlap.
template <int RPT, bool WHOLE, bool WITHB>
__device__ __forceinline__ void sweep(double (&x)[RPT], double* bcol,
                                      double* rowbuf, int base, int mp,
                                      const Step& s, double& acc,
                                      double& accb) {
  const int j = s.j, lane = s.lane;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = base + i;
    const bool below = WHOLE || (r > s.j && r < mp);   // uniform
    const bool after = WHOLE || (s.next && r > j + 1 && r < mp);
    const double v = x[i];
    const double sj = __shfl_sync(kFull, v, s.jl);
    const double vj = below ? sj * s.scal : 0.0;
    double nv = (!WHOLE && r == j) ? v - s.td : fma(-s.td, vj, v);
    if (lane == j) nv = below ? vj : (r == j ? s.beta : v);
    x[i] = nv;
    const double xn = __shfl_sync(kFull, nv, s.jn);
    // lane j's sum is read by no one
    acc = fma(lane < j ? v : (after ? xn : 0.0), lane < j ? vj : nv, acc);
    double nb = 0.0;
    if constexpr (WITHB) {
      const double bv = s.bmine ? bcol[i] : 0.0;
      nb = (!WHOLE && r == j) ? bv - s.tdb : fma(-s.tdb, vj, bv);
      if (s.bmine) bcol[i] = nb;
      accb = fma(after ? xn : 0.0, nb, accb);
    }
    if (!WHOLE && s.next && r == j + 1) {
      rowbuf[lane] = nv;
      if (WITHB && s.bmine) rowbuf[kPanel + lane] = nb;
    }
  }
}

// p[0] + p[stride] + ... over the 16 warps' slots, as a fixed tree
__device__ __forceinline__ double tree_sum(const double* p, int stride) {
  double h[kWarps / 2];
#pragma unroll
  for (int q = 0; q < kWarps / 2; ++q)
    h[q] = p[2 * q * stride] + p[(2 * q + 1) * stride];
#pragma unroll
  for (int q = 0; q < kWarps / 4; ++q) h[q] = h[2 * q] + h[2 * q + 1];
#pragma unroll
  for (int q = 0; q < kWarps / 8; ++q) h[q] = h[2 * q] + h[2 * q + 1];
  return h[0] + h[1];
}

template <int RPT, int MODE>
__global__ void __launch_bounds__(kThreads, 1) qr_panel(const Args a) {
  __shared__ double part[kWarps][kPanel];
  __shared__ double partb[kWarps][kMaxB];
  __shared__ double rowbuf[kPanel + kMaxB];
  __shared__ double tot[kMsg];
  __shared__ double cmsg[2][kMsg];           // this CTA's sums (cluster)
  __shared__ double Tsh[kPanel][kPanel + 1];
  __shared__ double ysh[kPanel];
  __shared__ double xs[kThreads];            // rank-chunk sums (grid)
  __shared__ double sc[3];                   // tau, beta, scale of v
  // b, column by column: bs[c * kRows + (row - this CTA's first)], a
  // layout whose rows the compiler tells apart; then each warp's tile
  extern __shared__ double bs[];
  constexpr int kRows = kWarps * RPT;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = blockIdx.x, f = blockIdx.y;
  const long long fb = a.b0 + f;
  const int FR = a.FR, p0 = a.p0, pb = a.pb, kb = a.kb, G = a.G;
  const int mp = FR - p0;                    // panel rows
  const int base = (g * kWarps + w) * RPT;   // this warp's first row
  const bool mine = lane < pb, bmine = lane < kb;
  double* Bf = kb ? a.B + (fb * FR + p0) * kb : nullptr;
  double* bcol = bs + lane * kRows + w * RPT;

  // the warp's rows, 8 at a time through its tile: read down the columns
  // (lane l: column c0 + l / 8, row l % 8), then a row a lane
  double* tile = bs + kb * kRows + w * (8 * kTileLd);
  const double* pan = a.A + (fb * a.FC + p0) * FR + p0 + base;
  double x[RPT];
#pragma unroll
  for (int i0 = 0; i0 < RPT; i0 += 8) {
#pragma unroll
    for (int c0 = 0; c0 < kPanel; c0 += 4) {
      const int c = c0 + lane / 8, i = i0 + lane % 8;
      tile[(lane % 8) * kTileLd + c] = (c < pb && base + i < mp)
          ? pan[(long long)c * FR + i] : 0.0;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i0 + i] = tile[i * kTileLd + lane];
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = base + i;
    if (bmine) bcol[i] = r < mp ? Bf[(long long)r * kb + lane] : 0.0;
  }
  if (threadIdx.x == 0) sc[0] = sc[1] = sc[2] = 0.0;   // step -1: no H
  __syncthreads();

  double mytau = 0.0;
  int par = 0;
  unsigned arrivals = 0;
  for (int j = -1; j < pb; ++j) {
    const double tau = sc[0], beta = sc[1], scal = sc[2];
    double td = 0.0, tdb = 0.0, rowv = 0.0;
    if (j >= 0) {
      rowv = tot[kRow + lane];
      if (lane > j && mine) td = tau * (rowv + tot[kU + lane] * scal);
      if (bmine) tdb = tau * (tot[kRowB + lane] + tot[kW + lane] * scal);
      if (lane == j) mytau = tau;
    }
    const bool next = j + 1 < pb;
    const int jl = j < 0 ? 0 : j, jn = next ? j + 1 : jl;
    // apply H_j to the rows and to b; sum what H_(j+1) needs (lanes > j,
    // b's sums apart) and T's column j (lanes < j).  No branch but the
    // next pivot row's, so the rows' shuffles overlap.
    double acc = 0.0, accb = 0.0;
    const Step st{j, jl, jn, lane, next, bmine, td, tdb, scal, beta};
    if (base > j + 1 && base + RPT <= mp) {  // every row below the pivots
      if (kb) sweep<RPT, true, true>(x, bcol, rowbuf, base, mp, st, acc, accb);
      else sweep<RPT, true, false>(x, bcol, rowbuf, base, mp, st, acc, accb);
    } else if (kb) {
      sweep<RPT, false, true>(x, bcol, rowbuf, base, mp, st, acc, accb);
    } else {
      sweep<RPT, false, false>(x, bcol, rowbuf, base, mp, st, acc, accb);
    }
    part[w][lane] = acc;
    if (bmine) partb[w][lane] = accb;
    __syncthreads();
    // the CTA's sums, warps in order
    if (w == 0) {
      const double s = tree_sum(&part[0][lane], kPanel);
      const double sb = bmine ? tree_sum(&partb[0][lane], kMaxB) : 0.0;
      double* out = MODE == kCta ? tot : MODE == kCluster ? cmsg[par]
          : a.msg + ((long long)par * gridDim.x * gridDim.y + f * G + g)
              * kMsg;
      out[kU + lane] = s;
      out[kRow + lane] = rowbuf[lane];
      if (bmine) {
        out[kW + lane] = sb;
        out[kRowB + lane] = rowbuf[kPanel + lane];
      }
      if (MODE == kCta && next && lane == j + 1)
        reflector(rowbuf[lane], s, sc);
    }
    // the front's sums: every CTA adds the G messages in rank order; the
    // pivot rows come from rank 0, which holds the top rows
    if constexpr (MODE == kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const int es = threadIdx.x;
      if (es < kPanel + kb) {
        const int e = es < kPanel ? kU + es : kW + es - kPanel;
        const int er = es < kPanel ? kRow + es : kRowB + es - kPanel;
        double v[kClusterMax];
#pragma unroll
        for (int q = 0; q < kClusterMax; ++q)
          v[q] = q < G ? cluster.map_shared_rank(cmsg[par], q)[e] : 0.0;
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < kClusterMax; ++q)
          if (q < G) s += v[q];
        const double rv = cluster.map_shared_rank(cmsg[par], 0)[er];
        tot[e] = s;
        tot[er] = rv;
        if (next && es == j + 1) reflector(rv, s, sc);
      }
    } else if constexpr (MODE == kGrid) {
      front_barrier(a.ctr + f, (unsigned)G * ++arrivals);
      const double* m0 = a.msg + ((long long)par * gridDim.x * gridDim.y
                                  + (long long)f * G) * kMsg;
      // a chunk of ranks a thread, the chunks fixed whatever kb is, so
      // that the front's own sums do not depend on b
      constexpr int ns = kPanel + kMaxB, chunks = kThreads / ns;
      const int per = (G + chunks - 1) / chunks;
      const int es = threadIdx.x % ns, ch = threadIdx.x / ns;
      const int e = es < kPanel ? kU + es : kW + es - kPanel;
      if (es < kPanel + kb) {
        double s = 0.0;
        const int q1 = min(G, (ch + 1) * per);
#pragma unroll 4
        for (int q = ch * per; q < q1; ++q)
          s += __ldcg(m0 + (long long)q * kMsg + e);
        xs[ch * ns + es] = s;
      }
      __syncthreads();
      if (threadIdx.x < kPanel + kb) {
        const int er = es < kPanel ? kRow + es : kRowB + es - kPanel;
        double s = 0.0;
        for (int c = 0; c < chunks && c * per < G; ++c) s += xs[c * ns + es];
        const double rv = __ldcg(m0 + er);
        tot[e] = s;
        tot[er] = rv;
        if (next && es == j + 1) reflector(rv, s, sc);
      }
    }
    __syncthreads();
    // T's column j: T(0:j, j) = -tau_j T(0:j, 0:j) (V(:, 0:j)' v_j), the
    // dots V_jk + sum below row j of V_rk v_rj
    if (j >= 0 && w == 0) {
      if (lane < j) ysh[lane] = rowv + tot[kU + lane];
      __syncwarp();
      double t = 0.0;
#pragma unroll 4
      for (int m = 0; m < j; ++m) {
        const double tm = Tsh[lane][m];
        t = fma(m >= lane ? tm : 0.0, ysh[m], t);
      }
      if (lane < j) Tsh[lane][j] = -tau * t;
      if (lane == j) Tsh[j][j] = tau;
      __syncwarp();
    }
    par ^= 1;
  }

  // the panel and b in place, V materialized (unit diagonal, zeros above)
  // beside it, both written down the columns through the tile
  const int l0 = p0 - a.j0;
  double* pout = a.A + (fb * a.FC + p0) * FR + p0 + base;
  double* vout = a.Vt + (fb * a.tld + l0) * FR + l0 + base;
#pragma unroll
  for (int i0 = 0; i0 < RPT; i0 += 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) tile[i * kTileLd + lane] = x[i0 + i];
    __syncwarp();
#pragma unroll
    for (int c0 = 0; c0 < kPanel; c0 += 4) {
      const int c = c0 + lane / 8, i = i0 + lane % 8, r = base + i;
      if (c < pb && r < mp) {
        const double v = tile[(lane % 8) * kTileLd + c];
        pout[(long long)c * FR + i] = v;
        vout[(long long)c * FR + i] = r > c ? v : (r == c ? 1.0 : 0.0);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = base + i;
    if (bmine && r < mp) Bf[(long long)r * kb + lane] = bcol[i];
  }
  if (mine && g == 0) {
    double* vt = a.Vt + (fb * a.tld + l0 + lane) * FR;
    for (int q = w; q < l0; q += kWarps) vt[q] = 0.0;
  }
  if (g == 0) {
    __syncthreads();
    if (w == 0 && mine) a.tau[fb * a.K + p0 + lane] = mytau;
    double* T = a.T + (fb * a.tld + l0) * a.tld + l0;
    for (int r = w; r < pb; r += kWarps)
      if (mine)
        T[(long long)r * a.tld + lane] = r <= lane ? Tsh[r][lane] : 0.0;
  }
  // no CTA of a cluster leaves while the others may read its sums
  if constexpr (MODE == kCluster) cg::this_cluster().sync();
}

template <int RPT, int MODE>
cudaError_t launch_mode(const Args& a, int nb, cudaStream_t stream) {
  const size_t smem = ((size_t)a.kb * kWarps * RPT + kWarps * 8 * kTileLd)
      * sizeof(double);
  auto kernel = qr_panel<RPT, MODE>;
  if (MODE == kCluster && a.G > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  // the dynamic part beside the static one passes the default 48 KB
  {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.G, nb, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (MODE == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  } else if constexpr (MODE == kGrid) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

extern "C" {

// Rows a thread holds: kRptFree for one CTA and a cluster, one of 8, 16,
// 24, 32 for a grid (the pairs panel_tiling gives); the panel's FR - p0
// rows must fit in G * 16 * rpt.  msg and ctr are read only when G > 16.
int sstpu_qr_panel_f64(double* A, double* tau, double* T, double* Vt,
                       double* B, double* msg, unsigned* ctr, int FR, int FC,
                       int K, int p0, int pb, int j0, int tld, int nb, int b0,
                       int G, int rpt, int kb, int dev, void* stream) {
  if (nb <= 0) return 0;
  if (pb <= 0 || pb > kPanel || p0 < j0 || p0 + pb > K || K > FR || K > FC
      || G <= 0 || kb < 0 || kb > kMaxB || (kb && !B) || tld < pb
      || p0 - j0 + pb > tld || (long long)G * kWarps * rpt < FR - p0
      || (G > kClusterMax && (!msg || !ctr)) || nb > 65535)
    return (int)cudaErrorInvalidValue;
  sstpu::OnDevice on(dev);
  if (on.error() != cudaSuccess) return (int)on.error();
  const Args a{A, tau, T, Vt, B, msg, ctr, FR, FC, K, p0, pb, j0, tld, b0,
               G, kb};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (G <= kClusterMax) {
    if (rpt != kRptFree) return (int)cudaErrorInvalidValue;
    err = G == 1 ? launch_mode<kRptFree, kCta>(a, nb, s)
                 : launch_mode<kRptFree, kCluster>(a, nb, s);
  } else {
    switch (rpt) {
      case 8: err = launch_mode<8, kGrid>(a, nb, s); break;
      case 16: err = launch_mode<16, kGrid>(a, nb, s); break;
      case 24: err = launch_mode<24, kGrid>(a, nb, s); break;
      case 32: err = launch_mode<32, kGrid>(a, nb, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
