// native_gemm: one-launch tensor contraction over strided operands (sm_90a).
//
// Replaces the TPU kernel native_gemm_pallas (src/repro/kernels/sb_gemm.py,
// body _kernel), which every StridedBatchedGEMM entry point of the JAX
// package rides on: C[c_modes] = sum over the contracted modes of
// A[a_modes] * B[b_modes], for any mode order, with an f32 accumulator and
// the result cast to the output type on store.
//
// Addressing.  The wrapper (repro_torch/kernels/sb_gemm.py) describes each
// launch by the modes it walks, each with an extent and one element stride
// per tensor (0 where the tensor lacks the mode, or where a view broadcasts
// it).  Strides come straight from tensor.stride(), so transposed, sliced
// and stride-0 views are read in place: no operand is permuted or copied.
//
// Routes.  The wrapper's native_route picks one from layout and extents
// alone (no fallback: a route that cannot build or launch raises):
//   stream   (ns_read_kernel, nw_kernel) float32 with one big side and a
//            narrow other one, e.g. the HOOI contractions of the 512^3
//            tensor with a rank-10 factor;
//   splitk   (nk_kernel, nk_reduce) float32 with a narrow output and a
//            long contraction, e.g. HOOI's contractions of the 512x512x10
//            intermediates;
//   wgmma    (nm_kernel, nm_reduce) bf16 weight streaming, C[m, n] =
//            sum_k X[m, k] W[k, n] with both operands TMA-readable, e.g.
//            every dense and LM-head product of a served model, and the
//            weight gradients, whose contracted modes (b, s) fuse into one
//            (bsv,bse->ve among them);
//   batched  (nm_kernel) the same kernel for bf16 products with batch
//            modes or contracted modes that do not fuse, C[g.., m, n] =
//            sum over o.. and k of X[g.., o.., m, k] W[g.., o.., k, n],
//            e.g. the attention scores and P.V and the MoE expert products;
//   gathered (nm_gather_kernel) the same consumer for every other bf16
//            product with a contracted mode and an own C mode, its stages
//            gathered through any strides by a producer warpgroup: bf16
//            rows no tensor map can step, the Table II layouts in bf16;
//   fbatched (fb_kernel, fb_reduce) every other product, C[g.., m, n] =
//            sum over o.. and k of X[g.., o.., m, k] W[g.., o.., k, n] at
//            any strides on the FMA units: float32 (the Table II cases at
//            every extent, the paper's Figs. 1-8, HOOI's Gram
//            mnp,mqp->nq, bik,kn->bin), mixed bf16 x float32, degenerate
//            bf16 (outer products, no own C mode).
// The wrapper fuses contracted modes that are one mode in both operands
// (neighbours in the same order, the outer stride the inner extent times
// the inner stride) before it picks a route.  Every route accumulates in
// f32 and casts on store; splits reduce in a fixed order, with no atomics,
// so a launch gives the same bits every time.
//
// Bounds on an H100 (3.35 TB/s; 67 TFLOP/s of f32 FMA).  At the HOOI
// shapes every route is far below the f32 ridge (about 5 flop per byte at
// the biggest shapes against 20), so bytes bound them all:
//   stream   reads (or, in the write kind, writes) the 537 MB tensor once:
//            0.163 ms.  The big operand goes through a 3-stage TMA ring of
//            64 KB stages per SM (write kind: 16-byte stores from
//            registers), the narrow side sits in shared memory or in
//            registers, and each thread owns whole output rows (two in
//            the read kind), so no column is padded to a tile.
//            Persistent blocks keep the ring full across tiles.
//   splitk   reads a 10 MB operand for a 0.2 MB output: 0.003 ms, so launch
//            latency and parallelism bound it.  The tile spans the narrow
//            output mode whole, and the contraction is split across blocks
//            until there are about 8 blocks per SM, with partial sums
//            reduced in a fixed order by a second kernel (no atomics).
//   wgmma    at M <= 64 rows a weight-streaming product reads its bf16
//            weight once: 201 MB for a 6144 x 16384 weight, 0.060 ms,
//            while its 12.9 GFLOP at 64 rows take 0.013 ms on the tensor
//            cores (989 TFLOP/s), so padding a decode product's 1-4 rows to
//            wgmma's 64 costs nothing that shows, and bytes in flight per
//            SM are what matter.  3.35 TB/s over ~1 us of loaded DRAM
//            latency is ~3.4 MB in flight across the card, ~25 KB per SM.
//            A block keeps its ring of NM_STAGES = 4 stages of 24 KB in
//            flight (64 KB of it W), 2.5x that, and 98 KB of shared memory
//            leave room for two blocks per SM.  The tile is 64 x 128, not
//            64 x 256: tensor-core work is not the bound, and the narrower
//            tile gives twice the tiles (8 at N = 1024, 128 at N = 16384),
//            so fewer splits fill the card and less partial-sum traffic
//            goes through the workspace, with 64 accumulators per thread.
//            Where column tiles are fewer than the SMs, the contraction
//            is split (the wrapper's wgmma_plan: column tiles x splits
//            nearest one block per SM, each split at least one ring deep)
//            and the partial sums reduced in split order by nm_reduce: no
//            atomics, the same bits on every launch.  The split depends
//            on N and K, never on M, so a row's bits do not depend on
//            which rows share its launch (a batched decode step gives a
//            request the tokens it gets alone).  Only such a product is
//            split: one with X M-major (a weight gradient), a grid mode or
//            an outer contracted mode never is, so nothing a launch shares
//            with other rows, requests or slots changes a row's sums.
//   batched  see the section "wgmma and batched" below.
//   gathered see the section "gathered" below: bound by bytes.
//   fbatched see the section "fbatched" below: bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// most grid and outer contracted modes of one fbatched or gathered launch
#define SB_MAX_MODES 8
// contracted indices per partial sum of a float32 walk (see "Split and
// sums" under "fbatched"), counted from k = 0
#define SB_SUM_CHUNK 4096

template <typename T> __device__ __forceinline__ T sb_from_f32(float x);
template <> __device__ __forceinline__ float sb_from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 sb_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ===================================================== routes stream and splitk
//
// Both take float32 operands in which one operand W carries the contracted
// mode k and one narrow mode (the wrapper's native_route finds them):
//   read kind   C[m, r] = sum_k X[m, k] W[k, r], r at most NR_NARROW wide, m
//               every other C mode (up to 3, decoded innermost first);
//   write kind  C[m, p] = sum_k X[m, k] W[p, k], k at most NR_NARROW deep, p
//               C's minor-most mode.
// Every output element is summed by one thread in a fixed order, or, split
// over k, from partial sums reduced in a fixed order: the same inputs give
// the same bits on every launch.

#define NR_NARROW 16

struct NrDesc {
  int64_t m_ext[3], m_xs[3], m_cs[3];  // the C modes of X, innermost first
  int64_t M, K, xk, wk, R, wr, cr;     // rows (product of m_ext), k, r
  int32_t n_m, kc, n_split, rp;        // splitk: k per split, splits; r padded to 4
};

struct NwDesc {
  int64_t M, P, K, xm, xk, wp, wk, cm;  // C[m * cm + p]
};

// acc[r] += x * w[r] for r < RP, w 16-byte aligned in shared memory (every
// thread reads the same w: a broadcast).
template <int RP>
__device__ __forceinline__ void nr_fma(float (&acc)[RP], float x, const float* w) {
#pragma unroll
  for (int q = 0; q < RP / 4; ++q) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + 4 * q);
    acc[4 * q] = fmaf(x, w4.x, acc[4 * q]);
    acc[4 * q + 1] = fmaf(x, w4.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(x, w4.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(x, w4.w, acc[4 * q + 3]);
  }
}

template <int RP, typename TC>
__device__ __forceinline__ void nr_store_row(TC* __restrict__ C, int64_t co, const NrDesc& d,
                                             const float (&acc)[RP]) {
#pragma unroll
  for (int r = 0; r < RP; ++r)
    if (r < d.R) C[co + r * d.cr] = sb_from_f32<TC>(acc[r]);
}

// ---------------------------------------------------------- stream, read kind
// One C mode m of at least one tile per SM, X read through a 2-D tensor
// map.  Persistent: each block walks tiles blockIdx.x, + gridDim.x, ...; a
// producer warp keeps NS_STAGES stages in flight across tile boundaries,
// each NS_RPT boxes of NS_TU rows x NS_BK k (64 KB), and each of NS_TU
// consumer threads owns NS_RPT rows of C (t and t + NS_TU of the tile) with
// their R sums in registers, so one broadcast read of W feeds NS_RPT rows.
// W (k-padded, zero past K and R) sits in shared memory for the whole
// launch.
#define NS_TU 256  // consumer threads; rows per box
#define NS_RPT 2   // rows per consumer thread: boxes per stage
#define NS_BK 32   // 32 f32 = one 128-byte swizzle span
#define NS_STAGES 3
#define NS_THREADS (NS_TU + 32)
#define NS_BOX_BYTES (NS_TU * NS_BK * 4)
#define NS_STAGE_BYTES (NS_RPT * NS_BOX_BYTES)
#define NS_TILE (NS_RPT * NS_TU)  // rows per tile
#define NS_W_BYTES_MAX (32 * 1024)  // with the ring: 230,448 of 232,448 bytes

static size_t ns_smem_bytes(int64_t K, int rp) {
  const int64_t kpad = (K + NS_BK - 1) / NS_BK * NS_BK;
  return 1024 + (size_t)NS_STAGES * NS_STAGE_BYTES + (size_t)kpad * rp * 4 + 16 * NS_STAGES;
}

// KFAST: X's k is stride-1; a box is [NS_TU rows][32 k] under the
// 128-byte swizzle (16-byte chunk c of row t at chunk c ^ (t % 8)), so
// thread t's float4 reads of its own row hit 8 distinct chunks per 8
// lanes: no bank conflict.  Otherwise m is stride-1 and a box is [32
// k][NS_TU rows]: thread t reads column t, conflict-free.
template <int RP, bool KFAST, typename TC>
__global__ void __launch_bounds__(NS_THREADS, 1)
ns_read_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ W,
               TC* __restrict__ C, const NrDesc d, int n_tiles) {
  extern __shared__ uint8_t ns_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(ns_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* ring = reinterpret_cast<float*>(sm);
  float* wsm = reinterpret_cast<float*>(sm + NS_STAGES * NS_STAGE_BYTES);
  const int kpad = (int)((d.K + NS_BK - 1) / NS_BK * NS_BK);
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + kpad * RP);
  uint64_t* empty = full + NS_STAGES;

  for (int e = threadIdx.x; e < kpad * RP; e += NS_THREADS) {
    const int k = e / RP, r = e % RP;
    wsm[e] = k < d.K && r < d.R ? W[k * d.wk + r * d.wr] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS_STAGES; ++s) {
      hp_bar_init(&full[s], 1);
      hp_bar_init(&empty[s], NS_TU / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_k = kpad / NS_BK;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= NS_TU) {  // producer warp: lane 0 issues every copy
    if (lane == 0) {
      int64_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int kb = 0; kb < n_k; ++kb, ++it) {
          const int s = (int)(it % NS_STAGES);
          if (it >= NS_STAGES) hp_bar_wait(&empty[s], (int)((it / NS_STAGES - 1) & 1));
          float* dst = ring + s * (NS_STAGE_BYTES / 4);
          hp_bar_expect(&full[s], NS_STAGE_BYTES);
#pragma unroll
          for (int b = 0; b < NS_RPT; ++b) {
            const int m0 = tile * NS_TILE + b * NS_TU;
            if (KFAST) hp_tma_load(dst + b * (NS_BOX_BYTES / 4), &xmap, &full[s], kb * NS_BK, m0);
            else hp_tma_load(dst + b * (NS_BOX_BYTES / 4), &xmap, &full[s], m0, kb * NS_BK);
          }
        }
    }
    return;
  }

  const int t = threadIdx.x;
  int64_t it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc[NS_RPT][RP];
#pragma unroll
    for (int b = 0; b < NS_RPT; ++b)
#pragma unroll
      for (int r = 0; r < RP; ++r) acc[b][r] = 0.f;
    for (int kb = 0; kb < n_k; ++kb, ++it) {
      const int s = (int)(it % NS_STAGES);
      hp_bar_wait(&full[s], (int)((it / NS_STAGES) & 1));
      const float* xs = ring + s * (NS_STAGE_BYTES / 4);
      const float* w = wsm + kb * NS_BK * RP;
      if (KFAST) {
#pragma unroll
        for (int c = 0; c < NS_BK / 4; ++c) {
          float4 x4[NS_RPT];
#pragma unroll
          for (int b = 0; b < NS_RPT; ++b)
            x4[b] = *reinterpret_cast<const float4*>(xs + b * (NS_BOX_BYTES / 4) + t * NS_BK +
                                                     4 * (c ^ (t % 8)));
#pragma unroll
          for (int b = 0; b < NS_RPT; ++b) nr_fma<RP>(acc[b], x4[b].x, w + (4 * c) * RP);
#pragma unroll
          for (int b = 0; b < NS_RPT; ++b) nr_fma<RP>(acc[b], x4[b].y, w + (4 * c + 1) * RP);
#pragma unroll
          for (int b = 0; b < NS_RPT; ++b) nr_fma<RP>(acc[b], x4[b].z, w + (4 * c + 2) * RP);
#pragma unroll
          for (int b = 0; b < NS_RPT; ++b) nr_fma<RP>(acc[b], x4[b].w, w + (4 * c + 3) * RP);
        }
      } else {
#pragma unroll 8
        for (int kk = 0; kk < NS_BK; ++kk)
#pragma unroll
          for (int b = 0; b < NS_RPT; ++b)
            nr_fma<RP>(acc[b], xs[b * (NS_BOX_BYTES / 4) + kk * NS_TU + t], w + kk * RP);
      }
      __syncwarp();
      if (lane == 0) hp_bar_arrive(&empty[s]);
    }
#pragma unroll
    for (int b = 0; b < NS_RPT; ++b) {
      const int64_t m = (int64_t)tile * NS_TILE + b * NS_TU + t;
      if (m < d.M) nr_store_row<RP, TC>(C, m * d.m_cs[0], d, acc[b]);
    }
  }
}

// --------------------------------------------------------- stream, write kind
// C (M, P) with P stride-1, k at most NR_NARROW deep.  Each warp owns 128
// columns (4 per lane) with its lanes' W[p, 0..K) in registers, loaded once
// per block; a block stages NW_TU rows of X in shared memory and writes
// them out, 16 bytes per lane where P allows.  Persistent over row tiles.
#define NW_TU 64
#define NW_THREADS 256

template <typename TC> __device__ __forceinline__ void nw_store4(TC* p, const float (&a)[4]);
template <> __device__ __forceinline__ void nw_store4<float>(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
template <>
__device__ __forceinline__ void nw_store4<__nv_bfloat16>(__nv_bfloat16* p, const float (&a)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

template <typename TC>
__global__ void __launch_bounds__(NW_THREADS)
nw_kernel(const float* __restrict__ X, const float* __restrict__ W, TC* __restrict__ C,
          const NwDesc d, int cw_blk, int64_t n_tiles) {
  __shared__ float xs[NR_NARROW * NW_TU];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = warp % cw_blk, phase = warp / cw_blk, n_phase = NW_THREADS / 32 / cw_blk;
  const int64_t p0 = ((int64_t)blockIdx.y * cw_blk + chunk) * 128 + 4 * lane;
  float w[NR_NARROW][4];
#pragma unroll
  for (int k = 0; k < NR_NARROW; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[k][j] = k < d.K && p0 + j < d.P ? W[(p0 + j) * d.wp + k * d.wk] : 0.f;
  const bool vec = d.P % 4 == 0 && d.cm % 4 == 0;  // 4 columns start 4-element aligned
  const int K = (int)d.K;

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t u0 = tile * NW_TU;
    __syncthreads();  // the previous tile's rows are read
    for (int e = threadIdx.x; e < K * NW_TU; e += NW_THREADS) {
      const int k = e / NW_TU, r = e % NW_TU;
      xs[e] = u0 + r < d.M ? X[(u0 + r) * d.xm + k * d.xk] : 0.f;
    }
    __syncthreads();
    if (p0 >= d.P) continue;
    for (int r = phase; r < NW_TU && u0 + r < d.M; r += n_phase) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < NR_NARROW; ++k) {
        if (k < K) {
          const float x = xs[k * NW_TU + r];
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = fmaf(x, w[k][j], a[j]);
        }
      }
      TC* c = C + (u0 + r) * d.cm + p0;
      if (vec) {
        nw_store4<TC>(c, a);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p0 + j < d.P) c[j] = sb_from_f32<TC>(a[j]);
      }
    }
  }
}

// ------------------------------------------------------------------- splitk
// Few rows (fewer than one stream tile per SM), a long k: a block of
// NK_TU threads owns NK_TU rows, one each, over k range blockIdx.y * kc ..
// + kc, reading X straight from global memory NK_UNROLL loads at a time
// (rows innermost-first, so neighbouring threads read neighbouring
// addresses where X's innermost C mode is stride-1) against W staged in
// shared memory NK_WROWS k at a time.  One split writes C; several write
// f32 partial sums to the workspace [split][r][m], which nk_reduce sums in
// split order and casts.
#define NK_TU 128
#define NK_UNROLL 16
#define NK_WROWS 256

template <int RP, typename TC>
__global__ void __launch_bounds__(NK_TU)
nk_kernel(const float* __restrict__ X, const float* __restrict__ W, TC* __restrict__ C,
          float* __restrict__ ws, const NrDesc d) {
  __shared__ __align__(16) float wsm[NK_WROWS * RP];
  const int64_t k0 = (int64_t)blockIdx.y * d.kc;
  const int kn = (int)(d.K - k0 < d.kc ? d.K - k0 : d.kc);
  const int64_t m = (int64_t)blockIdx.x * NK_TU + threadIdx.x;
  const bool live = m < d.M;
  int64_t xo = 0, co = 0, rem = m;
  for (int i = 0; i < d.n_m; ++i) {
    const int64_t idx = rem % d.m_ext[i];
    rem /= d.m_ext[i];
    xo += idx * d.m_xs[i];
    co += idx * d.m_cs[i];
  }
  const float* x = X + xo + k0 * d.xk;
  float acc[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc[r] = 0.f;

  for (int kb = 0; kb < kn; kb += NK_WROWS) {
    const int nb = kn - kb < NK_WROWS ? kn - kb : NK_WROWS;
    __syncthreads();  // the previous W rows are read
    for (int e = threadIdx.x; e < nb * RP; e += NK_TU) {
      const int k = e / RP, r = e % RP;
      wsm[e] = r < d.R ? W[(k0 + kb + k) * d.wk + r * d.wr] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const float* xb = x + kb * d.xk;
    int k = 0;
    for (; k + NK_UNROLL <= nb; k += NK_UNROLL) {
      float v[NK_UNROLL];
#pragma unroll
      for (int j = 0; j < NK_UNROLL; ++j) v[j] = __ldg(xb + (k + j) * d.xk);
#pragma unroll
      for (int j = 0; j < NK_UNROLL; ++j) nr_fma<RP>(acc, v[j], wsm + (k + j) * RP);
    }
    for (; k < nb; ++k) nr_fma<RP>(acc, __ldg(xb + k * d.xk), wsm + k * RP);
  }
  if (!live) return;
  if (d.n_split == 1) {
    nr_store_row<RP, TC>(C, co, d, acc);
  } else {
#pragma unroll
    for (int r = 0; r < RP; ++r)
      if (r < d.R) ws[((int64_t)blockIdx.y * d.R + r) * d.M + m] = acc[r];
  }
}

template <typename TC>
__global__ void __launch_bounds__(256)
nk_reduce(const float* __restrict__ ws, TC* __restrict__ C, const NrDesc d) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x, plane = d.R * d.M;
  if (i >= plane) return;
  float sum = 0.f;
  for (int s = 0; s < d.n_split; ++s) sum += ws[s * plane + i];
  const int64_t r = i / d.M;
  int64_t rem = i % d.M, co = r * d.cr;
  for (int j = 0; j < d.n_m; ++j) {
    co += rem % d.m_ext[j] * d.m_cs[j];
    rem /= d.m_ext[j];
  }
  C[co] = sb_from_f32<TC>(sum);
}

// --------------------------------------------------------- wgmma and batched
// bf16 products on the tensor cores, C[g.., m, n] = sum over o.. and k of
// X[g.., o.., m, k] W[g.., o.., k, n].  Route "wgmma" has neither g nor o:
// X (M, K) and W (K, N) are plain matrices, as in weight streaming (every
// dense and LM-head product of a served model) and the weight gradients,
// whose contracted modes (b, s) the wrapper fuses into one k.  Route
// "batched" has up to NM_MAX_EXTRA "extra" modes: grid modes g (batch modes,
// in X, W and C: the attention heads, the MoE experts; and C modes of X that
// do not fuse into the row mode m) and outer contracted modes o (one that
// does not fuse with k: r beside s in a GQA attention's dK and dV).  X is
// read K-major or M-major, W N-major or K-major (the wrapper's native_plan
// checks the layout).  Both routes replace the same TPU kernel as the
// routes above (native_gemm_pallas, src/repro/kernels/sb_gemm.py), whose
// grid axes are every C mode.
//
// Design.  One block owns a TM x NM_BN tile of C at one grid index: TM is
// NM_TM (one consumer warpgroup) where M <= NM_TM, as in weight streaming
// and decode, else NM_TM_WIDE (two), which halves W's reads for wide M (a
// weight gradient's 2304 to 122880 rows, S query rows, C2 expert tokens).
// Each consumer warpgroup runs wgmma m64nNM_BNk16 into NM_BN / 2 f32
// accumulators per thread, and lane 0 of one producer warp feeds a ring of
// stages by TMA under the 128-byte swizzle, each stage a 64-deep slab of X
// (TM rows, 8 KB per 64) and of W (NM_BN columns, 16 KB), guarded by a
// "full" and an "empty" mbarrier.  The ring is NM_STAGES deep at NM_TM and
// NM_STAGES_WIDE at NM_TM_WIDE: 96 KB either way, so two blocks share an
// SM and one's loads cover the other's waits: on an H100 the paths' wide
// products ran faster so than with a 4-deep ring and one block an SM, or
// than on 64-row tiles (PERF.md).  The tensor maps have rank 2 + the
// operand's extra modes (at most 5): its two matrix modes, and each extra
// mode as a dimension of box extent 1, whose coordinate is the block's grid
// index or, for an outer contracted mode, the producer's outer index (the
// K loop runs k's stages within each outer index).  Dimensions are ordered
// by stride, the stride-1 mode first.  The maps' extents are the true ones,
// so rows past M, columns past N and depth past K (an expert's C2 = 341
// tokens) read as zeros and a sliced operand reads no neighbour; the store
// masks rows >= M and columns >= N.  blockIdx.x is the tile (m fastest, so
// the m-tiles of one n-tile share W in L2, then n, then the grid index),
// blockIdx.y the split of the contraction: kc indices, a multiple of
// NM_BK, so only the last split runs past K.  One split stores C at its
// grid offset; several (the wgmma route only) store f32 partial sums to ws
// [split][M][N], which nm_reduce sums in split order and casts.
//
// Bound.  Weight streaming: see "wgmma" above.  The batched products sit
// near the bf16 ridge on the bytes side: an expert product at C2 341 rows
// does 118 GFLOP over 0.49 GB (0.146 ms of bytes against 0.119 of
// operations on an H100), the scores of a 4 x 512-token train step 4.8
// GFLOP over 0.094 GB (0.028 ms).  So both operands must stream at the
// memory's rate and the sums must not hold them back: the first slice's
// kernels staged scalar loads as f32 and summed on the CUDA cores (0.4-1.6%
// of the bound on the card); here TMA reads and the tensor cores sum.
#define NM_TM 64          // output rows per block at M <= NM_TM: one consumer warpgroup
#define NM_TM_WIDE 128    // ... at M > NM_TM: two consumer warpgroups
#define NM_BN 128         // output columns per block
#define NM_BK 64          // depth per stage: 64 bf16 are one 128-byte swizzle span
#define NM_STAGES 4       // ring depth at NM_TM: 4 x 24 KB
#define NM_STAGES_WIDE 3  // ... at NM_TM_WIDE: 3 x 32 KB, so two blocks share an SM too
#define NM_MAX_EXTRA 3    // grid and outer contracted modes: rank 2 + 3 = 5, TMA's most
#define NM_BOX (64 * NM_BK * 2)  // one [64][64] bf16 box: 8 KB

template <int TM>
struct NmTile {
  static constexpr int WGS = TM / 64;                                // consumer warpgroups
  static constexpr int THREADS = WGS * 128 + 32;                     // + one producer warp
  static constexpr int X_BYTES = WGS * NM_BOX;                       // X slab
  static constexpr int STAGE_BYTES = X_BYTES + NM_BN / 64 * NM_BOX;  // X slab, then W slab
  static constexpr int STAGES = TM == NM_TM ? NM_STAGES : NM_STAGES_WIDE;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * STAGES;       // + alignment slack
};

struct NmDesc {
  int64_t M, N, K;
  int64_t ext[NM_MAX_EXTRA];     // extra modes' extents: n_grid grid modes, innermost in C
                                 // first, then the outer contracted modes (1: unused)
  int64_t xs[2 + NM_MAX_EXTRA];  // X's element strides: m, k, the extra modes
  int64_t ws[2 + NM_MAX_EXTRA];  // W's: n, k, the extra modes (0: W lacks a grid mode)
  int64_t cs[1 + NM_MAX_EXTRA];  // C's: m, the grid modes (n is stride-1; 0 past them)
  int32_t n_grid, n_extra, kc, n_split;  // contracted indices per split, splits
};

// What each dimension of a tensor map stands for: 0 the operand's row or
// column mode (m or n), 1 k, 2 + j extra mode j.
struct NmRoles {
  int8_t x[2 + NM_MAX_EXTRA], w[2 + NM_MAX_EXTRA];
  int32_t x_rank, w_rank;
};

// One accumulator fragment (see hp_wgmma_ss) into rows m0.., columns n0..
// of out (row stride ld, column stride cn), masked to M x N; pairs of
// columns are stored together where cn is 1, ld even and out 2-element
// aligned (they then start 2-element aligned).  Warp w of the block takes
// rows 16w.., so a second consumer warpgroup (warps 4-7) stores rows 64..
// of the tile.
template <typename TO>
__device__ __forceinline__ void nm_store(TO* __restrict__ out, int64_t ld, int64_t cn,
                                         const float* acc, int64_t M, int64_t N, int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + 16 * warp + lane / 4;
  const bool pairs = cn == 1 && ld % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % (2 * sizeof(TO)) == 0;
#pragma unroll
  for (int i = 0; i < NM_BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      TO* p = out + (int64_t)row * ld + col * cn;
      const float x0 = acc[4 * i + 2 * h], x1 = acc[4 * i + 2 * h + 1];
      if (pairs && col + 1 < N) {
        hp_store2<TO>(p, x0, x1);
      } else {
        p[0] = sb_from_f32<TO>(x0);
        if (col + 1 < N) p[cn] = sb_from_f32<TO>(x1);
      }
    }
  }
}

// One box of an operand's map at row or column mn, depth k and extra-mode
// coordinates e.
__device__ __forceinline__ void nm_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                        const int8_t* role, int rank, int mn, int k,
                                        const int (&e)[NM_MAX_EXTRA]) {
  int c[2 + NM_MAX_EXTRA];
#pragma unroll
  for (int i = 0; i < 2 + NM_MAX_EXTRA; ++i)  // constant indices only: c, e stay in registers
    c[i] = role[i] == 0   ? mn
           : role[i] == 1 ? k
           : role[i] == 2 ? e[0]
           : role[i] == 3 ? e[1]
                          : e[2];
  hp_tma_load_n(dst, map, bar, c, rank);
}

// TM: the tile's rows (NM_TM or NM_TM_WIDE).  XM: X is M-major (m
// stride-1, wgmma's transpose bit for A); else K-major.  WK: W is K-major
// (stored (N, K)); else N-major (n stride-1, wgmma's transpose bit for B).
template <int TM, int XM, int WK, typename TC>
__global__ void __launch_bounds__(NmTile<TM>::THREADS, 1)
nm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
          TC* __restrict__ C, float* __restrict__ ws, const NmDesc d, const NmRoles r) {
  using T = NmTile<TM>;
  extern __shared__ uint8_t nm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(nm_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::BAR_OFF);
  uint64_t* empty = full + T::STAGES;

  const int64_t mt = (d.M + TM - 1) / TM, nt = (d.N + NM_BN - 1) / NM_BN;
  const int64_t tile = blockIdx.x % (mt * nt);
  const int m0 = (int)(tile % mt) * TM, n0 = (int)(tile / mt) * NM_BN;
  // the extra modes' coordinates: the block's grid index, innermost first;
  // the producer sets the outer contracted ones as it goes
  int e[NM_MAX_EXTRA];
  int64_t g = blockIdx.x / (mt * nt);
#pragma unroll
  for (int j = 0; j < NM_MAX_EXTRA; ++j) {
    e[j] = j < d.n_grid ? (int)(g % d.ext[j]) : 0;
    if (j < d.n_grid) g /= d.ext[j];
  }
  const int64_t k_begin = (int64_t)blockIdx.y * d.kc;
  const int64_t k_len = d.K - k_begin < d.kc ? d.K - k_begin : d.kc;
  const int n_in = (int)((k_len + NM_BK - 1) / NM_BK);  // k's stages per outer index
  int n_k = n_in;
  for (int j = d.n_grid; j < d.n_extra; ++j) n_k *= (int)d.ext[j];

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hp_bar_init(&full[s], 1);
      hp_bar_init(&empty[s], 4 * T::WGS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * T::WGS) {  // producer warp: lane 0 issues every copy
    // without extra modes both maps are 2-D, the stride-1 mode first (the
    // order XM and WK give): their coordinates need no roles, and k's stage
    // no division (weight streaming issues its loads as fast as it can)
    const bool flat = d.n_extra == 0, outer = d.n_extra > d.n_grid;
    if (lane == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % T::STAGES;
        const int k0 = (int)(k_begin + (int64_t)(outer ? it % n_in : it) * NM_BK);
        if (outer) {
          int o = it / n_in;
#pragma unroll
          for (int j = 0; j < NM_MAX_EXTRA; ++j)
            if (j >= d.n_grid && j < d.n_extra) {
              e[j] = o % (int)d.ext[j];
              o /= (int)d.ext[j];
            }
        }
        if (it >= T::STAGES) hp_bar_wait(&empty[s], (it / T::STAGES - 1) & 1);
        uint8_t* xs = sm + s * T::STAGE_BYTES;
        uint8_t* wsm = xs + T::X_BYTES;
        hp_bar_expect(&full[s], T::STAGE_BYTES);
        if (XM) {  // [64 k][64 m] boxes, one per consumer warpgroup
#pragma unroll
          for (int j = 0; j < T::WGS; ++j)
            if (flat) hp_tma_load(xs + j * NM_BOX, &xmap, &full[s], m0 + 64 * j, k0);
            else nm_load(xs + j * NM_BOX, &xmap, &full[s], r.x, r.x_rank, m0 + 64 * j, k0, e);
        } else {   // one [TM m][64 k] box
          if (flat) hp_tma_load(xs, &xmap, &full[s], k0, m0);
          else nm_load(xs, &xmap, &full[s], r.x, r.x_rank, m0, k0, e);
        }
        if (WK) {  // one [NM_BN n][64 k] box
          if (flat) hp_tma_load(wsm, &wmap, &full[s], k0, n0);
          else nm_load(wsm, &wmap, &full[s], r.w, r.w_rank, n0, k0, e);
        } else {   // [64 k][64 n] boxes
#pragma unroll
          for (int j = 0; j < NM_BN / 64; ++j)
            if (flat) hp_tma_load(wsm + j * NM_BOX, &wmap, &full[s], n0 + 64 * j, k0);
            else nm_load(wsm + j * NM_BOX, &wmap, &full[s], r.w, r.w_rank, n0 + 64 * j, k0, e);
        }
      }
    }
    return;
  }

  float acc[NM_BN / 2];
#pragma unroll
  for (int i = 0; i < NM_BN / 2; ++i) acc[i] = 0.f;
  // warpgroup w reads rows 64w.. of the X slab: its own box (M-major), or
  // the rows 8 KB on in the one box (K-major, whole 8-row swizzle groups)
  hp_consume_ring<XM, WK, T::STAGES>(acc, sm, T::STAGE_BYTES, (warp / 4) * NM_BOX, T::X_BYTES,
                                     full, empty, n_k);

  if (d.n_split == 1) {
    int64_t off = 0;
#pragma unroll
    for (int j = 0; j < NM_MAX_EXTRA; ++j)
      if (j < d.n_grid) off += e[j] * d.cs[1 + j];
    nm_store<TC>(C + off, d.cs[0], 1, acc, d.M, d.N, m0, n0);
  } else {
    nm_store<float>(ws + (int64_t)blockIdx.y * d.M * d.N, d.N, 1, acc, d.M, d.N, m0, n0);
  }
}

template <typename TC>
__global__ void __launch_bounds__(256)
nm_reduce(const float* __restrict__ ws, TC* __restrict__ C, const NmDesc d) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x, plane = d.M * d.N;
  if (i >= plane) return;
  float sum = 0.f;
  for (int s = 0; s < d.n_split; ++s) sum += ws[s * plane + i];
  C[i / d.N * d.cs[0] + i % d.N] = sb_from_f32<TC>(sum);
}

// ================================================================ fbatched
// Every float32 product that takes neither stream nor splitk: the Table II
// cases and the paper's Figs. 1-8 (n x n x n products, batch modes, both
// operands wide), HOOI's Gram mnp,mqp->nq (two contracted modes that do
// not fuse), the compiled program's bik,kn->bin; every mixed bf16 x
// float32 product; the bf16 products with no contracted or no own C mode
// (outer products, batch modes alone), which no tensor-core tile fits.  The wrapper's
// native_plan gives the product the batched route's form, C[g.., m, n] =
// sum over o.. and k of X[g.., o.., m, k] W[g.., o.., k, n], with none of
// its tensor-map limits: a grid mode g may be carried by X, by W or by both
// (stride 0 in the operand that lacks it; the Table II cases in which the
// operand with C's minor-most mode carries a second C mode), outer
// contracted modes o are walked in the kernel, strides are any that
// tensor.stride() gives, up to FB_MAX_EXTRA extra modes.  It replaces the
// same TPU kernel as the routes above (native_gemm_pallas,
// src/repro/kernels/sb_gemm.py).
//
// Bound.  Operations: Table II at n = 256 is 8.6 GFLOP over 0.13 GB (65
// flop a byte, against the H100's f32 ridge of 20), 0.128 ms at 67 TFLOP/s
// of f32 FMA; the Gram is 137 GFLOP, 2.05 ms.  So the FMA units must be fed
// every cycle: the design is the classic SIMT GEMM on a cp.async ring.
//
// Design.  A block of FB_THREADS = 256 threads owns a TM x TN tile of C at
// one grid index: FB_TM x FB_TN, or FB_TM x FB_TN_NARROW where N is at most
// that wide, or FB_TM_SMALL x FB_TN_NARROW for a product of at most
// FB_TM_SMALL rows (Table II's ragged p = 47) or one too small to give half
// the SMs a tile and too shallow to split (Table II at n = 64, where
// 128-row tiles ran up to 1.5x slower on an H100 than the first slice's
// 64 x 64 ones).  Thread (ty, tx) (fb_ty, fb_tx: 16 x 16) owns TM / 16 x
// TN / 16 outputs: rows 4 ty + i and, in a 128-row tile, 64 + 4 ty + i,
// columns 4 tx + j and, in a 128-column one, 64 + 4 tx + j (i, j < 4), so
// that each read of a k-row of a slab is a float4.  The walk is
// the contraction flattened: FB_BK-deep stages along k within each outer
// index, outer index slowest; FB_STAGES stages are in flight in a ring of
// shared memory, loaded by cp.async (16-byte copies along an operand's
// stride-1 mode where its strides and start allow, with the ragged tail's
// bytes zero-filled by the copy itself, else 4-byte copies), and the
// compute of one stage overlaps the loads of the next FB_STAGES - 1: one
// barrier a stage.  Each slab is laid out for the stride-1 mode of its
// operand: [FB_BK][rows] where the row mode (m of X, n of W) is the smaller
// stride, so that a thread's 4 rows or columns are one float4; else
// k-major, [rows][FB_BK], each row's eight 16-byte chunks swizzled (chunk q
// of row r at q ^ ((r / 4) % 8)), so that a thread's four k at one row are
// one float4 and the eight rows a quarter-warp reads at once (4 tx + j, tx
// < 8) hit eight distinct bank groups.  All four layouts of X and W occur
// in Table II.  One block owns one tile: a persistent grid, whose ring
// ran on from one tile's walk into the next, took longer on an H100 in
// an A/B of the two.  Tile, grid and split offsets are decoded once per
// block, the outer offsets once per outer index.  Products accumulate in f32
// registers with plain FMA (no TF32), in k order.
//
// A bf16 operand (flags FB_F_X_BF16, FB_F_W_BF16) cannot take the f32
// slabs' cp.async, which copies bytes and cannot widen.  Where its slab
// loads 16 bytes at a time (FB_F_VEC_*), its raw bf16 slabs take a ring of
// their own (FB_F_RAW_X or FB_F_RAW_W, one operand at most: the 128 x 128
// tile's smem holds one such ring), filled by cp.async FB_STAGES - 1
// stages ahead like the f32 ones; each thread widens the 16-byte chunks it
// copied itself into the f32 slab right after its copies of the stage
// land and before the stage's barrier, so no other thread waits on them
// and nothing is held in registers across the FMA.  Any other bf16
// operand (element loads, or the second of two) is loaded into registers,
// an element at a time, by each thread right after its FMA of stage it,
// for stage it + 1, and stored widened before the next barrier: its loads
// overlap the FMA the other warps still run.  (Both ways keep registers free: loading before
// the FMA, as a pre-Ampere double buffer does, keeps the loaded values
// live across it, and on an H100 the 128-row kernels, at 255 registers,
// then spilled, and so did the float32 walk beside such a walk in one
// kernel.)  A launch with a bf16 operand runs fb_kernel's WIDEN
// instantiation; the float32 ones are the walk alone.
//
// Split and sums.  A walk of more than SB_SUM_CHUNK contracted indices
// (FB_CHUNK_STAGES stages) keeps its running sums in shared memory and each
// chunk's in registers, added at the chunk's end (flag FB_F_CHUNKED):
// ((0 + c0) + c1) + ... over the chunk sums c.  One running sum over a long
// contraction (HOOI's 512 x 512 Gram sums 262144 products) grows its
// rounding error with the square root of the depth, and on an H100 put the
// Gram 2.2e-5 of the result from cuBLAS's; chunks grow it with the square
// roots of 4096 and of the number of chunks instead.  Chunks are counted
// from k = 0, so no result depends on the tile.  Where the output tiles
// are fewer than FB_SPLIT_PER_SM per SM, the wrapper's fbatched_plan
// splits the walk across blocks (blockIdx.y), one chunk a split; each
// split stores its chunk sum to the workspace [split][g][m][n], and
// fb_reduce adds them in split order from 0: the same sums in the same
// order as one block's chunked walk, so whether a product splits (which
// depends on its rows and grid) moves no bit of a row, and no atomics are
// used.  fb_launch refuses any other split.
#define FB_TM 128           // output rows per block
#define FB_TN 128           // output columns per block
#define FB_TN_NARROW 64     // ... where N is at most this wide
#define FB_TM_SMALL 64      // rows (and FB_TN_NARROW columns) of a small product's tile
#define FB_BK 32            // depth per stage: one 128-byte row of a k-major slab
#define FB_STAGES 4         // ring depth: 4 x 32 KB at FB_TN
#define FB_THREADS 256      // 16 x 16 threads, 8 x 8 outputs each at FB_TN
#define FB_SPLIT_PER_SM 2   // a product with fewer tiles per SM is split
#define FB_MAX_EXTRA SB_MAX_MODES
#define FB_CHUNK_STAGES (SB_SUM_CHUNK / FB_BK)
#define FB_F_CHUNKED 1      // flags: a block's walk is longer than one chunk
#define FB_F_VEC_X 2        // X's slabs load 16 bytes at a time
#define FB_F_VEC_W 4        // W's too
#define FB_F_VEC_C 8        // C's rows store float4s (n stride-1, 16-byte aligned rows)
#define FB_F_X_KMAJOR 16    // X's slabs are laid out k-major
#define FB_F_W_KMAJOR 32    // W's too
#define FB_F_NARROW_N 64    // the tile has FB_TN_NARROW columns
#define FB_F_SMALL 128      // ... and FB_TM_SMALL rows
#define FB_F_X_BF16 256     // X is bf16: its slabs are widened on the way to shared memory
#define FB_F_W_BF16 512     // W too
#define FB_F_RAW_X 16384    // X's bf16 slabs go through the raw ring (see "A bf16 operand")
#define FB_F_RAW_W 32768    // ... W's (one operand at most)

struct FbDesc {
  int64_t M, N, K;                // rows, columns, depth (0: C is zeros)
  int64_t xm, xk, wn, wk, cm, cn;  // the tile modes' strides
  int64_t ext[FB_MAX_EXTRA];       // n_grid grid modes, then the outer contracted modes
  int64_t xs[FB_MAX_EXTRA];        // X's strides of the extra modes (0: X lacks a grid mode)
  int64_t ws[FB_MAX_EXTRA];        // W's
  int64_t cs[FB_MAX_EXTRA];        // C's (0 past the grid modes)
  int64_t G, steps, spc;           // grid indices; stages of the walk; stages per split
  int32_t n_grid, n_extra, n_split, flags;
};

__device__ __forceinline__ int fb_swz(int r) { return (r >> 2) & 7; }

// The thread's place (ty, tx) in the 16 x 16 grid of a tile's 8 x 8 (8 x 4)
// output blocks: a warp covers 4 ty by 8 tx, so a k-row read of a slab is 4
// distinct float4s of X and 8 of W (one 128-byte wavefront each), where 2
// by 16 took 2 of W; it ran faster on an H100 in an A/B of the two.
__device__ __forceinline__ int fb_tx() { return threadIdx.x / 32 % 2 * 8 + threadIdx.x % 8; }
__device__ __forceinline__ int fb_ty() { return threadIdx.x / 64 * 4 + threadIdx.x % 32 / 8; }

// cp.async of 16 bytes of which the first `bytes` are read, the rest zeroed.
__device__ __forceinline__ void fb_cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(hp_smem(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ int fb_clamp4(int64_t left) {
  return left >= 4 ? 4 : left > 0 ? (int)left : 0;
}

// One operand's slab of one stage: R rows (m of X, n of W) by FB_BK k from
// `base` (the slab's first row at the stage's first k), rows sr and k sk
// apart; rows from r_left on and depth from k_left on read as zeros.  KM:
// laid out k-major and swizzled (see "Design"), else [FB_BK][R].  vec:
// 16-byte copies along the stored minor dimension, whose stride is then 1;
// else 4-byte copies.  `safe` is a mapped address for copies of 0 bytes.
template <int R, bool KM>
__device__ __forceinline__ void fb_load(float* s, const float* __restrict__ base,
                                        const float* safe, int64_t sr, int64_t sk,
                                        int64_t r_left, int64_t k_left, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    if (KM) {
      constexpr int PER = FB_BK / 4, N = R * PER / FB_THREADS, STEP = FB_THREADS / PER;
      const int kk = (tid % PER) * 4, r0 = tid / PER;
      const int nk = fb_clamp4(k_left - kk);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int r = r0 + c * STEP;
        const int n = r < r_left ? nk : 0;
        fb_cp16(s + r * FB_BK + (((kk >> 2) ^ fb_swz(r)) << 2), n ? base + r * sr + kk : safe,
                4 * n);
      }
    } else {
      constexpr int PER = R / 4, N = FB_BK * PER / FB_THREADS, STEP = FB_THREADS / PER;
      const int r = (tid % PER) * 4, kk0 = tid / PER;
      const int nr = fb_clamp4(r_left - r);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int kk = kk0 + c * STEP;
        const int n = kk < k_left ? nr : 0;
        fb_cp16(s + kk * R + r, n ? base + r + kk * sk : safe, 4 * n);
      }
    }
  } else {
    constexpr int N = R * FB_BK / FB_THREADS;
    if (KM) {  // neighbouring threads on neighbouring k
      const int kk = tid % FB_BK, r0 = tid / FB_BK;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int r = r0 + c * (FB_THREADS / FB_BK);
        const bool ok = r < r_left && kk < k_left;
        hp_cp_async<4>(s + r * FB_BK + (((kk >> 2) ^ fb_swz(r)) << 2) + (kk & 3),
                       ok ? base + r * sr + kk * sk : safe, ok);
      }
    } else {   // neighbouring threads on neighbouring rows
      const int r = tid % R, kk0 = tid / R;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const int kk = kk0 + c * (FB_THREADS / R);
        const bool ok = r < r_left && kk < k_left;
        hp_cp_async<4>(s + kk * R + r, ok ? base + r * sr + kk * sk : safe, ok);
      }
    }
  }
}

__device__ __forceinline__ float fb_lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One stage's products into a thread's sums, k in order.
template <int TM, int TN, bool XK, bool WK>
__device__ __forceinline__ void fb_stage_sum(float (&acc)[TM / 16][TN / 16], const float* xs,
                                             const float* ws) {
  constexpr int MI = TM / 16, NJ = TN / 16;
  const int tx = fb_tx(), ty = fb_ty();
#pragma unroll
  for (int q = 0; q < FB_BK / 4; ++q) {
    float4 xa[MI], wb[NJ];
    if constexpr (XK) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
        xa[i] = *reinterpret_cast<const float4*>(
            xs + ((i < 4 ? 0 : 64) + 4 * ty + (i & 3)) * FB_BK + ((q ^ (ty & 7)) << 2));
    }
    if constexpr (WK) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wb[j] = *reinterpret_cast<const float4*>(
            ws + ((j < 4 ? 0 : 64) + 4 * tx + (j & 3)) * FB_BK + ((q ^ (tx & 7)) << 2));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kk = 4 * q + c;
      float a[MI], b[NJ];
      if constexpr (XK) {
#pragma unroll
        for (int i = 0; i < MI; ++i) a[i] = fb_lane(xa[i], c);
      } else {
#pragma unroll
        for (int h = 0; h < MI / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(xs + kk * TM + 64 * h + 4 * ty);
          a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
        }
      }
      if constexpr (WK) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = fb_lane(wb[j], c);
      } else {
#pragma unroll
        for (int h = 0; h < NJ / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(ws + kk * TN + 64 * h + 4 * tx);
          b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// X's and W's offsets at outer index o (the outer modes innermost first).
// Indices and extents are below 2^31 (fb_launch checks), so 32-bit
// division decodes them: a small product's blocks are short enough for
// 64-bit division to show.
__device__ __forceinline__ void fb_outer(const FbDesc& d, int64_t o, int64_t& xo, int64_t& wo) {
  xo = wo = 0;
  uint32_t r = (uint32_t)o;
#pragma unroll
  for (int j = 0; j < FB_MAX_EXTRA; ++j)
    if (j >= d.n_grid && j < d.n_extra) {
      const uint32_t e = (uint32_t)d.ext[j], idx = r % e;
      r /= e;
      xo += idx * d.xs[j];
      wo += idx * d.ws[j];
    }
}

// A thread's sums into rows m0.., columns n0.. of out (strides cm, cn),
// masked to M x N; float4 stores where `vec` (cn 1, rows 16-byte aligned).
template <int TM, int TN, typename TO>
__device__ __forceinline__ void fb_store(TO* __restrict__ out, int64_t cm, int64_t cn, bool vec,
                                         const float (&acc)[TM / 16][TN / 16], int64_t m0,
                                         int64_t n0, int64_t M, int64_t N) {
  const int tx = fb_tx(), ty = fb_ty();
#pragma unroll
  for (int i = 0; i < TM / 16; ++i) {
    const int64_t row = m0 + (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
    if (row >= M) continue;
    TO* p = out + row * cm;
#pragma unroll
    for (int h = 0; h < TN / 64; ++h) {
      const int64_t col = n0 + 64 * h + 4 * tx;
      if constexpr (sizeof(TO) == 4) {
        if (vec && col + 3 < N) {
          *reinterpret_cast<float4*>(p + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < N) p[(col + j) * cn] = sb_from_f32<TO>(acc[i][4 * h + j]);
    }
  }
}

// Where tile t lies: its first row and column, its grid index, and its
// offsets in X (with the first row), W (with the first column) and C.
struct FbTile {
  int64_t m0, n0, g, x, w, c;
};

template <int TM, int TN>
__device__ __forceinline__ FbTile fb_tile(const FbDesc& d, uint32_t t) {
  const uint32_t n_mt = (uint32_t)((d.M + TM - 1) / TM), n_nt = (uint32_t)((d.N + TN - 1) / TN);
  FbTile tl;
  tl.m0 = (int64_t)(t % n_mt) * TM;
  t /= n_mt;
  tl.n0 = (int64_t)(t % n_nt) * TN;
  t /= n_nt;
  tl.g = t;
  tl.x = tl.m0 * d.xm;
  tl.w = tl.n0 * d.wn;
  tl.c = 0;
#pragma unroll
  for (int j = 0; j < FB_MAX_EXTRA; ++j)
    if (j < d.n_grid) {
      const uint32_t e = (uint32_t)d.ext[j], idx = t % e;
      t /= e;
      tl.x += idx * d.xs[j];
      tl.w += idx * d.ws[j];
      tl.c += idx * d.cs[j];
    }
  return tl;
}

// One bf16 operand's slab of one stage into registers, one element a load,
// packed two a register: the R x FB_BK elements fb_load would copy (its
// element-copy mapping), zeros where fb_load zero-fills.
template <int R, bool KM>
__device__ __forceinline__ void fb_fetch(uint32_t (&v)[R / 16],
                                         const __nv_bfloat16* __restrict__ base, int64_t sr,
                                         int64_t sk, int64_t r_left, int64_t k_left) {
  const int tid = threadIdx.x;
  const uint16_t* b = reinterpret_cast<const uint16_t*>(base);
#pragma unroll
  for (int c = 0; c < R / 16; ++c) {
    uint32_t h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * c + e;
      const int r = KM ? tid / FB_BK + i * (FB_THREADS / FB_BK) : tid % R;
      const int kk = KM ? tid % FB_BK : tid / R + i * (FB_THREADS / R);
      h[e] = r < r_left && kk < k_left ? __ldg(b + r * sr + kk * sk) : 0;
    }
    v[c] = h[0] | h[1] << 16;
  }
}

// R / 8 bf16 values of this thread, packed two a register, widened to f32
// into the slab s where fb_load would have put them: vec, fb_load_raw's
// 16-byte chunks; else fb_fetch's elements.
template <int R, bool KM>
__device__ __forceinline__ void fb_widen(float* s, const uint32_t (&v)[R / 16], bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int PER = KM ? FB_BK / 8 : R / 8, STEP = FB_THREADS / PER;
#pragma unroll
    for (int c = 0; c < R / 64; ++c) {
      float f[8];
      hp_unpack16<__nv_bfloat16>(make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]),
                                 f);
      const float4 lo = make_float4(f[0], f[1], f[2], f[3]);
      const float4 hi = make_float4(f[4], f[5], f[6], f[7]);
      if (KM) {
        const int r = tid / PER + c * STEP, q = (tid % PER) * 2;
        *reinterpret_cast<float4*>(s + r * FB_BK + ((q ^ fb_swz(r)) << 2)) = lo;
        *reinterpret_cast<float4*>(s + r * FB_BK + (((q + 1) ^ fb_swz(r)) << 2)) = hi;
      } else {
        const int r = (tid % PER) * 8, kk = tid / PER + c * STEP;
        *reinterpret_cast<float4*>(s + kk * R + r) = lo;
        *reinterpret_cast<float4*>(s + kk * R + r + 4) = hi;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < R / 8; ++i) {
      const float x = __uint_as_float(i % 2 ? v[i / 2] & 0xffff0000u : v[i / 2] << 16);
      const int r = KM ? tid / FB_BK + i * (FB_THREADS / FB_BK) : tid % R;
      const int kk = KM ? tid % FB_BK : tid / R + i * (FB_THREADS / R);
      if (KM) s[r * FB_BK + (((kk >> 2) ^ fb_swz(r)) << 2) + (kk & 3)] = x;
      else s[kk * R + r] = x;
    }
  }
}

// One bf16 operand's raw slab of one stage into the raw ring slot s (R
// rows by FB_BK k, stored as fb_widen's vec mapping reads it: each thread's
// 16-byte chunks at its own places) by 16-byte cp.async, zero-filled past
// the edges; the operand loads 16 bytes at a time (vec).
template <int R, bool KM>
__device__ __forceinline__ void fb_load_raw(uint16_t* s, const __nv_bfloat16* __restrict__ base,
                                            const void* safe, int64_t sr, int64_t sk,
                                            int64_t r_left, int64_t k_left) {
  const int tid = threadIdx.x;
  const uint16_t* b = reinterpret_cast<const uint16_t*>(base);
  constexpr int PER = KM ? FB_BK / 8 : R / 8, STEP = FB_THREADS / PER;
#pragma unroll
  for (int c = 0; c < R / 64; ++c) {
    const int r = KM ? tid / PER + c * STEP : (tid % PER) * 8;
    const int kk = KM ? (tid % PER) * 8 : tid / PER + c * STEP;
    const int64_t left = KM ? (r < r_left ? k_left - kk : 0) : (kk < k_left ? r_left - r : 0);
    const int n = left >= 8 ? 8 : left > 0 ? (int)left : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     hp_smem(s + 8 * (tid + c * FB_THREADS))),
                 "l"(n ? static_cast<const void*>(b + r * sr + kk * sk) : safe), "r"(2 * n)
                 : "memory");
  }
}

// The chunks fb_load_raw copied for this thread, widened into the f32 slab.
template <int R, bool KM>
__device__ __forceinline__ void fb_widen_raw(float* s, const uint16_t* raw) {
  uint32_t v[R / 16];
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < R / 64; ++c) {
    const uint4 x = *reinterpret_cast<const uint4*>(raw + 8 * (tid + c * FB_THREADS));
    v[4 * c] = x.x, v[4 * c + 1] = x.y, v[4 * c + 2] = x.z, v[4 * c + 3] = x.w;
  }
  fb_widen<R, KM>(s, v, true);
}

// Where a walk stands: outer index o, its stage kb along k, and X's and W's
// offsets at o.
struct FbPos {
  int64_t o, kb, xo, wo;
};

__device__ __forceinline__ void fb_next(const FbDesc& d, int64_t per_k, FbPos& p) {
  if (++p.kb == per_k) {
    p.kb = 0;
    fb_outer(d, ++p.o, p.xo, p.wo);
  }
}

// The block's n_steps stages from t_begin into acc (and run, chunked): the
// cp.async ring for float32 operands; under WIDEN, bf16 operands through
// the raw ring or registers (see "A bf16 operand" above).
template <int TM, int TN, bool XK, bool WK, bool WIDEN>
__device__ __forceinline__ void fb_walk(float (&acc)[TM / 16][TN / 16], float* fb_sm, float* run,
                                        uint16_t* raw, const void* X, const void* W,
                                        const FbDesc& d, const FbTile& tl, int64_t t_begin,
                                        int n_steps) {
  constexpr int MI = TM / 16, NJ = TN / 16, XS = TM * FB_BK, STAGE = (TM + TN) * FB_BK;
  constexpr int RAW = (TM > TN ? TM : TN) * FB_BK;  // bf16 elements a raw slot
  const int tid = threadIdx.x;
  const int64_t per_k = (d.K + FB_BK - 1) / FB_BK;
  const bool vx = d.flags & FB_F_VEC_X, vw = d.flags & FB_F_VEC_W;
  const bool chunked = d.flags & FB_F_CHUNKED;
  // which slabs the cp.async ring fills as float32, which as raw bf16, and
  // which go through registers after each stage's FMA
  const bool xb = WIDEN && (d.flags & FB_F_X_BF16), wb = WIDEN && (d.flags & FB_F_W_BF16);
  const bool rx_ = WIDEN && (d.flags & FB_F_RAW_X), rw_ = WIDEN && (d.flags & FB_F_RAW_W);
  const bool sx = xb && !rx_, sw = wb && !rw_;
  const float* Xf = static_cast<const float*>(X);
  const float* Wf = static_cast<const float*>(W);
  const __nv_bfloat16* Xh = static_cast<const __nv_bfloat16*>(X);
  const __nv_bfloat16* Wh = static_cast<const __nv_bfloat16*>(W);
  // where the cp.async loads stand (FB_STAGES - 1 stages ahead) and where
  // the register fetches do (one stage ahead)
  FbPos ap;
  ap.o = per_k ? t_begin / per_k : 0;
  ap.kb = per_k ? t_begin % per_k : 0;
  fb_outer(d, ap.o, ap.xo, ap.wo);
  FbPos rp = ap;

  auto load = [&](int slot) {
    float* xs = fb_sm + slot * STAGE;
    const int64_t k0 = ap.kb * FB_BK;
    if (!xb)
      fb_load<TM, XK>(xs, Xf + tl.x + ap.xo + k0 * d.xk, Xf, d.xm, d.xk, d.M - tl.m0, d.K - k0,
                      vx);
    else if (rx_)
      fb_load_raw<TM, XK>(raw + slot * RAW, Xh + tl.x + ap.xo + k0 * d.xk, X, d.xm, d.xk,
                          d.M - tl.m0, d.K - k0);
    if (!wb)
      fb_load<TN, WK>(xs + XS, Wf + tl.w + ap.wo + k0 * d.wk, Wf, d.wn, d.wk, d.N - tl.n0,
                      d.K - k0, vw);
    else if (rw_)
      fb_load_raw<TN, WK>(raw + slot * RAW, Wh + tl.w + ap.wo + k0 * d.wk, W, d.wn, d.wk,
                          d.N - tl.n0, d.K - k0);
    fb_next(d, per_k, ap);
  };
  auto fetch_widen = [&](int slot) {
    float* xs = fb_sm + slot * STAGE;
    const int64_t k0 = rp.kb * FB_BK;
    if (sx) {
      uint32_t v[TM / 16];
      fb_fetch<TM, XK>(v, Xh + tl.x + rp.xo + k0 * d.xk, d.xm, d.xk, d.M - tl.m0, d.K - k0);
      fb_widen<TM, XK>(xs, v, false);
    }
    if (sw) {
      uint32_t v[TN / 16];
      fb_fetch<TN, WK>(v, Wh + tl.w + rp.wo + k0 * d.wk, d.wn, d.wk, d.N - tl.n0, d.K - k0);
      fb_widen<TN, WK>(xs + XS, v, false);
    }
    fb_next(d, per_k, rp);
  };

  if (WIDEN && (sx || sw) && n_steps > 0) fetch_widen(0);
  for (int s = 0; s < FB_STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    hp_cp_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    hp_cp_wait<FB_STAGES - 2>();  // this thread's copies of stage it have landed
    if (WIDEN && (rx_ || rw_)) {  // ... so it widens its own raw chunks of them
      float* xs = fb_sm + (it % FB_STAGES) * STAGE;
      if (rx_) fb_widen_raw<TM, XK>(xs, raw + (it % FB_STAGES) * RAW);
      else fb_widen_raw<TN, WK>(xs + XS, raw + (it % FB_STAGES) * RAW);
    }
    __syncthreads();              // everyone's have, and stage it - 1 is computed
    if (it + FB_STAGES - 1 < n_steps) load((it + FB_STAGES - 1) % FB_STAGES);
    hp_cp_commit();
    const float* xs = fb_sm + (it % FB_STAGES) * STAGE;
    fb_stage_sum<TM, TN, XK, WK>(acc, xs, xs + XS);
    // slot (it + 1) % FB_STAGES was last read for stage it + 1 - FB_STAGES,
    // before this iteration's barrier
    if (WIDEN && (sx || sw) && it + 1 < n_steps) fetch_widen((it + 1) % FB_STAGES);
    if (chunked && (it + 1) % FB_CHUNK_STAGES == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          run[(i * NJ + j) * FB_THREADS + tid] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
  }
}

// TM x TN: the tile (FB_TM x FB_TN, FB_TM x FB_TN_NARROW or FB_TM_SMALL x
// FB_TN_NARROW).  XK, WK: X's and W's slabs laid out k-major.  WIDEN: X or
// W (the flags say which) is bf16; else both are float32.  Block x owns
// tile x (m fastest, then n, then the grid) over split blockIdx.y's stages
// of the walk.
template <int TM, int TN, bool XK, bool WK, bool WIDEN, typename TC>
__global__ void __launch_bounds__(FB_THREADS, 1)
fb_kernel(const void* __restrict__ X, const void* __restrict__ W, TC* __restrict__ C,
          float* __restrict__ ws, const FbDesc d) {
  constexpr int MI = TM / 16, NJ = TN / 16, STAGE = (TM + TN) * FB_BK;
  extern __shared__ __align__(16) float fb_sm[];
  float* run = fb_sm + FB_STAGES * STAGE;  // chunked: the running sums, [output][thread]
  // then the raw bf16 ring (FB_F_RAW_*)
  uint16_t* raw =
      reinterpret_cast<uint16_t*>(run + (d.flags & FB_F_CHUNKED ? MI * NJ * FB_THREADS : 0));
  const int tid = threadIdx.x;
  const FbTile tl = fb_tile<TM, TN>(d, blockIdx.x);
  // the block's stages of the walk
  const int64_t t_begin = (int64_t)blockIdx.y * d.spc;
  const int n_steps = (int)((t_begin + d.spc < d.steps ? t_begin + d.spc : d.steps) - t_begin);
  const bool chunked = d.flags & FB_F_CHUNKED;

  float acc[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  if (chunked)
#pragma unroll
    for (int e = 0; e < MI * NJ; ++e) run[e * FB_THREADS + tid] = 0.f;

  fb_walk<TM, TN, XK, WK, WIDEN>(acc, fb_sm, run, raw, X, W, d, tl, t_begin, n_steps);
  if (chunked)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = run[(i * NJ + j) * FB_THREADS + tid] + acc[i][j];

  if (d.n_split == 1)
    fb_store<TM, TN, TC>(C + tl.c, d.cm, d.cn, d.flags & FB_F_VEC_C, acc, tl.m0, tl.n0, d.M,
                         d.N);
  else
    fb_store<TM, TN, float>(ws + ((int64_t)blockIdx.y * d.G + tl.g) * d.M * d.N, d.N, 1,
                            d.N % 4 == 0, acc, tl.m0, tl.n0, d.M, d.N);
}

// The split's partial sums [split][g][m][n], added in split order into C.
template <typename TC>
__global__ void __launch_bounds__(256)
fb_reduce(const float* __restrict__ ws, TC* __restrict__ C, const FbDesc d) {
  const int64_t plane = d.G * d.M * d.N, i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= plane) return;
  float sum = 0.f;
  for (int s = 0; s < d.n_split; ++s) sum += ws[s * plane + i];
  int64_t g = i / d.N / d.M, off = i / d.N % d.M * d.cm + i % d.N * d.cn;
#pragma unroll
  for (int j = 0; j < FB_MAX_EXTRA; ++j)
    if (j < d.n_grid) {
      off += g % d.ext[j] * d.cs[j];
      g /= d.ext[j];
    }
  C[off] = sb_from_f32<TC>(sum);
}

// ================================================================ gathered
// Every bf16 product with a contracted mode and an own C mode that the
// tensor maps of wgmma and batched cannot read: modes whose strides are no
// multiple of 16 bytes (Table II in bf16 at odd extents, expert rows 500
// bytes apart), a start off a 16-byte boundary, more than NM_MAX_EXTRA
// grid and outer modes, a second own C mode of W.  The wrapper's
// native_plan gives it fbatched's form (FbDesc: grid modes from X, W or
// both, outer contracted modes, any strides, up to SB_MAX_MODES of them),
// with an operand's stride-1 own mode as its tile mode where k is not
// stride-1.  It replaces the same TPU kernel as the routes above
// (native_gemm_pallas, src/repro/kernels/sb_gemm.py).
//
// Bound.  Bytes: Table II in bf16 at n = 255 moves 33 MB of its 3-mode
// operand and 33 MB of C for 8.5 GFLOP (0.020 ms of bytes against 0.009
// of operations on an H100), and the expert products sit near the bf16
// ridge.  So the operands must stream, and the tensor cores sum.
//
// Design.  nm_kernel's consumer (hp_consume_ring: one or two consumer
// warpgroups on wgmma m64n128k16 into TM x NM_BN tiles, NM_BK-deep stages
// under the 128-byte swizzle) behind a producer warpgroup that gathers each
// stage instead of issuing TMA.  Its GA_PRODUCERS threads load a slab
// through the operand's strides with ld.global, neighbouring threads on
// neighbouring elements of the slab's stored minor dimension: where that
// mode is stride-1, 16 bytes at a time at any alignment (ga_slab16: aligned
// 16-byte loads of the block holding a chunk's first element and of the
// next, shifted together; odd strides, as every Table II case at n = 255
// has, start each line 2 bytes off a 16-byte boundary), else one element
// at a time (ga_slab1; cp.async cannot copy a lone 2-byte element).  They
// store them with st.shared at the swizzled places TMA would have written,
// zeros past M, N and K (TMA's out-of-bounds fill, so the ragged depth adds
// nothing); then each fences (fence.proxy.async.shared::cta: wgmma reads
// shared memory through the async proxy, the stores went through the
// generic one) and arrives on the stage's full barrier, which counts
// GA_PRODUCERS arrivals.  A thread keeps one batch of loads in flight
// (GA_BATCH elements, or GA_BATCH / 4 chunks) before it stores them, each
// address one add from the last, and the batches are a loop the compiler
// does not unroll into each other.  On an H100: a first build that loaded
// a slab's 64 elements a thread at once, each at its own 64-bit address,
// ran at 255 registers, spilled and took 5-10x einsum; one that loaded 16,
// 8 or 4 bytes only where the strides and start were aligned to them loaded
// Table II at n = 255 an element at a time; unrolled batches let the
// compiler raise every load of a slab above the stores, and the 128-row
// kernels (384 threads, 168 registers) spilled up to 752 bytes.  A stage's
// layout follows its operand: X M-major where m is the smaller stride, W
// K-major where k is; the wrapper's stage layout flags pick the kernel.
// GA_STAGES stages a ring, one block an SM.  Never split: each output is
// one walk over every outer index and stage, so a row's bits never depend
// on what shares its launch.
#define GA_STAGES 4
#define GA_PRODUCERS 128
#define GA_BATCH 32       // element loads a producer thread keeps in flight
#define GA_F_WIDE_X 1024  // flags: X's stored minor dimension is stride-1: 16-byte loads
#define GA_F_WIDE_W 2048  // ... W's

template <int TM>
struct GaTile {
  static constexpr int WGS = TM / 64;                                // consumer warpgroups
  static constexpr int THREADS = WGS * 128 + GA_PRODUCERS;           // + the producer warpgroup
  static constexpr int X_BYTES = WGS * NM_BOX;                       // X slab
  static constexpr int STAGE_BYTES = X_BYTES + NM_BN / 64 * NM_BOX;  // X slab, then W slab
  static constexpr int BAR_OFF = GA_STAGES * STAGE_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * 2 * GA_STAGES;    // + alignment slack
};

// Byte offset of a slab's element (r, kk) (row r of X's m or W's n, depth
// kk) where TMA's 128-byte swizzle puts it: KMAJ, [rows][NM_BK k], one
// 128-byte row a row; else [NM_BK k][64 rows] boxes, NM_BOX bytes each;
// 16-byte chunk c of a 128-byte row j at c ^ (j % 8).
template <bool KMAJ>
__device__ __forceinline__ int ga_off(int r, int kk) {
  if (KMAJ) return r * 128 + (((kk >> 3) ^ (r & 7)) << 4) + (kk & 7) * 2;
  return (r >> 6) * NM_BOX + kk * 128 + ((((r & 63) >> 3) ^ (kk & 7)) << 4) + (r & 7) * 2;
}

// One operand's slab of one stage, R rows by NM_BK k, gathered by the
// producer thread pt of GA_PRODUCERS into s, one element a load (the
// stored minor dimension, k where KMAJ, else the rows, is not stride-1):
// from base (the slab's first row at the stage's first k), rows sr and k sk
// apart; rows from r_left on and depth from k_left on are zeros.  Thread
// pt keeps one place along the minor dimension and steps the other
// GA_PRODUCERS / PER at a time, GA_BATCH loads in flight before it stores
// them, each address one add from the last.
template <int R, bool KMAJ>
__device__ __forceinline__ void ga_slab1(uint8_t* s, const uint16_t* base, int64_t sr,
                                         int64_t sk, int64_t r_left, int64_t k_left, int pt) {
  constexpr int PER = KMAJ ? NM_BK : R;                 // loads along the minor dimension
  constexpr int N = R * NM_BK / GA_PRODUCERS;           // loads a thread
  constexpr int STEP = GA_PRODUCERS / PER;              // the major dimension between them
  constexpr int BATCH = N < GA_BATCH ? N : GA_BATCH;
  static_assert(GA_PRODUCERS % PER == 0 && N % BATCH == 0, "slab split");
  const int minor = pt % PER, major0 = pt / PER;
  const int64_t s_major = KMAJ ? sr : sk;
  const bool in_minor = minor < (KMAJ ? k_left : r_left);
  const int64_t major_left = (KMAJ ? r_left : k_left) - major0;
  const uint16_t* p = base + minor * (KMAJ ? sk : sr) + major0 * s_major;
  const int64_t step = STEP * s_major;
#pragma unroll 1  // one batch's loads in flight: unrolled, the next ones' rise above the stores
  for (int b = 0; b < N; b += BATCH) {
    uint16_t buf[BATCH];
#pragma unroll
    for (int c = 0; c < BATCH; ++c)
      buf[c] = in_minor && (b + c) * STEP < major_left ? __ldg(p + (b + c) * step) : 0;
#pragma unroll
    for (int c = 0; c < BATCH; ++c) {
      const int major = major0 + (b + c) * STEP;
      *reinterpret_cast<uint16_t*>(s + ga_off<KMAJ>(KMAJ ? major : minor, KMAJ ? minor : major)) =
          buf[c];
    }
  }
}

// The same where the stored minor dimension is stride-1, at any alignment:
// each thread gathers 16-byte chunks (8 elements along a line of the minor
// dimension) with aligned 16-byte loads of the block that holds the
// chunk's first element and, where the line starts off a 16-byte
// boundary, of the next block, whose bytes it shifts in (funnel shifts of
// 32-bit words); elements past the line's valid ones are zeros, and a
// block holding none of them is not read.  GA_BATCH / 4 chunks in flight.
template <int R, bool KMAJ>
__device__ __forceinline__ void ga_slab16(uint8_t* s, const uint16_t* base, int64_t sr,
                                          int64_t sk, int64_t r_left, int64_t k_left, int pt) {
  constexpr int PER = (KMAJ ? NM_BK : R) / 8;           // chunks along a line
  constexpr int N = R * NM_BK / 8 / GA_PRODUCERS;       // chunks a thread
  constexpr int STEP = GA_PRODUCERS / PER;              // lines between them
  constexpr int BATCH = N < GA_BATCH / 4 ? N : GA_BATCH / 4;
  static_assert(GA_PRODUCERS % PER == 0 && N % BATCH == 0, "slab split");
  const int j = pt % PER, major0 = pt / PER;
  const int64_t s_major = KMAJ ? sr : sk;
  const int64_t left = (KMAJ ? k_left : r_left) - 8 * j;  // the chunk's valid elements
  const int n = left >= 8 ? 8 : left > 0 ? (int)left : 0;
  const int64_t major_left = (KMAJ ? r_left : k_left) - major0;
  const uint16_t* p = base + 8 * j + major0 * s_major;
  const int64_t step = STEP * s_major;
#pragma unroll 1
  for (int b = 0; b < N; b += BATCH) {
    uint4 lo[BATCH], hi[BATCH];
#pragma unroll
    for (int c = 0; c < BATCH; ++c) {
      const uint16_t* q = p + (b + c) * step;
      const int sh = (int)(reinterpret_cast<uintptr_t>(q) & 15);
      const uint4* a = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(q) - sh);
      const bool live = n > 0 && (b + c) * STEP < major_left;
      lo[c] = live ? __ldg(a) : make_uint4(0, 0, 0, 0);
      hi[c] = live && sh + 2 * n > 16 ? __ldg(a + 1) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int c = 0; c < BATCH; ++c) {
      // bytes sh .. sh + 15 of lo, hi: 32-bit words q8 + i, shifted by a half
      // word where sh is 2 mod 4
      const int sh = (int)(reinterpret_cast<uintptr_t>(p + (b + c) * step) & 15);
      const int q8 = sh >> 2;
      const uint32_t w[8] = {lo[c].x, lo[c].y, lo[c].z, lo[c].w,
                             hi[c].x, hi[c].y, hi[c].z, hi[c].w};
      uint32_t x[5], out[4];
#pragma unroll
      for (int i = 0; i < 5; ++i)
        x[i] = q8 == 0 ? w[i] : q8 == 1 ? w[i + 1] : q8 == 2 ? w[i + 2] : w[i + 3];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t v = sh & 2 ? __funnelshift_r(x[i], x[i + 1], 16) : x[i];
        out[i] = 2 * i + 1 < n ? v : 2 * i < n ? v & 0xffffu : 0u;
      }
      const int major = major0 + (b + c) * STEP;
      *reinterpret_cast<uint4*>(s + ga_off<KMAJ>(KMAJ ? major : 8 * j, KMAJ ? 8 * j : major)) =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// wide: the stored minor dimension is stride-1 (ga_slab16), else one
// element a load (ga_slab1).
template <int R, bool KMAJ>
__device__ __forceinline__ void ga_slab(uint8_t* s, const uint16_t* base, int64_t sr, int64_t sk,
                                        int64_t r_left, int64_t k_left, bool wide, int pt) {
  if (wide) ga_slab16<R, KMAJ>(s, base, sr, sk, r_left, k_left, pt);
  else ga_slab1<R, KMAJ>(s, base, sr, sk, r_left, k_left, pt);
}

// TM: the tile's rows (NM_TM or NM_TM_WIDE).  XM: X's stages M-major (m
// stored stride-1), else K-major; WK: W's K-major, else N-major.  Block x
// owns tile x (m fastest, then n, then the grid).
template <int TM, int XM, int WK, typename TC>
__global__ void __launch_bounds__(GaTile<TM>::THREADS, 1)
nm_gather_kernel(const uint16_t* __restrict__ X, const uint16_t* __restrict__ W,
                 TC* __restrict__ C, const FbDesc d) {
  using T = GaTile<TM>;
  extern __shared__ uint8_t ga_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(ga_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::BAR_OFF);
  uint64_t* empty = full + GA_STAGES;

  // the tile and its grid index (indices and extents below 2^31: ga_launch
  // checks)
  const uint32_t n_mt = (uint32_t)((d.M + TM - 1) / TM);
  const uint32_t n_nt = (uint32_t)((d.N + NM_BN - 1) / NM_BN);
  uint32_t t = blockIdx.x;
  const int m0 = (int)(t % n_mt) * TM;
  t /= n_mt;
  const int n0 = (int)(t % n_nt) * NM_BN;
  t /= n_nt;
  int64_t xg = m0 * d.xm, wg = n0 * d.wn, cg = 0;
#pragma unroll
  for (int j = 0; j < FB_MAX_EXTRA; ++j)
    if (j < d.n_grid) {
      const uint32_t e = (uint32_t)d.ext[j], idx = t % e;
      t /= e;
      xg += idx * d.xs[j];
      wg += idx * d.ws[j];
      cg += idx * d.cs[j];
    }
  const int n_k = (int)d.steps;  // the outer indices' stages, outer index slowest

  if (threadIdx.x == 0) {
    for (int s = 0; s < GA_STAGES; ++s) {
      hp_bar_init(&full[s], GA_PRODUCERS);  // every producer thread
      hp_bar_init(&empty[s], 4 * T::WGS);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 4 * T::WGS) {  // the producer warpgroup
    const int pt = threadIdx.x - 128 * T::WGS;
    const bool wx = d.flags & GA_F_WIDE_X, ww = d.flags & GA_F_WIDE_W;
    const int64_t per_k = (d.K + NM_BK - 1) / NM_BK;
    int64_t o = 0, kb = 0, xo = 0, wo = 0;
    for (int it = 0; it < n_k; ++it) {
      const int s = it % GA_STAGES;
      if (it >= GA_STAGES) hp_bar_wait(&empty[s], (it / GA_STAGES - 1) & 1);
      uint8_t* xs = sm + s * T::STAGE_BYTES;
      const int64_t k0 = kb * NM_BK;
      ga_slab<TM, !XM>(xs, X + xg + xo + k0 * d.xk, d.xm, d.xk, d.M - m0, d.K - k0, wx, pt);
      ga_slab<NM_BN, WK>(xs + T::X_BYTES, W + wg + wo + k0 * d.wk, d.wn, d.wk, d.N - n0,
                         d.K - k0, ww, pt);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      hp_bar_arrive(&full[s]);
      if (++kb == per_k) {
        kb = 0;
        fb_outer(d, ++o, xo, wo);
      }
    }
    return;
  }

  float acc[NM_BN / 2];
#pragma unroll
  for (int i = 0; i < NM_BN / 2; ++i) acc[i] = 0.f;
  hp_consume_ring<XM, WK, GA_STAGES>(acc, sm, T::STAGE_BYTES, (warp / 4) * NM_BOX, T::X_BYTES,
                                     full, empty, n_k);
  nm_store<TC>(C + cg, d.cm, d.cn, acc, d.M, d.N, m0, n0);
}

// ------------------------------------------------------------- host launches
static int nr_sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// The stream read kernel for (RP, KFAST, TC), as a function pointer.
template <typename TC> static const void* ns_read_fn(int rp, bool kfast) {
#define NS_FN(R_)                                                                   \
  if (rp == R_)                                                                     \
    return kfast ? (const void*)ns_read_kernel<R_, true, TC>                        \
                 : (const void*)ns_read_kernel<R_, false, TC>;
  NS_FN(4) NS_FN(8) NS_FN(12) NS_FN(16)
#undef NS_FN
  return nullptr;
}

template <int RP, typename TC>
static void ns_read_go(bool kfast, unsigned grid, size_t smem, cudaStream_t st,
                       const CUtensorMap& map, const float* W, TC* C, const NrDesc& d,
                       int n_tiles) {
  if (kfast) ns_read_kernel<RP, true, TC><<<grid, NS_THREADS, smem, st>>>(map, W, C, d, n_tiles);
  else ns_read_kernel<RP, false, TC><<<grid, NS_THREADS, smem, st>>>(map, W, C, d, n_tiles);
}

template <typename TC>
static int ns_read_launch(const void* X, const void* W, void* C, const NrDesc& d,
                          cudaStream_t st) {
  const bool kfast = d.xk == 1;
  const int64_t xm = d.m_xs[0], other = kfast ? xm : d.xk;
  if (d.n_m != 1 || (!kfast && xm != 1) || other <= 0 || other % 4 || (uintptr_t)X % 16 ||
      d.M >= ((int64_t)1 << 31) || d.K >= ((int64_t)1 << 31) ||
      (int64_t)((d.K + NS_BK - 1) / NS_BK * NS_BK) * d.rp * 4 > NS_W_BYTES_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)(kfast ? d.K : d.M), (cuuint64_t)(kfast ? d.M : d.K)};
  const cuuint64_t strides[1] = {(cuuint64_t)other * 4};
  const cuuint32_t box[2] = {kfast ? NS_BK : NS_TU, kfast ? NS_TU : NS_BK};
  int rc = hp_map_as(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     kfast ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE, X, 2, dims,
                     strides, box);
  if (rc) return rc;
  const void* fn = ns_read_fn<TC>(d.rp, kfast);
  if (!fn) return (int)cudaErrorInvalidValue;
  // once per kernel: room for the largest W; the ring alone holds one
  // block per SM, so the persistent grid is one block per SM
  static bool sized[2][NR_NARROW / 4];
  if (!sized[kfast][d.rp / 4 - 1]) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ns_smem_bytes(NS_W_BYTES_MAX / (4 * NR_NARROW), NR_NARROW));
    if (err != cudaSuccess) return (int)err;
    sized[kfast][d.rp / 4 - 1] = true;
  }
  const size_t smem = ns_smem_bytes(d.K, d.rp);
  const int n_tiles = (int)((d.M + NS_TILE - 1) / NS_TILE);
  const int sms = nr_sm_count();
  const unsigned grid = (unsigned)(n_tiles < sms ? n_tiles : sms);
  const float* w = (const float*)W;
  TC* c = (TC*)C;
  switch (d.rp) {
    case 4: ns_read_go<4, TC>(kfast, grid, smem, st, map, w, c, d, n_tiles); break;
    case 8: ns_read_go<8, TC>(kfast, grid, smem, st, map, w, c, d, n_tiles); break;
    case 12: ns_read_go<12, TC>(kfast, grid, smem, st, map, w, c, d, n_tiles); break;
    default: ns_read_go<16, TC>(kfast, grid, smem, st, map, w, c, d, n_tiles); break;
  }
  return (int)cudaGetLastError();
}

template <typename TC>
static int nw_launch_t(const void* X, const void* W, void* C, const NwDesc& d, cudaStream_t st) {
  const int64_t n_cw = (d.P + 127) / 128;
  int cw_blk = 1;
  while (cw_blk < n_cw && cw_blk < NW_THREADS / 32) cw_blk *= 2;
  const int64_t gy = (n_cw + cw_blk - 1) / cw_blk, n_tiles = (d.M + NW_TU - 1) / NW_TU;
  static int per_sm = 0;  // blocks per SM, asked once
  if (!per_sm) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nw_kernel<TC>, NW_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t slots = (int64_t)nr_sm_count() * per_sm;
  const int64_t gx = n_tiles < slots ? n_tiles : slots;
  if (gy >= 65536) return (int)cudaErrorInvalidValue;
  nw_kernel<TC><<<dim3((unsigned)gx, (unsigned)gy), NW_THREADS, 0, st>>>(
      (const float*)X, (const float*)W, (TC*)C, d, cw_blk, n_tiles);
  return (int)cudaGetLastError();
}

template <int RP, typename TC>
static void nk_go(const void* X, const void* W, void* C, void* ws, const NrDesc& d, dim3 grid,
                  cudaStream_t st) {
  nk_kernel<RP, TC><<<grid, NK_TU, 0, st>>>((const float*)X, (const float*)W, (TC*)C,
                                            (float*)ws, d);
}

template <typename TC>
static int nk_launch_t(const void* X, const void* W, void* C, void* ws, const NrDesc& d,
                       cudaStream_t st) {
  const int64_t gx = (d.M + NK_TU - 1) / NK_TU;
  if (gx >= ((int64_t)1 << 31) || d.n_split >= 65536 || d.kc < 1 ||
      (int64_t)d.kc * d.n_split < d.K || (d.n_split > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)d.n_split);
  switch (d.rp) {
    case 4: nk_go<4, TC>(X, W, C, ws, d, grid, st); break;
    case 8: nk_go<8, TC>(X, W, C, ws, d, grid, st); break;
    case 12: nk_go<12, TC>(X, W, C, ws, d, grid, st); break;
    default: nk_go<16, TC>(X, W, C, ws, d, grid, st); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || d.n_split == 1) return (int)err;
  const int64_t n = d.R * d.M;
  nk_reduce<TC><<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)ws, (TC*)C, d);
  return (int)cudaGetLastError();
}

// One operand's tensor map for the wgmma and batched routes: its row or
// column mode (extent e_mn, stride s_mn), k (K, s_k) and the extra modes it
// carries (ext, s; stride 0: it lacks the mode), as dimensions ordered by
// stride with the stride-1 matrix mode first.  Boxes: 64 along that mode;
// along the other matrix mode 64 if it is k, else mn_box (TM rows of X,
// NM_BN columns of W); 1 along each extra mode.  roles gets what each
// dimension stands for (NmRoles).
static int nm_map(CUtensorMap* map, int8_t* roles, int32_t* rank, const void* ptr,
                  int64_t e_mn, int64_t s_mn, int mn_box, int64_t K, int64_t s_k,
                  const int64_t* ext, const int64_t* s, int n_extra) {
  int64_t dim[2 + NM_MAX_EXTRA], str[2 + NM_MAX_EXTRA];
  int8_t role[2 + NM_MAX_EXTRA];
  int n = 0;
  auto add = [&](int64_t e, int64_t st, int ro) {
    dim[n] = e;
    str[n] = st;
    role[n++] = (int8_t)ro;
  };
  const bool k_first = s_k == 1;
  if (k_first) add(K, 1, 1), add(e_mn, s_mn, 0);
  else add(e_mn, 1, 0), add(K, s_k, 1);
  for (int j = 0; j < n_extra; ++j)
    if (s[j]) add(ext[j], s[j], 2 + j);
  // insertion sort of dimensions 1.. by stride (a stable order)
  for (int i = 2; i < n; ++i)
    for (int j = i; j > 1 && str[j] < str[j - 1]; --j) {
      const int64_t e = dim[j], st = str[j];
      const int8_t ro = role[j];
      dim[j] = dim[j - 1], str[j] = str[j - 1], role[j] = role[j - 1];
      dim[j - 1] = e, str[j - 1] = st, role[j - 1] = ro;
    }
  cuuint64_t dims[2 + NM_MAX_EXTRA], strides[1 + NM_MAX_EXTRA];
  cuuint32_t box[2 + NM_MAX_EXTRA];
  for (int i = 0; i < n; ++i) {
    if (dim[i] < 1 || dim[i] >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    dims[i] = (cuuint64_t)dim[i];
    box[i] = i == 0 || role[i] == 1 ? 64 : role[i] == 0 ? mn_box : 1;
    if (i > 0) {
      if (str[i] <= 0 || str[i] % 8 || str[i] >= ((int64_t)1 << 39))
        return (int)cudaErrorInvalidValue;
      strides[i - 1] = (cuuint64_t)str[i] * 2;
    }
  }
  for (int i = 0; i < 2 + NM_MAX_EXTRA; ++i) roles[i] = i < n ? role[i] : 0;
  *rank = n;
  return hp_map(map, ptr, n, dims, strides, box);
}

template <int TM, int XM, int WK, typename TC>
static int nm_go(const CUtensorMap& xmap, const CUtensorMap& wmap, void* C, void* ws,
                 const NmDesc& d, const NmRoles& r, dim3 grid, cudaStream_t st) {
  typedef NmTile<TM> T;
  static bool sized = false;  // once per kernel: its shared memory is above 48 KB
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        nm_kernel<TM, XM, WK, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  nm_kernel<TM, XM, WK, TC><<<grid, T::THREADS, T::SMEM, st>>>(xmap, wmap, (TC*)C, (float*)ws,
                                                               d, r);
  return (int)cudaGetLastError();
}

template <int TM, typename TC>
static int nm_go_layout(bool xm_major, bool wk_major, const CUtensorMap& xmap,
                        const CUtensorMap& wmap, void* C, void* ws, const NmDesc& d,
                        const NmRoles& r, dim3 grid, cudaStream_t st) {
  if (xm_major) return wk_major ? nm_go<TM, 1, 1, TC>(xmap, wmap, C, ws, d, r, grid, st)
                                : nm_go<TM, 1, 0, TC>(xmap, wmap, C, ws, d, r, grid, st);
  return wk_major ? nm_go<TM, 0, 1, TC>(xmap, wmap, C, ws, d, r, grid, st)
                  : nm_go<TM, 0, 0, TC>(xmap, wmap, C, ws, d, r, grid, st);
}

template <typename TC>
static int nm_launch_t(const void* X, const void* W, void* C, void* ws, const NmDesc& d,
                       cudaStream_t st) {
  const bool xm_major = d.xs[1] != 1, wk_major = d.ws[0] != 1;
  const int tm = d.M <= NM_TM ? NM_TM : NM_TM_WIDE;
  CUtensorMap xmap, wmap;
  NmRoles r;
  int rc = nm_map(&xmap, r.x, &r.x_rank, X, d.M, d.xs[0], tm, d.K, d.xs[1], d.ext, d.xs + 2,
                  d.n_extra);
  if (!rc)
    rc = nm_map(&wmap, r.w, &r.w_rank, W, d.N, d.ws[0], NM_BN, d.K, d.ws[1], d.ext, d.ws + 2,
                d.n_extra);
  if (rc) return rc;
  int64_t G = 1;
  for (int j = 0; j < d.n_grid; ++j) G *= d.ext[j];
  const int64_t tiles = (d.M + tm - 1) / tm * ((d.N + NM_BN - 1) / NM_BN) * G;
  if (tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)d.n_split);
  rc = tm == NM_TM
           ? nm_go_layout<NM_TM, TC>(xm_major, wk_major, xmap, wmap, C, ws, d, r, grid, st)
           : nm_go_layout<NM_TM_WIDE, TC>(xm_major, wk_major, xmap, wmap, C, ws, d, r, grid, st);
  if (rc || d.n_split == 1) return rc;
  const int64_t n = d.M * d.N;
  nm_reduce<TC><<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)ws, (TC*)C, d);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fbatched host
static int fb_tm(const FbDesc& d) { return d.flags & FB_F_SMALL ? FB_TM_SMALL : FB_TM; }
static int fb_tn(const FbDesc& d) { return d.flags & FB_F_NARROW_N ? FB_TN_NARROW : FB_TN; }

// The ring of f32 slabs, the chunked walk's running sums, and the raw bf16
// ring (raw_rows: 0, or the rows of the operand that takes it).
static size_t fb_smem_bytes(int tm, int tn, bool chunked, int raw_rows = 0) {
  return sizeof(float) * ((size_t)FB_STAGES * (tm + tn) * FB_BK +
                          (chunked ? (size_t)(tm / 16) * (tn / 16) * FB_THREADS : 0)) +
         (raw_rows ? 2 * (size_t)FB_STAGES * (tm > tn ? tm : tn) * FB_BK : 0);
}

template <int TM, int TN, bool XK, bool WK, bool WIDEN, typename TC>
static int fb_go(const void* X, const void* W, void* C, void* ws, const FbDesc& d, dim3 grid,
                 size_t smem, cudaStream_t st) {
  static bool sized = false;  // once per kernel: its shared memory is above 48 KB
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        fb_kernel<TM, TN, XK, WK, WIDEN, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)fb_smem_bytes(TM, TN, true, WIDEN ? 1 : 0));
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  fb_kernel<TM, TN, XK, WK, WIDEN, TC><<<grid, FB_THREADS, smem, st>>>(X, W, (TC*)C, (float*)ws,
                                                                        d);
  return (int)cudaGetLastError();
}

template <int TM, int TN, bool WIDEN, typename TC>
static int fb_go_layout(const void* X, const void* W, void* C, void* ws, const FbDesc& d,
                        dim3 grid, size_t smem, cudaStream_t st) {
  const bool xk = d.flags & FB_F_X_KMAJOR, wk = d.flags & FB_F_W_KMAJOR;
  if (xk) return wk ? fb_go<TM, TN, true, true, WIDEN, TC>(X, W, C, ws, d, grid, smem, st)
                    : fb_go<TM, TN, true, false, WIDEN, TC>(X, W, C, ws, d, grid, smem, st);
  return wk ? fb_go<TM, TN, false, true, WIDEN, TC>(X, W, C, ws, d, grid, smem, st)
            : fb_go<TM, TN, false, false, WIDEN, TC>(X, W, C, ws, d, grid, smem, st);
}

template <int TM, int TN, typename TC>
static int fb_go_widen(bool widen, const void* X, const void* W, void* C, void* ws,
                       const FbDesc& d, dim3 grid, size_t smem, cudaStream_t st) {
  return widen ? fb_go_layout<TM, TN, true, TC>(X, W, C, ws, d, grid, smem, st)
               : fb_go_layout<TM, TN, false, TC>(X, W, C, ws, d, grid, smem, st);
}

template <typename TC>
static int fb_launch_t(const void* X, const void* W, void* C, void* ws, const FbDesc& d,
                       cudaStream_t st) {
  const int tm = fb_tm(d), tn = fb_tn(d);
  const int64_t tiles = d.G * ((d.M + tm - 1) / tm) * ((d.N + tn - 1) / tn);
  if (tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)tiles, (unsigned)d.n_split);
  const bool widen = d.flags & (FB_F_X_BF16 | FB_F_W_BF16);
  const size_t smem = fb_smem_bytes(tm, tn, d.flags & FB_F_CHUNKED,
                                    d.flags & (FB_F_RAW_X | FB_F_RAW_W) ? 1 : 0);
  const int rc =
      tm == FB_TM_SMALL
          ? fb_go_widen<FB_TM_SMALL, FB_TN_NARROW, TC>(widen, X, W, C, ws, d, grid, smem, st)
      : tn == FB_TN ? fb_go_widen<FB_TM, FB_TN, TC>(widen, X, W, C, ws, d, grid, smem, st)
                    : fb_go_widen<FB_TM, FB_TN_NARROW, TC>(widen, X, W, C, ws, d, grid, smem, st);
  if (rc || d.n_split == 1) return rc;
  const int64_t n = d.G * d.M * d.N;
  fb_reduce<TC><<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)ws, (TC*)C, d);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ gathered host
template <int TM, int XM, int WK, typename TC>
static int ga_go(const void* X, const void* W, void* C, const FbDesc& d, unsigned grid,
                 cudaStream_t st) {
  typedef GaTile<TM> T;
  static bool sized = false;  // once per kernel: its shared memory is above 48 KB
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        nm_gather_kernel<TM, XM, WK, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  nm_gather_kernel<TM, XM, WK, TC><<<grid, T::THREADS, T::SMEM, st>>>(
      (const uint16_t*)X, (const uint16_t*)W, (TC*)C, d);
  return (int)cudaGetLastError();
}

template <int TM, typename TC>
static int ga_go_layout(bool xm_major, bool wk_major, const void* X, const void* W, void* C,
                        const FbDesc& d, unsigned grid, cudaStream_t st) {
  if (xm_major) return wk_major ? ga_go<TM, 1, 1, TC>(X, W, C, d, grid, st)
                                : ga_go<TM, 1, 0, TC>(X, W, C, d, grid, st);
  return wk_major ? ga_go<TM, 0, 1, TC>(X, W, C, d, grid, st)
                  : ga_go<TM, 0, 0, TC>(X, W, C, d, grid, st);
}

template <typename TC>
static int ga_launch_t(const void* X, const void* W, void* C, const FbDesc& d, cudaStream_t st) {
  const int tm = d.M <= NM_TM ? NM_TM : NM_TM_WIDE;
  const int64_t tiles = d.G * ((d.M + tm - 1) / tm) * ((d.N + NM_BN - 1) / NM_BN);
  if (tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const bool xm_major = !(d.flags & FB_F_X_KMAJOR), wk_major = d.flags & FB_F_W_KMAJOR;
  return tm == NM_TM
             ? ga_go_layout<NM_TM, TC>(xm_major, wk_major, X, W, C, d, (unsigned)tiles, st)
             : ga_go_layout<NM_TM_WIDE, TC>(xm_major, wk_major, X, W, C, d, (unsigned)tiles, st);
}

// One operand's 2-D layout (element strides s_outer, s_inner over extents
// outer, inner, either mode stride-1): what nm_map can encode.
static bool nm_layout_ok(int64_t s0, int64_t s1, int64_t e0, int64_t e1) {
  if (s1 == 1) return s0 > 0 && s0 % 8 == 0 && s0 >= e1 && s0 < ((int64_t)1 << 39);
  return s0 == 1 && s1 > 0 && s1 % 8 == 0 && s1 >= e0 && s1 < ((int64_t)1 << 39);
}

static bool nr_valid(const NrDesc* d, int tc) {
  return tc >= 0 && tc <= 1 && d->n_m >= 1 && d->n_m <= 3 && d->R >= 1 &&
         d->R <= NR_NARROW && d->rp >= d->R && d->rp % 4 == 0 && d->rp <= NR_NARROW &&
         d->K >= 1 && d->M >= 1;
}

// Route "stream", read kind: X float32 with one C mode and a 2-D tensor map
// (m or k stride-1, the other stride a multiple of 4 elements, 16-byte
// aligned base).  Type code tc: 0 = float32, 1 = bfloat16 output.  Returns
// a cudaError_t value or an HP_ERR_ code (hopper.cuh).
extern "C" int ns_launch_read(const void* X, const void* W, void* C, const NrDesc* d, int tc,
                              void* stream) {
  if (!nr_valid(d, tc)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc == 0) return ns_read_launch<float>(X, W, C, *d, st);
  return ns_read_launch<__nv_bfloat16>(X, W, C, *d, st);
}

// Route "stream", write kind: float32 X and W, k at most NR_NARROW deep.
extern "C" int ns_launch_write(const void* X, const void* W, void* C, const NwDesc* d, int tc,
                               void* stream) {
  if (tc < 0 || tc > 1 || d->K < 1 || d->K > NR_NARROW || d->M < 1 || d->P < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc == 0) return nw_launch_t<float>(X, W, C, *d, st);
  return nw_launch_t<__nv_bfloat16>(X, W, C, *d, st);
}

// Route "splitk": float32 X and W; `ws` holds n_split * R * M floats when
// n_split > 1 (else it may be null).
extern "C" int nk_launch(const void* X, const void* W, void* C, void* ws, const NrDesc* d,
                         int tc, void* stream) {
  if (!nr_valid(d, tc)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc == 0) return nk_launch_t<float>(X, W, C, ws, *d, st);
  return nk_launch_t<__nv_bfloat16>(X, W, C, ws, *d, st);
}

// Routes "wgmma" and "batched": bf16 X and W, each 16-byte aligned, whose
// (m, k) and (k, n) layouts nm_layout_ok takes, with n_grid grid modes and
// n_extra - n_grid outer contracted modes, whose strides are positive
// multiples of 8 elements in X (and in W; a grid mode may have 0 there,
// where W lacks it); `ws` holds n_split * M * N floats when n_split > 1,
// which only a launch with no extra mode may have (else it may be null).
// Type code tc: 0 = float32, 1 = bfloat16 output.  Returns a cudaError_t
// value or an HP_ERR_ code (hopper.cuh).
extern "C" int nm_launch(const void* X, const void* W, void* C, void* ws, const NmDesc* d, int tc,
                         void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  bool ok = tc >= 0 && tc <= 1 && d->M >= 1 && d->N >= 1 && d->K >= 1 && d->M < lim &&
            d->N < lim && d->K < lim && d->n_grid >= 0 && d->n_grid <= d->n_extra &&
            d->n_extra <= NM_MAX_EXTRA && nm_layout_ok(d->xs[0], d->xs[1], d->M, d->K) &&
            nm_layout_ok(d->ws[1], d->ws[0], d->K, d->N) &&
            ((uintptr_t)X | (uintptr_t)W) % 16 == 0 && d->kc >= NM_BK && d->kc % NM_BK == 0 &&
            d->n_split >= 1 && d->n_split < 65536 && (int64_t)d->kc * d->n_split >= d->K &&
            (int64_t)d->kc * (d->n_split - 1) < d->K &&
            (d->n_split == 1 || (ws && d->n_extra == 0));
  for (int j = 0; j < NM_MAX_EXTRA; ++j)
    ok = ok && d->ext[j] >= 1 && (j < d->n_extra ? d->xs[2 + j] > 0 : d->ext[j] == 1) &&
         (j < d->n_grid || d->cs[1 + j] == 0) &&
         (j < d->n_grid || j >= d->n_extra || d->ws[2 + j] > 0);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc == 0) return nm_launch_t<float>(X, W, C, ws, *d, st);
  return nm_launch_t<__nv_bfloat16>(X, W, C, ws, *d, st);
}

// Route "fbatched": float32 or (flags FB_F_X_BF16, FB_F_W_BF16) bf16 X and
// W with any strides, as native_plan describes them; `ws` holds n_split *
// G * M * N floats when n_split > 1 (else it may be null).  The walk must
// be O * ceil(K / FB_BK) stages, O the outer extents' product, split into
// n_split runs of spc stages, one chunk (FB_CHUNK_STAGES stages) each where
// n_split > 1; a 16-byte load flag needs its operand 16-byte aligned with
// its slab's minor stride 1.
// Type code tc: 0 = float32, 1 = bfloat16 output.  Returns a cudaError_t
// value.
extern "C" int fb_launch(const void* X, const void* W, void* C, void* ws, const FbDesc* d, int tc,
                         void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  bool ok = tc >= 0 && tc <= 1 && d->M >= 1 && d->N >= 1 && d->K >= 0 && d->G >= 1 &&
            d->n_grid >= 0 && d->n_grid <= d->n_extra && d->n_extra <= FB_MAX_EXTRA &&
            d->n_split >= 1 && d->n_split < 65536 && d->steps >= 0 && d->steps < lim;
  int64_t G = 1, O = 1;
  for (int j = 0; j < FB_MAX_EXTRA; ++j) {
    ok = ok && d->ext[j] >= 1 && (j < d->n_grid || d->cs[j] == 0);
    if (j < d->n_grid) G *= d->ext[j];
    else if (j < d->n_extra) O *= d->ext[j];
    else ok = ok && d->ext[j] == 1;
  }
  ok = ok && G == d->G && d->steps == O * ((d->K + FB_BK - 1) / FB_BK);
  if (d->steps > 0)
    ok = ok && d->spc >= 1 && (d->n_split - 1) * d->spc < d->steps &&
         d->n_split * d->spc >= d->steps;
  if (d->n_split > 1) ok = ok && ws && d->spc == FB_CHUNK_STAGES;
  const bool xkm = d->flags & FB_F_X_KMAJOR, wkm = d->flags & FB_F_W_KMAJOR;
  if (d->flags & FB_F_VEC_X) ok = ok && (uintptr_t)X % 16 == 0 && (xkm ? d->xk : d->xm) == 1;
  if (d->flags & FB_F_VEC_W) ok = ok && (uintptr_t)W % 16 == 0 && (wkm ? d->wk : d->wn) == 1;
  if (d->flags & FB_F_VEC_C) ok = ok && d->cn == 1 && d->cm % 4 == 0;
  if (d->flags & FB_F_SMALL) ok = ok && (d->flags & FB_F_NARROW_N);
  if (d->flags & FB_F_RAW_X) ok = ok && (d->flags & FB_F_X_BF16) && (d->flags & FB_F_VEC_X);
  if (d->flags & FB_F_RAW_W)
    ok = ok && (d->flags & FB_F_W_BF16) && (d->flags & FB_F_VEC_W) && !(d->flags & FB_F_RAW_X);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc == 0) return fb_launch_t<float>(X, W, C, ws, *d, st);
  return fb_launch_t<__nv_bfloat16>(X, W, C, ws, *d, st);
}

// Route "gathered": bf16 X and W with any strides, as native_plan
// describes them (fbatched's descriptor; one split, the walk O *
// ceil(K / NM_BK) stages); GA_F_WIDE_* needs the operand's stage minor
// stride 1.  Type code tc: 0 = float32, 1 = bfloat16
// output.  Returns a cudaError_t value.
extern "C" int ga_launch(const void* X, const void* W, void* C, const FbDesc* d, int tc,
                         void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  bool ok = tc >= 0 && tc <= 1 && d->M >= 1 && d->N >= 1 && d->K >= 1 && d->M < lim &&
            d->N < lim && d->K < lim && d->G >= 1 && d->n_grid >= 0 &&
            d->n_grid <= d->n_extra && d->n_extra <= FB_MAX_EXTRA && d->n_split == 1 &&
            d->steps >= 1 && d->steps < lim;
  int64_t G = 1, O = 1;
  for (int j = 0; j < FB_MAX_EXTRA; ++j) {
    ok = ok && d->ext[j] >= 1 && d->ext[j] < lim && (j < d->n_grid || d->cs[j] == 0);
    if (j < d->n_grid) G *= d->ext[j];
    else if (j < d->n_extra) O *= d->ext[j];
    else ok = ok && d->ext[j] == 1;
  }
  ok = ok && G == d->G && d->steps == O * ((d->K + NM_BK - 1) / NM_BK);
  const bool xkm = d->flags & FB_F_X_KMAJOR, wkm = d->flags & FB_F_W_KMAJOR;
  if (d->flags & GA_F_WIDE_X) ok = ok && (xkm ? d->xk : d->xm) == 1;
  if (d->flags & GA_F_WIDE_W) ok = ok && (wkm ? d->wk : d->wn) == 1;
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc == 0) return ga_launch_t<float>(X, W, C, *d, st);
  return ga_launch_t<__nv_bfloat16>(X, W, C, *d, st);
}

// Registers, local (spilled) bytes per thread and shared bytes per block of
// one kernel of the new routes: kind 0 stream read with m stride-1, 1
// stream read with k stride-1 (both at depth K, dynamic shared memory), 2
// stream write, 3 splitk, 4 its reduction (static shared memory), all with
// float32 output, rp the padded r of kinds 0, 1 and 3; kinds 5-8 the
// bfloat16-output wgmma kernel of NM_TM rows with X K-major (5, 6) or
// M-major (7, 8) and W N-major (5, 7) or K-major (6, 8), 9 its split
// reduction; kinds 10-13 the same kernel of NM_TM_WIDE rows; kinds 14-21
// the float32-output fbatched kernel of FB_TN (14-17) and FB_TN_NARROW
// (18-21) columns with X m-major (14, 15) or k-major (16, 17) and W
// n-major (14, 16) or k-major (15, 17), at its largest shared memory (a
// chunked walk), 22 its split reduction, 23-26 the same kernel with a
// FB_TM_SMALL x FB_TN_NARROW tile in the layout order of 14-17, and 27-34
// the bfloat16-output gathered kernel of NM_TM (27-30) and NM_TM_WIDE
// (31-34) rows in the layout order of 5-8, and 35-46 the float32-output
// fbatched kernel with a bf16 operand (WIDEN) in the tile and layout order
// of 14-21 and 23-26, at its largest shared memory (a chunked walk with the
// raw ring).
extern "C" int nr_info(int kind, int rp, int64_t K, int* out) {
  const void* fn = nullptr;
  size_t smem = 0;
  typedef __nv_bfloat16 B16;
  if (kind == 0 || kind == 1) {
    fn = ns_read_fn<float>(rp, kind == 1);
    smem = ns_smem_bytes(K, rp);
  } else if (kind == 2) {
    fn = (const void*)nw_kernel<float>;
  } else if (kind == 3) {
    if (rp == 4) fn = (const void*)nk_kernel<4, float>;
    if (rp == 8) fn = (const void*)nk_kernel<8, float>;
    if (rp == 12) fn = (const void*)nk_kernel<12, float>;
    if (rp == 16) fn = (const void*)nk_kernel<16, float>;
  } else if (kind == 4) {
    fn = (const void*)nk_reduce<float>;
  } else if (kind >= 5 && kind <= 8) {
    const void* fns[4] = {
        (const void*)nm_kernel<NM_TM, 0, 0, B16>, (const void*)nm_kernel<NM_TM, 0, 1, B16>,
        (const void*)nm_kernel<NM_TM, 1, 0, B16>, (const void*)nm_kernel<NM_TM, 1, 1, B16>};
    fn = fns[kind - 5];
    smem = NmTile<NM_TM>::SMEM;
  } else if (kind == 9) {
    fn = (const void*)nm_reduce<B16>;
  } else if (kind >= 10 && kind <= 13) {
    const void* fns[4] = {(const void*)nm_kernel<NM_TM_WIDE, 0, 0, B16>,
                          (const void*)nm_kernel<NM_TM_WIDE, 0, 1, B16>,
                          (const void*)nm_kernel<NM_TM_WIDE, 1, 0, B16>,
                          (const void*)nm_kernel<NM_TM_WIDE, 1, 1, B16>};
    fn = fns[kind - 10];
    smem = NmTile<NM_TM_WIDE>::SMEM;
  } else if (kind >= 14 && kind <= 21) {
    const void* fns[8] = {
        (const void*)fb_kernel<FB_TM, FB_TN, false, false, false, float>,
        (const void*)fb_kernel<FB_TM, FB_TN, false, true, false, float>,
        (const void*)fb_kernel<FB_TM, FB_TN, true, false, false, float>,
        (const void*)fb_kernel<FB_TM, FB_TN, true, true, false, float>,
        (const void*)fb_kernel<FB_TM, FB_TN_NARROW, false, false, false, float>,
        (const void*)fb_kernel<FB_TM, FB_TN_NARROW, false, true, false, float>,
        (const void*)fb_kernel<FB_TM, FB_TN_NARROW, true, false, false, float>,
        (const void*)fb_kernel<FB_TM, FB_TN_NARROW, true, true, false, float>};
    fn = fns[kind - 14];
    smem = fb_smem_bytes(FB_TM, kind < 18 ? FB_TN : FB_TN_NARROW, true);
  } else if (kind == 22) {
    fn = (const void*)fb_reduce<float>;
  } else if (kind >= 23 && kind <= 26) {
    const void* fns[4] = {
        (const void*)fb_kernel<FB_TM_SMALL, FB_TN_NARROW, false, false, false, float>,
        (const void*)fb_kernel<FB_TM_SMALL, FB_TN_NARROW, false, true, false, float>,
        (const void*)fb_kernel<FB_TM_SMALL, FB_TN_NARROW, true, false, false, float>,
        (const void*)fb_kernel<FB_TM_SMALL, FB_TN_NARROW, true, true, false, float>};
    fn = fns[kind - 23];
    smem = fb_smem_bytes(FB_TM_SMALL, FB_TN_NARROW, true);
  } else if (kind >= 35 && kind <= 46) {
    const void* fns[12] = {
        (const void*)fb_kernel<FB_TM, FB_TN, false, false, true, float>,
        (const void*)fb_kernel<FB_TM, FB_TN, false, true, true, float>,
        (const void*)fb_kernel<FB_TM, FB_TN, true, false, true, float>,
        (const void*)fb_kernel<FB_TM, FB_TN, true, true, true, float>,
        (const void*)fb_kernel<FB_TM, FB_TN_NARROW, false, false, true, float>,
        (const void*)fb_kernel<FB_TM, FB_TN_NARROW, false, true, true, float>,
        (const void*)fb_kernel<FB_TM, FB_TN_NARROW, true, false, true, float>,
        (const void*)fb_kernel<FB_TM, FB_TN_NARROW, true, true, true, float>,
        (const void*)fb_kernel<FB_TM_SMALL, FB_TN_NARROW, false, false, true, float>,
        (const void*)fb_kernel<FB_TM_SMALL, FB_TN_NARROW, false, true, true, float>,
        (const void*)fb_kernel<FB_TM_SMALL, FB_TN_NARROW, true, false, true, float>,
        (const void*)fb_kernel<FB_TM_SMALL, FB_TN_NARROW, true, true, true, float>};
    fn = fns[kind - 35];
    const int tm = kind < 43 ? FB_TM : FB_TM_SMALL, tn = kind < 39 ? FB_TN : FB_TN_NARROW;
    smem = fb_smem_bytes(tm, tn, true, 1);
  } else if (kind >= 27 && kind <= 30) {
    const void* fns[4] = {(const void*)nm_gather_kernel<NM_TM, 0, 0, B16>,
                          (const void*)nm_gather_kernel<NM_TM, 0, 1, B16>,
                          (const void*)nm_gather_kernel<NM_TM, 1, 0, B16>,
                          (const void*)nm_gather_kernel<NM_TM, 1, 1, B16>};
    fn = fns[kind - 27];
    smem = GaTile<NM_TM>::SMEM;
  } else if (kind >= 31 && kind <= 34) {
    const void* fns[4] = {(const void*)nm_gather_kernel<NM_TM_WIDE, 0, 0, B16>,
                          (const void*)nm_gather_kernel<NM_TM_WIDE, 0, 1, B16>,
                          (const void*)nm_gather_kernel<NM_TM_WIDE, 1, 0, B16>,
                          (const void*)nm_gather_kernel<NM_TM_WIDE, 1, 1, B16>};
    fn = fns[kind - 31];
    smem = GaTile<NM_TM_WIDE>::SMEM;
  }
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(smem ? smem : attr.sharedSizeBytes);
  return 0;
}

extern "C" const char* sb_error_string(int code) { return hp_error_string(code); }
