// grouped_gemm: ragged per-group GEMMs in one launch (sm_90a).
//
// Replaces the TPU kernel grouped_gemm_pallas (src/repro/kernels/grouped_gemm.py,
// body _kernel), the kernel of the JAX package's public entry point
// ops.grouped_matmul: for every group g of an int32 descriptor table
//   desc[g] = (m_p, n_p, k_p, a_off, b_off, c_off, trans_a, trans_b)
// it computes C[c_off : c_off+m_p, 0:n_p] = A_g (m_p x k_p) @ B_g (k_p x n_p),
// with A_g stored at rows a_off.. of the flat A buffer as (m_p, k_p), or as
// (k_p, m_p) when trans_a is set, and B_g at rows b_off.. of the flat B
// buffer as (k_p, n_p), or (n_p, k_p) under trans_b.  The sum is kept in
// f32 and cast to the output type on store; a k_p == 0 group writes zeros.
//
// Blocks.  The TPU grid (group, u, v, k) is sized by the largest group and
// predicates most of its programs off; its k axis is sequential, with an f32
// VMEM tile carried across it.  Here no state crosses blocks: the wrapper
// (repro_torch/kernels/grouped_gemm.py) passes the descriptor rows followed by
// an exclusive prefix sum of each group's output tiles, ceil(m_p/TM) *
// ceil(n_p/TN) for the route's tile, and launches exactly that many blocks.
// A block finds its group by binary search in the prefix, owns one TM x TN
// tile of C and runs the whole K loop itself.  Tiles of one group are
// consecutive, so the blocks in flight share the group's B in L2.  Both
// routes store C from registers, masked to the group's m_p x n_p: a tile
// store that crossed the group's edge would overwrite the next group's rows.
//
// Bound.  At the qwen2-moe-a2.7b expert up-projection (16,384 routed rows,
// d_model 2048 -> d_expert 1408, 60 experts) the work is 94.5 GFLOP.  In
// bf16 the bound is the bytes moved: 454 MB in 0.135 ms at 3.35 TB/s, since
// 94.5 GFLOP at the tensor cores' 989 TFLOP/s take 0.096 ms.  In f32 it is
// the FMA rate: 1.41 ms at 67 TFLOP/s.
//
// Route "wgmma" (gw_kernel: bf16 operands, 16-byte aligned, every group
// with output tiles having k_p % 64 == 0).  One block owns a 128 x 256
// tile of C: two consumer warpgroups of 64 rows each and one producer
// warpgroup (384 threads) that hands most of its registers to the
// consumers (setmaxnreg).  The producer's first thread feeds a ring of 4
// shared-memory stages, each a 64-deep slab of A (16 KB) and of B (32 KB)
// guarded by a "full" and an "empty" mbarrier, by TMA from one 2-D tensor
// map per operand layout over the whole flat buffer (its own row stride),
// with the 128-byte swizzle: 64 bf16 of depth are one swizzle span.  Plain
// A is read K-major, trans_a A M-major (wgmma's transpose bit for A),
// plain B N-major and trans_b B K-major.  Each consumer warpgroup runs four
// wgmma m64n256k16 per stage into 128 f32 accumulators per thread, keeps
// one stage's batch in flight while it waits for the next, and frees a
// stage once the batch that read it is done.  The 256-wide tile reads a
// quarter fewer bytes per product from L2 than a 128 x 128 one, which
// outweighs the wider padding at the up-projection's n = 1408 (1536
// computed): 33% (skewed) and 45% (uniform) of the products fall on padded
// rows and columns, against 22% and 33% at 128 x 128.  Why k_p % 64 == 0:
// a K slab that ran past k_p would read the next group's rows (plain B,
// trans_a A) or columns nobody promised are zero (plain A, trans_b B), and
// the sum would be wrong; overhang along M or N reaches only rows or
// columns of C that the store masks.  Under the default packing tiles (k =
// 128) every group qualifies.  A k_p == 0 group writes its tiles as zeros
// without touching the ring.  Left out: a persistent walk over the tile
// list (each block fills its ring from empty), clusters with TMA multicast
// of B, a TMA store of C through shared memory, and fp8.
//
// Route "fma" (gg_kernel: float32, mixed float32/bf16 operands, and groups
// with a ragged k_p).  The classic SIMT GEMM: each block of 128 threads
// owns a 64 x 128 tile of C and each thread an 8 x 8 sub-tile in f32
// registers, rows 4 ty + i and 32 + 4 ty + i, columns 4 tx + j and 64 + 4 tx
// + j, so that its slab reads from shared memory (laid out [k][row] and
// [k][col], rows padded by 4 floats) are four float4s per depth step:
// 16 floats for 64 FMAs.  Two shared-memory stages of 16-deep slabs, one
// barrier per slab: the next slab is in flight while the current one is
// computed.  The per-group flags pick the fetch.  Where the stored minor
// dimension is the tile's own (trans_a A, plain B) a float32 slab lands by
// 16-byte cp.async straight into place; bf16, and the k-inner layouts
// (plain A, trans_b B), go through registers, loaded before the compute
// and converted and transposed into the other stage after it.  Global
// reads are 16 bytes a thread (4 f32 or 8 bf16), legal because the wrapper
// requires every m_p, n_p, k_p and row stride to be a multiple of 8: a
// chunk is then wholly inside a group's extent or wholly outside it (and
// zero-filled), and every row starts 16-byte aligned.  Products
// accumulate with plain FMA (no TF32, which would break the f32 tolerance
// and the integer-valued bit-exact cases).  Ragged edges are masked to the
// group's m_p/n_p/k_p, so the kernel's tile need not match the packing
// tiles.  The tile is 64 rows, not 128: at the up-projection's skewed
// routing (median 136 rows per expert) 64-row tiles compute 18,368 rows
// for 16,384 routed (10.8% padding; 18,560 and 11.7% under the uniform
// routing) against 19,968 (17.9%; uniform 21,760, 24.7%) at 128 rows,
// and an A/B of the two on an H100 ran the 64-row tile a little faster.
// In f32 the kernel is bound by the FMA rate (1.41 ms at the
// up-projection); it takes 2.44 ms there, 58% of it, against 3.54-3.56 ms
// for the first version of this route (H100 80GB HBM3, 700 W; PERF.md).
// What holds it from the bound: the padded rows, the
// transposing stores of A through registers, one barrier per 16-deep
// slab, and 4 blocks of 4 warps per SM under a 128-register cap.  Its
// next step is split-precision products on the tensor cores (3xTF32 or
// bf16 x 3), beyond what the FMA units can give.

#include "hopper.cuh"

#define GG_TU 64      // output rows per block (mirrors KERNEL_TILES["fma"])
#define GG_TV 128     // output columns per block
#define GG_BK 16      // contracted depth per stage
#define GG_DESC 8     // int32 fields per descriptor row
#define GG_THREADS (2 * GG_TU)  // (GG_TU / 8) x 16 threads, 8 x 8 outputs each
#define GG_LDA (GG_TU + 4)      // smem row strides in floats: rows stay 16-byte aligned,
#define GG_LDB (GG_TV + 4)      // and a warp's transposing stores meet 2-way, not 4-way

template <typename T> __device__ __forceinline__ T gg_from_f32(float x);
template <> __device__ __forceinline__ float gg_from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 gg_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One operand's slab of one stage: OUTER stored rows x INNER stored
// columns, moved as 16-byte chunks into a shared tile [GG_BK][LD] laid out
// [k][row] (A) or [k][col] (B).  K_INNER: the stored minor dimension is k,
// so the slab is transposed on its way in, through registers.  Otherwise a
// stored row is a row of the tile: float32 goes by cp.async straight into
// place (ASYNC), bf16 through registers, converted.
template <typename T, int OUTER, int INNER, bool K_INNER, int LD>
struct GgSlab {
  static constexpr bool ASYNC = !K_INNER && sizeof(T) == 4;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = INNER / VEC;
  static constexpr int CHUNKS = OUTER * INNER / VEC / GG_THREADS;
  static_assert(OUTER * INNER % (VEC * GG_THREADS) == 0, "slab split");
  uint4 r[ASYNC ? 1 : CHUNKS];  // chunks in flight through registers

  // base: the group's block; (o0, i0) the slab origin in stored rows and
  // columns; (o_ext, i_ext) the group's stored extents.  ASYNC issues the
  // copies into sm (the caller commits them); else the chunks wait in
  // registers for store().
  __device__ __forceinline__ void load(const T* __restrict__ base, int64_t ld, int o0, int i0,
                                       int o_ext, int i_ext, float* sm) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = threadIdx.x + c * GG_THREADS;
      const int o = e / PER_ROW, i = (e % PER_ROW) * VEC;
      const bool ok = o0 + o < o_ext && i0 + i < i_ext;
      const T* p = ok ? base + (int64_t)(o0 + o) * ld + i0 + i : base;
      if constexpr (ASYNC)
        hp_cp_async<16>(sm + o * LD + i, p, ok);
      else
        r[c] = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(float* sm) const {
    if constexpr (!ASYNC) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int e = threadIdx.x + c * GG_THREADS;
        const int o = e / PER_ROW, i = (e % PER_ROW) * VEC;
        float x[VEC];
        hp_unpack16<T>(r[c], x);
        if (K_INNER) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) sm[(i + v) * LD + o] = x[v];
        } else {
#pragma unroll
          for (int v = 0; v < VEC; v += 4)
            *reinterpret_cast<float4*>(sm + o * LD + i + v) =
                make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
        }
      }
    }
  }
};

// 8 f32 values: 4 at p, 4 at p + half.
template <int HALF> __device__ __forceinline__ void gg_frag(const float* p, float* x) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + HALF);
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = lo.z;
  x[3] = lo.w;
  x[4] = hi.x;
  x[5] = hi.y;
  x[6] = hi.z;
  x[7] = hi.w;
}

// Thread (ty, tx) = (threadIdx / 16, threadIdx % 16) owns rows 4 ty + i and
// GG_TU / 2 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j (i, j < 4) of
// the block's tile.  As and Bs hold two stages.
template <typename TA, typename TB, typename TC, bool TRA, bool TRB>
__device__ __forceinline__ void gg_tile(const TA* __restrict__ A, const TB* __restrict__ B,
                                        TC* __restrict__ C, int64_t lda, int64_t ldb,
                                        int64_t ldc, const int32_t* d, int u_blk, int v_blk,
                                        float* As, float* Bs) {
  const int m = d[0], n = d[1], k = d[2];
  const int m0 = u_blk * GG_TU, n0 = v_blk * GG_TV;
  const TA* a = A + (int64_t)d[3] * lda;
  const TB* b = B + (int64_t)d[4] * ldb;
  // stored layouts: A (m, k) or (k, m); B (k, n) or (n, k)
  GgSlab<TA, TRA ? GG_BK : GG_TU, TRA ? GG_TU : GG_BK, !TRA, GG_LDA> sa;
  GgSlab<TB, TRB ? GG_TV : GG_BK, TRB ? GG_BK : GG_TV, TRB, GG_LDB> sb;
  auto load = [&](int k0, int st) {
    float* as = As + st * GG_BK * GG_LDA;
    float* bs = Bs + st * GG_BK * GG_LDB;
    if (TRA) sa.load(a, lda, k0, m0, k, m, as);
    else sa.load(a, lda, m0, k0, m, k, as);
    if (TRB) sb.load(b, ldb, n0, k0, n, k, bs);
    else sb.load(b, ldb, k0, n0, k, n, bs);
    hp_cp_commit();
  };
  auto store = [&](int st) {
    sa.store(As + st * GG_BK * GG_LDA);
    sb.store(Bs + st * GG_BK * GG_LDB);
    hp_cp_wait<0>();
  };

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (k + GG_BK - 1) / GG_BK;
  if (n_k > 0) {
    load(0, 0);
    store(0);
  }
  __syncthreads();
  // one barrier per slab: stage st ^ 1, written while st is computed, was
  // last read in the previous slab, before its barrier
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_k) load((kt + 1) * GG_BK, st ^ 1);  // next slab in flight during compute
    const float* as = As + st * GG_BK * GG_LDA + 4 * ty;
    const float* bs = Bs + st * GG_BK * GG_LDB + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < GG_BK; ++kk) {
      float av[8], bv[8];
      gg_frag<GG_TU / 2>(as + kk * GG_LDA, av);
      gg_frag<64>(bs + kk * GG_LDB, bv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < n_k) store(st ^ 1);
    __syncthreads();
  }

  TC* c = C + (int64_t)d[5] * ldc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 0 : GG_TU / 2) + 4 * ty + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 0 : 64) + 4 * tx + j % 4;
      if (col < n) c[(int64_t)row * ldc + col] = gg_from_f32<TC>(acc[i][j]);
    }
  }
}

// table: n_groups descriptor rows of GG_DESC int32, then n_groups + 1
// exclusive prefix sums of the groups' output tiles.  Returns the
// descriptor row of the last group whose first tile is at or before `tile`,
// and sets *t to the tile's index within that group.
__device__ __forceinline__ const int32_t* gg_group(const int32_t* __restrict__ table,
                                                   int n_groups, int tile, int* t) {
  const int32_t* prefix = table + GG_DESC * n_groups;
  int lo = 0, hi = n_groups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (prefix[mid] <= tile) lo = mid;
    else hi = mid - 1;
  }
  *t = tile - prefix[lo];
  return table + GG_DESC * lo;
}

// Four blocks of 128 threads per SM (at most 128 registers a thread) where
// both operands are float32, whose B slab of a plain layout lands by
// cp.async; three (at most 168) where a bf16 slab waits in registers too.
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(GG_THREADS, sizeof(TA) == 4 && sizeof(TB) == 4 ? 4 : 3)
gg_kernel(const TA* __restrict__ A, const TB* __restrict__ B, TC* __restrict__ C,
          const int32_t* __restrict__ table, int n_groups, int64_t lda, int64_t ldb,
          int64_t ldc) {
  __shared__ __align__(16) float As[2 * GG_BK * GG_LDA];
  __shared__ __align__(16) float Bs[2 * GG_BK * GG_LDB];
  int t;
  const int32_t* d = gg_group(table, n_groups, blockIdx.x, &t);
  const int nv = (d[1] + GG_TV - 1) / GG_TV;
  const int u_blk = t / nv, v_blk = t % nv;
  if (d[6]) {
    if (d[7]) gg_tile<TA, TB, TC, true, true>(A, B, C, lda, ldb, ldc, d, u_blk, v_blk, As, Bs);
    else gg_tile<TA, TB, TC, true, false>(A, B, C, lda, ldb, ldc, d, u_blk, v_blk, As, Bs);
  } else {
    if (d[7]) gg_tile<TA, TB, TC, false, true>(A, B, C, lda, ldb, ldc, d, u_blk, v_blk, As, Bs);
    else gg_tile<TA, TB, TC, false, false>(A, B, C, lda, ldb, ldc, d, u_blk, v_blk, As, Bs);
  }
}

template <typename TA, typename TB, typename TC>
static int gg_launch_t(const void* A, const void* B, void* C, const int32_t* table,
                       int n_groups, int64_t n_tiles, int64_t lda, int64_t ldb, int64_t ldc,
                       cudaStream_t stream) {
  gg_kernel<TA, TB, TC><<<(unsigned)n_tiles, GG_THREADS, 0, stream>>>(
      (const TA*)A, (const TB*)B, (TC*)C, table, n_groups, lda, ldb, ldc);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
static int gg_launch_c(const void* A, const void* B, void* C, const int32_t* table,
                       int n_groups, int64_t n_tiles, int64_t lda, int64_t ldb, int64_t ldc,
                       int tc, cudaStream_t stream) {
  if (tc == 0)
    return gg_launch_t<TA, TB, float>(A, B, C, table, n_groups, n_tiles, lda, ldb, ldc, stream);
  return gg_launch_t<TA, TB, __nv_bfloat16>(A, B, C, table, n_groups, n_tiles, lda, ldb, ldc,
                                            stream);
}

// Route "fma".  Type codes: 0 = float32, 1 = bfloat16.  `table` is on the
// device, its prefix over GG_TU x GG_TV tiles.  Returns a cudaError_t value.
extern "C" int gg_launch(const void* A, const void* B, void* C, const void* table,
                         int n_groups, int64_t n_tiles, int64_t lda, int64_t ldb,
                         int64_t ldc, int ta, int tb, int tc, void* stream) {
  if (ta < 0 || ta > 1 || tb < 0 || tb > 1 || tc < 0 || tc > 1 || n_groups < 1 ||
      n_tiles < 0 || n_tiles >= ((int64_t)1 << 31) || lda % 8 || ldb % 8 ||
      ((uintptr_t)A | (uintptr_t)B) % 16)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  const int32_t* tb_ = (const int32_t*)table;
  const cudaStream_t st = (cudaStream_t)stream;
  if (ta == 0 && tb == 0)
    return gg_launch_c<float, float>(A, B, C, tb_, n_groups, n_tiles, lda, ldb, ldc, tc, st);
  if (ta == 0)
    return gg_launch_c<float, __nv_bfloat16>(A, B, C, tb_, n_groups, n_tiles, lda, ldb, ldc,
                                             tc, st);
  if (tb == 0)
    return gg_launch_c<__nv_bfloat16, float>(A, B, C, tb_, n_groups, n_tiles, lda, ldb, ldc,
                                             tc, st);
  return gg_launch_c<__nv_bfloat16, __nv_bfloat16>(A, B, C, tb_, n_groups, n_tiles, lda, ldb,
                                                   ldc, tc, st);
}


// ---------------------------------------------------------------- wgmma route
#define GW_TM 128              // output rows per block: two consumer warpgroups of 64
#define GW_TN 256              // output columns per block
#define GW_BK 64               // depth per stage: 64 bf16 are one 128-byte swizzle span
#define GW_STAGES 4            // ring depth: 4 x 48 KB
#define GW_THREADS 384         // two consumer warpgroups + one producer warpgroup
#define GW_PRODUCER_REGS 40    // registers per thread after setmaxnreg; the producer
#define GW_CONSUMER_REGS 232   // only issues copies (128 x 40 + 256 x 232 <= 65,536)
#define GW_BOX (64 * GW_BK * 2)                 // one 64-row box of 128-byte rows: 8 KB
#define GW_A_BYTES (2 * GW_BOX)                  // A of one stage: 16 KB
#define GW_STAGE_BYTES (GW_A_BYTES + GW_TN / 64 * GW_BOX)  // then B: 32 KB
#define GW_BAR_OFF (GW_STAGES * GW_STAGE_BYTES)
#define GW_SMEM (1024 + GW_BAR_OFF + 8 * 2 * GW_STAGES)  // + alignment slack

// Shared memory, 1024-byte aligned (the 128-byte swizzle repeats every 8
// rows of 128 bytes): per stage, A as [128 rows][64 k] (plain) or two
// [64 k][64 m] boxes (trans_a), each warpgroup's 64 rows one box apart
// either way; then B as four [64 k][64 n] boxes (plain) or [256 n][64 k]
// (trans_b); then the mbarriers.  The four tensor maps of one launch: A
// read K-major (plain, boxes of 64 k x 128 rows) or M-major (trans_a, 64 m
// x 64 k rows); B read N-major (plain, 64 n x 64 k rows) or K-major
// (trans_b, 64 k x 256 n rows).

// One consumer warpgroup: C rows m0 + 64 wg + [0, 64), columns n0 + [0,
// 256) of the group at c (row stride ldc), masked to m x n.
template <int TRA, int TRB, typename TC>
__device__ __forceinline__ void gw_consume(const uint8_t* sm, uint64_t* full, uint64_t* empty,
                                           int n_k, int m, int n, int m0, int n0, TC* c,
                                           int64_t ldc) {
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  float acc[GW_TN / 2];
#pragma unroll
  for (int i = 0; i < GW_TN / 2; ++i) acc[i] = 0.f;

  hp_consume_ring<TRA, TRB, GW_STAGES>(acc, sm, GW_STAGE_BYTES, wg * GW_BOX, GW_A_BYTES, full,
                                       empty, n_k);

  const int row0 = m0 + 64 * wg + 16 * warp + lane / 4;
  const bool pairs = ldc % 2 == 0;  // (row, even col) pairs then start 2-element aligned
#pragma unroll
  for (int i = 0; i < GW_TN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane % 4);  // even; n is a multiple of 8
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      TC* p = c + (int64_t)row * ldc + col;
      if (pairs) {
        hp_store2<TC>(p, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      } else {
        p[0] = gg_from_f32<TC>(acc[4 * i + 2 * h]);
        p[1] = gg_from_f32<TC>(acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

template <typename TC>
__global__ void __launch_bounds__(GW_THREADS, 1)
gw_kernel(const __grid_constant__ CUtensorMap a_k, const __grid_constant__ CUtensorMap a_m,
          const __grid_constant__ CUtensorMap b_n, const __grid_constant__ CUtensorMap b_k,
          TC* __restrict__ C, const int32_t* __restrict__ table, int n_groups, int64_t ldc) {
  extern __shared__ uint8_t gw_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gw_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + GW_BAR_OFF);
  uint64_t* empty = full + GW_STAGES;

  int t;
  const int32_t* d = gg_group(table, n_groups, blockIdx.x, &t);
  const int m = d[0], n = d[1], k = d[2], a_off = d[3], b_off = d[4];
  const int tra = d[6], trb = d[7];
  const int nv = (n + GW_TN - 1) / GW_TN;
  const int m0 = t / nv * GW_TM, n0 = t % nv * GW_TN;
  TC* c = C + (int64_t)d[5] * ldc;

  if (k == 0) {  // exact zeros; no copy would complete a barrier
    for (int i = threadIdx.x; i < GW_TM * GW_TN; i += GW_THREADS) {
      const int row = m0 + i / GW_TN, col = n0 + i % GW_TN;
      if (row < m && col < n) c[(int64_t)row * ldc + col] = gg_from_f32<TC>(0.f);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < GW_STAGES; ++s) {
      hp_bar_init(&full[s], 1);
      hp_bar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_k = k / GW_BK;
  const int warp = threadIdx.x / 32;
  if (warp >= 8) {  // producer warpgroup: lane 0 of warp 8 issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(GW_PRODUCER_REGS));
    if (warp == 8 && threadIdx.x % 32 == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % GW_STAGES, k0 = it * GW_BK;
        if (it >= GW_STAGES) hp_bar_wait(&empty[s], (it / GW_STAGES - 1) & 1);
        uint8_t* as = sm + s * GW_STAGE_BYTES;
        uint8_t* bs = as + GW_A_BYTES;
        hp_bar_expect(&full[s], GW_STAGE_BYTES);
        if (tra) {  // stored (k_p, m_p): rows k0.., columns m0.. and m0 + 64..
          hp_tma_load(as, &a_m, &full[s], m0, a_off + k0);
          hp_tma_load(as + GW_BOX, &a_m, &full[s], m0 + 64, a_off + k0);
        } else {    // stored (m_p, k_p): rows m0.., columns k0..
          hp_tma_load(as, &a_k, &full[s], k0, a_off + m0);
        }
        if (trb) {  // stored (n_p, k_p): rows n0.., columns k0..
          hp_tma_load(bs, &b_k, &full[s], k0, b_off + n0);
        } else {    // stored (k_p, n_p): rows k0.., columns n0 + 64 j..
#pragma unroll
          for (int j = 0; j < GW_TN / 64; ++j)
            hp_tma_load(bs + j * GW_BOX, &b_n, &full[s], n0 + 64 * j, b_off + k0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(GW_CONSUMER_REGS));
    if (tra) {
      if (trb) gw_consume<1, 1, TC>(sm, full, empty, n_k, m, n, m0, n0, c, ldc);
      else gw_consume<1, 0, TC>(sm, full, empty, n_k, m, n, m0, n0, c, ldc);
    } else {
      if (trb) gw_consume<0, 1, TC>(sm, full, empty, n_k, m, n, m0, n0, c, ldc);
      else gw_consume<0, 0, TC>(sm, full, empty, n_k, m, n, m0, n0, c, ldc);
    }
  }
}

// A (rows, cols) bf16 buffer with row stride ld (elements), read in boxes
// of 64 columns x box_rows rows.  A buffer of one row (or none) is never
// stepped along its rows, so any stride is given a legal one.
static int gw_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols, int64_t ld,
                  int box_rows) {
  if (rows <= 1) ld = (cols + 7) / 8 * 8;
  const cuuint64_t dims[2] = {(cuuint64_t)(cols > 0 ? cols : 1), (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld > 0 ? ld : 8) * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return hp_map(map, ptr, 2, dims, strides, box);
}

template <typename TC>
static int gw_launch_t(const CUtensorMap* maps, void* C, const int32_t* table, int n_groups,
                       int64_t n_tiles, int64_t ldc, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(gw_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, GW_SMEM);
  if (err != cudaSuccess) return (int)err;
  gw_kernel<TC><<<(unsigned)n_tiles, GW_THREADS, GW_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (TC*)C, table, n_groups, ldc);
  return (int)cudaGetLastError();
}

// Route "wgmma": A and B bf16 (rows, cols) buffers with row strides lda,
// ldb (multiples of 8 elements) and 16-byte aligned bases; every group
// with output tiles has k_p % 64 == 0.  Output type code tc: 0 = float32,
// 1 = bfloat16.  `table` is on the device, its prefix over GW_TM x GW_TN
// tiles.  Returns a cudaError_t value or an HP_ERR_ code (hopper.cuh).
extern "C" int gg_launch_wgmma(const void* A, const void* B, void* C, const void* table,
                               int n_groups, int64_t n_tiles, int64_t a_rows, int64_t a_cols,
                               int64_t lda, int64_t b_rows, int64_t b_cols, int64_t ldb,
                               int64_t ldc, int tc, void* stream) {
  if (tc < 0 || tc > 1 || n_groups < 1 || n_tiles < 0 || n_tiles >= ((int64_t)1 << 31) ||
      lda % 8 || ldb % 8 || ((uintptr_t)A | (uintptr_t)B) % 16)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  CUtensorMap maps[4];
  int rc = gw_map(&maps[0], A, a_rows, a_cols, lda, GW_TM);
  if (!rc) rc = gw_map(&maps[1], A, a_rows, a_cols, lda, 64);
  if (!rc) rc = gw_map(&maps[2], B, b_rows, b_cols, ldb, 64);
  if (!rc) rc = gw_map(&maps[3], B, b_rows, b_cols, ldb, GW_TN);
  if (rc) return rc;
  const int32_t* tb_ = (const int32_t*)table;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc == 0) return gw_launch_t<float>(maps, C, tb_, n_groups, n_tiles, ldc, st);
  return gw_launch_t<__nv_bfloat16>(maps, C, tb_, n_groups, n_tiles, ldc, st);
}

// The wgmma kernel for output type code tc: out = {registers per thread,
// local (spilled) bytes per thread, dynamic shared bytes per block}.
extern "C" int gg_wgmma_info(int tc, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = tc == 0 ? cudaFuncGetAttributes(&attr, gw_kernel<float>)
                                  : cudaFuncGetAttributes(&attr, gw_kernel<__nv_bfloat16>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = GW_SMEM;
  return 0;
}

template <typename TA, typename TB, typename TC> static int gg_info_t(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, gg_kernel<TA, TB, TC>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  return 0;
}

template <typename TA, typename TB> static int gg_info_c(int tc, int* out) {
  return tc == 0 ? gg_info_t<TA, TB, float>(out) : gg_info_t<TA, TB, __nv_bfloat16>(out);
}

// The fma kernel for type codes ta, tb, tc (as gg_launch): out = {registers
// per thread, local (spilled) bytes per thread, static shared bytes per
// block}.
extern "C" int gg_fma_info(int ta, int tb, int tc, int* out) {
  if (ta == 0 && tb == 0) return gg_info_c<float, float>(tc, out);
  if (ta == 0) return gg_info_c<float, __nv_bfloat16>(tc, out);
  if (tb == 0) return gg_info_c<__nv_bfloat16, float>(tc, out);
  return gg_info_c<__nv_bfloat16, __nv_bfloat16>(tc, out);
}

extern "C" const char* gg_error_string(int code) { return hp_error_string(code); }
