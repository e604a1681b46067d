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
// an exclusive prefix sum of each group's output tiles, ceil(m_p/GG_TU) *
// ceil(n_p/GG_TV), and launches exactly that many blocks.  A block finds its
// group by binary search in the prefix, owns one GG_TU x GG_TV tile of C and
// runs the whole K loop itself.  Tiles of one group are consecutive, so the
// blocks in flight share the group's B in L2.
//
// Loads.  Each stage stages a GG_BK-deep slab of A_g and of B_g in shared
// memory, converted to f32, laid out [k][row] and [k][col].  The per-group
// flags pick the fetch: global loads run along each operand's stored minor
// dimension (k for plain A, m for trans_a, n for plain B, k for trans_b), 16
// bytes per thread (4 f32 or 8 bf16).  That is legal because the wrapper
// requires every m_p, n_p, k_p and row stride to be a multiple of 8: a
// 16-byte chunk is then either wholly inside a group's extent or wholly
// outside it, and every row starts 16-byte aligned.  The next stage is
// loaded into registers while the current one is computed.  Products
// accumulate in f32 registers with plain FMA (no TF32); each of the 256
// threads owns a 4 x 8 sub-tile.  Ragged edges are masked to the group's
// m_p/n_p/k_p, so the kernel's tile need not match the packing tiles.
//
// Bound.  At the qwen2-moe-a2.7b expert up-projection (16,384 routed rows,
// d_model 2048 -> d_expert 1408, 60 experts) the work is 94.5 GFLOP.  In
// f32 the bound is the FMA rate: 1.41 ms at 67 TFLOP/s (the 918 MB moved
// take 0.27 ms at 3.35 TB/s).  In bf16 it is the 459 MB moved, 0.14 ms,
// since 94.5 GFLOP at the tensor cores' 989 TFLOP/s take 0.10 ms.  This
// kernel runs on the FMA units and reads its operands without TMA, so it
// cannot approach the bf16 bound; wgmma with a TMA ring, and a persistent
// walk over the tile list, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GG_TU 64      // output rows per block (mirrors KERNEL_TILE)
#define GG_TV 128     // output columns per block
#define GG_BK 32      // contracted depth per stage
#define GG_THREADS 256
#define GG_DESC 8     // int32 fields per descriptor row
#define GG_TM 4       // rows per thread: ty + 16 i
#define GG_TN 8       // columns per thread: tx + 16 j

template <typename T> __device__ __forceinline__ T gg_from_f32(float x);
template <> __device__ __forceinline__ float gg_from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 gg_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes at p (16-byte aligned) as f32 values.
__device__ __forceinline__ void gg_load16(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void gg_load16(const __nv_bfloat16* p, float* v) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// One operand's slab: OUTER stored rows x INNER stored columns, read as
// 16-byte chunks.  K_INNER says whether the stored minor dimension is k
// (else it is the tile's row or column dimension); the smem tile is
// [GG_BK][W + 1] either way.
template <typename T, int OUTER, int INNER, bool K_INNER, int W>
struct GgSlab {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = INNER / VEC;
  static constexpr int CHUNKS = OUTER * INNER / VEC / GG_THREADS;
  static_assert(OUTER * INNER % (VEC * GG_THREADS) == 0, "slab split");
  float r[CHUNKS][VEC];

  // base: the group's block; (o0, i0) the slab origin in stored rows and
  // columns; (o_ext, i_ext) the group's stored extents.
  __device__ __forceinline__ void load(const T* __restrict__ base, int64_t ld, int o0,
                                       int i0, int o_ext, int i_ext) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = threadIdx.x + c * GG_THREADS;
      const int o = e / PER_ROW, i = (e % PER_ROW) * VEC;
      if (o0 + o < o_ext && i0 + i < i_ext) {
        gg_load16(base + (int64_t)(o0 + o) * ld + i0 + i, r[c]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) r[c][v] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* sm) const {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = threadIdx.x + c * GG_THREADS;
      const int o = e / PER_ROW, i = (e % PER_ROW) * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int k = K_INNER ? i + v : o, x = K_INNER ? o : i + v;
        sm[k * (W + 1) + x] = r[c][v];
      }
    }
  }
};

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
  GgSlab<TA, TRA ? GG_BK : GG_TU, TRA ? GG_TU : GG_BK, !TRA, GG_TU> sa;
  GgSlab<TB, TRB ? GG_TV : GG_BK, TRB ? GG_BK : GG_TV, TRB, GG_TV> sb;
  auto load = [&](int k0) {
    if (TRA) sa.load(a, lda, k0, m0, k, m);
    else sa.load(a, lda, m0, k0, m, k);
    if (TRB) sb.load(b, ldb, n0, k0, n, k);
    else sb.load(b, ldb, k0, n0, k, n);
  };

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[GG_TM][GG_TN];
#pragma unroll
  for (int i = 0; i < GG_TM; ++i)
#pragma unroll
    for (int j = 0; j < GG_TN; ++j) acc[i][j] = 0.f;

  if (k > 0) load(0);
  for (int k0 = 0; k0 < k; k0 += GG_BK) {
    sa.store(As);
    sb.store(Bs);
    __syncthreads();
    if (k0 + GG_BK < k) load(k0 + GG_BK);  // next stage in flight during compute
#pragma unroll 8
    for (int kk = 0; kk < GG_BK; ++kk) {
      float av[GG_TM], bv[GG_TN];
#pragma unroll
      for (int i = 0; i < GG_TM; ++i) av[i] = As[kk * (GG_TU + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < GG_TN; ++j) bv[j] = Bs[kk * (GG_TV + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < GG_TM; ++i)
#pragma unroll
        for (int j = 0; j < GG_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  TC* c = C + (int64_t)d[5] * ldc;
#pragma unroll
  for (int i = 0; i < GG_TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < GG_TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) c[(int64_t)row * ldc + col] = gg_from_f32<TC>(acc[i][j]);
    }
  }
}

// table: n_groups descriptor rows of GG_DESC int32, then n_groups + 1
// exclusive prefix sums of the groups' output tiles.
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(GG_THREADS)
gg_kernel(const TA* __restrict__ A, const TB* __restrict__ B, TC* __restrict__ C,
          const int32_t* __restrict__ table, int n_groups, int64_t lda, int64_t ldb,
          int64_t ldc) {
  __shared__ float As[GG_BK * (GG_TU + 1)];
  __shared__ float Bs[GG_BK * (GG_TV + 1)];
  const int32_t* prefix = table + GG_DESC * n_groups;
  const int tile = blockIdx.x;
  // the last group whose first tile is at or before this one
  int lo = 0, hi = n_groups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (prefix[mid] <= tile) lo = mid;
    else hi = mid - 1;
  }
  const int32_t* d = table + GG_DESC * lo;
  const int t = tile - prefix[lo];
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

// Type codes: 0 = float32, 1 = bfloat16.  `table` is on the device.
// Returns a cudaError_t value.
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

extern "C" const char* gg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
