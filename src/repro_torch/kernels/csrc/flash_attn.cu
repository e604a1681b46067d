// flash_attention: forward attention with an online softmax (sm_90a).
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/flash_attn.py,
// body _kernel): for q (BH, S, D) and k, v (BH, T, D) it computes
//   o[b, i] = sum_j softmax_j(s[b, i, j]) v[b, j],  s = (q[b, i] . k[b, j]) D^-0.5
// with s replaced by -2^30 (not -inf) where key j is masked: j >= T, or,
// under causal, i < j (top-left aligned: no offset when T != S).  The running
// row max m starts at -2^30; p = exp(s - m) is rounded to v's type before
// P.V; the row sum l comes from the unrounded f32 p and is clamped to
// >= 1e-30 before the final divide; the output has q's type.  These are the
// TPU kernel's numbers.  Both routes below keep them; neither pads or copies
// an operand, and both read q, k and v through their (bh, row) strides with
// unit stride along D, so a K/V broadcast over BH (stride 0) is read in
// place.  D is at most 256.  Causal blocks are issued longest first, and no
// block walks past the last key tile any of its rows can see: a tile wholly
// above the diagonal would add exp(-2^30 - m) = 0 to every row once key 0
// has set m (tile 0 is never skipped), with correction exp(0) = 1, so
// skipping it gives the same result; the TPU kernel computes those tiles.
//
// Route "wgmma" (fw_kernel: bf16 whose base pointers and strides TMA can
// describe).  One block owns one (bh, 128-row Q tile): two consumer
// warpgroups of 64 rows each and one producer warpgroup (384 threads),
// which hands most of its registers to the consumers (setmaxnreg).  The
// producer's first thread loads the Q tile once, then K and V tiles of BK keys
// into a ring of FW_STAGES shared-memory stages, each guarded by a "full"
// and an "empty" mbarrier, all by TMA with the 128-byte swizzle.  A tensor
// map is 3-D, (D, rows, heads) with the operand's own strides, so rows past
// S or T and columns past D arrive as TMA's zero fill and a stride-0 K/V
// is one head read by every block.  D is padded to DP = 64, 128 or 256, a
// tile being DP/64 boxes of 64 columns (one 128-byte swizzle span); boxes
// wholly past D are zeroed once and never loaded.  Each consumer warpgroup computes
// S = Q.K^T with wgmma m64nBKk16 (bf16 in, f32 accumulate; both operands
// K-major in shared memory), applies scale and masks to the accumulator
// in registers (masks only on tiles that cross the diagonal or the end at
// T), takes row max and row sum with quad shuffles, rescales the O
// accumulator, and runs O += P.V with wgmma m64nDPk16: P is the S
// accumulator converted to bf16 pairs, which is the register A fragment
// as it stands, and V is the B operand read N-major (transposed) from
// shared memory.  A stage is signalled empty only after the P.V wgmma that
// reads it has been waited on.  The softmax runs in base 2: log2(e) is
// folded into the scale and into the mask value, so p = exp2(x - m) equals
// the TPU's exp(s - m) up to rounding (held to the bf16 tolerance).
// DP = 64 and 128 take BK = 128; DP = 256 takes BK = 64 to fit two stages
// (Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB of the 227 KB a block has).
//
// Route "fma" (fa_kernel: float32, and bf16 layouts TMA cannot describe).
// One block of 256 threads owns one (bh, BQ-row Q tile), BQ = 128 at D <=
// 128 and 64 above, and loops over 64-key tiles.  Thread (ty, tx) holds RM
// = BQ / 16 rows x 4 keys of S (keys tx + 16 j) and RM rows x D/16 columns
// of O (columns 4 tx + 64 c + e), with m and l of its rows, in registers.
// Shared memory is f32 throughout: Q transposed [d][row], K [key][d], V
// [key][d] and P transposed [key][row], so that every inner step reads
// float4s: Q.K^T reads RM/4 float4s of Q (broadcast over the 16 threads of
// a row group) and one float4 of K per d step for 4 RM FMAs, P.V one float4
// of V per 4 columns and RM/4 of P per key for 4 RM FMAs each.  K and P
// rows are an odd number of 16-byte chunks long, so the 16 threads of a row
// group read K and write P on 16 distinct banks.  K and V have their own
// buffers: V(t) lands by cp.async during Q.K^T(t) and K(t+1) during P.V(t),
// three barriers per tile.  Float32 operands are copied as they are, 16
// bytes at a time where pointer, strides and D allow it, 4 where not; bf16
// is converted on its way into shared memory, through registers.  The
// softmax runs in base 2 as on the wgmma route.  At D = 128: Q 64 KB, K 33
// KB, V 32 KB, P 33 KB, 165,888 bytes, one block per SM; 207 registers a
// thread in f32, no spill.  The internlm2-20b causal prefill in f32 takes
// 5.86-5.88 ms, 52% of its bound below, against 9.54-9.58 ms for the
// first version of this route (H100 80GB HBM3, 700 W; PERF.md).
//
// Bound.  At the internlm2-20b prefill (48 query heads, D = 128, S = T =
// 4096, causal) the work is 4 * 48 * 4096^2 / 2 * 128 = 206 GFLOP: 0.21 ms
// at the tensor cores' 989 TFLOP/s (bf16) and 3.08 ms at the 67 TFLOP/s
// FMA rate (f32), while the 201 MB (bf16) or 403 MB (f32) moved take 0.06
// or 0.12 ms at 3.35 TB/s, so both routes are bound by operations.  Left
// out of the wgmma route, and what keeps it from that bound: ping-pong
// scheduling between the two warpgroups, overlap of one tile's softmax
// with the next tile's wgmma inside a warpgroup, clusters with TMA
// multicast of K/V, fp8, and a persistent grid.  What holds the fma route
// back: one block of 8 warps per SM (the 166 KB of tiles), so the FMA
// pipes idle at each of a tile's three barriers and through the softmax;
// Q.K^T's 8 x 4 register tile reads 12 floats per 32 FMAs, under the 4
// FMAs a float of P.V; a causal grid's last wave is ragged.  Its next step
// is split-precision products on the tensor cores (3xTF32 or bf16 x 3),
// beyond what the FMA units can give.

#include "hopper.cuh"

#define FA_BK 64          // keys per tile
#define FA_THREADS 256    // 16 row groups x 16 key (or column) groups
#define FA_MASK (-1073741824.0f)  // -2^30, the TPU kernel's mask value
#define FA_LOG2E 1.4426950408889634f
#define FA_MASK2 (FA_MASK * FA_LOG2E)  // the mask value in the base-2 softmax

struct FaArgs {
  int64_t sq_bh, sq_s, sk_bh, sk_t, sv_bh, sv_t;  // element strides
  int S, T, D;
  float scale;
  int causal;
};

// The fma route's tiling at padded head dim DP (64, 128 or 256): BQ query
// rows per block, each thread RM rows x 4 keys of S and RM rows x NC
// columns of O.  Shared memory, all f32: Q transposed [DP][BQ], K [BK][LDK],
// V [BK][DP] and P transposed [BK][LDP].  LDK and LDP are an odd number of
// 16-byte chunks, so the 16 threads of a row group read K, and write P, on
// distinct banks.  Mirrored by fma_tiles in flash_attn.py.
template <int DP> struct FaTile {
  static constexpr int BQ = DP <= 128 ? 128 : 64;
  static constexpr int RM = BQ / 16;
  static constexpr int NC = DP / 16;
  static constexpr int LDK = DP + 4;
  static constexpr int LDP = BQ + 4;
  static constexpr int Q_FLOATS = DP * BQ;
  static constexpr int K_FLOATS = FA_BK * LDK;
  static constexpr int V_FLOATS = FA_BK * DP;
  static constexpr int P_FLOATS = FA_BK * LDP;
  static constexpr int SMEM = 4 * (Q_FLOATS + K_FLOATS + V_FLOATS + P_FLOATS);
  static_assert(SMEM <= 232448, "a block has 227 KB of shared memory");
};

template <typename T> __device__ __forceinline__ float fa_to_f32(T x);
template <> __device__ __forceinline__ float fa_to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float fa_to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T fa_from_f32(float x);
template <> __device__ __forceinline__ float fa_from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 fa_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [r0, r0 + ROWS) of a (rows, D) slice src (row stride ld, unit stride
// along D) into shared memory as f32, row r and column c at dst[r * LD + c],
// or at dst[c * LD + r] under TRANS; rows at or past r_ext and columns at or
// past D (up to DP) as zero.  vec: src, ld and D allow 16-byte reads.
// Float32 without TRANS goes by cp.async, which the caller commits;
// everything else through registers, converted on the way in (TRANS walks
// rows fastest, so that a warp's scattered stores hit distinct banks).
template <typename T, int ROWS, int DP, int LD, bool TRANS>
__device__ __forceinline__ void fa_stage(float* dst, const T* __restrict__ src, int64_t ld,
                                         int r0, int r_ext, int D, bool vec) {
  constexpr bool ASYNC = !TRANS && sizeof(T) == 4;
  if (vec) {
    constexpr int VEC = 16 / sizeof(T), PER_ROW = DP / VEC;
    for (int e = threadIdx.x; e < ROWS * PER_ROW; e += FA_THREADS) {
      const int r = TRANS ? e % ROWS : e / PER_ROW;
      const int c = (TRANS ? e / ROWS : e % PER_ROW) * VEC;
      const bool ok = r0 + r < r_ext && c < D;
      const T* p = ok ? src + (int64_t)(r0 + r) * ld + c : src;
      if constexpr (ASYNC) {
        hp_cp_async<16>(dst + r * LD + c, p, ok);
      } else {
        float x[VEC];
        hp_unpack16<T>(ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0), x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[TRANS ? (c + i) * LD + r : r * LD + c + i] = x[i];
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += FA_THREADS) {
      const int r = TRANS ? e % ROWS : e / DP, c = TRANS ? e / ROWS : e % DP;
      const bool ok = r0 + r < r_ext && c < D;
      const T* p = ok ? src + (int64_t)(r0 + r) * ld + c : src;
      if constexpr (ASYNC) {
        hp_cp_async<4>(dst + r * LD + c, p, ok);
      } else {
        dst[TRANS ? c * LD + r : r * LD + c] = ok ? fa_to_f32<T>(*p) : 0.f;
      }
    }
  }
}

__device__ __forceinline__ float fa_part(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// N f32 values from 16-byte aligned shared memory.
template <int N> __device__ __forceinline__ void fa_read(const float* p, float (&x)[N]) {
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    const float4 f = reinterpret_cast<const float4*>(p)[h];
    x[4 * h] = f.x;
    x[4 * h + 1] = f.y;
    x[4 * h + 2] = f.z;
    x[4 * h + 3] = f.w;
  }
}

// Reduce over the 16 lanes that hold one row (lanes 0-15 or 16-31).
__device__ __forceinline__ float fa_row_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float fa_row_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DP: padded head dim.  vec: bits 0, 1, 2 set when q, k, v allow 16-byte
// reads.  Thread (ty, tx) = (threadIdx / 16, threadIdx % 16) owns query
// rows RM ty .. RM ty + RM - 1 of the block, keys tx + 16 j (j < 4) of each
// tile, and output columns 4 tx + 64 c + e (e < 4).
template <typename T, int DP>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, const FaArgs a, int vec) {
  using L = FaTile<DP>;
  constexpr int BQ = L::BQ, RM = L::RM, NC = L::NC;
  extern __shared__ float4 fa_raw[];
  float* Qs = reinterpret_cast<float*>(fa_raw);
  float* Ks = Qs + L::Q_FLOATS;
  float* Vs = Ks + L::K_FLOATS;
  float* Ps = Vs + L::V_FLOATS;

  const int bh = blockIdx.y;
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + bh * a.sk_bh;
  const T* vb = v + bh * a.sv_bh;
  const int t_end = a.causal ? min(a.T, q0 + BQ) : a.T;
  const float scale2 = a.scale * FA_LOG2E;

  fa_stage<T, BQ, DP, BQ, true>(Qs, q + bh * a.sq_bh, a.sq_s, q0, a.S, a.D, vec & 1);
  fa_stage<T, FA_BK, DP, L::LDK, false>(Ks, kb, a.sk_t, 0, a.T, a.D, vec & 2);
  hp_cp_commit();

  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = FA_MASK2;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = 0; t0 < t_end; t0 += FA_BK) {
    hp_cp_wait<0>();
    __syncthreads();  // Q and K(t) have landed; P.V(t-1) is done with Vs and Ps
    fa_stage<T, FA_BK, DP, DP, false>(Vs, vb, a.sv_t, t0, a.T, a.D, vec & 4);
    hp_cp_commit();  // V(t) lands during Q.K^T(t)

    float s[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < DP; d0 += 4) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::LDK + d0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float qf[RM];
        fa_read<RM>(Qs + (d0 + e) * BQ + RM * ty, qf);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qf[i], fa_part(kf[j], e), s[i][j]);
      }
    }

    // online softmax in base 2: log2(e) is folded into the scale and the
    // mask value, so exp2(x - m) is the TPU's exp(s - m)
    const bool masked = t0 + FA_BK > a.T || (a.causal && t0 + FA_BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + RM * ty + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale2;
        if (masked) {
          const int kj = t0 + tx + 16 * j;
          if (kj >= a.T || (a.causal && kj > qi)) x = FA_MASK2;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fa_row_max(mx);
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx);
        rs += p;
        s[i][j] = fa_to_f32<T>(fa_from_f32<T>(p));  // P.V takes p rounded to v's type
      }
      l[i] = l[i] * corr + fa_row_sum(rs);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < RM / 4; ++h)
        *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * L::LDP + RM * ty + 4 * h) =
            make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j], s[4 * h + 3][j]);
    __syncthreads();  // every thread is done with K(t); P is complete
    if (t0 + FA_BK < t_end)  // K(t+1) lands during P.V(t)
      fa_stage<T, FA_BK, DP, L::LDK, false>(Ks, kb, a.sk_t, t0 + FA_BK, a.T, a.D, vec & 2);
    hp_cp_commit();
    hp_cp_wait<1>();
    __syncthreads();  // V(t) has landed

#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      float pf[RM];
      fa_read<RM>(Ps + kk * L::LDP + RM * ty, pf);
#pragma unroll
      for (int c = 0; c < NC / 4; ++c) {
        const float4 vf = *reinterpret_cast<const float4*>(Vs + kk * DP + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][4 * c] = fmaf(pf[i], vf.x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(pf[i], vf.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pf[i], vf.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pf[i], vf.w, acc[i][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + RM * ty + i;
    if (row >= a.S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t)bh * a.S + row) * a.D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * (c / 4) + c % 4;
      if (col < a.D) orow[col] = fa_from_f32<T>(acc[i][c] / li);
    }
  }
}

// Whether an operand at p with element strides (s_bh, s_row) and head dim
// D can be read in 16-byte chunks.
template <typename T> static bool fa_vec(const void* p, int64_t s_bh, int64_t s_row, int D) {
  constexpr int VEC = 16 / sizeof(T);
  return (uintptr_t)p % 16 == 0 && D % VEC == 0 && s_bh % VEC == 0 && s_row % VEC == 0;
}

template <typename T, int DP>
static int fa_launch_t(const void* q, const void* k, const void* v, void* o, const FaArgs& a,
                       int bh, cudaStream_t stream) {
  using L = FaTile<DP>;
  const int vec = fa_vec<T>(q, a.sq_bh, a.sq_s, a.D) | fa_vec<T>(k, a.sk_bh, a.sk_t, a.D) << 1 |
                  fa_vec<T>(v, a.sv_bh, a.sv_t, a.D) << 2;
  const cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + L::BQ - 1) / L::BQ, bh);
  fa_kernel<T, DP><<<grid, FA_THREADS, L::SMEM, stream>>>((const T*)q, (const T*)k,
                                                          (const T*)v, (T*)o, a, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_launch_d(const void* q, const void* k, const void* v, void* o, const FaArgs& a,
                       int bh, cudaStream_t stream) {
  if (a.D <= 64) return fa_launch_t<T, 64>(q, k, v, o, a, bh, stream);
  if (a.D <= 128) return fa_launch_t<T, 128>(q, k, v, o, a, bh, stream);
  return fa_launch_t<T, 256>(q, k, v, o, a, bh, stream);
}

// ---------------------------------------------------------------- wgmma route
#define FW_BQ 128                  // query rows per block: two warpgroups of 64
#define FW_THREADS 384             // two consumer warpgroups + one producer warpgroup
#define FW_PRODUCER_REGS 40        // registers per thread after setmaxnreg; the producer
#define FW_CONSUMER_REGS 232       // only issues copies (128 x 40 + 256 x 232 <= 65,536)
#define FW_STAGES 2                // K/V ring depth
#define FW_LOG2E FA_LOG2E
#define FW_MASK2 FA_MASK2

// Shared memory of one block at padded head dim DP, 1024-byte aligned (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): Q as DP/64 boxes of
// [FW_BQ rows][64], then per stage K and V as DP/64 boxes of [BK][64], then
// the mbarriers.  Mirrored by wgmma_tiles in flash_attn.py.
template <int DP> struct FwTile {
  static constexpr int BK = DP == 256 ? 64 : 128;
  static constexpr int Q_BYTES = FW_BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // K or V of one stage
  static constexpr int BAR_OFF = Q_BYTES + FW_STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * FW_STAGES);  // + alignment slack
};

__device__ __forceinline__ uint32_t fw_pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += A B for one warpgroup, m64 x N x k16, bf16 in, f32 accumulate, with
// A from registers (the m16k16 fragment of each warp) and B from shared
// memory N-major.  d is the accumulator fragment of hp_wgmma_ss
// (hopper.cuh).
template <int N> __device__ __forceinline__ void fa_wgmma_rs(float (&d)[N / 2],
                                                            const uint32_t (&a)[4], uint64_t db);

template <> __device__ __forceinline__ void fa_wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void fa_wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void fa_wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// DP: padded head dim (64, 128 or 256).  q, k, v reach the kernel as tensor
// maps; o is contiguous (BH, S, D).
template <int DP>
__global__ void __launch_bounds__(FW_THREADS, 1)
fw_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
          const FaArgs a) {
  using L = FwTile<DP>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t fw_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fw_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = sm;               // [DP/64][FW_BQ][64]
  uint8_t* kvs = sm + L::Q_BYTES;  // stage s: K at 2s, V at 2s + 1, each [DP/64][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + FW_STAGES;

  const int bh = blockIdx.y;
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * FW_BQ;
  const int t_end = a.causal ? min(a.T, q0 + FW_BQ) : a.T;
  const int n_tiles = (t_end + BK - 1) / BK;
  const int boxes = (a.D + 63) / 64;  // 64-column boxes that hold data
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hp_bar_init(q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      hp_bar_init(&full[s], 1);
      hp_bar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (boxes < DP / 64) {
    // boxes wholly past D are never loaded: zero them once, so that both
    // products run over all of DP
    for (int i = threadIdx.x; i < (DP / 64 - boxes) * FW_BQ * 8; i += FW_THREADS)
      reinterpret_cast<uint4*>(qs + boxes * FW_BQ * 128)[i] = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < 2 * FW_STAGES * (DP / 64 - boxes) * BK * 8; i += FW_THREADS) {
      const int buf = i / ((DP / 64 - boxes) * BK * 8), r = i % ((DP / 64 - boxes) * BK * 8);
      reinterpret_cast<uint4*>(kvs + buf * L::KV_BYTES + boxes * BK * 128)[r] =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: lane 0 of warp 8 issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(FW_PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      // a stride-0 operand is one head that every block reads
      const int qh = a.sq_bh ? bh : 0, kh = a.sk_bh ? bh : 0, vh = a.sv_bh ? bh : 0;
      hp_bar_expect(q_full, boxes * FW_BQ * 128);
      for (int c = 0; c < boxes; ++c)
        hp_tma_load(qs + c * FW_BQ * 128, &qmap, q_full, 64 * c, q0, qh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % FW_STAGES;
        if (it >= FW_STAGES) hp_bar_wait(&empty[s], (it / FW_STAGES - 1) & 1);
        uint8_t* ks = kvs + 2 * s * L::KV_BYTES;
        hp_bar_expect(&full[s], 2 * boxes * BK * 128);
        for (int c = 0; c < boxes; ++c) {
          hp_tma_load(ks + c * BK * 128, &kmap, &full[s], 64 * c, it * BK, kh);
          hp_tma_load(ks + L::KV_BYTES + c * BK * 128, &vmap, &full[s], 64 * c, it * BK, vh);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64); this thread
    // holds rows row0 and row0 + 8 (see hp_wgmma_ss in hopper.cuh)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(FW_CONSUMER_REGS));
    const int wg = warp / 4;
    const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
    const float scale2 = a.scale * FW_LOG2E;
    float m[2] = {FW_MASK2, FW_MASK2}, l[2] = {0.f, 0.f};
    float sacc[BK / 2], oacc[DP / 2];
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    const uint8_t* qw = qs + wg * 64 * 128;

    hp_bar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % FW_STAGES, t0 = it * BK;
      const uint8_t* ks = kvs + 2 * s * L::KV_BYTES;
      const uint8_t* vs = ks + L::KV_BYTES;
      hp_bar_wait(&full[s], (it / FW_STAGES) & 1);

      // S = Q K^T: depth step kk is 16 columns of box kk / 4, 32 bytes in.
      // Each hp_keep before a fence pins the registers' last writes ahead
      // of it: a write inside a wgmma batch would serialise the batch.
      hp_keep(sacc);
      hp_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hp_wgmma_ss<0, 0>(sacc, hp_desc(qw + (kk / 4) * FW_BQ * 128 + (kk % 4) * 32, 16, 1024),
                          hp_desc(ks + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk);
      hp_wgmma_commit();
      hp_wgmma_wait<0>();
      hp_keep(sacc);

      // online softmax on the accumulator, base 2
      const bool masked = t0 + BK > a.T || (a.causal && t0 + BK - 1 > q0 + 64 * wg);
      float x[BK / 2], mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[4 * i + e] = sacc[4 * i + e] * scale2;
          if (masked) {
            const int j = t0 + 8 * i + 2 * (lane % 4) + (e & 1);
            if (j >= a.T || (a.causal && j > row0 + 8 * (e >> 1))) x[4 * i + e] = FW_MASK2;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], x[4 * i + e]);
        }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
      }
      // p in f32 feeds the row sum; rounded to bf16 pairs, keys 16 kk ..
      // 16 kk + 15 of the accumulator are the A fragment of depth step kk
      // as they stand
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p0 = exp2f(x[8 * kk + 2 * r] - m[r & 1]);
          const float p1 = exp2f(x[8 * kk + 2 * r + 1] - m[r & 1]);
          rs[r & 1] += p0 + p1;
          pf[kk][r] = fw_pack(p0, p1);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l[h] = l[h] * corr[h] + rs[h];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];

      // O += P V: depth step kk is keys 16 kk .., 16 rows of 128 bytes in;
      // V is N-major, boxes of 64 columns BK * 128 bytes apart
      hp_keep(oacc);
      hp_keep(pf);
      hp_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        fa_wgmma_rs<DP>(oacc, pf[kk], hp_desc(vs + kk * 16 * 128, BK * 128, 1024));
      hp_wgmma_commit();
      hp_wgmma_wait<0>();
      hp_keep(oacc);
      hp_keep(pf);
      if (lane == 0) hp_bar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= a.S) continue;
      const float lh = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow = o + ((int64_t)bh * a.S + row) * a.D;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        const float x0 = oacc[4 * i + 2 * h] / lh, x1 = oacc[4 * i + 2 * h + 1] / lh;
        if (col + 1 < a.D && a.D % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < a.D) orow[col] = __float2bfloat16(x0);
          if (col + 1 < a.D) orow[col + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

// A (D, rows, heads) bf16 tensor at ptr with element strides s_row and
// s_head, read in boxes of 64 columns x box_rows rows x 1 head with the
// 128-byte swizzle; out-of-range elements read as zero.  A stride-0 (or
// single) head is a map of one head.
static int fw_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads, int64_t s_row,
                  int64_t s_head, int box_rows) {
  if (rows == 1) s_row = (D + 7) / 8 * 8;  // a unit dimension's stride is never stepped
  if (heads == 1 || s_head == 0) {
    heads = 1;
    s_head = s_row * rows;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return hp_map(map, ptr, 3, dims, strides, box);
}

template <int DP>
static int fw_launch_t(const void* q, const void* k, const void* v, void* o, const FaArgs& a,
                       int bh, cudaStream_t stream) {
  using L = FwTile<DP>;
  CUtensorMap qm, km, vm;
  int rc = fw_map(&qm, q, a.D, a.S, bh, a.sq_s, a.sq_bh, FW_BQ);
  if (!rc) rc = fw_map(&km, k, a.D, a.T, bh, a.sk_t, a.sk_bh, L::BK);
  if (!rc) rc = fw_map(&vm, v, a.D, a.T, bh, a.sv_t, a.sv_bh, L::BK);
  if (rc) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      fw_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + FW_BQ - 1) / FW_BQ, bh);
  fw_kernel<DP><<<grid, FW_THREADS, L::SMEM, stream>>>(qm, km, vm, (__nv_bfloat16*)o, a);
  return (int)cudaGetLastError();
}

static bool fa_args_ok(const FaArgs* a, int bh) {
  return bh >= 1 && bh <= 65535 && a->S >= 1 && a->T >= 1 && a->D >= 1 && a->D <= 256;
}

// Route "fma".  Type code: 0 = float32, 1 = bfloat16 (q, k, v and o share
// it).  Output is contiguous (bh, S, D).  Returns a cudaError_t value.
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         const FaArgs* a, int bh, int dtype, void* stream) {
  if (dtype < 0 || dtype > 1 || !fa_args_ok(a, bh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return fa_launch_d<float>(q, k, v, o, *a, bh, st);
  return fa_launch_d<__nv_bfloat16>(q, k, v, o, *a, bh, st);
}

// Route "wgmma": bf16 only; every base pointer 16-byte aligned, and every
// row and head stride a multiple of 8 elements (or 0 for a head, or any
// value on a dimension of extent 1).  Output is contiguous (bh, S, D).
// Returns a cudaError_t value or an HP_ERR_ code (hopper.cuh).
extern "C" int fa_launch_wgmma(const void* q, const void* k, const void* v, void* o,
                               const FaArgs* a, int bh, void* stream) {
  if (!fa_args_ok(a, bh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->D <= 64) return fw_launch_t<64>(q, k, v, o, *a, bh, st);
  if (a->D <= 128) return fw_launch_t<128>(q, k, v, o, *a, bh, st);
  return fw_launch_t<256>(q, k, v, o, *a, bh, st);
}

// The wgmma kernel for head dim D: out = {registers per thread, local
// (spilled) bytes per thread, dynamic shared bytes per block}.
extern "C" int fa_wgmma_info(int D, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  int smem;
  if (D <= 64) {
    err = cudaFuncGetAttributes(&attr, fw_kernel<64>);
    smem = FwTile<64>::SMEM;
  } else if (D <= 128) {
    err = cudaFuncGetAttributes(&attr, fw_kernel<128>);
    smem = FwTile<128>::SMEM;
  } else {
    err = cudaFuncGetAttributes(&attr, fw_kernel<256>);
    smem = FwTile<256>::SMEM;
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  return 0;
}

template <typename T, int DP> static int fa_info_t(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fa_kernel<T, DP>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = FaTile<DP>::SMEM;
  return 0;
}

// The fma kernel for head dim D and type code dtype (as fa_launch): out =
// {registers per thread, local (spilled) bytes per thread, dynamic shared
// bytes per block}.
extern "C" int fa_fma_info(int D, int dtype, int* out) {
  if (dtype == 0) {
    if (D <= 64) return fa_info_t<float, 64>(out);
    if (D <= 128) return fa_info_t<float, 128>(out);
    return fa_info_t<float, 256>(out);
  }
  if (D <= 64) return fa_info_t<__nv_bfloat16, 64>(out);
  if (D <= 128) return fa_info_t<__nv_bfloat16, 128>(out);
  return fa_info_t<__nv_bfloat16, 256>(out);
}

extern "C" const char* fa_error_string(int code) { return hp_error_string(code); }
