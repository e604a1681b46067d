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
// One block owns one (bh, 64-row q tile) and loops over 64-key tiles; each
// of its 256 threads keeps m, l and the accumulator for 4 rows x (D/16)
// columns in registers.  Q.K^T and P.V run on the FMA units in f32 from
// shared memory (Q, then K and V in turn in one buffer, and P).
//
// Bound.  At the internlm2-20b prefill (48 query heads, D = 128, S = T =
// 4096, causal, bf16) the work is 4 * 48 * 4096^2 / 2 * 128 = 206 GFLOP:
// 0.21 ms at the tensor cores' 989 TFLOP/s, while the 201 MB moved take
// 0.06 ms at 3.35 TB/s, so the wgmma route is bound by operations.  Left
// out, and what keeps it from that bound: ping-pong scheduling between the
// two warpgroups, overlap of one tile's softmax with the next tile's wgmma
// inside a warpgroup, clusters with TMA multicast of K/V, fp8, and a
// persistent grid.  The fma route is bound by the FMA units (67 TFLOP/s in
// f32) and by its shared-memory loads; its redesign is later work.

#include "hopper.cuh"

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_MASK (-1073741824.0f)  // -2^30, the TPU kernel's mask value

struct FaArgs {
  int64_t sq_bh, sq_s, sk_bh, sk_t, sv_bh, sv_t;  // element strides
  int S, T, D;
  float scale;
  int causal;
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

// Rows [r0, r0 + 64) of a (rows, D) slice into smem as f32, row stride
// DP + 1; rows at or past r_ext and columns at or past D as zero.
template <typename T, int DP>
__device__ __forceinline__ void fa_stage(float* dst, const T* __restrict__ src,
                                         int64_t row_stride, int r0, int r_ext, int D) {
  for (int e = threadIdx.x; e < 64 * DP; e += FA_THREADS) {
    const int r = e / DP, c = e % DP;
    float val = 0.f;
    if (r0 + r < r_ext && c < D) val = fa_to_f32<T>(src[(int64_t)(r0 + r) * row_stride + c]);
    dst[r * (DP + 1) + c] = val;
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

// NJ: accumulator columns per thread; D <= 16 * NJ.
template <typename T, int NJ>
__global__ void __launch_bounds__(FA_THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, const FaArgs a) {
  constexpr int DP = 16 * NJ, LD = DP + 1, LP = FA_BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // [FA_BQ][LD]
  float* KVs = Qs + FA_BQ * LD;   // [FA_BK][LD], K then V
  float* Ps = KVs + FA_BK * LD;   // [FA_BQ][LP]

  const int bh = blockIdx.y;
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * FA_BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + bh * a.sk_bh;
  const T* vb = v + bh * a.sv_bh;

  fa_stage<T, DP>(Qs, q + bh * a.sq_bh, a.sq_s, q0, a.S, a.D);

  float m_i[4], l_i[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = FA_MASK;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int t_end = a.causal ? min(a.T, q0 + FA_BQ) : a.T;
  for (int t0 = 0; t0 < t_end; t0 += FA_BK) {
    __syncthreads();  // Q staged; the previous tile's P.V is done with KVs and Ps
    fa_stage<T, DP>(KVs, kb, a.sk_t, t0, a.T, a.D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = FA_MASK;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = t0 + tx + 16 * j;
        const bool ok = kj < a.T && (!a.causal || qi >= kj);
        s[i][j] = ok ? s[i][j] * a.scale : FA_MASK;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], fa_row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        // P.V takes p rounded to v's type, as the TPU kernel does
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = fa_to_f32<T>(fa_from_f32<T>(p));
      }
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + fa_row_sum(rs);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
      m_i[i] = m_new;
    }
    __syncthreads();  // every thread is done with K; P is complete
    fa_stage<T, DP>(KVs, vb, a.sv_t, t0, a.T, a.D);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = KVs[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = o + ((int64_t)bh * a.S + row) * a.D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < a.D) orow[col] = fa_from_f32<T>(acc[i][jj] / l);
    }
  }
}

template <typename T, int NJ>
static int fa_launch_t(const void* q, const void* k, const void* v, void* o, const FaArgs& a,
                       int bh, cudaStream_t stream) {
  constexpr int DP = 16 * NJ;
  const size_t smem = sizeof(float) * ((size_t)(FA_BQ + FA_BK) * (DP + 1) + FA_BQ * (FA_BK + 1));
  const cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + FA_BQ - 1) / FA_BQ, bh);
  fa_kernel<T, NJ><<<grid, FA_THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                      (T*)o, a);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_launch_d(const void* q, const void* k, const void* v, void* o, const FaArgs& a,
                       int bh, cudaStream_t stream) {
  if (a.D <= 16) return fa_launch_t<T, 1>(q, k, v, o, a, bh, stream);
  if (a.D <= 32) return fa_launch_t<T, 2>(q, k, v, o, a, bh, stream);
  if (a.D <= 64) return fa_launch_t<T, 4>(q, k, v, o, a, bh, stream);
  if (a.D <= 128) return fa_launch_t<T, 8>(q, k, v, o, a, bh, stream);
  return fa_launch_t<T, 16>(q, k, v, o, a, bh, stream);
}

// ---------------------------------------------------------------- wgmma route
#define FW_BQ 128                  // query rows per block: two warpgroups of 64
#define FW_THREADS 384             // two consumer warpgroups + one producer warpgroup
#define FW_PRODUCER_REGS 40        // registers per thread after setmaxnreg; the producer
#define FW_CONSUMER_REGS 232       // only issues copies (128 x 40 + 256 x 232 <= 65,536)
#define FW_STAGES 2                // K/V ring depth
#define FW_LOG2E 1.4426950408889634f
#define FW_MASK2 (FA_MASK * FW_LOG2E)  // the mask value in the base-2 softmax

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

extern "C" const char* fa_error_string(int code) { return hp_error_string(code); }
