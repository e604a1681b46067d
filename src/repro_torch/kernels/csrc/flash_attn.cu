// flash_attention: forward attention with an online softmax (sm_90a).
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/flash_attn.py,
// body _kernel): for q (BH, S, D) and k, v (BH, T, D) it computes
//   o[b, i] = sum_j softmax_j(s[b, i, j]) v[b, j],  s = (q[b, i] . k[b, j]) D^-0.5
// with s replaced by -2^30 (not -inf) where key j is masked: j >= T, or,
// under causal, i < j (top-left aligned: no offset when T != S).  The running
// row max m starts at -2^30; p = exp(s - m) is rounded to v's type before
// P.V; the row sum l is clamped to >= 1e-30 before the final divide; the
// output has q's type.  These are the TPU kernel's numbers exactly.
//
// Blocks.  The TPU grid (BH, q tiles, kv tiles) carries m, l and the f32
// accumulator in VMEM scratch across its sequential kv axis.  Here one block
// owns one (bh, 64-row q tile) and loops over 64-key tiles itself; each of
// its 256 threads keeps m, l and the accumulator for 4 rows x (D/16) columns
// in registers.  Q.K^T and P.V run on the FMA units in f32 from shared
// memory (Q, then K and V in turn in one buffer, and P).  Under causal the
// block stops at the last key tile that any of its rows can see: a tile
// wholly above the diagonal would add exp(-2^30 - m) = 0 to every row once
// key 0 has set m (tile 0 is never skipped), with correction exp(0) = 1, so
// skipping it gives the same result; the TPU kernel computes those tiles
// anyway.  Causal blocks are issued longest first.  Ragged S and T are
// masked in the kernel: nothing is padded or copied.
//
// Strides.  q, k and v are read through their (bh, row) strides with unit
// stride along D, so a K/V broadcast over BH (stride 0) is read in place.
// D is at most 256.
//
// Bound.  At the internlm2-20b prefill (48 query heads, D = 128, S = T =
// 4096, causal, bf16) the work is 4 * 48 * 4096^2 / 2 * 128 = 206 GFLOP:
// 0.21 ms at the tensor cores' 989 TFLOP/s, while the 201 MB moved take
// 0.06 ms at 3.35 TB/s.  This kernel runs on the FMA units (67 TFLOP/s in
// f32) and reads shared memory more often than it multiplies, so it cannot
// approach that bound; mma/wgmma tiles with TMA-fed K/V are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Type code: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Output
// is contiguous (bh, S, D).  Returns a cudaError_t value.
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         const FaArgs* a, int bh, int dtype, void* stream) {
  if (dtype < 0 || dtype > 1 || bh < 1 || bh > 65535 || a->S < 1 || a->T < 1 || a->D < 1 ||
      a->D > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return fa_launch_d<float>(q, k, v, o, *a, bh, st);
  return fa_launch_d<__nv_bfloat16>(q, k, v, o, *a, bh, st);
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
