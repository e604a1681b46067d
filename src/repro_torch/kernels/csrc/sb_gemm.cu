// native_gemm: one-launch tensor contraction over strided operands (sm_90a).
//
// Replaces the TPU kernel native_gemm_pallas (src/repro/kernels/sb_gemm.py,
// body _kernel), which every StridedBatchedGEMM entry point of the JAX
// package rides on: C[c_modes] = sum over the contracted modes of
// A[a_modes] * B[b_modes], for any mode order, with an f32 accumulator and
// the result cast to the output type on store.
//
// Addressing.  The wrapper (repro_torch/kernels/sb_gemm.py) describes the
// problem as up to NG_MAX_MODES "slots", each with an extent and one
// element stride per tensor (0 where the tensor lacks the mode, or where a
// view broadcasts it):
//   slot 0      u: the output tile's row mode (extent 1 if C has one mode)
//   slot 1      v: the output tile's column mode, C's minor-most mode
//   slots 2..   the other C modes ("rest"), decoded from the tile index;
//               one block walks `walk` consecutive indices of slot 2
//   then        the contracted modes, walked as one flattened K in-kernel
//               (last contracted slot fastest)
// Strides come straight from tensor.stride(), so transposed, sliced and
// stride-0 views are read in place: no operand is permuted or copied.
//
// Tiling.  One block of 256 threads owns a BM x BN tile of (u, v) (128 x 16
// when v is at most 16 wide, as at the HOOI ranks, else 64 x 64) and loops
// over K in stages.  Each stage stages one "brick" per operand in shared
// memory, over only the tile dimensions the operand carries, converted to
// f32; loads put neighbouring threads on the operand's smallest-stride
// brick dimension, so the big operand's reads coalesce whichever of its
// modes is stride-1.  Two kernels share this design:
//   ng_outer_kernel  the common GEMM shape (A varies along u, B along v,
//                    both along one contracted mode): 2D bricks of
//                    compile-time size, and the next stage loaded into
//                    registers during compute;
//   ng_kernel        every other layout (an operand that varies along both
//                    u and v, or several contracted modes): 3D bricks sized
//                    at launch, the flattened K decoded per element.
// Products accumulate in f32 registers with plain FMA (no TF32).  Ragged
// edges are masked on load and store.  The TPU kernel's sequential grid
// axes and VMEM accumulator become the in-block K loop: no state crosses
// blocks.
//
// Bound.  At the HOOI shapes the kernel is memory-bound: "mnp,pk->mnk" at
// n=512, r=10 reads ~537 MB and does 2.7 GFLOP, ~0.16 ms at 3.35 TB/s,
// while f32 outside the tensor cores peaks at 67 TFLOP/s.  The loads are
// plain (no TMA) and a narrow output gives few blocks; TMA, wgmma for
// bf16, a deeper pipeline and split-K for small outputs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NG_MAX_MODES 8
#define NG_THREADS 256
#define NG_SMEM_BYTES 49152
#define NG_MAX_BK 32

struct NgDesc {
  int64_t ext[NG_MAX_MODES];
  int64_t sa[NG_MAX_MODES];
  int64_t sb[NG_MAX_MODES];
  int64_t sc[NG_MAX_MODES];
  int32_t n_rest;  // C modes besides u and v (slots 2 .. 2+n_rest-1)
  int32_t n_k;     // contracted modes (the slots after the rest)
  int32_t walk;    // slot-2 indices one block walks (>= 1)
};

// Per-operand brick geometry, worked out once per launch on the host.
struct NgBrick {
  int32_t du, dv;         // brick extent along u and v (tile size or 1)
  int32_t su, sv, sk;     // shared-memory strides of the brick
  int32_t order[3];       // brick dims outer -> inner for loads: 0=k 1=u 2=v
};

template <typename T> __device__ __forceinline__ float ng_to_f32(T x);
template <> __device__ __forceinline__ float ng_to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float ng_to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T ng_from_f32(float x);
template <> __device__ __forceinline__ float ng_from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 ng_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Offset of flattened contracted index kf under one tensor's strides.
__device__ __forceinline__ int64_t ng_k_offset(const NgDesc& d, const int64_t* s,
                                               int64_t kf) {
  const int k0 = 2 + d.n_rest;
  if (d.n_k == 1) return kf * s[k0];
  int64_t off = 0;
  for (int i = d.n_k - 1; i >= 0; --i) {
    const int64_t e = d.ext[k0 + i];
    off += (kf % e) * s[k0 + i];
    kf /= e;
  }
  return off;
}

// Where tile `tile` starts: its u and v origins, the offsets of its other C
// modes in A, B and C (the walked slot-2 index included), and how many
// slot-2 indices it walks.
struct NgTile {
  int64_t u0, v0, oa, ob, oc;
  int n_walk;
};

__device__ __forceinline__ NgTile ng_tile(const NgDesc& d, int64_t t, int BM, int BN) {
  const int64_t nu = (d.ext[0] + BM - 1) / BM, nv = (d.ext[1] + BN - 1) / BN;
  NgTile tl;
  tl.v0 = (t % nv) * BN;
  t /= nv;
  tl.u0 = (t % nu) * BM;
  t /= nu;
  tl.oa = tl.ob = tl.oc = 0;
  tl.n_walk = 1;
  if (!d.n_rest) return tl;
  const int64_t nw = (d.ext[2] + d.walk - 1) / d.walk;
  const int64_t w0 = (t % nw) * d.walk;
  t /= nw;
  tl.n_walk = (int)(d.ext[2] - w0 < d.walk ? d.ext[2] - w0 : d.walk);
  tl.oa = w0 * d.sa[2];
  tl.ob = w0 * d.sb[2];
  tl.oc = w0 * d.sc[2];
  for (int sl = 3; sl < 2 + d.n_rest; ++sl) {
    const int64_t idx = t % d.ext[sl];
    t /= d.ext[sl];
    tl.oa += idx * d.sa[sl];
    tl.ob += idx * d.sb[sl];
    tl.oc += idx * d.sc[sl];
  }
  return tl;
}

// Stage one operand's brick for K range [kbase, kbase + bk) into smem.
template <typename T>
__device__ __forceinline__ void ng_stage(float* smem, const T* __restrict__ X,
                                         const NgDesc& d, const int64_t* s,
                                         const NgBrick& br, int bk, int64_t base,
                                         int64_t u0, int64_t v0, int64_t kbase,
                                         int64_t K) {
  const int size[3] = {bk, br.du, br.dv};
  const int n = bk * br.du * br.dv;
  const int o0 = br.order[0], o1 = br.order[1], o2 = br.order[2];
  for (int e = threadIdx.x; e < n; e += NG_THREADS) {
    int c[3];
    int r = e;
    c[o2] = r % size[o2];
    r /= size[o2];
    c[o1] = r % size[o1];
    c[o0] = r / size[o1];
    const int64_t gu = u0 + c[1], gv = v0 + c[2], gk = kbase + c[0];
    float val = 0.f;
    if (gu < d.ext[0] && gv < d.ext[1] && gk < K) {
      const int64_t off = base + gu * s[0] + gv * s[1] + (d.n_k ? ng_k_offset(d, s, gk) : 0);
      val = ng_to_f32<T>(X[off]);
    }
    smem[c[0] * br.sk + c[1] * br.su + c[2] * br.sv] = val;
  }
}

template <typename TA, typename TB, typename TC, int TM, int TN>
__global__ void __launch_bounds__(NG_THREADS)
ng_kernel(const TA* __restrict__ A, const TB* __restrict__ B, TC* __restrict__ C,
          const NgDesc d, const NgBrick ba, const NgBrick bb, int bk, int64_t K,
          int64_t n_tiles) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + bk * ba.sk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const NgTile tl = ng_tile(d, tile, BM, BN);
    const int64_t u0 = tl.u0, v0 = tl.v0;
    for (int w = 0; w < tl.n_walk; ++w) {
      const int64_t pa = tl.oa + w * d.sa[2], pb = tl.ob + w * d.sb[2],
                    pc = tl.oc + w * d.sc[2];
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

      for (int64_t kbase = 0; kbase < K; kbase += bk) {
        ng_stage<TA>(As, A, d, d.sa, ba, bk, pa, u0, v0, kbase, K);
        ng_stage<TB>(Bs, B, d, d.sb, bb, bk, pb, u0, v0, kbase, K);
        __syncthreads();
        for (int kk = 0; kk < bk; ++kk) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int ui = ty + 16 * i, vj = tx + 16 * j;
              acc[i][j] = fmaf(As[kk * ba.sk + ui * ba.su + vj * ba.sv],
                               Bs[kk * bb.sk + ui * bb.su + vj * bb.sv], acc[i][j]);
            }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int64_t gu = u0 + ty + 16 * i, gv = v0 + tx + 16 * j;
          if (gu < d.ext[0] && gv < d.ext[1])
            C[pc + gu * d.sc[0] + gv * d.sc[1]] = ng_from_f32<TC>(acc[i][j]);
        }
    }
  }
}

// The common GEMM shape ("outer"): A varies along u and one contracted
// mode only, B along v and that contracted mode only.  Each operand's
// brick is then a BK x W slab with compile-time extents, so a thread's
// element coordinates cost a mask and a shift instead of divisions, and
// the next stage's elements are loaded into registers while the current
// stage is computed.  `w_fast` puts neighbouring threads on the brick's
// W dimension (when that is the operand's smaller stride), else on k.
template <typename T, int W, int BK>
__device__ __forceinline__ void ng_load_slab(float (&r)[W * BK / NG_THREADS],
                                             const T* __restrict__ X, int64_t base,
                                             int64_t x0, int64_t w_ext, int64_t w_stride,
                                             int64_t k_stride, bool w_fast, int64_t kbase,
                                             int64_t K) {
#pragma unroll
  for (int i = 0; i < W * BK / NG_THREADS; ++i) {
    const int e = threadIdx.x + i * NG_THREADS;
    const int w = w_fast ? e % W : e / BK, k = w_fast ? e / W : e % BK;
    r[i] = x0 + w < w_ext && kbase + k < K
               ? ng_to_f32<T>(X[base + (x0 + w) * w_stride + (kbase + k) * k_stride])
               : 0.f;
  }
}

template <int W, int BK>
__device__ __forceinline__ void ng_store_slab(float* sm, const float (&r)[W * BK / NG_THREADS],
                                              bool w_fast) {
#pragma unroll
  for (int i = 0; i < W * BK / NG_THREADS; ++i) {
    const int e = threadIdx.x + i * NG_THREADS;
    const int w = w_fast ? e % W : e / BK, k = w_fast ? e / W : e % BK;
    sm[k * (W + 1) + w] = r[i];  // one pad word per k row: no bank conflicts
  }
}

template <typename TA, typename TB, typename TC, int TM, int TN>
__global__ void __launch_bounds__(NG_THREADS)
ng_outer_kernel(const TA* __restrict__ A, const TB* __restrict__ B, TC* __restrict__ C,
                const NgDesc d, int64_t K, int64_t a_k_stride, int64_t b_k_stride,
                int64_t n_tiles, bool a_u_fast, bool b_v_fast) {
  constexpr int BM = 16 * TM, BN = 16 * TN, BK = NG_MAX_BK;
  static_assert(BM * BK % NG_THREADS == 0 && BN * BK % NG_THREADS == 0, "slab split");
  __shared__ float As[BK * (BM + 1)];
  __shared__ float Bs[BK * (BN + 1)];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const NgTile tl = ng_tile(d, tile, BM, BN);
    const int64_t u0 = tl.u0, v0 = tl.v0;
    for (int w = 0; w < tl.n_walk; ++w) {
      const int64_t pa = tl.oa + w * d.sa[2], pb = tl.ob + w * d.sb[2],
                    pc = tl.oc + w * d.sc[2];
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

      float ra[BM * BK / NG_THREADS], rb[BN * BK / NG_THREADS];
      ng_load_slab<TA, BM, BK>(ra, A, pa, u0, d.ext[0], d.sa[0], a_k_stride, a_u_fast, 0, K);
      ng_load_slab<TB, BN, BK>(rb, B, pb, v0, d.ext[1], d.sb[1], b_k_stride, b_v_fast, 0, K);
      for (int64_t kbase = 0; kbase < K; kbase += BK) {
        ng_store_slab<BM, BK>(As, ra, a_u_fast);
        ng_store_slab<BN, BK>(Bs, rb, b_v_fast);
        __syncthreads();
        if (kbase + BK < K) {  // next stage in flight while this one computes
          ng_load_slab<TA, BM, BK>(ra, A, pa, u0, d.ext[0], d.sa[0], a_k_stride, a_u_fast,
                                   kbase + BK, K);
          ng_load_slab<TB, BN, BK>(rb, B, pb, v0, d.ext[1], d.sb[1], b_k_stride, b_v_fast,
                                   kbase + BK, K);
        }
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
          float a[TM], b[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = As[kk * (BM + 1) + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = Bs[kk * (BN + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int64_t gu = u0 + ty + 16 * i, gv = v0 + tx + 16 * j;
          if (gu < d.ext[0] && gv < d.ext[1])
            C[pc + gu * d.sc[0] + gv * d.sc[1]] = ng_from_f32<TC>(acc[i][j]);
        }
    }
  }
}

static inline int64_t ng_abs(int64_t x) { return x < 0 ? -x : x; }

// Brick of one operand: which tile dims it spans, its smem strides, and
// the load order that puts neighbouring threads on its smallest stride.
static NgBrick ng_brick(const NgDesc& d, const int64_t* s, int bm, int bn) {
  NgBrick br;
  br.du = s[0] ? bm : 1;
  br.dv = s[1] ? bn : 1;
  br.sv = s[1] ? 1 : 0;
  br.su = s[0] ? br.dv : 0;
  // one pad word per k-slice: loads that walk k put neighbouring threads
  // on neighbouring k, which would otherwise hit one shared-memory bank
  br.sk = br.du * br.dv + 1;
  const int64_t ks = d.n_k ? s[1 + d.n_rest + d.n_k] : 0;  // fastest contracted slot
  int64_t key[3] = {ks, s[0], s[1]};
  for (int i = 0; i < 3; ++i) {
    if (key[i] < 0) key[i] = -key[i];
    br.order[i] = i;
  }
  // outer -> inner: descending stride; a dim the brick does not span
  // (stride 0) is innermost, where its single index costs nothing
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j) {
      const int64_t ki = key[br.order[i]] ? key[br.order[i]] : -1;
      const int64_t kj = key[br.order[j]] ? key[br.order[j]] : -1;
      if (kj > ki) {
        const int tmp = br.order[i];
        br.order[i] = br.order[j];
        br.order[j] = tmp;
      }
    }
  return br;
}

template <typename TA, typename TB, typename TC, int TM, int TN>
static int ng_launch_t(const void* A, const void* B, void* C, const NgDesc& d,
                       cudaStream_t stream) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  const NgBrick ba = ng_brick(d, d.sa, BM, BN), bb = ng_brick(d, d.sb, BM, BN);
  const int per_k = ba.sk + bb.sk;
  int bk = NG_SMEM_BYTES / (int)(sizeof(float) * per_k);
  int64_t K = 1;
  for (int i = 0; i < d.n_k; ++i) K *= d.ext[2 + d.n_rest + i];
  if (bk > NG_MAX_BK) bk = NG_MAX_BK;
  if (bk > K) bk = (int)K;
  if (bk < 1) bk = 1;
  int64_t n_tiles = ((d.ext[0] + BM - 1) / BM) * ((d.ext[1] + BN - 1) / BN);
  if (d.n_rest) n_tiles *= (d.ext[2] + d.walk - 1) / d.walk;
  for (int sl = 3; sl < 2 + d.n_rest; ++sl) n_tiles *= d.ext[sl];
  if (n_tiles == 0) return (int)cudaSuccess;
  const int64_t max_grid = (int64_t)1 << 24;
  const unsigned grid = (unsigned)(n_tiles < max_grid ? n_tiles : max_grid);
  if (d.sa[1] == 0 && d.sb[0] == 0 && d.n_k <= 1) {
    // neighbouring threads go along the slab's smaller-stride dimension
    const int64_t ka = d.n_k ? d.sa[2 + d.n_rest] : 0;
    const int64_t kb = d.n_k ? d.sb[2 + d.n_rest] : 0;
    const bool a_u_fast = d.sa[0] && (!ka || ng_abs(d.sa[0]) <= ng_abs(ka));
    const bool b_v_fast = d.sb[1] && (!kb || ng_abs(d.sb[1]) <= ng_abs(kb));
    ng_outer_kernel<TA, TB, TC, TM, TN><<<grid, NG_THREADS, 0, stream>>>(
        (const TA*)A, (const TB*)B, (TC*)C, d, K, ka, kb, n_tiles, a_u_fast, b_v_fast);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * (size_t)bk * per_k;
  ng_kernel<TA, TB, TC, TM, TN><<<grid, NG_THREADS, smem, stream>>>(
      (const TA*)A, (const TB*)B, (TC*)C, d, ba, bb, bk, K, n_tiles);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB, typename TC>
static int ng_launch_tile(const void* A, const void* B, void* C, const NgDesc& d,
                          cudaStream_t stream) {
  // a narrow v (the HOOI ranks) takes a 128 x 16 tile, anything wider 64 x 64
  if (d.ext[1] <= 16) return ng_launch_t<TA, TB, TC, 8, 1>(A, B, C, d, stream);
  return ng_launch_t<TA, TB, TC, 4, 4>(A, B, C, d, stream);
}

template <typename TA, typename TB>
static int ng_launch_c(const void* A, const void* B, void* C, const NgDesc& d, int tc,
                       cudaStream_t stream) {
  if (tc == 0) return ng_launch_tile<TA, TB, float>(A, B, C, d, stream);
  return ng_launch_tile<TA, TB, __nv_bfloat16>(A, B, C, d, stream);
}

// Type codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t value.
extern "C" int ng_launch(const void* A, const void* B, void* C, const NgDesc* d, int ta,
                         int tb, int tc, void* stream) {
  if (ta < 0 || ta > 1 || tb < 0 || tb > 1 || tc < 0 || tc > 1 || d->walk < 1 ||
      d->n_rest < 0 || d->n_k < 0 || 2 + d->n_rest + d->n_k > NG_MAX_MODES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (ta == 0 && tb == 0) return ng_launch_c<float, float>(A, B, C, *d, tc, st);
  if (ta == 0) return ng_launch_c<float, __nv_bfloat16>(A, B, C, *d, tc, st);
  if (tb == 0) return ng_launch_c<__nv_bfloat16, float>(A, B, C, *d, tc, st);
  return ng_launch_c<__nv_bfloat16, __nv_bfloat16>(A, B, C, *d, tc, st);
}

extern "C" const char* ng_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
