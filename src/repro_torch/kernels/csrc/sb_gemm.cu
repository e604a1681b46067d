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
// Routes.  The wrapper's native_route picks one from layout and extents
// alone (no fallback: a route that cannot build or launch raises):
//   generic  (ng_outer_kernel, ng_kernel) every layout: batch modes,
//            several contracted modes, mixed bf16 x f32 operands, layouts
//            TMA cannot read, the Table II cases;
//   stream   (ns_read_kernel, nw_kernel) float32 with one big side and a
//            narrow other one, e.g. the HOOI contractions of the 512^3
//            tensor with a rank-10 factor;
//   splitk   (nk_kernel, nk_reduce) float32 with a narrow output and a
//            long contraction, e.g. HOOI's contractions of the 512x512x10
//            intermediates;
//   wgmma    (nm_kernel, nm_reduce) bf16 weight streaming, C[m, n] =
//            sum_k X[m, k] W[k, n] with both operands TMA-readable, e.g.
//            every dense and LM-head product of a served model.
//
// Generic tiling.  One block of 256 threads owns a BM x BN tile of (u, v)
// (128 x 16 when v is at most 16 wide, else 64 x 64) and loops over K in
// stages.  Each stage stages one "brick" per operand in shared memory,
// over only the tile dimensions the operand carries, converted to f32;
// loads put neighbouring threads on the operand's smallest-stride brick
// dimension, so the big operand's reads coalesce whichever of its modes
// is stride-1.  Two kernels share this design:
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
//            request the tokens it gets alone).
//   generic  the remaining layouts at the tile sizes above; its loads are
//            plain, not TMA, one element a thread, and it runs on the FMA
//            units in f32 whatever the operand type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
    if (r < d.R) C[co + r * d.cr] = ng_from_f32<TC>(acc[r]);
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
          if (p0 + j < d.P) c[j] = ng_from_f32<TC>(a[j]);
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
  C[co] = ng_from_f32<TC>(sum);
}

// -------------------------------------------------------------------- wgmma
// bf16 weight streaming: C[m, n] = sum_k X[m, k] W[k, n], X (M, K) and W
// (K, N) each read by a 2-D tensor map (X K-major or M-major, W N-major or
// K-major; the wrapper's native_plan checks the layout).  One block owns a
// 64 x NM_BN tile of C: one consumer warpgroup runs wgmma m64nNM_BNk16 into
// NM_BN / 2 f32 accumulators per thread, and lane 0 of one producer warp
// feeds a ring of NM_STAGES stages by TMA under the 128-byte swizzle, each
// stage a 64-deep slab of X (64 rows, 8 KB) and of W (NM_BN columns, 16
// KB), guarded by a "full" and an "empty" mbarrier.  The maps' extents are
// M, N and K, not the row strides, so rows past M and depth past K read as
// zeros (a sliced operand reads no neighbour); the store masks rows >= M
// and columns >= N.  blockIdx.x is the tile (m fastest, so the m-tiles of
// one n-tile share W in L2), blockIdx.y the split of the contraction: kc
// indices, a multiple of NM_BK, so only the last split runs past K.  One
// split stores C; several store f32 partial sums to ws [split][M][N],
// which nm_reduce sums in split order and casts.
#define NM_TM 64          // output rows per block: one consumer warpgroup
#define NM_BN 128         // output columns per block
#define NM_BK 64          // depth per stage: 64 bf16 are one 128-byte swizzle span
#define NM_STAGES 4       // ring depth: 4 x 24 KB
#define NM_THREADS 160    // one consumer warpgroup + one producer warp
#define NM_BOX (64 * NM_BK * 2)                          // one [64][64] bf16 box: 8 KB
#define NM_STAGE_BYTES (NM_BOX + NM_BN / 64 * NM_BOX)     // X slab, then W slab: 24 KB
#define NM_BAR_OFF (NM_STAGES * NM_STAGE_BYTES)
#define NM_SMEM (1024 + NM_BAR_OFF + 8 * 2 * NM_STAGES)  // + alignment slack

struct NmDesc {
  int64_t M, N, K, xm, xk, wn, wk, ldc;  // element strides; C[m * ldc + n]
  int32_t kc, n_split;                   // contracted indices per split, splits
};

// One accumulator fragment (see hp_wgmma_ss) into rows m0.., columns n0..
// of out (row stride ld), masked to M x N; pairs of columns are stored
// together where ld is even (they then start 2-element aligned).
template <typename TO>
__device__ __forceinline__ void nm_store(TO* __restrict__ out, int64_t ld, const float* acc,
                                         int64_t M, int64_t N, int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + 16 * warp + lane / 4;
  const bool pairs = ld % 2 == 0;
#pragma unroll
  for (int i = 0; i < NM_BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      TO* p = out + (int64_t)row * ld + col;
      const float x0 = acc[4 * i + 2 * h], x1 = acc[4 * i + 2 * h + 1];
      if (pairs && col + 1 < N) {
        hp_store2<TO>(p, x0, x1);
      } else {
        p[0] = ng_from_f32<TO>(x0);
        if (col + 1 < N) p[1] = ng_from_f32<TO>(x1);
      }
    }
  }
}

// XM: X is M-major (stored (K, M), wgmma's transpose bit for A); else
// K-major.  WK: W is K-major (stored (N, K)); else N-major (wgmma's
// transpose bit for B).
template <int XM, int WK, typename TC>
__global__ void __launch_bounds__(NM_THREADS)
nm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
          TC* __restrict__ C, float* __restrict__ ws, const NmDesc d) {
  extern __shared__ uint8_t nm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(nm_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + NM_BAR_OFF);
  uint64_t* empty = full + NM_STAGES;

  const int mt = (int)((d.M + NM_TM - 1) / NM_TM);
  const int m0 = (int)(blockIdx.x % mt) * NM_TM, n0 = (int)(blockIdx.x / mt) * NM_BN;
  const int64_t k_begin = (int64_t)blockIdx.y * d.kc;
  const int64_t k_len = d.K - k_begin < d.kc ? d.K - k_begin : d.kc;
  const int n_k = (int)((k_len + NM_BK - 1) / NM_BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NM_STAGES; ++s) {
      hp_bar_init(&full[s], 1);
      hp_bar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {  // producer warp: lane 0 issues every copy
    if (lane == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % NM_STAGES, k0 = (int)(k_begin + (int64_t)it * NM_BK);
        if (it >= NM_STAGES) hp_bar_wait(&empty[s], (it / NM_STAGES - 1) & 1);
        uint8_t* xs = sm + s * NM_STAGE_BYTES;
        uint8_t* wsm = xs + NM_BOX;
        hp_bar_expect(&full[s], NM_STAGE_BYTES);
        if (XM) hp_tma_load(xs, &xmap, &full[s], m0, k0);  // [64 k][64 m]
        else hp_tma_load(xs, &xmap, &full[s], k0, m0);     // [64 m][64 k]
        if (WK) {
          hp_tma_load(wsm, &wmap, &full[s], k0, n0);       // [NM_BN n][64 k]
        } else {
#pragma unroll
          for (int j = 0; j < NM_BN / 64; ++j)             // [64 k][64 n] boxes
            hp_tma_load(wsm + j * NM_BOX, &wmap, &full[s], n0 + 64 * j, k0);
        }
      }
    }
    return;
  }

  float acc[NM_BN / 2];
#pragma unroll
  for (int i = 0; i < NM_BN / 2; ++i) acc[i] = 0.f;
  hp_consume_ring<XM, WK, NM_STAGES>(acc, sm, NM_STAGE_BYTES, 0, NM_BOX, full, empty, n_k);

  if (d.n_split == 1) nm_store<TC>(C, d.ldc, acc, d.M, d.N, m0, n0);
  else nm_store<float>(ws + (int64_t)blockIdx.y * d.M * d.N, d.N, acc, d.M, d.N, m0, n0);
}

template <typename TC>
__global__ void __launch_bounds__(256)
nm_reduce(const float* __restrict__ ws, TC* __restrict__ C, const NmDesc d) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x, plane = d.M * d.N;
  if (i >= plane) return;
  float sum = 0.f;
  for (int s = 0; s < d.n_split; ++s) sum += ws[s * plane + i];
  C[i / d.N * d.ldc + i % d.N] = ng_from_f32<TC>(sum);
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

// An (outer, inner) bf16 operand with outer stride ld (elements), read in
// boxes of 64 inner elements x box_outer rows under the 128-byte swizzle.
static int nm_map(CUtensorMap* map, const void* ptr, int64_t outer, int64_t inner, int64_t ld,
                  int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  return hp_map(map, ptr, 2, dims, strides, box);
}

template <int XM, int WK, typename TC>
static int nm_go(const CUtensorMap& xmap, const CUtensorMap& wmap, void* C, void* ws,
                 const NmDesc& d, dim3 grid, cudaStream_t st) {
  static bool sized = false;  // once per kernel: its shared memory is above 48 KB
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        nm_kernel<XM, WK, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, NM_SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  nm_kernel<XM, WK, TC><<<grid, NM_THREADS, NM_SMEM, st>>>(xmap, wmap, (TC*)C, (float*)ws, d);
  return (int)cudaGetLastError();
}

template <typename TC>
static int nm_launch_t(const void* X, const void* W, void* C, void* ws, const NmDesc& d,
                       cudaStream_t st) {
  const bool xm_major = d.xk != 1, wk_major = d.wn != 1;
  CUtensorMap xmap, wmap;
  int rc = xm_major ? nm_map(&xmap, X, d.K, d.M, d.xk, 64) : nm_map(&xmap, X, d.M, d.K, d.xm, 64);
  if (!rc)
    rc = wk_major ? nm_map(&wmap, W, d.N, d.K, d.wn, NM_BN) : nm_map(&wmap, W, d.K, d.N, d.wk, 64);
  if (rc) return rc;
  const int64_t tiles = (d.M + NM_TM - 1) / NM_TM * ((d.N + NM_BN - 1) / NM_BN);
  if (tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)d.n_split);
  if (xm_major) rc = wk_major ? nm_go<1, 1, TC>(xmap, wmap, C, ws, d, grid, st)
                              : nm_go<1, 0, TC>(xmap, wmap, C, ws, d, grid, st);
  else rc = wk_major ? nm_go<0, 1, TC>(xmap, wmap, C, ws, d, grid, st)
                     : nm_go<0, 0, TC>(xmap, wmap, C, ws, d, grid, st);
  if (rc || d.n_split == 1) return rc;
  const int64_t n = d.M * d.N;
  nm_reduce<TC><<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)ws, (TC*)C, d);
  return (int)cudaGetLastError();
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

// Route "wgmma": bf16 X (M, K) and W (K, N), each 16-byte aligned with a
// layout nm_layout_ok takes; `ws` holds n_split * M * N floats when n_split
// > 1 (else it may be null).  Type code tc: 0 = float32, 1 = bfloat16
// output.  Returns a cudaError_t value or an HP_ERR_ code (hopper.cuh).
extern "C" int nm_launch(const void* X, const void* W, void* C, void* ws, const NmDesc* d, int tc,
                         void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  if (tc < 0 || tc > 1 || d->M < 1 || d->N < 1 || d->K < 1 || d->M >= lim || d->N >= lim ||
      d->K >= lim || !nm_layout_ok(d->xm, d->xk, d->M, d->K) ||
      !nm_layout_ok(d->wk, d->wn, d->K, d->N) || ((uintptr_t)X | (uintptr_t)W) % 16 ||
      d->kc < NM_BK || d->kc % NM_BK || d->n_split < 1 || d->n_split >= 65536 ||
      (int64_t)d->kc * d->n_split < d->K || (int64_t)d->kc * (d->n_split - 1) >= d->K ||
      (d->n_split > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tc == 0) return nm_launch_t<float>(X, W, C, ws, *d, st);
  return nm_launch_t<__nv_bfloat16>(X, W, C, ws, *d, st);
}

// Registers, local (spilled) bytes per thread and shared bytes per block of
// one kernel of the new routes: kind 0 stream read with m stride-1, 1
// stream read with k stride-1 (both at depth K, dynamic shared memory), 2
// stream write, 3 splitk, 4 its reduction (static shared memory), all with
// float32 output, rp the padded r of kinds 0, 1 and 3; kinds 5-8 the
// bfloat16-output wgmma kernel with X K-major (5, 6) or M-major (7, 8) and
// W N-major (5, 7) or K-major (6, 8), 9 its split reduction.
extern "C" int nr_info(int kind, int rp, int64_t K, int* out) {
  const void* fn = nullptr;
  size_t smem = 0;
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
    typedef __nv_bfloat16 B16;
    const void* fns[4] = {(const void*)nm_kernel<0, 0, B16>, (const void*)nm_kernel<0, 1, B16>,
                          (const void*)nm_kernel<1, 0, B16>, (const void*)nm_kernel<1, 1, B16>};
    fn = fns[kind - 5];
    smem = NM_SMEM;
  } else if (kind == 9) {
    fn = (const void*)nm_reduce<__nv_bfloat16>;
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

extern "C" const char* ng_error_string(int code) { return hp_error_string(code); }
