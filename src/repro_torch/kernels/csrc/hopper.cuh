// hopper.cuh: Hopper (sm_90a) building blocks shared by the port's kernels.
//
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// warpgroup fences around a wgmma batch, the bf16 wgmma with both operands
// in shared memory, a consumer warpgroup's K loop over a TMA ring, paired
// stores of its accumulators, cp.async copies and 16-byte unpacking for
// the FMA kernels, and the tensor-map encoder fetched through the CUDA
// runtime (so no library links against libcuda).  Included by flash_attn.cu,
// grouped_gemm.cu and sb_gemm.cu; each builds into its own library, so
// everything here is inline or static.  _build.py hashes this header with
// every source, so a change here rebuilds all of them.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Error codes of the tensor-map encoder, beside cudaError_t's positive ones.
#define HP_ERR_ENTRY (-1)          // libcuda has no cuTensorMapEncodeTiled
#define HP_ERR_ENCODE (-1000)      // minus the CUresult it returned

__device__ __forceinline__ uint32_t hp_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void hp_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(hp_smem(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void hp_bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(hp_smem(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void hp_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(hp_smem(bar)) : "memory");
}
// Every wait is for a copy or a tile's compute, microseconds; one that
// spins for ~2^34 cycles (about 10 s) is a fault in the protocol, and traps
// so that the launch fails instead of holding the card.
__device__ __forceinline__ void hp_bar_wait(uint64_t* bar, int parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(hp_smem(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (!start) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One box of a 2-D or 3-D tensor map at coordinates (c0, c1[, c2]),
// innermost first, into shared memory; its bytes count on bar.
__device__ __forceinline__ void hp_tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(hp_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hp_smem(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void hp_tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(hp_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hp_smem(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async: BYTES (16, or 4 for an unaligned float) from global src to
// shared dst, bypassing registers; when !valid nothing is read and dst is
// zero-filled (src must still be a mapped address).  16-byte copies go
// through L2 only (.cg), 4-byte ones through L1 (.ca, the only kind for
// them).  Completion is tracked per thread by commit and wait groups.
template <int BYTES>
__device__ __forceinline__ void hp_cp_async(void* dst, const void* src, bool valid) {
  static_assert(BYTES == 16 || BYTES == 4, "cp.async size");
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(hp_smem(dst)), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(hp_smem(dst)), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void hp_cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N committed cp.async groups of this thread are pending.
template <int N> __device__ __forceinline__ void hp_cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A 16-byte chunk of T (4 float32 or 8 bf16) as f32 values.
template <typename T> __device__ __forceinline__ void hp_unpack16(const uint4& x, float* v);
template <> __device__ __forceinline__ void hp_unpack16<float>(const uint4& x, float* v) {
  v[0] = __uint_as_float(x.x);
  v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z);
  v[3] = __uint_as_float(x.w);
}
template <> __device__ __forceinline__ void hp_unpack16<__nv_bfloat16>(const uint4& x, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Two neighbouring f32 values stored to p as T (float32 or bf16, rounded
// to nearest) in one access; p must be 2-element aligned.
template <typename T> __device__ __forceinline__ void hp_store2(T* p, float x0, float x1);
template <> __device__ __forceinline__ void hp_store2<float>(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <> __device__ __forceinline__ void hp_store2<__nv_bfloat16>(__nv_bfloat16* p, float x0,
                                                                     float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets: lbo
// between swizzle spans along the leading dimension, sbo between groups of
// 8 rows.
__device__ __forceinline__ uint64_t hp_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((hp_smem(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void hp_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void hp_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups of this thread are pending.
template <int N> __device__ __forceinline__ void hp_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// An empty asm that reads and writes each register: placed before a fence
// it pins the registers' last writes ahead of the wgmma batch, after the
// wait it keeps their next reads behind it.
template <int N> __device__ __forceinline__ void hp_keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N> __device__ __forceinline__ void hp_keep(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// d (+)= A B for one warpgroup, m64 x N x k16, bf16 in, f32 accumulate,
// A and B from shared memory; scale_d = 0 overwrites d.  TA = 0 reads A
// K-major, 1 M-major (transposed); TB = 0 reads B K-major, 1 N-major.  d is
// the f32 accumulator fragment: of the N/2 values a thread holds, d[4i + e]
// is row 16 * warp + lane / 4 + 8 * (e / 2), column 8i + 2 * (lane % 4) +
// e % 2, with warp the warp's index in its warpgroup.
template <int TA, int TB>
__device__ __forceinline__ void hp_wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void hp_wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void hp_wgmma_ss(float (&d)[128], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The K loop of one consumer warpgroup over a ring of STAGES shared-memory
// stages, stage_bytes apart, each 64 deep under the 128-byte swizzle and
// announced on full[s] by a producer: this warpgroup's 64 rows of A at
// a_off into the stage, K-major ([64 m][64 k]) or, under TA, M-major ([64
// k][64 m]); B at b_off, N-major ([64 k][64 n] boxes 8 KB apart) or, under
// KB, K-major ([n][64 k]).  Accumulates n_k stages into acc with one
// batch kept in flight, and hands a stage back on empty[s] (lane 0 of
// each warp) once the batch that read it is done.
template <int TA, int KB, int STAGES, int N>
__device__ __forceinline__ void hp_consume_ring(float (&acc)[N], const uint8_t* ring,
                                                int stage_bytes, int a_off, int b_off,
                                                uint64_t* full, uint64_t* empty, int n_k) {
  constexpr int BOX = 64 * 64 * 2;
  const int lane = threadIdx.x % 32;
  for (int it = 0; it < n_k; ++it) {
    const int s = it % STAGES;
    const uint8_t* as = ring + s * stage_bytes + a_off;
    const uint8_t* bs = ring + s * stage_bytes + b_off;
    hp_bar_wait(&full[s], (it / STAGES) & 1);
    // depth step kk: 16 k of a K-major slab is 32 bytes along its rows; of
    // an M- or N-major slab, 16 rows of 128 bytes, with the next box of 64
    // columns one box further on
    hp_keep(acc);
    hp_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = TA ? hp_desc(as + kk * 16 * 128, BOX, 1024)
                             : hp_desc(as + kk * 32, 16, 1024);
      const uint64_t db = KB ? hp_desc(bs + kk * 32, 16, 1024)
                             : hp_desc(bs + kk * 16 * 128, BOX, 1024);
      hp_wgmma_ss<TA, !KB>(acc, da, db, 1);
    }
    hp_wgmma_commit();
    // this stage's batch stays in flight; the previous one is done, and
    // its stage goes back to the producer
    hp_wgmma_wait<1>();
    hp_keep(acc);
    if (it > 0 && lane == 0) hp_bar_arrive(&empty[(it - 1) % STAGES]);
  }
  hp_wgmma_wait<0>();
  hp_keep(acc);
}

typedef CUresult (*HpEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library needs no link against libcuda.
static HpEncodeFn hp_encoder() {
  static HpEncodeFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (HpEncodeFn)p;
  }
  return fn;
}

// A tensor map of `rank` dimensions (innermost first) of element type
// `type`, with byte strides of dimensions 1.., read in boxes of `box`
// elements under `swizzle`; out-of-range elements read as zero.  Returns 0,
// HP_ERR_ENTRY or HP_ERR_ENCODE - CUresult.
static int hp_map_as(CUtensorMap* map, CUtensorMapDataType type, CUtensorMapSwizzle swizzle,
                     const void* ptr, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const HpEncodeFn encode = hp_encoder();
  if (!encode) return HP_ERR_ENTRY;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : HP_ERR_ENCODE - (int)r;
}

// A bf16 tensor map read in boxes of 64 innermost elements (one 128-byte
// swizzle span) with the 128-byte swizzle.
static int hp_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box) {
  return hp_map_as(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B, ptr, rank,
                   dims, strides, box);
}

// Text for a code returned by a launch: a cudaError_t or an HP_ERR_ code.
static const char* hp_error_string(int code) {
  if (code == HP_ERR_ENTRY) return "libcuda has no cuTensorMapEncodeTiled";
  if (code <= HP_ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}
