// A Hopper (sm_90a) GEMM building block shared by the port's kernels:
//
//   out (M, N) = A (M, K) . B (N, K)^T (+ bias (N)),  fp32 accumulation, one rounding
//
// with A and B K-major (torch's row-major activations and Linear weights).
// edge_attention.cu instantiates it as kv_proj ([k|v] = f . w^T + b, the
// projection inside anemoi_models_tpu/ops/pallas/edge_attention.py:_feats_kernel)
// and gnn_common.cuh as the per-node pre-pass of the factored edge MLP
// (x_i . W0[:, 0:C] + b0 and x_j . W0[:, C:2C]), each under its own tag so a
// profile tells the two apart; gnn_conv_layered.cu runs its pipelines
// (proj_bf16_start / proj_bf16_run, proj_f32_tile) under epilogues of its own. flash_attention.cu builds on its device parts
// (4-D tensor maps over strided heads, mbarriers, wgmma with A from registers
// and B transposed).
//
// bf16 operands (proj_bf16_kernel): tensor cores through wgmma.
//   - CTA tile 128 x 128 (M x N), K in 64-wide steps (128 bytes of bf16, the
//     128-byte swizzle wgmma reads). At the O96 processor shape (M = 10,242,
//     N = 512) that is 81 x 4 = 324 tiles; two CTAs fit an SM (98 KB of
//     shared memory, at most 128 registers a thread), so 264 run at once:
//     1.23 waves on 132 SMs. At the encoder's M = 40,320, 1,260 tiles, 4.8
//     waves. A 128 x 256 tile halves the tile count but holds one CTA per SM
//     (128 accumulator registers a thread): the same 1.23 waves with no
//     second CTA to overlap one's epilogue with the other's loads.
//   - Tiles of A and B arrive by TMA (cp.async.bulk.tensor, UTMALDG in SASS)
//     into a 3-stage ring guarded by mbarriers; the tensor map's zero fill
//     takes ragged M, N and K with no masking. Thread 0 issues the copies;
//     it refills a stage once all 256 threads have arrived on its "empty"
//     barrier after their wgmma on it completed.
//   - Two consumer warpgroups, 64 rows each, issue wgmma.mma_async m64n128k16
//     with the fp32 accumulator in registers (64 a thread).
//   - The epilogue adds the bias in fp32 (staged in shared memory once),
//     rounds once to the output type (bf16 or fp32) into a shared-memory
//     tile and stores it in whole 16-byte chunks, masked by M and N.
//   - No split-K and no atomics: two calls are bit-identical.
//   The tensor maps are encoded on the host for every call
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no -lcuda), a
//   few microseconds of host time. Rows must be 16-byte aligned (K % 8 == 0,
//   N % 8 == 0, 16-byte aligned bases and output rows).
//   Bound on the H100: bytes at these shapes (K = 256: 2 K = 512 operations
//   per output against 2-4 bytes written).
//
// fp32 operands (proj_f32_kernel): exact fp32 on the CUDA cores (TF32 would
// miss the 1e-5 gate): 64 x 64 tile, 4 x 4 outputs a thread, operands staged
// through shared memory. Operation-bound (67 TFLOP/s of fp32).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 2-D bf16 tensor map: `rows` rows of `cols` elements, `row_stride`
// elements apart; boxes of box_rows x box_cols, swizzled at box_cols * 2
// bytes (128, 64 or 32), out-of-bounds elements read as zero. Returns 0 or a
// cudaError_t.
inline int make_map_bf16(CUtensorMap* map, const void* base, int64_t rows, int64_t cols, int64_t row_stride,
                         int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_stride) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 4-D bf16 tensor map over (d0, d1, d2, d3) = (cols, rows, heads, batch)
// with element strides (1, s1, s2, s3): boxes of box_cols x box_rows x 1 x 1,
// swizzled at box_cols * 2 bytes (128, 64 or 32), out-of-bounds elements read
// as zero. The strides must be multiples of 8 elements. Returns 0 or a
// cudaError_t.
inline int make_map_bf16_4d(CUtensorMap* map, const void* base, const int64_t dims[4], const int64_t strides[3],
                            int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  cuuint64_t d[4], st[3];
  for (int i = 0; i < 4; ++i) d[i] = static_cast<cuuint64_t>(dims[i]);
  for (int i = 0; i < 3; ++i) st[i] = static_cast<cuuint64_t>(strides[i]) * sizeof(bf16);
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, st, box, elem_strides,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (the 128-byte swizzle repeats every 1024 bytes)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory; completion counts bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 2-D tensor map into shared memory; completion counts bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma's (async-proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// byte offset `o` of a K-major tile whose rows are SW bytes (the TMA swizzle
// of that width): the 16-byte chunk index XOR the row bits above it
template <int SW>
__device__ __forceinline__ int swizzle(int o) {
  return o ^ (((o >> 7) & (SW / 16 - 1)) << 4);
}

// wgmma shared-memory descriptor of a K-major, SW-byte-swizzled tile: rows of
// SW bytes, 8-row groups SW * 8 bytes apart; the start moves 32 bytes per k16 step
template <int SW>
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>((8 * SW) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving accumulator reads or writes across the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, A and B K-major from shared
// memory; d (N / 2 floats a thread) += A . B^T, or = with scale_d == 0
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
          "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// D-fragment layout of m64nN (per warpgroup thread t, warp w = t / 32, lane l):
// register r holds row 16 w + l / 4 + 8 ((r / 2) % 2), column 8 (r / 4) + 2 (l % 4) + r % 2.

// wgmma shared-memory descriptor of an MN-major (transposed) operand with the
// SW-byte swizzle: rows of SW bytes along K, each holding SW / 2 consecutive
// bf16 of the MN dimension; 8-row groups SW * 8 bytes apart (SBO) and the next
// SW / 2 columns of MN `lbo` bytes on (LBO); the start moves 16 rows per k16 step
__device__ __forceinline__ uint64_t make_desc_mn_bits(const void* p, int sw, uint32_t lbo) {
  const uint64_t layout = sw == 128 ? 1 : sw == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(((8 * sw) >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, A from registers (4 words a
// thread, the m16n8k16 A-fragment of this warp's 16 rows: word 0 row l / 4,
// columns 2 (l % 4) + {0, 1}; word 1 the same 8 rows down; words 2, 3 the
// same 8 columns on) and B MN-major from shared memory (imm-trans-b = 1):
// d (N / 2 floats a thread) += A . B, or = with scale_d == 0
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// ---------------------------------------------------------------------------
// the projection kernels
// ---------------------------------------------------------------------------

enum BiasKind { kNoBias = 0, kBiasF32 = 1, kBiasBF16 = 2 };

__device__ __forceinline__ float bias_at(const void* bias, int kind, int col) {
  if (kind == kBiasF32) return static_cast<const float*>(bias)[col];
  if (kind == kBiasBF16) return __bfloat162float(static_cast<const bf16*>(bias)[col]);
  return 0.f;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

constexpr int kProjBM = 128;
constexpr int kProjBN = 128;
constexpr int kProjBK = 64;
constexpr int kProjStages = 3;
constexpr int kProjThreads = 256;
constexpr int kProjTileA = kProjBM * kProjBK * 2;
constexpr int kProjStage = kProjTileA + kProjBN * kProjBK * 2;
constexpr int kProjBarOff = kProjStages * kProjStage;  // full[S], empty[S]
constexpr int kProjBiasOff = kProjBarOff + 64;         // the tile's bias, fp32
constexpr size_t kProjSmem = 1024 + kProjBiasOff + kProjBN * sizeof(float);

// up to two independent products in one launch (blockIdx.z picks one)
struct ProjProblem {
  CUtensorMap a;  // (m, k) bf16, boxes of 128 x 64
  CUtensorMap b;  // (n, k) bf16, boxes of 128 x 64
  const void* bias;
  void* out;      // (m, n) rows ldo apart
  int m, n, ldo, bias_kind;
};
struct ProjBatch {
  ProjProblem p[2];
  int k;
};

// One stage of the ring: the A and B boxes of K tile kt of the tile at (m0, n0).
__device__ __forceinline__ void proj_bf16_load(const ProjProblem& pr, uint8_t* smem, int kt, int m0, int n0) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kProjBarOff);
  const int s = kt % kProjStages;
  uint8_t* stage = smem + s * kProjStage;
  mbar_expect_tx(full + s, kProjStage);
  tma_load_2d(stage, &pr.a, full + s, kt * kProjBK, m0);
  tma_load_2d(stage + kProjTileA, &pr.b, full + s, kt * kProjBK, n0);
}

// The pipeline of proj_bf16_kernel, which the kernels with other epilogues
// share (gnn_conv_layered.cu). proj_bf16_start: thread 0 initialises the
// ring's barriers; the block's barrier publishes them (and whatever the
// caller wrote to shared memory before); thread 0 issues the first stages.
__device__ __forceinline__ void proj_bf16_start(const ProjProblem& pr, int ktiles, int m0, int n0, uint8_t* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kProjBarOff);
  uint64_t* empty = full + kProjStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kProjStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kProjThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int kt = 0; kt < kProjStages && kt < ktiles; ++kt) proj_bf16_load(pr, smem, kt, m0, n0);
  }
}

// proj_bf16_run: acc (kProjBN / 2 floats a thread: this warpgroup's 64 rows
// of the tile in the D-fragment layout) += A . B^T over every K tile.
__device__ __forceinline__ void proj_bf16_run(const ProjProblem& pr, int ktiles, int m0, int n0, uint8_t* smem,
                                              float* acc) {
  constexpr int kR = kProjBN / 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kProjBarOff);
  uint64_t* empty = full + kProjStages;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kProjStages;
    const uint32_t phase = (kt / kProjStages) & 1;
    mbar_wait(full + s, phase);
    const uint8_t* a_tile = smem + s * kProjStage + wg * 64 * 128;  // this warpgroup's 64 rows
    const uint8_t* b_tile = smem + s * kProjStage + kProjTileA;
    fence_regs<kR>(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kProjBK / 16; ++k) {
      Wgmma<kProjBN>::mma(acc, make_desc<128>(a_tile + 32 * k), make_desc<128>(b_tile + 32 * k), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kR>(acc);
    mbar_arrive(empty + s);
    if (tid == 0 && kt + kProjStages < ktiles) {
      mbar_wait(empty + s, phase);
      proj_bf16_load(pr, smem, kt + kProjStages, m0, n0);
    }
  }
}

// The epilogue of proj_bf16_kernel, shared like its pipeline: acc (+ the
// tile's fp32 bias from shared memory with kBias) rounded once to OutT into a
// shared-memory tile (the ring is free once both warpgroups are done), then
// stored in whole 16-byte chunks of consecutive columns, masked by m and n.
template <typename OutT, bool kBias>
__device__ __forceinline__ void proj_bf16_store(const float* acc, const float* bias, void* out_ptr, int m, int n,
                                                int ldo, int m0, int n0, uint8_t* smem) {
  constexpr int kV = 16 / sizeof(OutT);       // elements per 16-byte chunk
  constexpr int kLd = kProjBN + kV;           // padded row: the fragment writes spread over banks
  static_assert(kProjBM * kLd * sizeof(OutT) <= kProjStages * kProjStage, "output tile over the ring");
  OutT* tile = reinterpret_cast<OutT*>(smem);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  __syncthreads();
  const int lane = tid % 32;
  const int row0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kProjBN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float b0 = kBias ? bias[col] : 0.f;
      const float b1 = kBias ? bias[col + 1] : 0.f;
      store_pair(tile + (row0 + 8 * h) * kLd + col, acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
  __syncthreads();
  OutT* out = static_cast<OutT*>(out_ptr);
  for (int idx = tid; idx < kProjBM * (kProjBN / kV); idx += kProjThreads) {
    const int r = idx / (kProjBN / kV);
    const int c = (idx % (kProjBN / kV)) * kV;
    if (m0 + r < m && n0 + c < n) {
      *reinterpret_cast<int4*>(out + static_cast<int64_t>(m0 + r) * ldo + n0 + c) =
          *reinterpret_cast<const int4*>(tile + r * kLd + c);
    }
  }
}

template <typename Tag, typename OutT>
__global__ void __launch_bounds__(kProjThreads, 2) proj_bf16_kernel(const __grid_constant__ ProjBatch batch) {
  const ProjProblem& pr = batch.p[blockIdx.z];
  const int m0 = blockIdx.x * kProjBM;
  const int n0 = blockIdx.y * kProjBN;
  if (m0 >= pr.m || n0 >= pr.n) return;  // the other problem's grid is larger
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* bias = reinterpret_cast<float*>(smem + kProjBiasOff);
  const int tid = threadIdx.x;
  const int ktiles = (batch.k + kProjBK - 1) / kProjBK;
  if (tid < kProjBN) bias[tid] = n0 + tid < pr.n ? bias_at(pr.bias, pr.bias_kind, n0 + tid) : 0.f;
  proj_bf16_start(pr, ktiles, m0, n0, smem);

  constexpr int kR = kProjBN / 2;
  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.f;
  proj_bf16_run(pr, ktiles, m0, n0, smem, acc);

  proj_bf16_store<OutT, true>(acc, bias, pr.out, pr.m, pr.n, pr.ldo, m0, n0, smem);
}

// Launches the products of `batch` (count 1 or 2) on `stream`.
template <typename Tag, typename OutT>
int launch_proj_bf16(const ProjBatch& batch, int count, cudaStream_t stream) {
  auto kernel = proj_bf16_kernel<Tag, OutT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kProjSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int m = 0, n = 0;
  for (int i = 0; i < count; ++i) {
    m = batch.p[i].m > m ? batch.p[i].m : m;
    n = batch.p[i].n > n ? batch.p[i].n : n;
  }
  const dim3 grid((m + kProjBM - 1) / kProjBM, (n + kProjBN - 1) / kProjBN, count);
  kernel<<<grid, kProjThreads, kProjSmem, stream>>>(batch);
  return static_cast<int>(cudaGetLastError());
}

// Encodes one problem's tensor maps: a (m, k) rows lda apart, b (n, k) rows ldb apart.
inline int set_proj_problem(ProjProblem* pr, const void* a, int lda, const void* b, int ldb, const void* bias,
                            int bias_kind, void* out, int ldo, int m, int n, int k) {
  int rc = make_map_bf16(&pr->a, a, m, k, lda, kProjBM, kProjBK);
  if (rc == 0) rc = make_map_bf16(&pr->b, b, n, k, ldb, kProjBN, kProjBK);
  pr->bias = bias;
  pr->bias_kind = bias_kind;
  pr->out = out;
  pr->m = m;
  pr->n = n;
  pr->ldo = ldo;
  return rc;
}

// fp32: out (m, n) = a (m, k) . b (n, k)^T + bias, exact fp32 on the CUDA cores
constexpr int kF32BM = 64;
constexpr int kF32BN = 64;
constexpr int kF32BK = 16;
constexpr int kF32TM = 4;
constexpr int kF32TN = 4;
constexpr int kF32Threads = (kF32BM / kF32TM) * (kF32BN / kF32TN);  // 256

struct ProjF32Problem {
  const float* a;
  const float* b;
  const float* bias;  // or nullptr
  float* out;
  int m, n, lda, ldb, ldo;
};
struct ProjF32Batch {
  ProjF32Problem p[2];
  int k;
};

// The K loop of proj_f32_kernel, which the kernels with other epilogues share
// (gnn_conv_layered.cu): acc (rows 4 ty + i, columns 4 tx + j of the 64 x 64
// tile at (m0, n0), tx = tid % 16, ty = tid / 16) = A . B^T in exact fp32.
// Its first barrier also publishes what the caller wrote to shared memory.
__device__ __forceinline__ void proj_f32_tile(const ProjF32Problem& pr, int K, int m0, int n0,
                                              float (&acc)[kF32TM][kF32TN]) {
  __shared__ float As[kF32BK][kF32BM + 4];
  __shared__ float Bs[kF32BK][kF32BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kF32BN / kF32TN);
  const int ty = tid / (kF32BN / kF32TN);
#pragma unroll
  for (int i = 0; i < kF32TM; ++i)
#pragma unroll
    for (int j = 0; j < kF32TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32BK) {
    for (int idx = tid; idx < kF32BM * kF32BK; idx += kF32Threads) {
      const int r = idx / kF32BK;
      const int c = idx % kF32BK;
      const int gk = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      As[c][r] = (gm < pr.m && gk < K) ? pr.a[(int64_t)gm * pr.lda + gk] : 0.f;
      Bs[c][r] = (gn < pr.n && gk < K) ? pr.b[(int64_t)gn * pr.ldb + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      float av[kF32TM], bv[kF32TN];
#pragma unroll
      for (int i = 0; i < kF32TM; ++i) av[i] = As[kk][ty * kF32TM + i];
#pragma unroll
      for (int j = 0; j < kF32TN; ++j) bv[j] = Bs[kk][tx * kF32TN + j];
#pragma unroll
      for (int i = 0; i < kF32TM; ++i)
#pragma unroll
        for (int j = 0; j < kF32TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename Tag>
__global__ void __launch_bounds__(kF32Threads) proj_f32_kernel(const __grid_constant__ ProjF32Batch batch) {
  const ProjF32Problem& pr = batch.p[blockIdx.z];
  const int m0 = blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * kF32BN;
  if (m0 >= pr.m || n0 >= pr.n) return;
  const int tid = threadIdx.x;
  const int tx = tid % (kF32BN / kF32TN);
  const int ty = tid / (kF32BN / kF32TN);
  float acc[kF32TM][kF32TN];
  proj_f32_tile(pr, batch.k, m0, n0, acc);

#pragma unroll
  for (int i = 0; i < kF32TM; ++i) {
    const int gm = m0 + ty * kF32TM + i;
    if (gm >= pr.m) continue;
#pragma unroll
    for (int j = 0; j < kF32TN; ++j) {
      const int gn = n0 + tx * kF32TN + j;
      if (gn < pr.n) pr.out[(int64_t)gm * pr.ldo + gn] = acc[i][j] + (pr.bias ? pr.bias[gn] : 0.f);
    }
  }
}

template <typename Tag>
int launch_proj_f32(const ProjF32Batch& batch, int count, cudaStream_t stream) {
  int m = 0, n = 0;
  for (int i = 0; i < count; ++i) {
    m = batch.p[i].m > m ? batch.p[i].m : m;
    n = batch.p[i].n > n ? batch.p[i].n : n;
  }
  const dim3 grid((m + kF32BM - 1) / kF32BM, (n + kF32BN - 1) / kF32BN, count);
  proj_f32_kernel<Tag><<<grid, kF32Threads, 0, stream>>>(batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
