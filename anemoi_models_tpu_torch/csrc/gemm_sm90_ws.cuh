// A warp-specialised, persistent Hopper (sm_90a) bf16 GEMM with the epilogue
// as a template parameter:
//
//   out tile = epilogue(A (M, K) . B (N, K)^T),  fp32 accumulation
//
// A and B K-major bf16 (torch's row-major activations and Linear weights),
// one or two independent products of one K per launch. gnn_conv_layered.cu
// runs every bf16 GEMM of the GNN conv's layered route on it (the per-node
// pre-pass and each Dense of the edge MLP) with its own epilogues; it
// replaces, for that route, gemm_sm90.cuh's proj_bf16 pipeline, which kv_proj
// and the fused gnn_conv keep unchanged (their bits and times).
//
// The design:
//   - CTA tiles of 128 x BN (BN = 256, or 128 for widths that 256 does not
//     divide), K in steps of 64 (128 bytes of bf16, the 128-byte swizzle).
//     At BN = 256 a K step moves 48 KB into shared memory for 4.2 MFLOP,
//     two thirds of the bytes per operation of 128 x 128 tiles.
//   - One producer warp (thread 0 issues every TMA copy) keeps a ring of
//     kStages stages in flight (4 of 48 KB at BN = 256, 6 of 32 KB at 128),
//     each guarded by a "full" mbarrier (bytes landed) and an "empty" one
//     that each of the 8 consumer warps arrives on once its products of the
//     stage are done. It runs ahead across tiles, so the next tile's loads
//     overlap this tile's last products and its epilogue.
//   - Two consumer warpgroups, rows 0-63 and 64-127 of the tile, each
//     issuing wgmma.mma_async m64nBNk16 (BN / 2 fp32 accumulator registers a
//     thread); wgmma.wait_group 1 keeps one batch queued behind the running
//     one and releases each stage one K tile late. Timed with clock64 on an
//     H100 (C = 1024, BN = 256), a K step takes about 1,000 cycles against
//     the 1,024 of the tensor cores' rate: the main loop is not starved.
//   - A persistent grid: one CTA an SM walks the tiles t = blockIdx.x,
//     blockIdx.x + gridDim.x, ..., the N tiles of a row block next to each
//     other, so the CTAs in flight share a few row blocks of A (read from
//     device memory once) and the C x C weight stays in L2.
//   - An index warp, for epilogues that gather rows (Epi::kGather): each
//     tile's 128 gather rows are looked up (Epi::rows) into one of two
//     shared-memory slots ahead of the epilogue that reads them.
//   - The epilogue runs from the registers while the producer already loads
//     the next tile. It issues its loads (bias, gathered rows) before the
//     stores they feed: a load after a store to possibly the same memory
//     cannot start before that store, and the first epilogue, which loaded
//     each bias pair between stores, took as long as the main loop.
// 384 threads: the two consumer warpgroups (warps 0-7) and a producer
// warpgroup (warp 8 the producer, warp 9 the index warp, warps 10-11 idle).
// The launch gives each thread 168 registers; setmaxnreg, which acts on a
// whole warpgroup, then takes the producer warpgroup down to 40 and the
// consumers up to 232 (128 x 40 + 256 x 232 <= 65,536): room for 128
// accumulators beside Dense 0's gathered rows and the epilogues' batches.
// The two roles are the two arms of one if-else that never meet again, so
// ptxas allocates each arm at its own count (else it warns C7508 and ignores
// setmaxnreg). Shared memory: a 192 KB ring + 2 x 1 KB of gather rows + the
// mbarriers + 1 KB of alignment slack, under 200 KB of the 227 KB a block
// may have. No atomics: two calls are bit-identical; the tile order fixes
// each output's K order. A launch may cut one problem's K into `splits`
// fixed ranges (gnn_conv_bwd.cu's weight gradients, K = a chunk's edge
// rows): each range's tiles are tiles of their own, and the epilogue gets the
// range's index as its problem index and stores a partial of its own.
//
// An epilogue type provides:
//   static constexpr bool kGather;
//   template <int BN> __device__ void rows(int prob, int m0, int n0, int lane, int* rows) const;  // kGather
//   template <int BN> __device__ void store(const float* acc, int prob, int m0, int n0, int r0, int c_lo,
//                                          const int* rows_a, const int* rows_b) const;
// (rows writes the tile's 128 gather rows of each table: rows[0:128], rows[128:256]);
// acc holds the thread's BN / 2 values of its warpgroup's 64 x BN part of
// the tile at (m0, n0): acc[4 j + 2 q + e] is row m0 + r0 + 8 q, column n0 +
// 8 j + c_lo + e (q, e in {0, 1}, j < BN / 8); rows_a / rows_b are the
// tile's 128 gather rows (kGather) or null.

#pragma once

#include "gemm_sm90.cuh"  // tensor maps, mbarriers, TMA loads, wgmma

namespace sm90ws {

using namespace sm90;

constexpr int kWsBM = 128;  // rows of a tile (two m64 warpgroups)
constexpr int kWsBK = 64;   // K of a stage: 128 bytes of bf16, the 128-byte swizzle
constexpr int kWsConsumerWarps = 8;
constexpr int kWsThreads = 32 * kWsConsumerWarps + 128;  // + the producer warpgroup
constexpr int kWsProducerRegs = 40;                      // registers a thread after setmaxnreg
constexpr int kWsConsumerRegs = 232;
static_assert(128 * kWsProducerRegs + 32 * kWsConsumerWarps * kWsConsumerRegs <= 65536, "the SM's register file");
constexpr int kWsRing = 196608;                          // bytes of the stage ring

template <int BN>
struct WsTile {
  static constexpr int kTileA = kWsBM * kWsBK * 2;  // 16 KB
  static constexpr int kStage = kTileA + BN * kWsBK * 2;
  static constexpr int kStages = kWsRing / kStage;  // 4 at BN = 256, 6 at BN = 128
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kBars = 2 * kStages + 4;     // full, empty, rows_full[2], rows_empty[2]
  static constexpr int kRowsOff = kBarOff + kBars * 8;
  static constexpr size_t kSmem = 1024 + kRowsOff + 2 * 2 * kWsBM * sizeof(int);
  static_assert(kSmem <= 232448, "over the 227 KB a block may have");
};

// up to two independent products of one K in one launch; problem 0's tiles first
struct WsProblem {
  CUtensorMap a;  // (m, k) bf16, boxes of 128 x 64
  CUtensorMap b;  // (n, k) bf16, boxes of BN x 64
  int m, n;
};
struct WsArgs {
  WsProblem p[2];
  int tiles0;  // problem 0's tiles (of every K range)
  int tiles;   // all tiles
  int ktiles;  // K tiles of a tile
  int splits;  // K ranges of problem 0 (1: none)
};

// Encodes one problem's tensor maps: a (m, k) rows lda apart, b (n, k) rows ldb apart.
template <int BN>
int set_ws_problem(WsProblem* pr, const void* a, int lda, const void* b, int ldb, int m, int n, int k) {
  int rc = make_map_bf16(&pr->a, a, m, k, lda, kWsBM, kWsBK);
  if (rc == 0) rc = make_map_bf16(&pr->b, b, n, k, ldb, BN, kWsBK);
  pr->m = m;
  pr->n = n;
  return rc;
}

// tile t -> (problem, K range, m0, n0); the N tiles of a row block are consecutive, a K range's tiles too
template <int BN>
__device__ __forceinline__ void ws_tile(const WsArgs& args, int t, int* prob, int* split, int* m0, int* n0) {
  const int pb = t < args.tiles0 ? 0 : 1;
  int local = pb == 0 ? t : t - args.tiles0;
  const int nt = (args.p[pb].n + BN - 1) / BN;
  const int per = args.tiles0 / args.splits;  // problem 0's tiles of one K range
  *split = pb == 0 ? local / per : 0;
  local -= *split * per;
  *prob = pb;
  *m0 = (local / nt) * kWsBM;
  *n0 = (local % nt) * BN;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// this warpgroup's registers a thread, down or up to R (every warp of the warpgroup executes it)
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int BN, class Epi>
__global__ void __launch_bounds__(kWsThreads, 1)
ws_gemm_kernel(const __grid_constant__ WsArgs args, const __grid_constant__ Epi epi) {
  using T = WsTile<BN>;
  constexpr int kR = BN / 2;  // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + T::kStages;
  uint64_t* rows_full = empty + T::kStages;  // rows_full[w]: slot w's gather rows are written
  uint64_t* rows_empty = rows_full + 2;      // rows_empty[w]: every consumer warp has read them
  int* rows = reinterpret_cast<int*>(smem + T::kRowsOff);  // [slot][a: 128 | b: 128]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = gridDim.x;
  const int ktiles = args.ktiles;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWsConsumerWarps);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(rows_full + w, 32);
      mbar_init(rows_empty + w, kWsConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kWsConsumerWarps) {  // the producer warpgroup
    setmaxnreg_dec<kWsProducerRegs>();
    if (warp == kWsConsumerWarps && lane == 0) {  // the producer: every TMA copy, in the consumers' order
      int p = 0;
      for (int t = blockIdx.x; t < args.tiles; t += G) {
        int pb, sp, m0, n0;
        ws_tile<BN>(args, t, &pb, &sp, &m0, &n0);
        const WsProblem& pr = args.p[pb];
        for (int kt = sp * ktiles; kt < (sp + 1) * ktiles; ++kt, ++p) {
          const int s = p % T::kStages;
          if (p >= T::kStages) mbar_wait(empty + s, ((p / T::kStages) - 1) & 1);
          uint8_t* stage = smem + s * T::kStage;
          mbar_expect_tx(full + s, T::kStage);
          tma_load_2d(stage, &pr.a, full + s, kt * kWsBK, m0);
          tma_load_2d(stage + T::kTileA, &pr.b, full + s, kt * kWsBK, n0);
        }
      }
    } else if (warp == kWsConsumerWarps + 1) {
      if constexpr (Epi::kGather) {  // the index warp: each tile's gather rows, a tile ahead
        int i = 0;
        for (int t = blockIdx.x; t < args.tiles; t += G, ++i) {
          const int w = i & 1, j = i >> 1;
          if (j > 0) mbar_wait(rows_empty + w, (j - 1) & 1);
          int pb, sp, m0, n0;
          ws_tile<BN>(args, t, &pb, &sp, &m0, &n0);
          epi.template rows<BN>(pb + sp, m0, n0, lane, rows + w * 2 * kWsBM);
          mbar_arrive(rows_full + w);
        }
      }
    }
  } else {  // the consumer warpgroups
    setmaxnreg_inc<kWsConsumerRegs>();
    const int wg = warp / 4;  // rows 64 wg .. 64 wg + 63 of the tile
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int c_lo = 2 * (lane % 4);
    float acc[kR];
    int i = 0;
    for (int t = blockIdx.x; t < args.tiles; t += G, ++i) {
      int pb, sp, m0, n0;
      ws_tile<BN>(args, t, &pb, &sp, &m0, &n0);
      pb += sp;  // the epilogue's problem: the K range's index when K is split
#pragma unroll
      for (int x = 0; x < kR; ++x) acc[x] = 0.f;
      const int p0 = i * ktiles;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int p = p0 + kt;
        const int s = p % T::kStages;
        mbar_wait(full + s, (p / T::kStages) & 1);
        const uint8_t* a_tile = smem + s * T::kStage + wg * 64 * 128;
        const uint8_t* b_tile = smem + s * T::kStage + T::kTileA;
        fence_regs<kR>(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kWsBK / 16; ++k) {
          Wgmma<BN>::mma(acc, make_desc<128>(a_tile + 32 * k), make_desc<128>(b_tile + 32 * k), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<kR>(acc);
        if (kt > 0 && lane == 0) mbar_arrive(empty + (p - 1) % T::kStages);  // K tile kt - 1's products are done
      }
      wgmma_wait<0>();
      fence_regs<kR>(acc);
      if (lane == 0) mbar_arrive(empty + (p0 + ktiles - 1) % T::kStages);
      if constexpr (Epi::kGather) {
        const int w = i & 1;
        const int* ra = rows + w * 2 * kWsBM;
        mbar_wait(rows_full + w, (i >> 1) & 1);
        epi.template store<BN>(acc, pb, m0, n0, r0, c_lo, ra, ra + kWsBM);
        __syncwarp();
        if (lane == 0) mbar_arrive(rows_empty + w);
      } else {
        epi.template store<BN>(acc, pb, m0, n0, r0, c_lo, nullptr, nullptr);
      }
    }
  }
}

inline int ws_sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return count;
}

// Launches the products of `args` (count 1 or 2, one K) under `epi` on `stream`; with splits > 1 (count
// 1), problem 0's K cut into `splits` ranges of whole K tiles, the last ones past K reading zeros.
template <int BN, class Epi>
int launch_ws_gemm(WsArgs& args, int count, int k, const Epi& epi, cudaStream_t stream, int splits = 1) {
  using T = WsTile<BN>;
  auto kernel = ws_gemm_kernel<BN, Epi>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (ws_sm_count() <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  int tiles[2] = {0, 0};
  for (int i = 0; i < count; ++i) {
    tiles[i] = ((args.p[i].m + kWsBM - 1) / kWsBM) * ((args.p[i].n + BN - 1) / BN);
  }
  if (splits < 1 || (splits > 1 && count != 1)) return static_cast<int>(cudaErrorInvalidValue);
  args.splits = splits;
  args.tiles0 = tiles[0] * splits;
  args.tiles = args.tiles0 + tiles[1];
  args.ktiles = ((k + kWsBK - 1) / kWsBK + splits - 1) / splits;
  if (args.tiles == 0) return 0;
  const int grid = args.tiles < ws_sm_count() ? args.tiles : ws_sm_count();
  kernel<<<grid, kWsThreads, T::kSmem, stream>>>(args, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90ws
