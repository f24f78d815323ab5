// A warp-specialised, persistent Hopper (sm_90a) bf16 GEMM for the backward
// of the GNN conv (gnn_conv_bwd.cu), either operand read in its own major
// order:
//
//   out tile = epilogue(A . B),  A (M x K), B (K x N), fp32 accumulation
//
// kBMN: B is a row-major (K, N) matrix read as it lies (MN-major): the edge
// rows a_{i-1} and e of a weight gradient dW_i = dh_i^T . a_{i-1} (K = edge
// rows), a node table of the first Dense's node-level gradient, or a
// (C_out, C_in) Linear weight for an input gradient dh . W (K = C_out);
// else B is (N, K) K-major (a Linear weight for the recompute a . W^T). kAMN:
// A is read MN-major too (dh_i as (edge rows, C_out), so dh_i^T is read
// without a copy); else K-major (an input gradient's dh rows). wgmma reads a
// 16-bit operand of either major order from shared memory (the transpose
// immediates of wgmma_ops.cuh:WgmmaSST); TMA copies each operand in boxes of
// 128-byte rows (the 128-byte swizzle) straight from its natural layout. That
// is what takes the transposed copies of the chunk (and of the weights) out
// of the backward.
//
// The schedule is gemm_sm90_ws.cuh's, which the forward keeps unchanged:
//   - CTA tiles of 128 x BN (BN = 256, or 128 for widths 256 does not
//     divide), K in steps of 64; a stage is 16 KB of A and BN x 128 bytes of
//     B (48 KB at BN = 256, a ring of 4 stages);
//   - a producer warp issues every TMA copy, running ahead across tiles; two
//     consumer warpgroups, rows 0-63 and 64-127 of the tile, each issue
//     wgmma m64nBNk16 (BN / 2 accumulator registers a thread) and release a
//     stage one K tile late (wgmma.wait_group 1); setmaxnreg gives the
//     producer warpgroup 40 registers a thread and the consumers 232;
//   - a persistent grid walks the tiles of up to kMnMaxProblems products of
//     their own shapes and K in one launch (the weight gradients of every
//     Dense of a chunk; the two sides of the node-level products), each K
//     cut into `splits` fixed ranges of whole K tiles (a range's partial is
//     its own output: the epilogue gets the range's index), so the order of
//     every sum is a function of the shape and two calls give the same bits;
//   - each consumer warpgroup has 4 x BN floats of shared memory for an
//     epilogue's column sums over its 64 rows (db of an input gradient).
//
// An epilogue type provides
//   template <int BN> __device__ void store(const float* acc, int prob, int split, int m0, int n0, int r0,
//                                          int c_lo, float* sums) const;
// with acc as gemm_sm90_ws.cuh's (acc[4 j + 2 q + e] is row m0 + r0 + 8 q, column n0 + 8 j + c_lo + e; r0 / 64
// is the warpgroup's 64-row half of the tile) and sums the warpgroup's [4][BN] floats (its named barrier is 1 +
// the warpgroup's index, 128 threads). The epilogue runs from the registers while the producer loads the next
// tile; its stores are exposed to the tensor cores (a ping-pong schedule, each warpgroup on 64-row tiles of its
// own, measured slower at C = 1024: it doubles the weight slices' L2 reads per row).

#pragma once

#include "gemm_sm90_ws.cuh"  // setmaxnreg, wgmma_wait, ws_sm_count
#include "wgmma_ops.cuh"     // WgmmaSST

namespace sm90mn {

using namespace sm90;

constexpr int kMnBM = 128;
constexpr int kMnBK = 64;
constexpr int kMnBox = 64 * 128;  // bytes of one 64 x 64 bf16 box
constexpr int kMnConsumerWarps = 8;
constexpr int kMnThreads = 32 * kMnConsumerWarps + 128;
constexpr int kMnMaxProblems = 6;
constexpr int kMnRing = 196608;

template <int BN>
struct MnTile {
  static constexpr int kTileA = kMnBM * kMnBK * 2;  // 16 KB
  static constexpr int kStage = kTileA + BN * kMnBK * 2;
  static constexpr int kStages = kMnRing / kStage;  // 4 at BN = 256, 6 at BN = 128
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kSumOff = kBarOff + 2 * kStages * 8 + 64;
  static constexpr size_t kSmem = 1024 + kSumOff + 2 * 4 * BN * sizeof(float);
  static_assert(kSmem <= 232448, "over the 227 KB a block may have");
};

struct MnProblem {
  CUtensorMap a;  // kAMN: (k, m) rows, boxes of 64 x 64; else (m, k), boxes of 128 x 64
  CUtensorMap b;  // kBMN: (k, n) rows, boxes of 64 x 64; else (n, k), boxes of BN x 64
  int m, n;
  int splits;  // K ranges
  int ktiles;  // K tiles of a range
  int tile0;   // the problem's first tile
};
struct MnArgs {
  MnProblem p[kMnMaxProblems];
  int count;
  int tiles;
};

// Encodes problem `i` of `args`: A (m x k) as kAMN (k, m) rows lda apart or (m, k) rows lda apart, B (k x n) as
// kBMN (k, n) rows ldb apart or (n, k) rows ldb apart, K cut into `splits` ranges; bn the tile's columns (the
// K-major B's box rows).
template <bool kAMN, bool kBMN>
int set_mn_problem(MnArgs* args, int i, const void* a, int lda, const void* b, int ldb, int m, int n, int k,
                   int splits, int bn = 256) {
  if (i >= kMnMaxProblems || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  MnProblem* pr = &args->p[i];
  int rc = kAMN ? make_map_bf16(&pr->a, a, k, m, lda, 64, kMnBK) : make_map_bf16(&pr->a, a, m, k, lda, kMnBM, kMnBK);
  if (rc == 0) rc = kBMN ? make_map_bf16(&pr->b, b, k, n, ldb, 64, 64) : make_map_bf16(&pr->b, b, n, k, ldb, bn, kMnBK);
  pr->m = m;
  pr->n = n;
  pr->splits = splits;
  pr->ktiles = ((k + kMnBK - 1) / kMnBK + splits - 1) / splits;
  return rc;
}

template <int BN>
__device__ __forceinline__ void mn_tile(const MnArgs& args, int t, int* prob, int* split, int* m0, int* n0) {
  int pb = 0;
  while (pb + 1 < args.count && t >= args.p[pb + 1].tile0) ++pb;
  const MnProblem& pr = args.p[pb];
  const int local = t - pr.tile0;
  const int nt = (pr.n + BN - 1) / BN;
  const int per = ((pr.m + kMnBM - 1) / kMnBM) * nt;  // tiles of one K range
  *prob = pb;
  *split = local / per;
  *m0 = ((local % per) / nt) * kMnBM;
  *n0 = ((local % per) % nt) * BN;
}

template <int BN, bool kAMN, bool kBMN, class Epi>
__global__ void __launch_bounds__(kMnThreads, 1)
mn_gemm_kernel(const __grid_constant__ MnArgs args, const __grid_constant__ Epi epi) {
  using T = MnTile<BN>;
  constexpr int kR = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + T::kStages;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kMnConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kMnConsumerWarps) {  // the producer warpgroup; warp 8's lane 0 issues every copy
    sm90ws::setmaxnreg_dec<sm90ws::kWsProducerRegs>();
    if (warp == kMnConsumerWarps && lane == 0) {
      int p = 0;
      for (int t = blockIdx.x; t < args.tiles; t += G) {
        int pb, sp, m0, n0;
        mn_tile<BN>(args, t, &pb, &sp, &m0, &n0);
        const MnProblem& pr = args.p[pb];
        for (int kt = sp * pr.ktiles; kt < (sp + 1) * pr.ktiles; ++kt, ++p) {
          const int s = p % T::kStages;
          if (p >= T::kStages) mbar_wait(empty + s, ((p / T::kStages) - 1) & 1);
          uint8_t* stage = smem + s * T::kStage;
          mbar_expect_tx(full + s, T::kStage);
          if constexpr (kAMN) {
            tma_load_2d(stage, &pr.a, full + s, m0, kt * kMnBK);
            tma_load_2d(stage + kMnBox, &pr.a, full + s, m0 + 64, kt * kMnBK);
          } else {
            tma_load_2d(stage, &pr.a, full + s, kt * kMnBK, m0);
          }
          if constexpr (kBMN) {
#pragma unroll
            for (int x = 0; x < BN / 64; ++x)
              tma_load_2d(stage + T::kTileA + x * kMnBox, &pr.b, full + s, n0 + 64 * x, kt * kMnBK);
          } else {
            tma_load_2d(stage + T::kTileA, &pr.b, full + s, kt * kMnBK, n0);
          }
        }
      }
    }
  } else {  // the consumer warpgroups
    sm90ws::setmaxnreg_inc<sm90ws::kWsConsumerRegs>();
    const int wg = warp / 4;
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int c_lo = 2 * (lane % 4);
    float* sums = reinterpret_cast<float*>(smem + T::kSumOff) + wg * 4 * BN;
    float acc[kR];
    int p = 0;
    for (int t = blockIdx.x; t < args.tiles; t += G) {
      int pb, sp, m0, n0;
      mn_tile<BN>(args, t, &pb, &sp, &m0, &n0);
      const int ktiles = args.p[pb].ktiles;
#pragma unroll
      for (int x = 0; x < kR; ++x) acc[x] = 0.f;
      for (int kt = 0; kt < ktiles; ++kt, ++p) {
        const int s = p % T::kStages;
        mbar_wait(full + s, (p / T::kStages) & 1);
        const uint8_t* stage = smem + s * T::kStage;
        fence_regs<kR>(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kMnBK / 16; ++k) {
          // A: the warpgroup's 64 rows, the k16 step 16 rows (MN-major) or 32 bytes (K-major) on; B likewise
          const uint64_t da = kAMN ? make_desc_mn_bits(stage + wg * kMnBox + k * 16 * 128, 128, kMnBox)
                                   : make_desc<128>(stage + wg * 64 * 128 + 32 * k);
          const uint64_t db = kBMN ? make_desc_mn_bits(stage + T::kTileA + k * 16 * 128, 128, kMnBox)
                                   : make_desc<128>(stage + T::kTileA + 32 * k);
          WgmmaSST<BN, kAMN ? 1 : 0, kBMN ? 1 : 0>::mma(acc, da, db, 1);
        }
        wgmma_commit();
        sm90ws::wgmma_wait<1>();
        fence_regs<kR>(acc);
        if (kt > 0 && lane == 0) mbar_arrive(empty + (p - 1) % T::kStages);
      }
      sm90ws::wgmma_wait<0>();
      fence_regs<kR>(acc);
      if (ktiles > 0 && lane == 0) mbar_arrive(empty + (p - 1) % T::kStages);
      epi.template store<BN>(acc, pb, sp, m0, n0, r0, c_lo, sums);
    }
  }
}

// Launches the `count` problems of `args` (set by set_mn_problem) under `epi` on `stream`.
template <int BN, bool kAMN, bool kBMN, class Epi>
int launch_mn_gemm(MnArgs& args, int count, const Epi& epi, cudaStream_t stream) {
  using T = MnTile<BN>;
  auto kernel = mn_gemm_kernel<BN, kAMN, kBMN, Epi>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (count < 1 || count > kMnMaxProblems || sm90ws::ws_sm_count() <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    MnProblem& pr = args.p[i];
    pr.tile0 = tiles;
    if (pr.m > 0 && pr.n > 0) tiles += ((pr.m + kMnBM - 1) / kMnBM) * ((pr.n + BN - 1) / BN) * pr.splits;
  }
  args.count = count;
  args.tiles = tiles;
  if (tiles == 0) return 0;
  const int grid = tiles < sm90ws::ws_sm_count() ? tiles : sm90ws::ws_sm_count();
  kernel<<<grid, kMnThreads, T::kSmem, stream>>>(args, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90mn
