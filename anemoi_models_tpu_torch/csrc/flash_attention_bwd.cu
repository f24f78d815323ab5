// Hopper (sm_90a) backward of band-masked (sliding-window) flash attention.
//
// The gradient of anemoi_models_tpu/ops/pallas/flash_attention.py:_flash_kernel
// (the JAX package's _bwd takes jax.vjp of its blockwise twin, which XLA
// fuses). It computes the backward of ops/flash_attention.py:
// blockwise_attention at the rounding points of flash_attention_bwd_plain,
// from the forward's row statistics (flash_attention.cu writes each row's
// log-sum-exp when asked), for everything the forward takes: bf16 and fp32,
// the band |i - j| <= w or none, causal, queries and keys at offsets with
// keys outside [0, n_valid) masked (flash_common.cuh's Band), and dropout,
// whose keep bits it redraws with the forward's Philox4x32-10 at global
// positions. P = exp(S - lse_i) is recomputed per pair, the dropped weights
// P~ = keep P / (1 - p), dV = P~^T dO, dS = P (dP~ - D_i) with dP~ = keep
// (dO v_j) / (1 - p) and D_i = rowsum(dO_i * O_i) (flash_bwd_delta_kernel, a
// warp a row), dK = dS^T Q scale, dQ = dS K scale.
//
// bf16, heads of 16, 32, 64 and 128 (the wrapper pads the others up to 128):
// flash_bwd_wgmma_kernel, on the forward's building blocks (gemm_sm90.cuh's
// TMA and wgmma, flash_attention.cu's 4-D tensor maps over the strided heads).
//   - A CTA takes a block of 128 keys: two consumer warpgroups of 64 keys and
//     a producer warpgroup (setmaxnreg: 24 registers a thread for it, 240 for
//     the consumers). The producer warp copies K and V once, then, for each
//     64-query tile the block's band reaches, Q and dO by TMA into a
//     two-stage ring, and lse and D_i by its lanes.
//   - A warpgroup computes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16,
//     both operands K-major from shared memory): rows are its keys, so P~^T
//     and dS^T come out in the accumulator layout, which is the A-fragment
//     layout, and dV += P~^T dO and dK += dS^T Q run with A from registers
//     and dO, Q read MN-major from the same tiles. S, P, dP and dS are
//     computed once per pair: 10 D operations a (query, key) pair, where the
//     parent's two passes (a dK / dV pass and a dQ pass, each recomputing S
//     and dP) did 14 D.
//   - dQ: each warpgroup writes its dS^T to shared memory in the 128-byte
//     swizzle and runs dQ_part = dS K over its 64 keys (wgmma with both
//     operands MN-major); one warpgroup's part goes through shared memory to
//     the other (the two alternate by tile), which adds warpgroup 0's part and
//     warpgroup 1's and then adds their sum, scaled, to the fp32 dQ of the
//     tile in device memory. The adds to a tile are ordered by key block: a
//     per-tile counter, which the adding warpgroup waits on until the lower
//     key blocks have added (FlashAttention-3's deterministic mode; its
//     release and acquire are CUTLASS's semaphore's: one thread's red.release
//     after the warpgroup's barrier, one thread's ld.acquire before it).
//     This was chosen over a second pass that reads dS saved to device
//     memory, because dS at O96 (42 M pairs a layer) is 84 MB of bf16 that
//     would sit on a train step's peak memory. A CTA takes its key block
//     from an atomic work counter, so every lower key block of its head is
//     held by a CTA that is already running, and it walks its query tiles
//     from the last to the first: the block below reaches each tile one
//     tile earlier, so with a band a CTA rarely waits. The order of every
//     sum is fixed, so two calls give the same bits; the counters and the
//     work counter are zeroed by the caller.
//   - Bound: operations (10 D a pair at the tensor cores' rate); the
//     per-element work (masks, exp2, the dropout's Philox per pair) and the
//     dQ read-modify-write through L2 (64 x D fp32 a tile and key block)
//     stand beside the products and are not overlapped with them.
// fp32, heads up to 128 (padded to 16, 32, 64, 128): exact fp32 on the CUDA
// cores, register-tiled through shared memory like the forward's fp32 tile:
// flash_bwd_dkdv_f32_kernel (a CTA a block of 64 keys, 256 threads, each a
// 4 x 4 block of S^T and dP^T, then of dK and dV by 4 x D / 16 channels;
// the tiles stored [channel][row] with an odd row stride, so every read of a
// warp spreads over the banks) and flash_bwd_dq_f32_kernel (a CTA a block of
// 64 queries, the same for dQ): 14 D operations a pair, operation-bound at
// the 67 TFLOP/s of fp32, no atomics.
// bf16 heads above 128 and fp32 heads above 128 run the CUDA-core row
// kernels (flash_bwd_dkdv_rows_kernel, flash_bwd_dq_rows_kernel): a warp a
// key (or query) row, the dot products summed by shuffles.
//
// Bound on the H100: operations. At O96 (B*H = 4, N = 10,242, D = 64,
// w = 512) about 1,025 keys per query live in the band: 10 D per pair, 26.9
// GFLOP, 0.027 ms at the bf16 tensor-core peak, against about 47 MB of q, k,
// v, o, dO and the three fp32 gradients (0.014 ms). On an H100 SXM (700 W)
// that shape takes 0.299 ms in bf16 and 1.75 in fp32 (kernel_turns.py; the
// mma.sync design before this one: 0.45 and 15.1): 324 CTAs are 2.45 waves
// of one CTA an SM, and within a CTA the elementwise pass, the dQ
// read-modify-write and the barriers between the two warpgroups stand
// beside the products.
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"  // the band, Philox dropout
#include "gemm_sm90_ws.cuh"  // TMA, wgmma, setmaxnreg
#include "wgmma_ops.cuh"     // WgmmaSST

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;  // dO
  const float* lse;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int H, D;
  int64_t qs[3], ks[3], os[3], gs[3];  // (batch, head, row) strides; k and v share theirs
  Band band;
  float scale;
  Dropout dp;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the queries [qlo, qhi] that see keys [ja, jb] (qhi < qlo: none)
__device__ __forceinline__ void query_range(const Band& bd, int ja, int jb, int& qlo, int& qhi) {
  ja = max(ja, bd.jlo);
  jb = min(jb, bd.jhi);
  qlo = 0;
  qhi = bd.nq - 1;
  if (bd.window >= 0) {
    qlo = max(qlo, ja - bd.delta - bd.window);
    qhi = min(qhi, jb - bd.delta + bd.window);
  }
  if (bd.causal) qlo = max(qlo, ja - bd.delta);
  if (jb < ja) qhi = qlo - 1;
}

// whether query i sees key j
__device__ __forceinline__ bool live_pair(const Band& bd, int i, int j) {
  return in_band(bd, i, j, i >= 0 && i < bd.nq && j >= bd.jlo && j <= bd.jhi);
}

// D_i = rowsum(dO_i * O_i): a warp a row
template <typename T>
__global__ void __launch_bounds__(128) flash_bwd_delta_kernel(const __grid_constant__ BwdArgs a) {
  const int nq = a.band.nq;
  const int i = blockIdx.x * 4 + threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  if (i >= nq) return;
  const T* o = static_cast<const T*>(a.o) + b * a.os[0] + h * a.os[1] + i * a.os[2];
  const T* g = static_cast<const T*>(a.g) + b * a.gs[0] + h * a.gs[1] + i * a.gs[2];
  float s = 0.f;
  for (int c = threadIdx.x % 32; c < a.D; c += 32) s += to_f(o[c]) * to_f(g[c]);
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) a.delta[static_cast<int64_t>(bh) * nq + i] = s;
}

// P, the dropped weights and dS of one pair (all 0 where the pair is masked)
template <bool DROP>
__device__ __forceinline__ void pair_terms(const BwdArgs& a, int bh, int i, int j, float s, float dpv, float lse,
                                           float delta, float& pd, float& ds) {
  const Band& bd = a.band;
  if (!live_pair(bd, i, j)) {
    pd = ds = 0.f;
    return;
  }
  const float p = expf(s * a.scale - lse);
  pd = p;
  if constexpr (DROP) {
    const bool kept = keep(a.dp, bh, bd.q_pos0 + i, bd.k_pos0 + j);
    pd = kept ? p * a.dp.rscale : 0.f;
    dpv = kept ? dpv * a.dp.rscale : 0.f;
  }
  ds = p * (dpv - delta);
}

// ---------------------------------------------------------------------------
// bf16, D <= 128: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kFbKeys = 128;      // keys a CTA: two consumer warpgroups of 64
constexpr int kFbQueries = 64;    // queries a tile
constexpr int kFbStages = 2;
constexpr int kFbThreads = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int kFbProducerRegs = 24;
constexpr int kFbConsumerRegs = 240;
static_assert(128 * kFbProducerRegs + 256 * kFbConsumerRegs <= 65536, "the SM's register file");

template <int D>
struct Fb {
  static constexpr int kSw = D >= 64 ? 128 : 2 * D;   // swizzle bytes = bytes of a box row
  static constexpr int kBoxCols = kSw / 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kKBox = kFbKeys * kSw;         // one box of K or V
  static constexpr int kKVBytes = kBoxes * kKBox;
  static constexpr int kQBox = kFbQueries * kSw;      // one box of Q or dO
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kStage = 2 * kQBytes;          // Q, dO
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKVBytes;
  static constexpr int kStageOff = 2 * kKVBytes;
  static constexpr int kDs = 64 * 128;                // a warpgroup's dS^T: 64 keys x 64 queries bf16
  static constexpr int kDsOff = kStageOff + kFbStages * kStage;
  static constexpr int kX = 64 * D * 4;               // warpgroup 1's dQ part, fp32
  static constexpr int kXOff = kDsOff + 2 * kDs;
  static constexpr int kStatsOff = kXOff + 2 * kX;    // per stage: lse, D_i of the tile's 64 queries
  static constexpr int kBarOff = kStatsOff + kFbStages * 2 * kFbQueries * 4;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (2 * kFbStages + 1) + 16;
  static_assert(kSmem <= 232448, "over the 227 KB a block may have");
};

struct FbMaps {
  CUtensorMap q, k, v, g;  // (D, N, H, B) bf16, boxes of kBoxCols x rows
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// waits until *ctr reaches target; a wait past 20 s (a broken order, not a slow card) ends the kernel with an
// error rather than a hang
__device__ __forceinline__ void wait_count(const int* ctr, int target) {
  const uint64_t t0 = global_ns();
  while (ld_acquire(ctr) < target) {
    if (global_ns() - t0 > 20000000000ull) __trap();
  }
}

// *ctr += 1, ordered after every write this thread saw (the warpgroup's, through the barrier before it)
__device__ __forceinline__ void add_release(int* ctr) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(ctr) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the first key block (of kFbKeys) that a query tile's band reaches
__device__ __forceinline__ int first_key_block(const Band& bd, int i0) {
  int lo, hi;
  key_range(bd, i0, min(i0 + kFbQueries, bd.nq) - 1, lo, hi);
  return lo / kFbKeys;
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kFbThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ FbMaps maps, const __grid_constant__ BwdArgs a,
                       int* __restrict__ counters) {
  using F = Fb<D>;
  const Band& bd = a.band;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::kBarOff);
  uint64_t* empty = full + kFbStages;
  uint64_t* kv_bar = empty + kFbStages;
  int* work = reinterpret_cast<int*>(kv_bar + 1);
  float* stats = reinterpret_cast<float*>(smem + F::kStatsOff);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kFbStages; ++s) {
      sm90::mbar_init(full + s, 32);  // the producer warp's lanes: lane 0's with the bytes
      sm90::mbar_init(empty + s, 8);  // a consumer warp each
    }
    sm90::mbar_init(kv_bar, 1);
    sm90::fence_barrier_init();
    *work = atomicAdd(counters, 1);  // the key blocks in the order the CTAs start
  }
  __syncthreads();
  const int nkb = (bd.nk + kFbKeys - 1) / kFbKeys;
  const int nqt = (bd.nq + kFbQueries - 1) / kFbQueries;
  const int bh = *work / nkb, kb = *work % nkb;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = kb * kFbKeys;
  int qlo, qhi;
  query_range(bd, k0, min(k0 + kFbKeys, bd.nk) - 1, qlo, qhi);
  const int t_hi = qhi / kFbQueries;
  const int ntiles = qlo <= qhi ? t_hi - qlo / kFbQueries + 1 : 0;  // walked from t_hi down

  if (tid >= 256) {  // the producer warpgroup
    sm90ws::setmaxnreg_dec<kFbProducerRegs>();
    if (tid < 256 + 32) {
      const int lane = tid - 256;
      if (lane == 0) {
        sm90::mbar_expect_tx(kv_bar, 2 * F::kKVBytes);
        for (int x = 0; x < F::kBoxes; ++x) {
          sm90::tma_load_4d(smem + F::kKOff + x * F::kKBox, &maps.k, kv_bar, x * F::kBoxCols, k0, h, b);
          sm90::tma_load_4d(smem + F::kVOff + x * F::kKBox, &maps.v, kv_bar, x * F::kBoxCols, k0, h, b);
        }
      }
      const float* lse = a.lse + static_cast<int64_t>(bh) * bd.nq;
      const float* delta = a.delta + static_cast<int64_t>(bh) * bd.nq;
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kFbStages;
        const int i0 = (t_hi - it) * kFbQueries;
        if (it >= kFbStages) sm90::mbar_wait(empty + s, ((it / kFbStages) - 1) & 1);
        float* st = stats + s * 2 * kFbQueries;
#pragma unroll
        for (int r = lane; r < kFbQueries; r += 32) {
          st[r] = i0 + r < bd.nq ? lse[i0 + r] : 0.f;
          st[kFbQueries + r] = i0 + r < bd.nq ? delta[i0 + r] : 0.f;
        }
        if (lane == 0) {
          uint8_t* stage = smem + F::kStageOff + s * F::kStage;
          sm90::mbar_expect_tx(full + s, F::kStage);
          for (int x = 0; x < F::kBoxes; ++x) {
            sm90::tma_load_4d(stage + x * F::kQBox, &maps.q, full + s, x * F::kBoxCols, i0, h, b);
            sm90::tma_load_4d(stage + F::kQBytes + x * F::kQBox, &maps.g, full + s, x * F::kBoxCols, i0, h, b);
          }
        } else {
          sm90::mbar_arrive(full + s);
        }
      }
    }
  } else {  // the consumer warpgroups: keys k0 + 64 wg ..
    sm90ws::setmaxnreg_inc<kFbConsumerRegs>();
    const int wg = tid / 128, t = tid % 128, warp4 = t / 32, lane = tid % 32;
    const int kr = 16 * warp4 + lane / 4;   // the thread's key rows in the warpgroup's 64: kr, kr + 8
    const int kja = k0 + 64 * wg + kr;      // and their keys: kja, kja + 8
    const int c2 = 2 * (lane % 4);
    const float sl2 = a.scale * kLog2e;
    const uint8_t* k_wg = smem + F::kKOff + wg * 64 * F::kSw;  // the warpgroup's rows of box 0
    const uint8_t* v_wg = smem + F::kVOff + wg * 64 * F::kSw;
    uint8_t* ds_tile = smem + F::kDsOff + wg * F::kDs;
    float* xs = reinterpret_cast<float*>(smem + F::kXOff);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dk[r] = dv[r] = 0.f;
    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kFbStages;
      const int tq = t_hi - it, i0 = tq * kFbQueries;
      const uint8_t* q_st = smem + F::kStageOff + s * F::kStage;
      const uint8_t* g_st = q_st + F::kQBytes;
      const float* st = stats + s * 2 * kFbQueries;
      sm90::mbar_wait(full + s, (it / kFbStages) & 1);
      // S^T = K Q^T and dP^T = V dO^T: rows the warpgroup's 64 keys, columns the tile's 64 queries
      float sacc[32], pacc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sacc[r] = pacc[r] = 0.f;
      sm90::fence_regs<32>(sacc);
      sm90::fence_regs<32>(pacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = (kk * 16) / F::kBoxCols;
        const int off = ((kk * 16) % F::kBoxCols) * 2;
        sm90::Wgmma<64>::mma(sacc, sm90::make_desc<F::kSw>(k_wg + box * F::kKBox + off),
                             sm90::make_desc<F::kSw>(q_st + box * F::kQBox + off), kk > 0);
        sm90::Wgmma<64>::mma(pacc, sm90::make_desc<F::kSw>(v_wg + box * F::kKBox + off),
                             sm90::make_desc<F::kSw>(g_st + box * F::kQBox + off), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs<32>(sacc);
      sm90::fence_regs<32>(pacc);
      // register r: key kja + 8 ((r / 2) % 2), query i0 + 8 (r / 4) + c2 + r % 2; P~^T and dS^T rounded as the A
      // fragments of the next products (fragment k16 step r / 8, word (r % 8) / 2). A tile whose every pair
      // of this warpgroup is live (inside the band, the valid keys and the query rows) evaluates no mask.
      const int kw = k0 + 64 * wg;  // the warpgroup's first key
      bool whole = i0 + kFbQueries <= bd.nq && kw >= bd.jlo && kw + 63 <= bd.jhi;
      if (bd.window >= 0)
        whole = whole && kw + 63 - (i0 + bd.delta) <= bd.window && i0 + kFbQueries - 1 + bd.delta - kw <= bd.window;
      if (bd.causal) whole = whole && kw + 63 <= i0 + bd.delta;
      uint32_t pf[4][4], sf[4][4];
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int kj = kja + 8 * ((r / 2) % 2);
        const int ql = 8 * (r / 4) + c2;
        float pd[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = i0 + ql + e;
          const float lse = st[ql + e], delta = st[kFbQueries + ql + e];
          float p = 0.f, dpv = pacc[r + e];
          if (whole || live_pair(bd, qi, kj)) p = exp2f(fmaf(sacc[r + e], sl2, -lse * kLog2e));
          pd[e] = p;
          if constexpr (DROP) {
            const bool kept = keep(a.dp, bh, bd.q_pos0 + qi, bd.k_pos0 + kj);
            pd[e] = kept ? p * a.dp.rscale : 0.f;
            dpv = kept ? dpv * a.dp.rscale : 0.f;
          }
          ds[e] = p * (dpv - delta);
        }
        pf[r / 8][(r % 8) / 2] = pack_bf16(pd[0], pd[1]);
        sf[r / 8][(r % 8) / 2] = pack_bf16(ds[0], ds[1]);
      }
      // dS^T into this warpgroup's tile: row = key, 64 queries of 2 bytes in the 128-byte swizzle (the A operand
      // of dQ = dS K, MN-major); word w = 2 j + hf of the fragments holds key kr + 8 hf, queries 8 j + c2, + 1
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(ds_tile + sm90::swizzle<128>((kr + 8 * hf) * 128 + (8 * j + c2) * 2)) =
              sf[j / 2][2 * (j % 2) + hf];
      // dV += P~^T dO and dK += dS^T Q, dO and Q read MN-major
      sm90::fence_regs<D / 2>(dv);
      sm90::fence_regs<D / 2>(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFbQueries / 16; ++kk) {
        sm90::WgmmaRS<D>::mma(dv, pf[kk], sm90::make_desc_mn_bits(g_st + kk * 16 * F::kSw, F::kSw, F::kQBox), 1);
        sm90::WgmmaRS<D>::mma(dk, sf[kk], sm90::make_desc_mn_bits(q_st + kk * 16 * F::kSw, F::kSw, F::kQBox), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs<D / 2>(dv);
      sm90::fence_regs<D / 2>(dk);
      if (lane == 0) sm90::mbar_arrive(empty + s);  // Q and dO of this stage are read
      sm90::fence_proxy_async();                    // the dS^T stores, visible to wgmma
      sm90::named_barrier(1 + wg, 128);
      // dQ part = dS K over the warpgroup's keys: A = dS^T, B = K (rows = keys), both MN-major
      float dq[D / 2];
#pragma unroll
      for (int r = 0; r < D / 2; ++r) dq[r] = 0.f;
      sm90::fence_regs<D / 2>(dq);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk)
        sm90::WgmmaSST<D, 1, 1>::mma(dq, sm90::make_desc_mn_bits(ds_tile + kk * 16 * 128, 128, F::kDs),
                                     sm90::make_desc_mn_bits(k_wg + kk * 16 * F::kSw, F::kSw, F::kKBox), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs<D / 2>(dq);
      // dQ of the tile: one warpgroup's part through shared memory (two buffers by the tile's parity) to the
      // other, which adds (warpgroup 0's part + warpgroup 1's) scale to dq after the lower key blocks have added
      // theirs; the two trade roles by the tile's parity, so each waits and adds on every other tile
      float* x = xs + (it & 1) * (D / 2) * 128;
      const int adder = it & 1;
      if (wg != adder) {
#pragma unroll
        for (int r = 0; r < D / 2; ++r) x[r * 128 + t] = dq[r];
      }
      sm90::named_barrier(3, 256);
      if (wg == adder) {
        int* ctr = counters + 1 + static_cast<int64_t>(bh) * nqt + tq;
        if (t == 0) wait_count(ctr, kb - first_key_block(bd, i0));
        sm90::named_barrier(4 + wg, 128);
        // register r: query i0 + 16 warp4 + lane / 4 + 8 ((r / 2) % 2), channel 8 (r / 4) + c2 + r % 2
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int qi = i0 + 16 * warp4 + lane / 4 + 8 * hf;
          if (qi >= bd.nq) continue;
          float* row = a.dq + (static_cast<int64_t>(bh) * bd.nq + qi) * D;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            float2* p = reinterpret_cast<float2*>(row + 8 * j + c2);
            const float2 old = __ldcg(p);
            const int r = 4 * j + 2 * hf;
            const float2 o = make_float2(x[r * 128 + t], x[(r + 1) * 128 + t]);  // the other warpgroup's part
            const float2 p0 = wg == 0 ? make_float2(dq[r], dq[r + 1]) : o, p1 = wg == 0 ? o : make_float2(dq[r], dq[r + 1]);
            __stcg(p, make_float2(old.x + (p0.x + p1.x) * a.scale, old.y + (p0.y + p1.y) * a.scale));
          }
        }
        sm90::named_barrier(4 + wg, 128);
        if (t == 0) add_release(ctr);
      }
    }
    // dK (scaled) and dV of the thread's two keys
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = kja + 8 * hf;
      if (j >= bd.nk) continue;
      float* dkr = a.dk + (static_cast<int64_t>(bh) * bd.nk + j) * D;
      float* dvr = a.dv + (static_cast<int64_t>(bh) * bd.nk + j) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(dkr + 8 * n + c2) = make_float2(dk[4 * n + 2 * hf] * a.scale, dk[4 * n + 2 * hf + 1] * a.scale);
        *reinterpret_cast<float2*>(dvr + 8 * n + c2) = make_float2(dv[4 * n + 2 * hf], dv[4 * n + 2 * hf + 1]);
      }
    }
  }
}

template <int D, bool DROP>
int launch_wgmma(const BwdArgs& a, int B, int BH, int* counters, cudaStream_t s) {
  using F = Fb<D>;
  FbMaps maps;
  const Band& bd = a.band;
  const int64_t qdims[4] = {D, bd.nq, a.H, B};
  const int64_t kdims[4] = {D, bd.nk, a.H, B};
  const int64_t qst[3] = {a.qs[2], a.qs[1], a.qs[0]};
  const int64_t kst[3] = {a.ks[2], a.ks[1], a.ks[0]};
  const int64_t gst[3] = {a.gs[2], a.gs[1], a.gs[0]};
  int rc = sm90::make_map_bf16_4d(&maps.q, a.q, qdims, qst, kFbQueries, F::kBoxCols);
  if (rc == 0) rc = sm90::make_map_bf16_4d(&maps.g, a.g, qdims, gst, kFbQueries, F::kBoxCols);
  if (rc == 0) rc = sm90::make_map_bf16_4d(&maps.k, a.k, kdims, kst, kFbKeys, F::kBoxCols);
  if (rc == 0) rc = sm90::make_map_bf16_4d(&maps.v, a.v, kdims, kst, kFbKeys, F::kBoxCols);
  if (rc != 0) return rc;
  auto kernel = flash_bwd_wgmma_kernel<D, DROP>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(F::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nkb = (bd.nk + kFbKeys - 1) / kFbKeys;
  kernel<<<BH * nkb, kFbThreads, F::kSmem, s>>>(maps, a, counters);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32, D <= 128: register tiles on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kT32Rows = 64;      // keys (dK, dV) or queries (dQ) a CTA, and the rows of a walked tile
constexpr int kT32Threads = 256;  // 16 x 16: ty a group of 4 rows (ty + 16 i), tx a group of columns (tx + 16 j)

template <int D>
struct T32 {
  static constexpr int kLd = kT32Rows + 1;  // [channel][row] tiles: an odd stride, so a warp's reads spread over banks
  static constexpr int kLdP = kT32Rows + 4;  // [row][row] tiles of P and dS
  static constexpr int kTile = D * kLd;
  static constexpr size_t kBytes = (4 * static_cast<size_t>(kTile) + 2 * kT32Rows * kLdP + 2 * kT32Rows) * 4;
  static_assert(kBytes <= 232448, "over the 227 KB a block may have");
};

// rows [r0, r0 + 64) of an (n, D) head matrix, rows sn apart, into a [channel][row] tile (rows outside [0, n) as 0)
template <int D>
__device__ __forceinline__ void load_t32(float* tile, const float* src, int64_t sn, int r0, int n) {
  constexpr int kV = D / 4;
  for (int idx = threadIdx.x; idx < kT32Rows * kV; idx += kT32Threads) {
    const int r = idx / kV, c = (idx % kV) * 4;
    const bool ok = r0 + r >= 0 && r0 + r < n;
    const float4 v = ok ? *reinterpret_cast<const float4*>(src + (r0 + r) * sn + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    tile[(c + 0) * T32<D>::kLd + r] = v.x;
    tile[(c + 1) * T32<D>::kLd + r] = v.y;
    tile[(c + 2) * T32<D>::kLd + r] = v.z;
    tile[(c + 3) * T32<D>::kLd + r] = v.w;
  }
}

// x[i][j] = sum over channels of A[:, ty + 16 i] B[:, tx + 16 j], for two pairs of [channel][row] tiles at once
template <int D>
__device__ __forceinline__ void tile_dots(const float* A0, const float* B0, const float* A1, const float* B1,
                                          float (&x0)[4][4], float (&x1)[4][4], int ty, int tx) {
  constexpr int kLd = T32<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x0[i][j] = x1[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a0[4], b0[4], a1[4], b1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a0[i] = A0[d * kLd + ty + 16 * i];
      a1[i] = A1[d * kLd + ty + 16 * i];
      b0[i] = B0[d * kLd + tx + 16 * i];
      b1[i] = B1[d * kLd + tx + 16 * i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x0[i][j] = fmaf(a0[i], b0[j], x0[i][j]);
        x1[i][j] = fmaf(a1[i], b1[j], x1[i][j]);
      }
  }
}

// dK and dV of a block of 64 keys: the query tiles its band reaches
template <int D, bool DROP>
__global__ void __launch_bounds__(kT32Threads) flash_bwd_dkdv_f32_kernel(const __grid_constant__ BwdArgs a) {
  using L = T32<D>;
  extern __shared__ __align__(16) float sm32[];
  float* Kt = sm32;
  float* Vt = Kt + L::kTile;
  float* Qt = Vt + L::kTile;
  float* Gt = Qt + L::kTile;
  float* Ps = Gt + L::kTile;  // [query][key]
  float* Ss = Ps + kT32Rows * L::kLdP;
  float* Ls = Ss + kT32Rows * L::kLdP;
  float* Ds = Ls + kT32Rows;
  const Band& bd = a.band;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int j0 = blockIdx.x * kT32Rows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.ks[0] + h * a.ks[1];
  const float* go = static_cast<const float*>(a.g) + b * a.gs[0] + h * a.gs[1];
  const float* lse = a.lse + static_cast<int64_t>(bh) * bd.nq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * bd.nq;
  load_t32<D>(Kt, k, a.ks[2], j0, bd.nk);
  load_t32<D>(Vt, v, a.ks[2], j0, bd.nk);
  int qlo, qhi;
  query_range(bd, j0, min(j0 + kT32Rows, bd.nk) - 1, qlo, qhi);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;
  for (int i0 = qlo; i0 <= qhi; i0 += kT32Rows) {
    __syncthreads();  // the previous tile is consumed
    load_t32<D>(Qt, q, a.qs[2], i0, bd.nq);
    load_t32<D>(Gt, go, a.gs[2], i0, bd.nq);
    if (threadIdx.x < kT32Rows) {
      const int i = i0 + threadIdx.x;
      Ls[threadIdx.x] = i < bd.nq ? lse[i] : 0.f;
      Ds[threadIdx.x] = i < bd.nq ? delta[i] : 0.f;
    }
    __syncthreads();
    // S^T and dP^T: keys ty + 16 i, queries tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<D>(Kt, Qt, Vt, Gt, s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tx + 16 * j, kl = ty + 16 * i;
        float pd, ds;
        pair_terms<DROP>(a, bh, i0 + ql, j0 + kl, s[i][j], dp[i][j], Ls[ql], Ds[ql], pd, ds);
        Ps[ql * L::kLdP + kl] = pd;
        Ss[ql * L::kLdP + kl] = ds;
      }
    __syncthreads();
    // dV += P~^T dO and dK += dS^T Q: keys ty + 16 i, channels tx + 16 c
#pragma unroll 4
    for (int ql = 0; ql < kT32Rows; ++ql) {
      float p[4], sd[4], g[D / 16], qv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[ql * L::kLdP + ty + 16 * i];
        sd[i] = Ss[ql * L::kLdP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        g[c] = Gt[(tx + 16 * c) * L::kLd + ql];
        qv[c] = Qt[(tx + 16 * c) * L::kLd + ql];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          dv[i][c] = fmaf(p[i], g[c], dv[i][c]);
          dk[i][c] = fmaf(sd[i], qv[c], dk[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + ty + 16 * i;
    if (j >= bd.nk) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      a.dk[(static_cast<int64_t>(bh) * bd.nk + j) * D + tx + 16 * c] = dk[i][c] * a.scale;
      a.dv[(static_cast<int64_t>(bh) * bd.nk + j) * D + tx + 16 * c] = dv[i][c];
    }
  }
}

// dQ of a block of 64 queries: the key tiles its band reaches
template <int D, bool DROP>
__global__ void __launch_bounds__(kT32Threads) flash_bwd_dq_f32_kernel(const __grid_constant__ BwdArgs a) {
  using L = T32<D>;
  extern __shared__ __align__(16) float sm32[];
  float* Qt = sm32;
  float* Gt = Qt + L::kTile;
  float* Kt = Gt + L::kTile;
  float* Vt = Kt + L::kTile;
  float* Ss = Vt + L::kTile;  // [key][query]
  float* Ls = Ss + 2 * kT32Rows * L::kLdP;
  float* Ds = Ls + kT32Rows;
  const Band& bd = a.band;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int i0 = blockIdx.x * kT32Rows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.ks[0] + h * a.ks[1];
  const float* go = static_cast<const float*>(a.g) + b * a.gs[0] + h * a.gs[1];
  load_t32<D>(Qt, q, a.qs[2], i0, bd.nq);
  load_t32<D>(Gt, go, a.gs[2], i0, bd.nq);
  if (threadIdx.x < kT32Rows) {
    const int i = i0 + threadIdx.x;
    Ls[threadIdx.x] = i < bd.nq ? a.lse[static_cast<int64_t>(bh) * bd.nq + i] : 0.f;
    Ds[threadIdx.x] = i < bd.nq ? a.delta[static_cast<int64_t>(bh) * bd.nq + i] : 0.f;
  }
  int lo, hi;
  key_range(bd, i0, min(i0 + kT32Rows, bd.nq) - 1, lo, hi);
  float dq[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[i][c] = 0.f;
  for (int j0 = lo; j0 <= hi; j0 += kT32Rows) {
    __syncthreads();
    load_t32<D>(Kt, k, a.ks[2], j0, bd.nk);
    load_t32<D>(Vt, v, a.ks[2], j0, bd.nk);
    __syncthreads();
    // S and dP: queries ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
    tile_dots<D>(Qt, Kt, Gt, Vt, s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = ty + 16 * i, kl = tx + 16 * j;
        float pd, ds;
        pair_terms<DROP>(a, bh, i0 + ql, j0 + kl, s[i][j], dp[i][j], Ls[ql], Ds[ql], pd, ds);
        Ss[kl * L::kLdP + ql] = ds;
      }
    __syncthreads();
    // dQ += dS K: queries ty + 16 i, channels tx + 16 c
#pragma unroll 4
    for (int kl = 0; kl < kT32Rows; ++kl) {
      float sd[4], kv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) sd[i] = Ss[kl * L::kLdP + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) kv[c] = Kt[(tx + 16 * c) * L::kLd + kl];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < D / 16; ++c) dq[i][c] = fmaf(sd[i], kv[c], dq[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = i0 + ty + 16 * i;
    if (qi >= bd.nq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) a.dq[(static_cast<int64_t>(bh) * bd.nq + qi) * D + tx + 16 * c] = dq[i][c] * a.scale;
  }
}

template <int D, bool DROP>
int launch_f32_tiles(const BwdArgs& a, int BH, cudaStream_t s) {
  using L = T32<D>;
  auto dkdv = flash_bwd_dkdv_f32_kernel<D, DROP>;
  auto dq = flash_bwd_dq_f32_kernel<D, DROP>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
    return e != cudaSuccess ? e : cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       static_cast<int>(L::kBytes));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dkdv<<<dim3((a.band.nk + kT32Rows - 1) / kT32Rows, BH), kT32Threads, L::kBytes, s>>>(a);
  dq<<<dim3((a.band.nq + kT32Rows - 1) / kT32Rows, BH), kT32Threads, L::kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 and wide heads: a warp a row on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 4;

// dQ of query i: lane l owns channels l, l + 32, ... below D
template <typename T, int NV, bool DROP>
__global__ void __launch_bounds__(32 * kRowWarps) flash_bwd_dq_rows_kernel(const __grid_constant__ BwdArgs a) {
  const Band& bd = a.band;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  if (i >= bd.nq) return;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1] + i * a.qs[2];
  const T* go = static_cast<const T*>(a.g) + b * a.gs[0] + h * a.gs[1] + i * a.gs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.ks[0] + h * a.ks[1];
  float qv[NV], gv[NV], acc[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int ch = lane + 32 * c;
    qv[c] = ch < a.D ? to_f(q[ch]) : 0.f;
    gv[c] = ch < a.D ? to_f(go[ch]) : 0.f;
    acc[c] = 0.f;
  }
  const float lse = a.lse[static_cast<int64_t>(bh) * bd.nq + i];
  const float delta = a.delta[static_cast<int64_t>(bh) * bd.nq + i];
  int lo, hi;
  key_range(bd, i, i, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    float kr[NV], s = 0.f, dpv = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int ch = lane + 32 * c;
      kr[c] = ch < a.D ? to_f(k[j * a.ks[2] + ch]) : 0.f;
      s = fmaf(qv[c], kr[c], s);
      dpv = fmaf(gv[c], ch < a.D ? to_f(v[j * a.ks[2] + ch]) : 0.f, dpv);
    }
    s = warp_sum(s);
    dpv = warp_sum(dpv);
    float pd, ds;
    pair_terms<DROP>(a, bh, i, j, s, dpv, lse, delta, pd, ds);
    ds = to_f(from_f<T>(ds));
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[c] = fmaf(ds, kr[c], acc[c]);
  }
  float* dq = a.dq + (static_cast<int64_t>(bh) * bd.nq + i) * a.D;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int ch = lane + 32 * c;
    if (ch < a.D) dq[ch] = acc[c] * a.scale;
  }
}

// dK and dV of key j
template <typename T, int NV, bool DROP>
__global__ void __launch_bounds__(32 * kRowWarps) flash_bwd_dkdv_rows_kernel(const __grid_constant__ BwdArgs a) {
  const Band& bd = a.band;
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  if (j >= bd.nk) return;
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1] + j * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.ks[0] + h * a.ks[1] + j * a.ks[2];
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* go = static_cast<const T*>(a.g) + b * a.gs[0] + h * a.gs[1];
  float kv[NV], vv[NV], dk[NV], dv[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int ch = lane + 32 * c;
    kv[c] = ch < a.D ? to_f(k[ch]) : 0.f;
    vv[c] = ch < a.D ? to_f(v[ch]) : 0.f;
    dk[c] = dv[c] = 0.f;
  }
  int qlo, qhi;
  query_range(bd, j, j, qlo, qhi);
  for (int i = qlo; i <= qhi; ++i) {
    float qr[NV], gr[NV], s = 0.f, dpv = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int ch = lane + 32 * c;
      qr[c] = ch < a.D ? to_f(q[i * a.qs[2] + ch]) : 0.f;
      gr[c] = ch < a.D ? to_f(go[i * a.gs[2] + ch]) : 0.f;
      s = fmaf(qr[c], kv[c], s);
      dpv = fmaf(gr[c], vv[c], dpv);
    }
    s = warp_sum(s);
    dpv = warp_sum(dpv);
    float pd, ds;
    pair_terms<DROP>(a, bh, i, j, s, dpv, a.lse[static_cast<int64_t>(bh) * bd.nq + i],
                     a.delta[static_cast<int64_t>(bh) * bd.nq + i], pd, ds);
    pd = to_f(from_f<T>(pd));
    ds = to_f(from_f<T>(ds));
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      dv[c] = fmaf(pd, gr[c], dv[c]);
      dk[c] = fmaf(ds, qr[c], dk[c]);
    }
  }
  float* dkr = a.dk + (static_cast<int64_t>(bh) * bd.nk + j) * a.D;
  float* dvr = a.dv + (static_cast<int64_t>(bh) * bd.nk + j) * a.D;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int ch = lane + 32 * c;
    if (ch < a.D) {
      dkr[ch] = dk[c] * a.scale;
      dvr[ch] = dv[c];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int NV, bool DROP>
int launch_rows(const BwdArgs& a, int BH, cudaStream_t s) {
  flash_bwd_dkdv_rows_kernel<T, NV, DROP>
      <<<dim3((a.band.nk + kRowWarps - 1) / kRowWarps, BH), 32 * kRowWarps, 0, s>>>(a);
  flash_bwd_dq_rows_kernel<T, NV, DROP><<<dim3((a.band.nq + kRowWarps - 1) / kRowWarps, BH), 32 * kRowWarps, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DROP>
int launch_grads(const BwdArgs& a, int B, int BH, int* counters, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (a.D <= 128 && counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    switch (a.D) {
      case 16: return launch_wgmma<16, DROP>(a, B, BH, counters, s);
      case 32: return launch_wgmma<32, DROP>(a, B, BH, counters, s);
      case 64: return launch_wgmma<64, DROP>(a, B, BH, counters, s);
      case 128: return launch_wgmma<128, DROP>(a, B, BH, counters, s);
      default: break;
    }
  } else {
    switch (a.D) {
      case 16: return launch_f32_tiles<16, DROP>(a, BH, s);
      case 32: return launch_f32_tiles<32, DROP>(a, BH, s);
      case 64: return launch_f32_tiles<64, DROP>(a, BH, s);
      case 128: return launch_f32_tiles<128, DROP>(a, BH, s);
      default: break;
    }
  }
  if (a.D <= 128) return static_cast<int>(cudaErrorInvalidValue);  // the wrapper pads every width up to 128
  if (a.D <= 256) return launch_rows<T, 8, DROP>(a, BH, s);
  if (a.D <= 512) return launch_rows<T, 16, DROP>(a, BH, s);
  if (a.D <= 1024) return launch_rows<T, 32, DROP>(a, BH, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                     float* delta, float* dq, float* dk, float* dv, int B, int H, int Nq, int Nk, int D,
                     const int64_t qs[3], const int64_t ks[3], const int64_t os[3], const int64_t gs[3], int window,
                     int causal, int q_pos0, int k_pos0, int n_valid, float scale, const Dropout& dp, int* counters,
                     cudaStream_t s) {
  if (D <= 0 || D > 1024 || B * H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, o, g, lse, delta, dq, dk, dv, H, D, {qs[0], qs[1], qs[2]}, {ks[0], ks[1], ks[2]},
            {os[0], os[1], os[2]}, {gs[0], gs[1], gs[2]},
            make_band(Nq, Nk, window, causal, q_pos0, k_pos0, n_valid, qs, ks), scale, dp};
  const int BH = B * H;
  flash_bwd_delta_kernel<T><<<dim3((Nq + 3) / 4, BH), 128, 0, s>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return dp.on ? launch_grads<T, true>(a, B, BH, counters, s) : launch_grads<T, false>(a, B, BH, counters, s);
}

}  // namespace

extern "C" {

// q (B, H, Nq, D), k, v (B, H, Nk, D), o and dO (B, H, Nq, D) by their (batch, head, row) strides (channels
// contiguous, 16-byte rows); lse (B, H, Nq) fp32 from the forward; delta (B, H, Nq) fp32 scratch; dq, dk, dv
// contiguous fp32 outputs: dq zeroed by the caller (a query that sees no key keeps 0; the bf16 kernel adds to
// it), dk and dv written for every key; counters: for bf16 heads up to 128, 1 + B H ceil(Nq / 64) int32 zeroed
// by the caller (the work counter, then each query tile's), else unused; the band, offsets and dropout as
// flash_attention.cu's entry points take them
#define FLASH_BWD_ENTRY(name, T)                                                                                   \
  int name(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,            \
           float* delta, float* dq, float* dk, float* dv, int B, int H, int Nq, int Nk, int D, int64_t qsb,          \
           int64_t qsh, int64_t qsn, int64_t ksb, int64_t ksh, int64_t ksn, int64_t osb, int64_t osh, int64_t osn,    \
           int64_t gsb, int64_t gsh, int64_t gsn, int window, int causal, int q_pos0, int k_pos0, int n_valid,        \
           float scale, int dropout, uint32_t keep_below, uint32_t k0, uint32_t k1, float rscale, int* counters,      \
           void* stream) {                                                                                         \
    const int64_t qs[3] = {qsb, qsh, qsn}, ks[3] = {ksb, ksh, ksn}, os[3] = {osb, osh, osn}, gs[3] = {gsb, gsh, gsn}; \
    return launch_flash_bwd<T>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Nq, Nk, D, qs, ks, os, gs, window,     \
                               causal, q_pos0, k_pos0, n_valid, scale, Dropout{dropout, keep_below, k0, k1, rscale}, \
                               counters, static_cast<cudaStream_t>(stream));                                         \
  }

FLASH_BWD_ENTRY(flash_attn_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attn_bwd_bf16, bf16)

#undef FLASH_BWD_ENTRY

}  // extern "C"
