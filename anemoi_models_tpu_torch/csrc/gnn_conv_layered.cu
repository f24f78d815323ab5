// Hopper (sm_90a) kernels of the GNN edge-MLP convolution's layered route:
// every width C % 8 == 0 and every MLP depth that gnn_conv.cu's fused kernels
// do not take (they take C in {32, 64, 128, 256} with three Dense layers);
// the wrapper pads any other width to a multiple of 8 with zero columns, and
// the LayerNorm's statistics run over the true width. The production width,
// C = 1024 (anemoi_models_tpu/configs.py), runs here.
//
// Replaces anemoi_models_tpu/ops/pallas/gnn_conv.py:_kernel (launched by
// slot_gnn_pallas) as gnn_conv.cu does, and computes the same function with
// the same rounding points as ops/gnn_conv.py:gnn_conv_plain:
//
//   pre-pass        P_dst = x_dst . W0[:, 0:C]^T + b0, P_src = x_src .
//                   W0[:, C:2C]^T, fp32, once per node, one launch
//   per chunk of consecutive CSR edge rows (a fixed count the wrapper
//   sets, so the scratch is bounded and the work order fixed):
//     gnn_rows_kernel (bf16)          each row's P_dst and P_src rows, into the chunk's h scratch
//     Dense 0 (gnn_dense0_tag)        H = act((e . W0[:, 2C:3C]^T + P_dst[dst]) + P_src[src]), rounded
//     hidden Dense (gnn_dense_tag)    H = act(H . Wi^T + bi), rounded, once per hidden Dense
//                                     after the first (ping-pong between two buffers)
//     last Dense (gnn_dense_last_tag) h = H . Wlast^T + blast, fp32
//     LayerNorm pass                  msg = round(LN(h)) * gamma + beta + e (fp32 statistics,
//                                     eps 1e-6), rounded at the points of gnn_conv.cu
//                                     (gnn_ln_kernel; in bf16 gnn_ln_kernel_regs up to C = 2048)
//   sum  the per-destination fp32 sum of the whole msg in edge order (gnn_common.cuh's
//        gnn_agg_kernel, 16-byte loads)
//
// Why not grow the fused kernel: its bf16 message kernel holds a 64 x C fp32
// accumulator per warpgroup (C / 2 registers a thread, 255 with 480 bytes of
// spills at C = 256) and 227 KB of shared memory at C = 256; its fp32 kernel
// 8 rows x C / 32 columns a thread. None of it scales to C = 1024. Here each
// Dense is one GEMM over the whole chunk, so every width tiles the same way.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations. Each Dense is
// 2 C^2 per edge and the pre-pass 2 * 2 C^2 per node. At C = 1024 in bf16,
// with three Dense, on the O96 sets (chip_smoke.py:gnn_bound):
//   processor (81,900 edges, 10,242 nodes, self-graph): 558 GFLOP, 0.564 ms;
//     409 MB read and written once, 0.122 ms
//   encoder (376,228 edges, 40,320 -> 10,242): 2,473 GFLOP, 2.50 ms; 1.70 GB, 0.51 ms
//   decoder (120,960 edges, 10,242 -> 40,320): 867 GFLOP, 0.877 ms; 775 MB, 0.23 ms
// The chain moves more than that: per edge row e (2C bytes) read twice, each
// Dense's output written and read again (2C each in bf16, 4C for the fp32 h),
// msg written and read by the sum, and the gathered P rows (8C): about 32C
// bytes a row, 2.7 GB on the processor's set (0.8 ms at 3.35 TB/s), most of
// it under the Dense kernels' products.
//
// bf16 (the GEMMs on gemm_sm90_ws.cuh): the pre-pass and every Dense run on
// the warp-specialised persistent pipeline with the epilogues of this file.
// Against what the parent's pipeline (gemm_sm90.cuh's proj_bf16_*, two
// 128 x 128 CTAs an SM) left on the table:
//   1. no producer warp, and the tensor-core queue drained after every K
//      tile: a producer warp keeps four 48 KB stages of TMA loads in flight
//      across tiles, and wgmma.wait_group 1 releases each stage one K tile
//      late;
//   2. 128 registers a thread and the gather preloaded into the accumulator
//      (28-52 bytes of spills, the gather's latency at the head of every
//      tile): setmaxnreg gives each consumer thread 232 registers, room for
//      128 accumulators and the gathered values; Dense 0 adds P_dst[dst] + P_src[src]
//      after the product, in the epilogue, in the order gnn_conv_plain adds
//      them (this changes layer 0's fp32 rounding against the parent's
//      kernel, not against the plain version); a small kernel writes each
//      chunk row's two P rows into a table (gnn_rows_kernel), which an index
//      warp copies into shared memory a tile ahead, asking L2 for the rows;
//   3. one tile a CTA with nothing overlapped: a persistent grid of one CTA
//      an SM walks 128 x 256 tiles (128 x 128 where 256 does not divide C:
//      ws_wide), two thirds of the bytes per operation of 128 x 128 tiles;
//      the epilogue runs while the producer loads the next tile, and its
//      loads come in batches ahead of their stores;
//   4. bytes outside the products: the chain stays (chunks of edge rows,
//      fp32 h, a LayerNorm pass, a sum; PERF.md weighs the fusions), but the
//      LayerNorm pass holds a row in registers and reads h once (the parent
//      read it three times: 0.34 ms on the processor set on an H100 80GB
//      HBM3 at 700 W, against 0.20 for its bytes), and the sum reads msg in
//      16-byte loads (2-byte loads before: 0.15 ms against 0.06).
// Budget: 384 threads (two consumer warpgroups at 232 registers a thread, a
// producer warpgroup at 40 that holds the producer and the index warp),
// under 200 KB of shared memory (a 192 KB ring, the gather rows, the
// mbarriers), one CTA an SM. W0[:, 2C:3C] is a strided
// K-major view: its tensor map takes the row stride 3C, so nothing is copied.
// fp32 (gnn_dense_f32_kernel): gemm_sm90.cuh's CUDA-core tile (exact fp32;
// TF32 would miss the 1e-5 gate) with the same epilogues, the P rows added
// after the product; the pre-pass on gemm_sm90.cuh's fp32 kernel.
//
// No split-K and no atomics: two calls are bit-identical. The entry points
// have a plain C interface, launch on the stream they are given, allocate
// nothing (P tables, activations and h are the caller's scratch) and return
// cudaGetLastError().

#include "gemm_sm90_ws.cuh"  // the warp-specialised bf16 GEMM
#include "gnn_common.cuh"    // the activations, dst_of, the fp32 pre-pass, gnn_rows_kernel and gnn_agg_kernel

namespace {

using namespace sm90;  // bf16, the GEMM, TMA and wgmma helpers

struct gnn_dense0_tag {};      // layer 0: + P_dst[dst] + P_src[src], act, rounded
struct gnn_dense_tag {};       // a hidden Dense: + bias, act, rounded
struct gnn_dense_last_tag {};  // the last Dense: + bias, fp32

// What the fp32 kernels' epilogues read beside the product.
struct DenseEpi {
  const float* p_dst;  // (B * Nd, C) fp32 (layer 0)
  const float* p_src;  // (B * Ns, C) fp32 (layer 0)
  const int* rowptr;
  const int* src;
  int64_t row0;  // the chunk's first row among the B * E edge rows
  int E, num_dst, num_src, C, act;
};

// The P rows of edge row r (batch b = r / E, CSR edge ee = r % E).
__device__ __forceinline__ void p_rows(const DenseEpi& epi, int64_t r, int* d_row, int* s_row) {
  const int b = static_cast<int>(r / epi.E);
  const int ee = static_cast<int>(r - static_cast<int64_t>(b) * epi.E);
  *d_row = b * epi.num_dst + dst_of(epi.rowptr, epi.num_dst, ee);
  *s_row = b * epi.num_src + epi.src[ee];
}

// ---------------------------------------------------------------------------
// bf16: the epilogues of the warp-specialised GEMM (gemm_sm90_ws.cuh)
// ---------------------------------------------------------------------------

// Each epilogue walks the thread's BN / 2 values of its warpgroup's 64 x BN
// part of the tile (gemm_sm90_ws.cuh's layout) row by row and stores each
// pair of columns, masked by m and n (n % 8 == 0: a block of 8 columns is in
// or out). Its loads come in batches ahead of the stores they feed: a load
// issued after a store may not pass it (the compiler cannot rule out that
// they touch the same memory), so one load between two stores costs its
// whole latency. The activation is a template parameter of the walk,
// dispatched once a tile (a switch per element would branch per element).
#define GNN_ACT_DISPATCH(act, call) \
  switch (act) {                    \
    case 1: call(1); break;         \
    case 2: call(2); break;         \
    case 3: call(3); break;         \
    case 4: call(4); break;         \
    case 5: call(5); break;         \
    case 6: call(6); break;         \
    case 7: call(7); break;         \
    case 8: call(8); break;         \
    case 9: call(9); break;         \
    default: call(0); break;        \
  }

// + bias (bf16, where given) in fp32, then act (kAct), rounded once to OutT:
// the pre-pass (two problems, fp32, b0 on P_dst only), a hidden Dense (bf16,
// act) and the last Dense (fp32 h)
template <typename Tag, typename OutT, bool kAct>
struct BiasEpi {
  static constexpr bool kGather = false;
  OutT* out[2];
  const bf16* bias[2];  // or null
  int m[2];
  int n, ldo, act;

  template <int BN>
  __device__ __forceinline__ void rows(int, int, int, int, int*) const {}

  template <int BN, int A>
  __device__ __forceinline__ void walk(const float* acc, int pb, int m0, int n0, int r0, int c_lo) const {
    constexpr int kBatch = 8;  // column blocks of bias words held at a time
    const bf16* b = bias[pb];
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += kBatch) {
      uint32_t bw[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int col = n0 + 8 * (j0 + j) + c_lo;
        bw[j] = b != nullptr && col < n ? *reinterpret_cast<const uint32_t*>(b + col) : 0u;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = m0 + r0 + 8 * q;
        OutT* o = out[pb] + static_cast<int64_t>(row) * ldo + n0 + c_lo;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (row < m[pb] && n0 + 8 * (j0 + j) < n) {
            const float* a = acc + 4 * (j0 + j) + 2 * q;
            store_pair(o + 8 * (j0 + j), act_fn<A, true>(a[0] + bf16_lo(bw[j])),
                       act_fn<A, true>(a[1] + bf16_hi(bw[j])));
          }
        }
      }
    }
  }

  template <int BN>
  __device__ __forceinline__ void store(const float* acc, int pb, int m0, int n0, int r0, int c_lo, const int*,
                                        const int*) const {
#define GNN_BIAS_WALK(a) walk<BN, a>(acc, pb, m0, n0, r0, c_lo)
    GNN_ACT_DISPATCH(kAct ? act : 0, GNN_BIAS_WALK)
#undef GNN_BIAS_WALK
  }
};

// Dense 0: (e . W0[:, 2C:3C]^T + P_dst[dst]) + P_src[src] in fp32, act, rounded
template <typename Tag>
struct GatherEpi {
  static constexpr bool kGather = true;
  const float* p_dst;  // (B * Nd, C) fp32
  const float* p_src;  // (B * Ns, C) fp32
  const int2* p_rows;  // (m,): each chunk row's P_dst and P_src rows (gnn_rows_kernel)
  bf16* out;
  int m, C, act;

  // The index warp's copy of the tile's P rows into shared memory (lane l:
  // rows 4 l .. 4 l + 3; a row past the chunk takes the chunk's last row,
  // never stored). It also asks L2 for the tile's columns of both P rows,
  // so the epilogue's gathers, a tile later, find them there.
  template <int BN>
  __device__ __forceinline__ void rows(int, int m0, int n0, int lane, int* out_rows) const {
    int2 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = p_rows[min(m0 + 4 * lane + k, m - 1)];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out_rows[4 * lane + k] = v[k].x;
      out_rows[sm90ws::kWsBM + 4 * lane + k] = v[k].y;
      const float* pd = p_dst + static_cast<int64_t>(v[k].x) * C + n0;
      const float* ps = p_src + static_cast<int64_t>(v[k].y) * C + n0;
      for (int c = 0; c < BN && n0 + c < C; c += 32) {  // 128-byte lines of the tile's columns
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(pd + c));
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(ps + c));
      }
    }
  }

  // a row's gathered P values, kBatch column blocks of both tables loaded
  // ahead of their stores. The next batch's loads must not be hoisted
  // beside them: the memory clobber holds the compiler, and coherent loads
  // (not __ldg) hold ptxas, which may move a read-only ld.global.nc above a
  // store; at 128 x 256 that hoisted a row's 64 pairs, which spilled beside
  // the 128 accumulators.
  template <int BN, int A>
  __device__ __forceinline__ void walk(const float* acc, int m0, int n0, int r0, int c_lo, const int* d_rows,
                                       const int* s_rows) const {
    constexpr int kBatch = 8;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = r0 + 8 * q;
      const float* pd = p_dst + static_cast<int64_t>(d_rows[r]) * C + n0 + c_lo;
      const float* ps = p_src + static_cast<int64_t>(s_rows[r]) * C + n0 + c_lo;
      bf16* o = out + static_cast<int64_t>(m0 + r) * C + n0 + c_lo;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kBatch) {
        asm volatile("" ::: "memory");
        float2 xd[kBatch], xs[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const bool live = n0 + 8 * (j0 + j) < C;
          xd[j] = live ? *reinterpret_cast<const float2*>(pd + 8 * (j0 + j)) : make_float2(0.f, 0.f);
          xs[j] = live ? *reinterpret_cast<const float2*>(ps + 8 * (j0 + j)) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (m0 + r < m && n0 + 8 * (j0 + j) < C) {
            const float* a = acc + 4 * (j0 + j) + 2 * q;
            store_pair(o + 8 * (j0 + j), act_fn<A, true>((a[0] + xd[j].x) + xs[j].x),
                       act_fn<A, true>((a[1] + xd[j].y) + xs[j].y));
          }
        }
      }
    }
  }

  template <int BN>
  __device__ __forceinline__ void store(const float* acc, int, int m0, int n0, int r0, int c_lo, const int* d_rows,
                                        const int* s_rows) const {
#define GNN_GATHER_WALK(a) walk<BN, a>(acc, m0, n0, r0, c_lo, d_rows, s_rows)
    GNN_ACT_DISPATCH(act, GNN_GATHER_WALK)
#undef GNN_GATHER_WALK
  }
};

// The GEMM's N tile, in one place: 256 where it divides C (C = 256, 512,
// 1024, ...), else 128 (C = 384, padded narrow widths, ...).
inline bool ws_wide(int C) { return C % 256 == 0; }

// P_dst = x_dst . W0[:, 0:C]^T + b0 and P_src = x_src . W0[:, C:2C]^T, fp32, one launch
template <int BN>
int prepass_bn(const void* x_dst, const void* x_src, const void* w0, const void* b0, float* p_dst, float* p_src,
               int rows_dst, int rows_src, int C, cudaStream_t stream) {
  const bf16* w = static_cast<const bf16*>(w0);
  sm90ws::WsArgs args{};
  int rc = sm90ws::set_ws_problem<BN>(&args.p[0], x_dst, C, w, 3 * C, rows_dst, C, C);
  if (rc == 0) rc = sm90ws::set_ws_problem<BN>(&args.p[1], x_src, C, w + C, 3 * C, rows_src, C, C);
  if (rc != 0) return rc;
  BiasEpi<gnn_prepass_tag, float, false> epi{{p_dst, p_src}, {static_cast<const bf16*>(b0), nullptr},
                                             {rows_dst, rows_src}, C, C, 0};
  return sm90ws::launch_ws_gemm<BN>(args, 2, C, epi, stream);
}

int prepass_bf16(const void* x_dst, const void* x_src, const void* w0, const void* b0, float* p_dst, float* p_src,
                 int rows_dst, int rows_src, int C, cudaStream_t stream) {
  return ws_wide(C) ? prepass_bn<256>(x_dst, x_src, w0, b0, p_dst, p_src, rows_dst, rows_src, C, stream)
                    : prepass_bn<128>(x_dst, x_src, w0, b0, p_dst, p_src, rows_dst, rows_src, C, stream);
}

// out (m, C) = epi(a (m, C) . w (C, C; rows ldw apart)^T)
template <int BN, class Epi>
int dense_bn(const void* a, const void* w, int ldw, int m, int C, const Epi& epi, cudaStream_t stream) {
  sm90ws::WsArgs args{};
  const int rc = sm90ws::set_ws_problem<BN>(&args.p[0], a, C, w, ldw, m, C, C);
  if (rc != 0) return rc;
  return sm90ws::launch_ws_gemm<BN>(args, 1, C, epi, stream);
}

template <class Epi>
int dense_bf16(const void* a, const void* w, int ldw, int m, int C, const Epi& epi, cudaStream_t stream) {
  return ws_wide(C) ? dense_bn<256>(a, w, ldw, m, C, epi, stream) : dense_bn<128>(a, w, ldw, m, C, epi, stream);
}

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------

template <typename Tag, bool kGather>
__global__ void __launch_bounds__(kF32Threads) gnn_dense_f32_kernel(const ProjF32Problem pr, const DenseEpi epi) {
  const int m0 = blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * kF32BN;
  __shared__ int d_rows[kF32BM];
  __shared__ int s_rows[kF32BM];
  const int tid = threadIdx.x;
  const int tx = tid % (kF32BN / kF32TN);
  const int ty = tid / (kF32BN / kF32TN);
  if (kGather && tid < kF32BM) p_rows(epi, epi.row0 + min(m0 + tid, pr.m - 1), d_rows + tid, s_rows + tid);
  float acc[kF32TM][kF32TN];
  proj_f32_tile(pr, epi.C, m0, n0, acc);  // its first barrier publishes d_rows and s_rows

#pragma unroll
  for (int i = 0; i < kF32TM; ++i) {
    const int r = ty * kF32TM + i;
    const float* pd = epi.p_dst + static_cast<int64_t>(kGather ? d_rows[r] : 0) * epi.C;
    const float* ps = epi.p_src + static_cast<int64_t>(kGather ? s_rows[r] : 0) * epi.C;
#pragma unroll
    for (int j = 0; j < kF32TN; ++j) {
      const int gn = min(n0 + tx * kF32TN + j, pr.n - 1);  // a column past C is never stored
      acc[i][j] = kGather ? acc[i][j] + pd[gn] + ps[gn] : acc[i][j] + (pr.bias ? pr.bias[gn] : 0.f);
    }
  }
  apply_act<kF32TM * kF32TN, false>(&acc[0][0], epi.act);
#pragma unroll
  for (int i = 0; i < kF32TM; ++i) {
    const int gm = m0 + ty * kF32TM + i;
    if (gm >= pr.m) continue;
#pragma unroll
    for (int j = 0; j < kF32TN; ++j) {
      const int gn = n0 + tx * kF32TN + j;
      if (gn < pr.n) pr.out[static_cast<int64_t>(gm) * pr.ldo + gn] = acc[i][j];
    }
  }
}

template <typename Tag, bool kGather>
int dense_f32(const void* a, const void* w, int ldw, const void* bias, void* out, int m, const DenseEpi& epi,
              cudaStream_t stream) {
  const int C = epi.C;
  const ProjF32Problem pr{static_cast<const float*>(a), static_cast<const float*>(w),
                          static_cast<const float*>(bias), static_cast<float*>(out), m, C, C, ldw, C};
  const dim3 grid((m + kF32BM - 1) / kF32BM, (C + kF32BN - 1) / kF32BN);
  gnn_dense_f32_kernel<Tag, kGather><<<grid, kF32Threads, 0, stream>>>(pr, epi);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// LayerNorm, + e
// ---------------------------------------------------------------------------

constexpr int kLnRows = 8;  // one warp a row

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// msg (rows, C) from h (rows, C) fp32: LN with fp32 statistics and eps 1e-6;
// in bf16 the normalised value, its product with gamma and the sum with beta
// each rounded, then + e rounded (gnn_conv.cu's points); in fp32 none. With
// PAD the statistics run over the first c_ln channels only: the wrapper pads
// a width that is not a multiple of 8 with zero columns (zero in h, and zero
// gamma, beta and e there, so the padded msg columns are 0).
template <typename T, bool PAD>
__global__ void __launch_bounds__(32 * kLnRows)
gnn_ln_kernel(const float* __restrict__ h, const T* __restrict__ e, const T* __restrict__ gamma,
              const T* __restrict__ beta, T* __restrict__ msg, int rows, int C, int c_ln) {
  const int row = blockIdx.x * kLnRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* hr = h + static_cast<int64_t>(row) * C;
  float sum = 0.f;
  for (int c = 2 * lane; c < C; c += 64) {
    const float2 v = load2(hr + c);
    sum += v.x + v.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / (PAD ? c_ln : C);
  float sq = 0.f;
  for (int c = 2 * lane; c < C; c += 64) {
    const float2 v = load2(hr + c);
    if constexpr (PAD) {  // the padded columns' (0 - mu)^2 stay out of the variance
      const float dx = c < c_ln ? v.x - mu : 0.f, dy = c + 1 < c_ln ? v.y - mu : 0.f;
      sq += dx * dx + dy * dy;
    } else {
      sq += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float rs = rsqrtf(sq / (PAD ? c_ln : C) + 1e-6f);
  const T* er = e + static_cast<int64_t>(row) * C;
  T* out = msg + static_cast<int64_t>(row) * C;
  for (int c = 2 * lane; c < C; c += 64) {
    const float2 v = load2(hr + c);
    const float2 ev = load2(er + c);
    const float2 g = load2(gamma + c);
    const float2 b = load2(beta + c);
    if constexpr (std::is_same<T, bf16>::value) {
      float y[2];
      const float hv[2] = {v.x, v.y}, gv[2] = {g.x, g.y}, bv[2] = {b.x, b.y}, evv[2] = {ev.x, ev.y};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bf16 hn = round_bf16((hv[q] - mu) * rs);
        const bf16 yy = round_bf16(to_f(round_bf16(to_f(hn) * gv[q])) + bv[q]);
        y[q] = to_f(yy) + evv[q];
      }
      *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(y[0], y[1]);
    } else {
      *reinterpret_cast<float2*>(out + c) = make_float2((v.x - mu) * rs * g.x + b.x + ev.x,
                                                        (v.y - mu) * rs * g.y + b.y + ev.y);
    }
  }
}

// bf16 (C <= 2048): the same msg with the row in registers. Lane l holds NV
// float4 of h at columns 128 v + 4 l, so h is read once (gnn_ln_kernel reads
// each row three times); the statistics run over the first c_ln columns and
// every value rounds at gnn_ln_kernel's points.
template <int NV>
__global__ void __launch_bounds__(32 * kLnRows)
gnn_ln_kernel_regs(const float* __restrict__ h, const bf16* __restrict__ e, const bf16* __restrict__ gamma,
                   const bf16* __restrict__ beta, bf16* __restrict__ msg, int rows, int C, int c_ln) {
  const int row = blockIdx.x * kLnRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* hr = h + static_cast<int64_t>(row) * C;
  float v[NV][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 128 * i + 4 * lane;
    const float4 x = c < C ? *reinterpret_cast<const float4*>(hr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[i][0] = x.x;
    v[i][1] = x.y;
    v[i][2] = x.z;
    v[i][3] = x.w;
    sum += (x.x + x.y) + (x.z + x.w);  // the padded columns hold 0
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / c_ln;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = 128 * i + 4 * lane + k < c_ln ? v[i][k] - mu : 0.f;
      sq += d * d;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float rs = rsqrtf(sq / c_ln + 1e-6f);
  const bf16* er = e + static_cast<int64_t>(row) * C;
  bf16* out = msg + static_cast<int64_t>(row) * C;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 128 * i + 4 * lane;
    if (c >= C) continue;
    const uint2 er4 = *reinterpret_cast<const uint2*>(er + c);
    const uint2 g4 = *reinterpret_cast<const uint2*>(gamma + c);
    const uint2 b4 = *reinterpret_cast<const uint2*>(beta + c);
    const float ev[4] = {bf16_lo(er4.x), bf16_hi(er4.x), bf16_lo(er4.y), bf16_hi(er4.y)};
    const float gv[4] = {bf16_lo(g4.x), bf16_hi(g4.x), bf16_lo(g4.y), bf16_hi(g4.y)};
    const float bv[4] = {bf16_lo(b4.x), bf16_hi(b4.x), bf16_lo(b4.y), bf16_hi(b4.y)};
    uint32_t y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bf16 hn = round_bf16((v[i][k] - mu) * rs);
      const bf16 yy = round_bf16(to_f(round_bf16(to_f(hn) * gv[k])) + bv[k]);
      y[k] = __bfloat16_as_ushort(round_bf16(to_f(yy) + ev[k]));
    }
    *reinterpret_cast<uint2*>(out + c) = make_uint2(y[0] | (y[1] << 16), y[2] | (y[3] << 16));
  }
}

// the LayerNorm pass of one chunk in bf16: from registers up to C = 2048
int launch_ln_bf16(const float* h, const bf16* e, const bf16* gamma, const bf16* beta, bf16* msg, int m, int C,
                   int c_ln, cudaStream_t s) {
  const int blocks = (m + kLnRows - 1) / kLnRows;
  const int nv = (C + 127) / 128;
  if (nv == 1) {
    gnn_ln_kernel_regs<1><<<blocks, 32 * kLnRows, 0, s>>>(h, e, gamma, beta, msg, m, C, c_ln);
  } else if (nv == 2) {
    gnn_ln_kernel_regs<2><<<blocks, 32 * kLnRows, 0, s>>>(h, e, gamma, beta, msg, m, C, c_ln);
  } else if (nv <= 4) {
    gnn_ln_kernel_regs<4><<<blocks, 32 * kLnRows, 0, s>>>(h, e, gamma, beta, msg, m, C, c_ln);
  } else if (nv <= 8) {
    gnn_ln_kernel_regs<8><<<blocks, 32 * kLnRows, 0, s>>>(h, e, gamma, beta, msg, m, C, c_ln);
  } else if (nv <= 16) {
    gnn_ln_kernel_regs<16><<<blocks, 32 * kLnRows, 0, s>>>(h, e, gamma, beta, msg, m, C, c_ln);
  } else {
    auto ln = c_ln == C ? gnn_ln_kernel<bf16, false> : gnn_ln_kernel<bf16, true>;
    ln<<<blocks, 32 * kLnRows, 0, s>>>(h, e, gamma, beta, msg, m, C, c_ln);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the whole conv
// ---------------------------------------------------------------------------

template <typename T>
int launch_gnn_conv_layered(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                            const void* src, const void* const* dense, int n_dense, const void* ln_g,
                            const void* ln_b, void* p_dst, void* p_src, void* h0, void* h1, void* hf,
                            int chunk_rows, void* msg, void* agg, int batch, int num_dst, int num_src, int E, int C,
                            int c_ln, int act, void* stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dense < 2 || C % 8 != 0 || chunk_rows <= 0 || c_ln <= 0 || c_ln > C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E > 0) {
    float* pd = static_cast<float*>(p_dst);
    float* ps = static_cast<float*>(p_src);
    int rc;
    if constexpr (kBf16) {
      rc = prepass_bf16(x_dst, x_src, dense[0], dense[1], pd, ps, batch * num_dst, batch * num_src, C, s);
    } else {
      rc = launch_prepass<T>(x_dst, x_src, dense[0], dense[1], pd, ps, batch * num_dst, batch * num_src, C, s);
    }
    if (rc != 0) return rc;
    const T* w0 = static_cast<const T*>(dense[0]);
    void* hbuf[2] = {h0, h1};
    const int* rp = static_cast<const int*>(rowptr);
    const int* sp = static_cast<const int*>(src);
    const int64_t rows = static_cast<int64_t>(batch) * E;
    for (int64_t r0 = 0; r0 < rows; r0 += chunk_rows) {
      const int m = static_cast<int>(rows - r0 < chunk_rows ? rows - r0 : chunk_rows);
      const T* e_c = static_cast<const T*>(e) + r0 * C;
      int cur = 0;
      if constexpr (kBf16) {
        // hf holds the chunk's P-row table until the last Dense writes h (m int2 fit in m C floats)
        rc = launch_rows(rowptr, src, hf, r0, m, E, num_dst, num_src, batch, s);
        if (rc == 0) {
          rc = dense_bf16(e_c, w0 + 2 * C, 3 * C, m, C,
                          GatherEpi<gnn_dense0_tag>{pd, ps, static_cast<const int2*>(hf),
                                                    static_cast<bf16*>(hbuf[0]), m, C, act},
                          s);
        }
        for (int i = 1; rc == 0 && i < n_dense - 1; ++i, cur ^= 1) {
          rc = dense_bf16(hbuf[cur], dense[2 * i], C, m, C,
                          BiasEpi<gnn_dense_tag, bf16, true>{{static_cast<bf16*>(hbuf[cur ^ 1]), nullptr},
                                                             {static_cast<const bf16*>(dense[2 * i + 1]), nullptr},
                                                             {m, 0}, C, C, act},
                          s);
        }
        if (rc == 0) {
          rc = dense_bf16(hbuf[cur], dense[2 * (n_dense - 1)], C, m, C,
                          BiasEpi<gnn_dense_last_tag, float, false>{{static_cast<float*>(hf), nullptr},
                                                                    {static_cast<const bf16*>(dense[2 * n_dense - 1]),
                                                                     nullptr},
                                                                    {m, 0}, C, C, 0},
                          s);
        }
      } else {
        DenseEpi epi{pd, ps, rp, sp, r0, E, num_dst, num_src, C, act};
        rc = dense_f32<gnn_dense0_tag, true>(e_c, w0 + 2 * C, 3 * C, nullptr, hbuf[0], m, epi, s);
        for (int i = 1; rc == 0 && i < n_dense - 1; ++i, cur ^= 1) {
          rc = dense_f32<gnn_dense_tag, false>(hbuf[cur], dense[2 * i], C, dense[2 * i + 1], hbuf[cur ^ 1], m, epi,
                                               s);
        }
        epi.act = 0;  // the last Dense has no activation
        if (rc == 0) {
          rc = dense_f32<gnn_dense_last_tag, false>(hbuf[cur], dense[2 * (n_dense - 1)], C, dense[2 * n_dense - 1],
                                                    hf, m, epi, s);
        }
      }
      if (rc != 0) return rc;
      if constexpr (kBf16) {
        rc = launch_ln_bf16(static_cast<const float*>(hf), e_c, static_cast<const bf16*>(ln_g),
                            static_cast<const bf16*>(ln_b), static_cast<bf16*>(msg) + r0 * C, m, C, c_ln, s);
      } else {
        auto ln = c_ln == C ? gnn_ln_kernel<T, false> : gnn_ln_kernel<T, true>;
        ln<<<(m + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(
            static_cast<const float*>(hf), e_c, static_cast<const T*>(ln_g), static_cast<const T*>(ln_b),
            static_cast<T*>(msg) + r0 * C, m, C, c_ln);
        rc = static_cast<int>(cudaGetLastError());
      }
      if (rc != 0) return rc;
    }
  }
  return launch_agg<T>(msg, rowptr, agg, batch, num_dst, E, C, s);
}

}  // namespace

extern "C" {

// dense: 2 * n_dense pointers, each Dense's weight (C, K) in torch's Linear
// layout (K = 3C for the first) then its bias (C); h0, h1: (chunk_rows, C) in
// the compute dtype, hf: (chunk_rows, C) fp32; c_ln: the channels of the
// LayerNorm's statistics, C unless the wrapper padded the width to C
int gnn_conv_layered_f32(const void* x_dst, const void* x_src, const void* e, const void* rowptr, const void* src,
                         const void* const* dense, int n_dense, const void* ln_g, const void* ln_b, void* p_dst,
                         void* p_src, void* h0, void* h1, void* hf, int chunk_rows, void* msg, void* agg, int batch,
                         int num_dst, int num_src, int E, int C, int c_ln, int act, void* stream) {
  return launch_gnn_conv_layered<float>(x_dst, x_src, e, rowptr, src, dense, n_dense, ln_g, ln_b, p_dst, p_src, h0,
                                        h1, hf, chunk_rows, msg, agg, batch, num_dst, num_src, E, C, c_ln, act, stream);
}

int gnn_conv_layered_bf16(const void* x_dst, const void* x_src, const void* e, const void* rowptr, const void* src,
                          const void* const* dense, int n_dense, const void* ln_g, const void* ln_b, void* p_dst,
                          void* p_src, void* h0, void* h1, void* hf, int chunk_rows, void* msg, void* agg, int batch,
                          int num_dst, int num_src, int E, int C, int c_ln, int act, void* stream) {
  return launch_gnn_conv_layered<bf16>(x_dst, x_src, e, rowptr, src, dense, n_dense, ln_g, ln_b, p_dst, p_src, h0,
                                       h1, hf, chunk_rows, msg, agg, batch, num_dst, num_src, E, C, c_ln, act, stream);
}

}  // extern "C"
