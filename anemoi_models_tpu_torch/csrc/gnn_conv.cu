// Hopper (sm_90a) kernels for the GNN flavor's edge-MLP convolution.
//
// Replaces anemoi_models_tpu/ops/pallas/gnn_conv.py:_kernel: per destination
// block it DMA'd a source slab, materialised x_i and x_j by one-hot matmuls
// (Mosaic cannot gather in VMEM), ran the edge MLP in VMEM and group-summed
// the slot messages, with the slot layout, slab window and outlier list that
// gather forced. On Hopper rows load by index, so the port runs straight off
// the destination-sorted CSR edge list (no cap, any degree), in three kernels
// behind one entry point:
//
//   pre-pass        the first Dense factors as the TPU kernel computes it, in
//                   three fp32 dots (gnn_conv.py:81-85): per node, once,
//                   P_dst = x_dst . W0[:, 0:C]^T + b0 and P_src = x_src .
//                   W0[:, C:2C]^T in fp32 (the GEMM of gemm_sm90.cuh under
//                   gnn_prepass_tag: both products in one launch).
//   gnn_msg_*       per tile of consecutive CSR edges
//                   h  = act(e . W0[:, 2C:3C]^T + P_dst[dst] + P_src[src])  (rounded)
//                   h  = act(h . W1^T + b1)                                 (rounded)
//                   h  = h . W2^T + b2                                      (fp32)
//                   msg = LN(h) * gamma + beta + e                          (compute dtype)
//                   with fp32 LayerNorm statistics (eps 1e-6), the normalised
//                   value rounded before gamma and beta, as the TPU kernel
//                   rounds; msg goes to memory in edge order.
//   gnn_agg_kernel  one CTA per (batch, destination) sums its CSR row of the
//                   rounded msg in edge order, in fp32: one writer per row, no
//                   atomics, run-to-run deterministic.
//
// Bound on the H100: operations at the bf16 tensor-core rate, 2 * 2 C^2 per
// node and 2 * 3 C^2 per edge; at the O96 processor (10,242 nodes, 81,900
// edges, C = 256) about 35 GFLOP per layer, 0.035 ms, against 0.025 ms of
// bytes (e read and msg written). Factoring the first Dense takes the
// per-edge product from 10 C^2 to 6 C^2 operations and every gather off the
// tensor cores' operand path: the only rows gathered are the fp32 P rows,
// added straight into the accumulator registers.
//
// bf16, gnn_msg_bf16_kernel<C> (wgmma fed by TMA):
//   - A CTA takes 128 consecutive edges: two warpgroups of 64 edges each
//     (256 threads, one CTA per SM, at most 255 registers a thread: the
//     64 x C fp32 accumulator is C / 2 registers, 128 at C = 256). A third,
//     producer warpgroup (384 threads) left ptxas 168 registers a thread and
//     the C = 256 kernel spilled; setmaxnreg did not change its allocation.
//     At C = 256 ptxas still uses 255 registers and spills 480 bytes.
//   - Thread 0 copies by TMA both warpgroups' e tiles (the edge features are
//     contiguous in CSR order) and streams the three weight matrices,
//     W0[:, 2C:3C], W1 and W2, in 64-column K tiles (C x 64 bf16, 32 KB at
//     C = 256) through a 3-stage ring that both warpgroups read: each
//     weight byte leaves L2 once per 128 edges. It refills a stage once every
//     thread has arrived on its "empty" barrier.
//   - Each layer is wgmma.mma_async m64nCk16 over the K tiles. Layer 0's
//     accumulator starts at the gathered fp32 rows P_dst[dst] + P_src[src],
//     loaded while the e tile arrives. The epilogues run on the accumulator
//     registers: layers 0 and 1 the activation (one switch per layer, not per
//     element) and the rounding to bf16 into a shared-memory tile in the
//     128-byte swizzle (the A operand of the next layer), layer 2 the
//     LayerNorm: in the D-fragment layout a row's C columns sit in the four
//     threads of a quad, so its statistics take two shfl_xor steps. Then
//     gamma, beta and + e (read from the e tile) and the store of msg.
//   - Shared memory at C = 256: e tiles 64 KB, activations 64 KB, ring 96 KB,
//     227 KB in all.
//   On an H100 SXM (700 W) the O96 processor set takes 0.30 ms, 8.6x the
//   bound: the products and the TMA ring take a few microseconds of a CTA's
//   time, the epilogues (activation, LayerNorm, the P-row gathers) the rest.
// fp32, gnn_msg_f32_kernel<C>: the CUDA cores (exact fp32; TF32 would miss
//   the 1e-5 gate), 64 edges per CTA, 256 threads, 8 rows x C / 32 columns a
//   thread, weights staged through shared memory in 32-row K tiles; the
//   same factoring (three C x C products per edge, the P rows added in the
//   epilogue of the first).
//
// This is the route for C in {32, 64, 128, 256} with three Dense layers;
// gnn_conv_layered.cu takes every other width (C % 8 == 0) and MLP depth.
// The pre-pass, gnn_agg_kernel and the activations live in gnn_common.cuh.
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing (the fp32 P tables are the caller's scratch) and
// returns cudaGetLastError().

#include "gnn_common.cuh"  // the activations, dst_of, the pre-pass and gnn_agg_kernel

namespace {

using namespace sm90;  // bf16, the GEMM, TMA and wgmma helpers

struct MsgArgs {
  const float* p_dst;  // (B * Nd, C) fp32
  const float* p_src;  // (B * Ns, C) fp32
  const void* e;       // (B * E, C)
  const int* rowptr;
  const int* src;
  const void* b1;
  const void* b2;
  const void* ln_g;
  const void* ln_b;
  void* msg;  // (B * E, C)
  int num_dst, num_src, E, act;
};

// ---------------------------------------------------------------------------
// bf16 message kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

constexpr int kMsgEdges = 128;  // per CTA: two warpgroups of 64
constexpr int kMsgStages = 3;
constexpr int kMsgThreads = 256;  // two warpgroups; thread 0 also issues the copies

template <int C>
struct MsgLayout {
  static constexpr int kBK = C < 64 ? C : 64;  // K tile: 128-byte rows (64-byte at C = 32)
  static constexpr int kSW = kBK * 2;          // swizzle width in bytes
  static constexpr int kKT = C / kBK;          // K tiles per layer
  static constexpr int kTiles = 3 * kKT;       // weight tiles per CTA
  static constexpr int kOperand = 64 * C * 2;  // one warpgroup's 64 x C bf16 tile (kKT blocks of 64 x kBK)
  static constexpr int kRingTile = C * kBK * 2;
  static constexpr int kE = 0;                       // e tiles, two warpgroups
  static constexpr int kH = kE + 2 * kOperand;       // activations, two warpgroups
  static constexpr int kRing = kH + 2 * kOperand;    // weight ring
  static constexpr int kIdx = kRing + kMsgStages * kRingTile;  // dst, src of the 128 edges
  static constexpr int kBar = kIdx + 2 * kMsgEdges * 4;        // e_full, full[S], empty[S]
  static constexpr size_t kBytes = 1024 + kBar + (1 + 2 * kMsgStages) * 8;
  static_assert(kBytes <= 232448, "gnn_msg_bf16_kernel: shared memory over the 227 KB an SM gives a block");
};

// Byte offsets of a thread's accumulator elements (rows r_lo, r_lo + 8;
// columns 8 j + c_lo, + 1) in a 64 x C operand tile: kKT blocks of 64 rows x
// kSW bytes in the TMA swizzle. Only the 16-byte chunk index changes with j,
// XORed with the row's swizzle bits (the same for both rows), so the offsets
// are a base, an immediate and one of kBK / 8 values; an offset computed from
// (row, col) afresh for each element is what the compiler keeps live across
// the products, and at C = 256 that spilled.
template <int C>
struct FragOffsets {
  using L = MsgLayout<C>;
  static constexpr int kCh = L::kBK / 8;  // 16-byte chunks in a row
  int base;                               // row r_lo, column c_lo, unswizzled
  int rx;                                 // the rows' swizzle bits
  __device__ FragOffsets(int r_lo, int c_lo)
      : base(r_lo * L::kSW + 2 * c_lo), rx(((r_lo * L::kSW) >> 7) & (L::kSW / 16 - 1)) {}
  __device__ __forceinline__ int at(int h, int j) const {
    return base + h * 8 * L::kSW + (j / kCh) * 64 * L::kSW + (((j % kCh) ^ rx) << 4);
  }
};

struct MsgMaps {
  CUtensorMap e;   // (B * E, C), boxes of 64 x kBK
  CUtensorMap w0;  // (C, 3C), boxes of C x kBK
  CUtensorMap w1;  // (C, C)
  CUtensorMap w2;  // (C, C)
};

template <int C>
__global__ void __launch_bounds__(kMsgThreads, 1)
gnn_msg_bf16_kernel(const __grid_constant__ MsgMaps maps, const MsgArgs args) {
  using L = MsgLayout<C>;
  constexpr int kR = C / 2;  // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  int* dst_s = reinterpret_cast<int*>(smem + L::kIdx);
  int* src_s = dst_s + kMsgEdges;
  uint64_t* e_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = e_full + 1;
  uint64_t* empty = full + kMsgStages;

  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kMsgEdges;
  const int tid = threadIdx.x;
  // thread 0 issues every copy: both warpgroups' e tiles, then the weight
  // ring's first stages (before the destinations are looked up, so that the
  // copies overlap that); each later tile once both warpgroups are done with
  // the one whose stage it takes (issue_tile in layer_product)
  auto issue_tile = [&](int t) {
    const int s = t % kMsgStages;
    const int layer = t / L::kKT;
    const int kt = t % L::kKT;
    const CUtensorMap* map = layer == 0 ? &maps.w0 : layer == 1 ? &maps.w1 : &maps.w2;
    mbar_expect_tx(full + s, L::kRingTile);
    tma_load_2d(smem + L::kRing + s * L::kRingTile, map, full + s, (layer == 0 ? 2 * C : 0) + kt * L::kBK, 0);
  };
  if (tid == 0) {
    mbar_init(e_full, 1);
    for (int s = 0; s < kMsgStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kMsgThreads);  // every thread arrives
    }
    fence_barrier_init();
    const int rows = gridDim.y * args.E;
    mbar_expect_tx(e_full, 2 * L::kOperand);
    for (int wg = 0; wg < 2; ++wg) {
      // a box wholly past the last row starts at the last row instead: its rows are never stored
      const int row = min(b * args.E + e0 + 64 * wg, rows - 1);
      for (int kt = 0; kt < L::kKT; ++kt) {
        tma_load_2d(smem + L::kE + wg * L::kOperand + kt * 64 * L::kSW, &maps.e, e_full, kt * L::kBK, row);
      }
    }
    for (int t = 0; t < kMsgStages && t < L::kTiles; ++t) issue_tile(t);
  }
  if (tid < kMsgEdges) {
    const int ee = e0 + tid;
    dst_s[tid] = ee < args.E ? dst_of(args.rowptr, args.num_dst, ee) : 0;
    src_s[tid] = ee < args.E ? args.src[ee] : 0;
  }
  __syncthreads();  // the barriers' initialisation, dst_s and src_s

  // warpgroup wg: edges e0 + 64 wg ..
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r_lo = ((tid % 128) / 32) * 16 + lane / 4;  // this thread's rows: r_lo, r_lo + 8
  const int c_lo = 2 * (lane % 4);                       // and columns 8 j + c_lo, + 1
  uint8_t* e_tile = smem + L::kE + wg * L::kOperand;
  uint8_t* h_tile = smem + L::kH + wg * L::kOperand;
  const FragOffsets<C> frag(r_lo, c_lo);
  float acc[kR];

  // acc (+)= A . W^T over one layer's K tiles (tiles t0 .. t0 + kKT of the ring)
  auto layer_product = [&](const uint8_t* a_tile, int t0) {
#pragma unroll
    for (int kt = 0; kt < L::kKT; ++kt) {
      const int t = t0 + kt;
      const int s = t % kMsgStages;
      mbar_wait(full + s, (t / kMsgStages) & 1);
      const uint8_t* a = a_tile + kt * 64 * L::kSW;
      const uint8_t* w = smem + L::kRing + s * L::kRingTile;
      fence_regs<kR>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < L::kBK / 16; ++k) {
        Wgmma<C>::mma(acc, make_desc<L::kSW>(a + 32 * k), make_desc<L::kSW>(w + 32 * k), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kR>(acc);
      mbar_arrive(empty + s);
      if (tid == 0 && t + kMsgStages < L::kTiles) {
        mbar_wait(empty + s, (t / kMsgStages) & 1);
        issue_tile(t + kMsgStages);
      }
    }
  };
  // round(act(acc)) into this warpgroup's activation tile, the next layer's A operand
  auto store_activation = [&] {
    apply_act<kR, true>(acc, args.act);
    named_barrier(1 + wg, 128);  // every warp's product has finished reading h_tile
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<__nv_bfloat162*>(h_tile + frag.at(h, j)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  };

  // layer 0: the accumulator starts at the gathered per-node terms P_dst[dst] + P_src[src]
  // (loaded while the e tile arrives), then takes e . W0[:, 2C:3C]^T
  {
    const int slot = 64 * wg + r_lo;
    const float* pd[2] = {args.p_dst + ((int64_t)b * args.num_dst + dst_s[slot]) * C,
                          args.p_dst + ((int64_t)b * args.num_dst + dst_s[slot + 8]) * C};
    const float* ps[2] = {args.p_src + ((int64_t)b * args.num_src + src_s[slot]) * C,
                          args.p_src + ((int64_t)b * args.num_src + src_s[slot + 8]) * C};
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = *reinterpret_cast<const float2*>(pd[h] + 8 * j + c_lo);
        acc[4 * j + 2 * h] = x.x;
        acc[4 * j + 2 * h + 1] = x.y;
      }
    // P_src four column blocks at a time: the compiler hoists every independent load it
    // can, and 64 float2 loads in flight need 128 registers more than the accumulator
    // leaves (the same fence bounds the later epilogues' loads)
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      if (j % 4 == 0) asm volatile("" ::: "memory");
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 y = *reinterpret_cast<const float2*>(ps[h] + 8 * j + c_lo);
        acc[4 * j + 2 * h] += y.x;
        acc[4 * j + 2 * h + 1] += y.y;
      }
    }
  }
  mbar_wait(e_full, 0);
  layer_product(e_tile, 0);
  store_activation();
  // layers 1 and 2 start from their bias
  auto init_bias = [&](const void* bias) {
    const bf16* bv = static_cast<const bf16*>(bias);
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      if (j % 8 == 0) asm volatile("" ::: "memory");
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(bv + 8 * j + c_lo);
      acc[4 * j] = acc[4 * j + 2] = to_f(v.x);
      acc[4 * j + 1] = acc[4 * j + 3] = to_f(v.y);
    }
  };
  init_bias(args.b1);
  layer_product(h_tile, L::kKT);
  store_activation();
  // layer 2, then the LayerNorm over each row (the 4 threads of a quad hold its C columns),
  // with gamma and beta staged as fp32 in this warpgroup's activation tile, free once the
  // product has read it
  init_bias(args.b2);
  layer_product(h_tile, 2 * L::kKT);
  float* gb = reinterpret_cast<float*>(h_tile);  // gamma (C), beta (C)
  named_barrier(1 + wg, 128);
  for (int i = tid % 128; i < 2 * C; i += 128) {
    gb[i] = to_f(static_cast<const bf16*>(i < C ? args.ln_g : args.ln_b)[i % C]);
  }
  named_barrier(1 + wg, 128);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) sum += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mu = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const float d0 = acc[4 * j + 2 * h] - mu;
      const float d1 = acc[4 * j + 2 * h + 1] - mu;
      sq += d0 * d0 + d1 * d1;
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float rs = rsqrtf(sq / C + 1e-6f);
    const int r = r_lo + 8 * h;
    const int ee = e0 + 64 * wg + r;
    if (ee >= args.E) continue;
    bf16* out = static_cast<bf16*>(args.msg) + ((int64_t)b * args.E + ee) * C;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      if (j % 4 == 0) asm volatile("" ::: "memory");  // keeps the loads of 4 column blocks in flight, not all
      const int col = 8 * j + c_lo;
      const __nv_bfloat162 ev = *reinterpret_cast<const __nv_bfloat162*>(e_tile + frag.at(h, j));
      const float2 g = *reinterpret_cast<const float2*>(gb + col);
      const float2 beta = *reinterpret_cast<const float2*>(gb + C + col);
      float y[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bf16 hn = round_bf16((acc[4 * j + 2 * h + q] - mu) * rs);
        const bf16 yy = round_bf16(to_f(round_bf16(to_f(hn) * (q == 0 ? g.x : g.y))) + (q == 0 ? beta.x : beta.y));
        y[q] = to_f(yy) + to_f(q == 0 ? ev.x : ev.y);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(y[0], y[1]);
    }
  }
}

template <int C>
int launch_msg_bf16(const MsgArgs& args, const void* w0, const void* w1, const void* w2, int batch,
                    cudaStream_t stream) {
  using L = MsgLayout<C>;
  MsgMaps maps;
  int rc = make_map_bf16(&maps.e, args.e, (int64_t)batch * args.E, C, C, 64, L::kBK);
  if (rc == 0) rc = make_map_bf16(&maps.w0, w0, C, 3 * C, 3 * C, C, L::kBK);
  if (rc == 0) rc = make_map_bf16(&maps.w1, w1, C, C, C, C, L::kBK);
  if (rc == 0) rc = make_map_bf16(&maps.w2, w2, C, C, C, C, L::kBK);
  if (rc != 0) return rc;
  auto kernel = gnn_msg_bf16_kernel<C>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((args.E + kMsgEdges - 1) / kMsgEdges, batch);
  kernel<<<grid, kMsgThreads, L::kBytes, stream>>>(maps, args);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32 message kernel (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int kF32Edges = 64;
constexpr int kF32MsgThreads = 256;
constexpr int kF32KC = 32;  // K tile

// Shared memory: the weight tile Wt (K-tile rows, one per input channel),
// the e tile At and the activations H; after the last product the fp32 rows
// S for the LayerNorm take their place. About 110 KB at C = 256.
template <int C>
struct F32Layout {
  static constexpr int kLdW = C + 1;      // Wt rows (kF32KC of them); odd: the transposing writes spread over banks
  static constexpr int kLdA = kF32KC + 4;  // e tile rows (kF32Edges)
  static constexpr int kLdH = C + 4;      // activations (kF32Edges rows)
  static constexpr size_t kW = (size_t)kF32KC * kLdW * 4;
  static constexpr size_t kA = (size_t)kF32Edges * kLdA * 4;
  static constexpr size_t kH = (size_t)kF32Edges * kLdH * 4;
  static constexpr size_t kUnion = kW + kA + kH;  // S (kH bytes) reuses it from the start
  static constexpr size_t kBytes = kUnion + 2 * kF32Edges * sizeof(int);
};

// acc = A (64 x C) . W[:, koff:koff + C]^T in fp32, W (C, ldw) in torch's Linear
// layout; A is the e tile (EDGE) or H. Thread t owns rows 8 (t / 32) .. + 8 and
// columns lane + 32 j.
template <int C, bool EDGE>
__device__ __forceinline__ void f32_product(float (&acc)[8][C / 32], const float* __restrict__ W, int ldw, int koff, float* Wt,
                            float* At, const float* H, const float* __restrict__ e, int e0, int E) {
  using L = F32Layout<C>;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < C / 32; ++j) acc[i][j] = 0.f;
  for (int kc = 0; kc < C; kc += kF32KC) {
    __syncthreads();  // the previous tile's Wt / At are consumed
    for (int idx = tid; idx < C * (kF32KC / 4); idx += kF32MsgThreads) {
      const int n = idx / (kF32KC / 4);
      const int k4 = (idx % (kF32KC / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(W + (int64_t)n * ldw + koff + kc + k4);
      Wt[(k4 + 0) * L::kLdW + n] = v.x;
      Wt[(k4 + 1) * L::kLdW + n] = v.y;
      Wt[(k4 + 2) * L::kLdW + n] = v.z;
      Wt[(k4 + 3) * L::kLdW + n] = v.w;
    }
    if constexpr (EDGE) {
      for (int idx = tid; idx < kF32Edges * (kF32KC / 4); idx += kF32MsgThreads) {
        const int r = idx / (kF32KC / 4);
        const int c = (idx % (kF32KC / 4)) * 4;
        const float4 v = e0 + r < E ? *reinterpret_cast<const float4*>(e + (int64_t)(e0 + r) * C + kc + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(At + r * L::kLdA + c) = v;
      }
    }
    __syncthreads();
    const float* A = EDGE ? At : H + kc;
    const int lda = EDGE ? L::kLdA : L::kLdH;
    for (int kk = 0; kk < kF32KC; ++kk) {
      float av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = A[(r0 + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < C / 32; ++j) {
        const float w = Wt[kk * L::kLdW + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(av[i], w, acc[i][j]);
      }
    }
  }
  __syncthreads();  // every warp is done reading Wt, At and H before they are rewritten
}

template <int C>
__global__ void __launch_bounds__(kF32MsgThreads, 2)
gnn_msg_f32_kernel(const MsgArgs args, const float* __restrict__ w0, const float* __restrict__ w1,
                   const float* __restrict__ w2) {
  using L = F32Layout<C>;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Wt = reinterpret_cast<float*>(smem_f32);
  float* At = reinterpret_cast<float*>(smem_f32 + L::kW);
  float* H = reinterpret_cast<float*>(smem_f32 + L::kW + L::kA);
  float* S = reinterpret_cast<float*>(smem_f32);  // after the last product only
  int* dst_s = reinterpret_cast<int*>(smem_f32 + L::kUnion);
  int* src_s = dst_s + kF32Edges;

  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kF32Edges;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 8;
  if (tid < kF32Edges) {
    const int ee = e0 + tid;
    dst_s[tid] = ee < args.E ? dst_of(args.rowptr, args.num_dst, ee) : 0;
    src_s[tid] = ee < args.E ? args.src[ee] : 0;
  }
  // (f32_product's first barrier publishes dst_s / src_s)
  const float* e_b = static_cast<const float*>(args.e) + (int64_t)b * args.E * C;
  const float* b1 = static_cast<const float*>(args.b1);
  const float* b2 = static_cast<const float*>(args.b2);
  float acc[8][C / 32];

  f32_product<C, true>(acc, w0, 3 * C, 2 * C, Wt, At, H, e_b, e0, args.E);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* pd = args.p_dst + ((int64_t)b * args.num_dst + dst_s[r0 + i]) * C;
    const float* ps = args.p_src + ((int64_t)b * args.num_src + src_s[r0 + i]) * C;
#pragma unroll
    for (int j = 0; j < C / 32; ++j) acc[i][j] = acc[i][j] + pd[lane + 32 * j] + ps[lane + 32 * j];
  }
  apply_act<8 * C / 32, false>(&acc[0][0], args.act);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < C / 32; ++j) H[(r0 + i) * L::kLdH + lane + 32 * j] = acc[i][j];
  f32_product<C, false>(acc, w1, C, 0, Wt, At, H, e_b, e0, args.E);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < C / 32; ++j) acc[i][j] += b1[lane + 32 * j];
  apply_act<8 * C / 32, false>(&acc[0][0], args.act);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < C / 32; ++j) H[(r0 + i) * L::kLdH + lane + 32 * j] = acc[i][j];
  f32_product<C, false>(acc, w2, C, 0, Wt, At, H, e_b, e0, args.E);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < C / 32; ++j) S[(r0 + i) * L::kLdH + lane + 32 * j] = acc[i][j];
  __syncthreads();

  // LayerNorm over each row (one warp per 8 rows), gamma, beta, + e
  const float* g = static_cast<const float*>(args.ln_g);
  const float* beta = static_cast<const float*>(args.ln_b);
  constexpr int kCols = C / 32;
  for (int r = r0; r < r0 + 8; ++r) {
    if (e0 + r >= args.E) break;
    float hv[kCols];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      hv[j] = S[r * L::kLdH + c] + b2[c];
      sum += hv[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) sq += (hv[j] - mu) * (hv[j] - mu);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rs = rsqrtf(sq / C + 1e-6f);
    const int64_t row = (int64_t)(e0 + r) * C;
    float* out = static_cast<float*>(args.msg) + (int64_t)b * args.E * C;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      out[row + c] = (hv[j] - mu) * rs * g[c] + beta[c] + e_b[row + c];
    }
  }
}

template <int C>
int launch_msg_f32(const MsgArgs& args, const void* w0, const void* w1, const void* w2, int batch,
                   cudaStream_t stream) {
  using L = F32Layout<C>;
  auto kernel = gnn_msg_f32_kernel<C>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((args.E + kF32Edges - 1) / kF32Edges, batch);
  kernel<<<grid, kF32MsgThreads, L::kBytes, stream>>>(args, static_cast<const float*>(w0),
                                                       static_cast<const float*>(w1), static_cast<const float*>(w2));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the whole conv
// ---------------------------------------------------------------------------

template <typename T>
int launch_gnn_conv(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                    const void* src, const void* w0, const void* b0, const void* w1,
                    const void* b1, const void* w2, const void* b2, const void* ln_g,
                    const void* ln_b, void* p_dst, void* p_src, void* msg, void* agg, int batch,
                    int num_dst, int num_src, int E, int C, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    int rc = launch_prepass<T>(x_dst, x_src, w0, b0, static_cast<float*>(p_dst), static_cast<float*>(p_src),
                               batch * num_dst, batch * num_src, C, s);
    if (rc != 0) return rc;
    const MsgArgs args{static_cast<const float*>(p_dst), static_cast<const float*>(p_src), e,
                       static_cast<const int*>(rowptr), static_cast<const int*>(src), b1, b2, ln_g, ln_b, msg,
                       num_dst, num_src, E, act};
    constexpr bool kBF16 = std::is_same<T, bf16>::value;
    switch (C) {  // the wrapper admits these widths only
      case 32:
        rc = kBF16 ? launch_msg_bf16<32>(args, w0, w1, w2, batch, s) : launch_msg_f32<32>(args, w0, w1, w2, batch, s);
        break;
      case 64:
        rc = kBF16 ? launch_msg_bf16<64>(args, w0, w1, w2, batch, s) : launch_msg_f32<64>(args, w0, w1, w2, batch, s);
        break;
      case 128:
        rc = kBF16 ? launch_msg_bf16<128>(args, w0, w1, w2, batch, s)
                   : launch_msg_f32<128>(args, w0, w1, w2, batch, s);
        break;
      case 256:
        rc = kBF16 ? launch_msg_bf16<256>(args, w0, w1, w2, batch, s)
                   : launch_msg_f32<256>(args, w0, w1, w2, batch, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
  }
  return launch_agg<T>(msg, rowptr, agg, batch, num_dst, E, C, s);
}

}  // namespace

extern "C" {

int gnn_conv_f32(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                 const void* src, const void* w0, const void* b0, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* ln_g, const void* ln_b, void* p_dst,
                 void* p_src, void* msg, void* agg, int batch, int num_dst, int num_src, int E, int C,
                 int act, void* stream) {
  return launch_gnn_conv<float>(x_dst, x_src, e, rowptr, src, w0, b0, w1, b1, w2, b2, ln_g, ln_b,
                                p_dst, p_src, msg, agg, batch, num_dst, num_src, E, C, act, stream);
}

int gnn_conv_bf16(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                  const void* src, const void* w0, const void* b0, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* ln_g, const void* ln_b, void* p_dst,
                  void* p_src, void* msg, void* agg, int batch, int num_dst, int num_src, int E, int C,
                  int act, void* stream) {
  return launch_gnn_conv<bf16>(x_dst, x_src, e, rowptr, src, w0, b0, w1, b1, w2, b2, ln_g, ln_b,
                               p_dst, p_src, msg, agg, batch, num_dst, num_src, E, C, act, stream);
}

// the pre-pass alone (P_dst, P_src), for its own timing and checks
int gnn_prepass_f32(const void* x_dst, const void* x_src, const void* w0, const void* b0, void* p_dst,
                    void* p_src, int rows_dst, int rows_src, int C, void* stream) {
  return launch_prepass<float>(x_dst, x_src, w0, b0, static_cast<float*>(p_dst), static_cast<float*>(p_src),
                               rows_dst, rows_src, C, static_cast<cudaStream_t>(stream));
}

int gnn_prepass_bf16(const void* x_dst, const void* x_src, const void* w0, const void* b0, void* p_dst,
                     void* p_src, int rows_dst, int rows_src, int C, void* stream) {
  return launch_prepass<bf16>(x_dst, x_src, w0, b0, static_cast<float*>(p_dst), static_cast<float*>(p_src),
                              rows_dst, rows_src, C, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
