// Hopper (sm_90a) backward of the GNN edge-MLP convolution, for every width
// C % 8 == 0 (the wrapper pads any other width with zero columns, and the
// LayerNorm's statistics run over the true width), every MLP depth and every
// activation of ops/gnn_conv.py:_ACT_CODES, in bf16 and fp32.
//
// The gradient of anemoi_models_tpu/ops/pallas/gnn_conv.py:_kernel (launched
// by slot_gnn_pallas; the JAX package's ops/slot_gnn.py:conv_bwd takes
// jax.vjp of its jnp twin and leaves every product to XLA). It computes the
// backward of ops/gnn_conv.py:gnn_conv_plain at the rounding points of
// gnn_conv_bwd_plain, per chunk of consecutive edge rows (a fixed count the
// wrapper sets, so the scratch is bounded and the work order fixed). Per
// edge row and Dense it recomputes the forward (z_i in fp32 for act', a_i
// rounded), runs the LayerNorm's backward, the input-gradient chain dh_{n-1}
// .. dh_0 (dh_{i-1} = round((dh_i . W_i) * act'(z_{i-1})), de = dmsg + dh_0 .
// W0[:, 2C:3C]) and the weight gradients dW_i = dh_i^T . a_{i-1} (a_{-1} = e),
// db_i = the column sums of dh_i; then sums dh_0 per destination (the CSR)
// and per source (the transposed CSR) and runs the first Dense's node-level
// products dx = round(dp) . W0's node block, dW0's node blocks = round(dp)^T
// . x.
//
// What bounds it on the H100, and the design (bf16):
//   - C <= 256 (the flagship's 256): launches and bytes. A product is 4 K
//     steps deep, so a launch per product is mostly fill and epilogue, and
//     every intermediate through device memory (z, a, h, dh and transposed
//     copies: about 15 KB an edge row at C = 256) costs more than the
//     operations (0.106 ms on the O96 processor set). So one kernel,
//     gnn_bwd_chain_kernel, takes 64 consecutive edge rows a CTA through the
//     whole chain: the recompute (Dense 0 from the e tile on the gathered P
//     rows, z_i into shared memory in fp32, a_i rounded into the shared A
//     tile, the next product's A operand), the LayerNorm backward in
//     registers, the input-gradient chain with each W_i streamed through a
//     three-stage TMA ring (K-major for the recompute, MN-major, as it lies,
//     for dh . W_i), de written once. Two consumer warpgroups split every
//     product's columns and epilogue (eight warps to wait on the epilogues'
//     loads; a row's statistics summed across the two through shared
//     memory), a producer warp issues the copies. Only a_i and dh_i, which
//     the weight gradients need, go to device memory (bf16, stored from the
//     A tile by TMA), with the tile's column sums (dgamma, dbeta, db_i) as
//     partials. At C = 256 with three Dense: 48 KB of ring, a 32 KB A tile
//     and 128 KB of z tiles a CTA, one CTA an SM. A first design (one
//     warpgroup, A operands in registers) spent its time in epilogues that
//     one warp an SMSP could not keep fed, and spilled.
//   - C > 256, or a depth whose z tiles do not fit (ops/gnn_conv.py:
//     _bwd_route): the layered chain, a launch per product, every product
//     on gemm_sm90_mn.cuh: the recompute with W_i K-major under ZPairs (z in
//     fp32 and a rounded), the LayerNorm backward a row kernel (the row in
//     registers up to C = 1024) that also sums db_{n-1}, each input
//     gradient with W_i read MN-major (no transposed weight copies) under
//     DaSums, which rounds dh_{i-1} and sums db_{i-1} per 64-row block
//     through shared memory. At C = 1024 the products run at 300-400
//     TFLOP/s; what remains exposed is each tile's epilogue (fp32 z and bf16
//     a, about 196 KB a 128 x 256 tile, stored while the tensor cores idle:
//     the two consumer warpgroups share a tile) and the LayerNorm pass's
//     second read of h. A ping-pong schedule (each warpgroup its own 64-row
//     tiles, one's epilogue beside the other's products) measured slower
//     (4.62 against 4.46 ms of products a processor call): a 64-row tile
//     reads its weight slices for half the rows. Folding the LayerNorm's
//     statistics into the last recompute's epilogue would need a row's C
//     columns in one CTA (four 256-column tiles at C = 1024): not done.
//   - The weight gradients reduce over edge rows. gemm_sm90_mn.cuh reads
//     dh_i and a_{i-1} MN-major straight from their row-major (edge row, C)
//     layout (wgmma's transpose immediates), so no chunk is copied
//     transposed, and one launch runs every Dense's product (grouped, K cut
//     into fixed ranges, each range's partial kept apart and added to
//     across chunks).
//   - The per-node sums write (first chunk) or add to dp in fp32; the last
//     chunk writes them rounded for the node products, which run as two
//     grouped launches (dx both sides, dW0's node blocks both sides) on the
//     same GEMM with fp32 accumulation. One launch sums every partial in a
//     fixed order (gnn_sum_segs_kernel).
//   Launches a call: the pre-pass, then per chunk the row table, the chain
//   (fused: 1; layered: 2 n + 1), the weight gradients, two CSR sums; then
//   two node products and the sums: 5 a chunk and 4 more on the fused route
//   (15 device kernels on the O96 processor set at C = 256, from 66).
//
// fp32 runs every product on gemm_sm90.cuh's CUDA-core tile (exact fp32;
// TF32 would miss the 1e-4 gate): operation-bound at 67 TFLOP/s, the weight
// gradients through transposed copies of the chunk (gnn_transpose_kernel,
// which also sums db), the node products per side.
//
// No atomics: each output element has one writer a launch, the launches run
// in order on one stream, and every split is a function of the shape, so two
// calls give the same bits.
//
// Bound on the H100 (989 TFLOP/s bf16): operations at C = 1024, three times
// the forward's (the recompute, then 4 C^2 per edge and Dense and 4 C^2 per
// node): on the O96 processor set (81,900 edges) 1.67 TFLOP, 1.69 ms; at
// C = 256 the 0.106 ms of operations against the bytes above. On an H100
// SXM (700 W) that set takes 1.08 ms at C = 256 (the fused chain 0.72 of
// it: its epilogues' loads and the weight slices it streams again for every
// 64 rows, about 1.8 GB from L2 a call) and 5.62 ms at C = 1024
// (kernel_turns.py; the design before this one: 1.91 and 6.88).
//
// The entry points have a plain C interface, launch on the stream they are
// given, allocate nothing and return cudaGetLastError().

#include "gemm_sm90_mn.cuh"  // the backward's bf16 GEMM (MN-major operands); includes gemm_sm90_ws.cuh
#include "gnn_common.cuh"     // the activations, the pre-pass, gnn_rows_kernel
#include "wgmma_ops.cuh"      // WgmmaSST

namespace {

using namespace sm90;

constexpr int kLnBwdWarps = 4;
constexpr int kLnBwdRows = 64;  // rows a CTA of the LayerNorm backward sums: ops/gnn_conv.py:_LN_BWD_ROWS
constexpr int kTr = 64;         // the fp32 route's transpose tile: rows and columns

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

// d act(x) / dx, as torch's autograd takes it (gnn_conv.py:act_grad); kFast (the bf16 route) takes exp and
// the quotients from the fast intrinsics (a few ulp of fp32, then rounded to bf16 with the product)
template <int A, bool kFast = false>
__device__ __forceinline__ float act_grad(float x) {
  auto ex = [](float v) { return kFast ? __expf(v) : expf(v); };
  auto rcp1p = [](float v) { return kFast ? __fdividef(1.f, 1.f + v) : 1.f / (1.f + v); };  // 1 / (1 + v)
  if constexpr (A == 1) {
    const float s = rcp1p(ex(-x));
    return s * (1.f + x * (1.f - s));
  } else if constexpr (A == 2) {
    constexpr float k = 0.7978845608028654f;
    const float t = tanhf(k * (x + 0.044715f * x * x * x));
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * k * (1.f + 3.f * 0.044715f * x * x);
  } else if constexpr (A == 3) {
    return x > 0.f ? 1.f : 0.f;
  } else if constexpr (A == 4) {
    const float t = tanhf(x);
    return 1.f - t * t;
  } else if constexpr (A == 5) {
    const float s = rcp1p(ex(-x));
    return s * (1.f - s);
  } else if constexpr (A == 6) {
    return x > 0.f ? 1.f : 0.01f;
  } else if constexpr (A == 7) {
    return x > 0.f ? 1.f : ex(x);
  } else if constexpr (A == 8) {
    return rcp1p(ex(-x));
  } else if constexpr (A == 9) {
    const float t = tanhf(fmaxf(x, 0.f) + log1pf(ex(-fabsf(x))));
    return t + x * rcp1p(ex(-x)) * (1.f - t * t);
  } else {
    return 1.f;
  }
}

#define GNN_BWD_ACT_DISPATCH(act, call) \
  switch (act) {                        \
    case 1: call(1); break;             \
    case 2: call(2); break;             \
    case 3: call(3); break;             \
    case 4: call(4); break;             \
    case 5: call(5); break;             \
    case 6: call(6); break;             \
    case 7: call(7); break;             \
    case 8: call(8); break;             \
    case 9: call(9); break;             \
    default: call(0); break;            \
  }

// ---------------------------------------------------------------------------
// epilogues: each stores the columns (col, col + 1) of an output row, in three
// steps, so that the walks below issue a batch of a row's loads before the
// stores they feed (a load issued after a store to possibly the same memory
// waits for it: gemm_sm90_ws.cuh): at(pb, row) -> the row's pointers,
// fetch(row, col) -> what the pair reads beside the product, put<A>(row,
// fetched, col, v0, v1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 pair_at(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a Dense recomputed: z = acc + (Dense 0: P_dst[dst] + P_src[src]; else its bias), fp32; a = round(act(z)) where
// asked (the last Dense writes h = z alone)
template <typename T>
struct ZPairs {
  static constexpr bool kAct = true;
  float* z;
  T* a;             // or null
  const T* bias;    // null for Dense 0
  const float* p_dst;
  const float* p_src;
  const int2* rows;  // Dense 0: each chunk row's P rows, else null
  int C;

  struct Row {
    const float* pd;  // Dense 0's gathered rows, else null
    const float* ps;
    float* z;
    T* a;
  };
  struct In {
    float2 x, y;
  };

  __device__ __forceinline__ Row at(int, int row) const {
    const int64_t o = static_cast<int64_t>(row) * C;
    Row r{nullptr, nullptr, z + o, a != nullptr ? a + o : nullptr};
    if (rows != nullptr) {
      const int2 pr = rows[row];
      r.pd = p_dst + static_cast<int64_t>(pr.x) * C;
      r.ps = p_src + static_cast<int64_t>(pr.y) * C;
    }
    return r;
  }
  __device__ __forceinline__ In fetch(const Row& r, int col) const {
    if (r.pd != nullptr) return In{pair_at(r.pd + col), pair_at(r.ps + col)};
    return In{pair_at(bias + col), make_float2(0.f, 0.f)};
  }
  template <int A>
  __device__ __forceinline__ void put(const Row& r, const In& in, int col, float v0, float v1) const {
    if (r.pd != nullptr) {
      v0 = (v0 + in.x.x) + in.y.x;
      v1 = (v1 + in.x.y) + in.y.y;
    } else {
      v0 += in.x.x;
      v1 += in.x.y;
    }
    store_pair(r.z + col, v0, v1);
    if (r.a != nullptr) {
      constexpr bool kFast = std::is_same<T, bf16>::value;  // as the forward's epilogues
      store_pair(r.a + col, act_fn<A, kFast>(v0), act_fn<A, kFast>(v1));
    }
  }
};

// a hidden Dense's input gradient: round((dh . W) * act'(z))
template <typename T>
struct DaPairs {
  static constexpr bool kAct = true;
  const float* z;
  T* out;
  int C;

  struct Row {
    const float* z;
    T* out;
  };
  struct In {
    float2 z;
  };

  __device__ __forceinline__ Row at(int, int row) const {
    const int64_t o = static_cast<int64_t>(row) * C;
    return Row{z + o, out + o};
  }
  __device__ __forceinline__ In fetch(const Row& r, int col) const { return In{pair_at(r.z + col)}; }
  template <int A>
  __device__ __forceinline__ void put(const Row& r, const In& in, int col, float v0, float v1) const {
    store_pair(r.out + col, v0 * act_grad<A>(in.z.x), v1 * act_grad<A>(in.z.y));
  }
};

// fp32 rows as they come (the node-level input gradients)
struct StorePairs {
  static constexpr bool kAct = false;
  float* out;
  int ld;

  struct In {};

  __device__ __forceinline__ float* at(int, int row) const { return out + static_cast<int64_t>(row) * ld; }
  __device__ __forceinline__ In fetch(float*, int) const { return In{}; }
  template <int A>
  __device__ __forceinline__ void put(float* r, const In&, int col, float v0, float v1) const {
    *reinterpret_cast<float2*>(r + col) = make_float2(v0, v1);
  }
};

// fp32 rows added to: Dense 0's edge-feature gradient (de, holding the LayerNorm's dmsg, += dh0 . W0[:, 2C:3C])
// and a weight gradient's partial of K range pb (written by the first chunk, added to by the others)
struct AddPairs {
  static constexpr bool kAct = false;
  float* out;      // (ranges, rows, ld)
  int rows, ld, accumulate;

  struct In {
    float2 old;
  };

  __device__ __forceinline__ float* at(int pb, int row) const {
    return out + (static_cast<int64_t>(pb) * rows + row) * ld;
  }
  __device__ __forceinline__ In fetch(float* r, int col) const {
    return In{accumulate ? pair_at(r + col) : make_float2(0.f, 0.f)};
  }
  template <int A>
  __device__ __forceinline__ void put(float* r, const In& in, int col, float v0, float v1) const {
    *reinterpret_cast<float2*>(r + col) = accumulate ? make_float2(in.old.x + v0, in.old.y + v1) : make_float2(v0, v1);
  }
};

// fp32: gemm_sm90.cuh's CUDA-core tile over K range blockIdx.z of `kchunk` columns
template <int A, class P>
__device__ __forceinline__ void f32_pairs(const P& p, const float (&acc)[kF32TM][kF32TN], int m, int n, int m0,
                                          int n0) {
  const int tx = threadIdx.x % (kF32BN / kF32TN);
  const int ty = threadIdx.x / (kF32BN / kF32TN);
#pragma unroll
  for (int i = 0; i < kF32TM; ++i) {
    const int row = m0 + ty * kF32TM + i;
    if (row >= m) continue;
    const auto r = p.at(blockIdx.z, row);
#pragma unroll
    for (int j = 0; j < kF32TN; j += 2) {
      const int col = n0 + tx * kF32TN + j;
      if (col < n) p.template put<A>(r, p.fetch(r, col), col, acc[i][j], acc[i][j + 1]);
    }
  }
}

template <class P>
__global__ void __launch_bounds__(kF32Threads) gnn_bwd_f32_kernel(ProjF32Problem pr, int K, int kchunk, const P p,
                                                                   int act) {
  const int m0 = blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * kF32BN;
  const int k0 = blockIdx.z * kchunk;
  const int klen = max(0, min(kchunk, K - k0));
  pr.a += k0;
  pr.b += k0;
  float acc[kF32TM][kF32TN];
  proj_f32_tile(pr, klen, m0, n0, acc);
  if constexpr (P::kAct) {
#define GNN_BWD_F32(a) f32_pairs<a>(p, acc, pr.m, pr.n, m0, n0)
    GNN_BWD_ACT_DISPATCH(act, GNN_BWD_F32)
#undef GNN_BWD_F32
  } else {
    f32_pairs<0>(p, acc, pr.m, pr.n, m0, n0);
  }
}

// fp32: out (m, n) pairs of epi(A (m, k; rows lda apart) . B (n, k; rows ldb apart)^T), K cut into `splits`
// ranges
template <typename T, class P>
int gemm(const void* a, int lda, const void* b, int ldb, int m, int n, int k, const P& p, int act, int splits,
         cudaStream_t s) {
  static_assert(std::is_same<T, float>::value, "the bf16 products run on gemm_sm90_mn.cuh");
  if (m <= 0 || n <= 0) return 0;
  const ProjF32Problem pr{static_cast<const float*>(a), static_cast<const float*>(b), nullptr, nullptr, m, n, lda,
                          ldb, 0};
  const int kchunk = (k + splits - 1) / splits;
  const dim3 grid((m + kF32BM - 1) / kF32BM, (n + kF32BN - 1) / kF32BN, splits);
  gnn_bwd_f32_kernel<P><<<grid, kF32Threads, 0, s>>>(pr, k, kchunk, p, act);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the LayerNorm backward, the fp32 route's transposes, sums
// ---------------------------------------------------------------------------

// the column sums of a warp's 16 rows: lanes l, l ^ 4, l ^ 8, l ^ 16 hold the same columns of other rows
__device__ __forceinline__ float rows_sum16(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  return s;
}

// A warp a row of the chunk: the LayerNorm's statistics over the first c_ln columns recomputed from the fp32 h,
// dmsg = g_msg + g_agg[dst] written to de, dh = rs (dy - mean dy - xhat mean(dy xhat)) rounded; dgamma, dbeta
// and (db, where given: the bf16 route) the column sums of the rounded dh summed per warp in shared memory, then
// over the CTA's warps in order into its partials (2, C) and db's row (C).
template <typename T>
__global__ void __launch_bounds__(32 * kLnBwdWarps)
gnn_ln_bwd_kernel(const float* __restrict__ h, const T* __restrict__ g_msg, const float* __restrict__ g_agg,
                  const int2* __restrict__ rows, const T* __restrict__ gamma, float* __restrict__ de,
                  T* __restrict__ dh, float* __restrict__ parts, float* __restrict__ db, int m, int C, int c_ln,
                  int accumulate) {
  extern __shared__ float sums[];  // [warp][dgamma C | dbeta C | db C]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mine = sums + warp * 3 * C;
  for (int c = lane; c < 3 * C; c += 32) mine[c] = 0.f;
  const int r_lo = blockIdx.x * kLnBwdRows;
  const int r_hi = min(r_lo + kLnBwdRows, m);
  for (int r = r_lo + warp; r < r_hi; r += kLnBwdWarps) {
    const float* hr = h + static_cast<int64_t>(r) * C;
    float sum = 0.f;
    for (int c = lane; c < c_ln; c += 32) sum += hr[c];
    const float mu = warp_sum(sum) / c_ln;
    float sq = 0.f;
    for (int c = lane; c < c_ln; c += 32) sq += (hr[c] - mu) * (hr[c] - mu);
    const float rs = rsqrtf(warp_sum(sq) / c_ln + 1e-6f);
    const T* gm = g_msg + static_cast<int64_t>(r) * C;
    const float* ga = g_agg + static_cast<int64_t>(rows[r].x) * C;
    float* der = de + static_cast<int64_t>(r) * C;
    float sdy = 0.f, sdyx = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float x = (hr[c] - mu) * rs;
      const float dm = to_f(gm[c]) + ga[c];
      der[c] = dm;
      mine[c] += dm * to_f(from_f<T>(x));
      mine[C + c] += dm;
      if (c < c_ln) {
        const float dy = dm * to_f(gamma[c]);
        sdy += dy;
        sdyx += dy * x;
      }
    }
    const float mdy = warp_sum(sdy) / c_ln, mdyx = warp_sum(sdyx) / c_ln;
    T* dhr = dh + static_cast<int64_t>(r) * C;
    for (int c = lane; c < C; c += 32) {
      const float x = (hr[c] - mu) * rs;
      const float dy = der[c] * to_f(gamma[c]);
      const T v = from_f<T>(c < c_ln ? rs * (dy - mdy - x * mdyx) : 0.f);
      dhr[c] = v;
      mine[2 * C + c] += to_f(v);
    }
  }
  __syncthreads();
  float* out = parts + static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < 3 * C; c += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kLnBwdWarps; ++w) v += sums[w * 3 * C + c];
    float* o = c < 2 * C ? out + c : db != nullptr ? db + static_cast<int64_t>(blockIdx.x) * C + c - 2 * C : nullptr;
    if (o != nullptr) *o = accumulate ? *o + v : v;
  }
}

// four adjacent values as one load or store
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}

// gnn_ln_bwd_kernel's function and order with the row in registers (C <= 128 NV): lane l holds columns
// 128 v + 4 l .. + 3, so h, g_msg, g_agg and gamma are each read once a row (the generic kernel reads h four
// times, a value at a time)
template <typename T, int NV>
__global__ void __launch_bounds__(32 * kLnBwdWarps)
gnn_ln_bwd_regs_kernel(const float* __restrict__ h, const T* __restrict__ g_msg, const float* __restrict__ g_agg,
                       const int2* __restrict__ rows, const T* __restrict__ gamma, float* __restrict__ de,
                       T* __restrict__ dh, float* __restrict__ parts, float* __restrict__ db, int m, int C, int c_ln,
                       int accumulate) {
  extern __shared__ float sums[];  // [warp][dgamma C | dbeta C | db C]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mine = sums + warp * 3 * C;
  for (int c = lane; c < 3 * C; c += 32) mine[c] = 0.f;
  __syncwarp();
  const int r_lo = blockIdx.x * kLnBwdRows;
  const int r_hi = min(r_lo + kLnBwdRows, m);
  for (int r = r_lo + warp; r < r_hi; r += kLnBwdWarps) {
    const float* hr = h + static_cast<int64_t>(r) * C;
    float hv[NV][4], dm[NV][4];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = 128 * v + 4 * lane;
      const float4 x = c < C ? load4(hr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      hv[v][0] = x.x;
      hv[v][1] = x.y;
      hv[v][2] = x.z;
      hv[v][3] = x.w;
      sum += (x.x + x.y) + (x.z + x.w);  // the padded columns hold 0
    }
    const float mu = warp_sum(sum) / c_ln;
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = 128 * v + 4 * lane + k < c_ln ? hv[v][k] - mu : 0.f;
        sq += d * d;
      }
    const float rs = rsqrtf(warp_sum(sq) / c_ln + 1e-6f);
    const T* gm = g_msg + static_cast<int64_t>(r) * C;
    const float* ga = g_agg + static_cast<int64_t>(rows[r].x) * C;
    float* der = de + static_cast<int64_t>(r) * C;
    float sdy = 0.f, sdyx = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = 128 * v + 4 * lane;
      if (c >= C) continue;
      const float4 g4 = load4(gm + c), a4 = load4(ga + c), w4 = load4(gamma + c);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, av[4] = {a4.x, a4.y, a4.z, a4.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w};
      float4* acc = reinterpret_cast<float4*>(mine + c);
      float4* accb = reinterpret_cast<float4*>(mine + C + c);
      float4 ga4 = *acc, gb4 = *accb;
      float dg[4] = {ga4.x, ga4.y, ga4.z, ga4.w}, dbt[4] = {gb4.x, gb4.y, gb4.z, gb4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float x = (hv[v][k] - mu) * rs;
        dm[v][k] = gv[k] + av[k];
        dg[k] += dm[v][k] * to_f(from_f<T>(x));
        dbt[k] += dm[v][k];
        if (c + k < c_ln) {
          const float dy = dm[v][k] * wv[k];
          sdy += dy;
          sdyx += dy * x;
        }
      }
      *acc = make_float4(dg[0], dg[1], dg[2], dg[3]);
      *accb = make_float4(dbt[0], dbt[1], dbt[2], dbt[3]);
      store4(der + c, make_float4(dm[v][0], dm[v][1], dm[v][2], dm[v][3]));
    }
    const float mdy = warp_sum(sdy) / c_ln, mdyx = warp_sum(sdyx) / c_ln;
    T* dhr = dh + static_cast<int64_t>(r) * C;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = 128 * v + 4 * lane;
      if (c >= C) continue;
      const float4 w4 = load4(gamma + c);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      float g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float x = (hv[v][k] - mu) * rs;
        g[k] = to_f(from_f<T>(c + k < c_ln ? rs * (dm[v][k] * wv[k] - mdy - x * mdyx) : 0.f));  // rounded
      }
      store4(dhr + c, make_float4(g[0], g[1], g[2], g[3]));
      float4* accd = reinterpret_cast<float4*>(mine + 2 * C + c);
      const float4 d4 = *accd;
      *accd = make_float4(d4.x + g[0], d4.y + g[1], d4.z + g[2], d4.w + g[3]);
    }
  }
  __syncthreads();
  float* out = parts + static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < 3 * C; c += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kLnBwdWarps; ++w) v += sums[w * 3 * C + c];
    float* o = c < 2 * C ? out + c : db != nullptr ? db + static_cast<int64_t>(blockIdx.x) * C + c - 2 * C : nullptr;
    if (o != nullptr) *o = accumulate ? *o + v : v;
  }
}

// two adjacent values as one load or store (8 bytes in fp32)
// out (C, ld) = in (m, C)^T (fp32), 64 x 64 tiles through shared memory; with `sums`, each tile's column sums
// over its 64 rows into sums[row block] (written by the first chunk, added to by the others)
__global__ void __launch_bounds__(256) gnn_transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                                                            float* __restrict__ sums, int m, int C, int ld,
                                                            int accumulate) {
  __shared__ float tile[kTr][kTr + 1];
  const int r0 = blockIdx.y * kTr, c0 = blockIdx.x * kTr;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < kTr; i += 8) {  // input row r0 + i, columns c0 + 2 tx, + 1 (C % 8 == 0: both or none)
    const int r = r0 + i, c = c0 + 2 * tx;
    const float2 v = r < m && c < C ? *reinterpret_cast<const float2*>(in + static_cast<int64_t>(r) * C + c)
                                    : make_float2(0.f, 0.f);
    tile[i][2 * tx] = v.x;
    tile[i][2 * tx + 1] = v.y;
  }
  __syncthreads();
  for (int i = ty; i < kTr; i += 8) {  // output row c0 + i, columns r0 + 2 tx, + 1
    const int c = c0 + i, r = r0 + 2 * tx;
    if (c >= C || r >= m) continue;
    float* o = out + static_cast<int64_t>(c) * ld + r;
    if (r + 1 < m) {
      *reinterpret_cast<float2*>(o) = make_float2(tile[2 * tx][i], tile[2 * tx + 1][i]);
    } else {
      *o = tile[2 * tx][i];
    }
  }
  if (sums != nullptr && ty == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = c0 + 2 * tx + k;
      if (c >= C) continue;
      float sum = 0.f;
      for (int i = 0; i < kTr; ++i) sum += tile[i][2 * tx + k];
      float* p = sums + static_cast<int64_t>(blockIdx.y) * C + c;
      *p = accumulate ? *p + sum : sum;
    }
  }
}

// dp[b, d] = (the earlier chunks' dp[b, d], where accumulate) + the sum of dh's rows of (b, d)'s CSR range inside
// the chunk, in edge order: a CTA a (batch, destination), a thread a column; the first chunk writes every row, a
// later one the rows with an edge in it; with `rounded` (the bf16 route's last chunk) every row's total goes
// there rounded instead
template <typename T>
__global__ void gnn_dst_sum_kernel(const T* __restrict__ dh, const int* __restrict__ rowptr, float* __restrict__ dp,
                                   T* __restrict__ rounded, int64_t r0, int m, int E, int num_dst, int C,
                                   int accumulate) {
  const int row = blockIdx.x;
  const int b = row / num_dst, d = row - b * num_dst;
  const int64_t base = static_cast<int64_t>(b) * E - r0;  // edge ee is chunk row base + ee
  const int64_t lo = max(static_cast<int64_t>(rowptr[d]), -base);
  const int64_t hi = min(static_cast<int64_t>(rowptr[d + 1]), m - base);
  if (accumulate && lo >= hi && rounded == nullptr) return;  // no edge of the row in this chunk: dp as it is
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int64_t ee = lo; ee < hi; ++ee) acc += to_f(dh[(base + ee) * C + c]);
    const int64_t o = static_cast<int64_t>(row) * C + c;
    const float v = accumulate ? dp[o] + acc : acc;
    if (rounded != nullptr) {
      rounded[o] = from_f<T>(v);
    } else {
      dp[o] = v;
    }
  }
}

// the same per source s over the transposed CSR's order
template <typename T>
__global__ void gnn_src_sum_kernel(const T* __restrict__ dh, const int* __restrict__ colptr,
                                   const int* __restrict__ perm, float* __restrict__ dp, T* __restrict__ rounded,
                                   int64_t r0, int m, int E, int num_src, int C, int accumulate) {
  const int row = blockIdx.x;
  const int b = row / num_src, sidx = row - b * num_src;
  const int64_t base = static_cast<int64_t>(b) * E - r0;
  const bool hit = base + E > 0 && base < m;  // the batch's edges meet the chunk
  const int lo = colptr[sidx], hi = hit ? colptr[sidx + 1] : lo;
  if (accumulate && rounded == nullptr) {  // no edge of the row in this chunk: dp as it is
    bool any = false;
    for (int k = lo; k < hi && !any; ++k) any = base + perm[k] >= 0 && base + perm[k] < m;
    if (!any) return;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) {
      const int64_t r = base + perm[k];
      if (r >= 0 && r < m) acc += to_f(dh[r * C + c]);
    }
    const int64_t o = static_cast<int64_t>(row) * C + c;
    const float v = accumulate ? dp[o] + acc : acc;
    if (rounded != nullptr) {
      rounded[o] = from_f<T>(v);
    } else {
      dp[o] = v;
    }
  }
}

template <typename T>
int csr_sums(const T* dh, const void* rowptr, const void* colptr, const void* perm, float* dp_dst, float* dp_src,
             T* round_dst, T* round_src, int64_t r0, int m, int E, int batch, int num_dst, int num_src, int C,
             int accumulate, cudaStream_t s) {
  const int threads = C < 256 ? ((C + 31) / 32) * 32 : 256;
  gnn_dst_sum_kernel<T><<<batch * num_dst, threads, 0, s>>>(dh, static_cast<const int*>(rowptr), dp_dst, round_dst,
                                                            r0, m, E, num_dst, C, accumulate);
  gnn_src_sum_kernel<T><<<batch * num_src, threads, 0, s>>>(dh, static_cast<const int*>(colptr),
                                                            static_cast<const int*>(perm), dp_src, round_src, r0, m, E,
                                                            num_src, C, accumulate);
  return static_cast<int>(cudaGetLastError());
}

// every partial sum of the call in one launch: segment blockIdx.y's out[i] = sum over p of parts[p][i], p in order
constexpr int kMaxSegs = 16;
struct SumSeg {
  const float* parts;
  float* out;
  int n_parts;
  int64_t len;
};
struct SumSegs {
  SumSeg s[kMaxSegs];
};

__global__ void __launch_bounds__(256) gnn_sum_segs_kernel(const __grid_constant__ SumSegs segs) {
  const SumSeg& g = segs.s[blockIdx.y];
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < g.len;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    int p = 0;
    for (; p + 8 <= g.n_parts; p += 8) {  // eight loads in flight, added in order
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = g.parts[(p + k) * g.len + i];
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
    for (; p < g.n_parts; ++p) s += g.parts[p * g.len + i];
    g.out[i] = s;
  }
}

int sum_segs(const SumSeg* segs, int count, cudaStream_t s) {
  if (count <= 0 || count > kMaxSegs) return static_cast<int>(cudaErrorInvalidValue);
  SumSegs all{};
  int64_t len = 0;
  for (int i = 0; i < count; ++i) {
    all.s[i] = segs[i];
    len = segs[i].len > len ? segs[i].len : len;
  }
  const int64_t blocks = (len + 255) / 256;
  gnn_sum_segs_kernel<<<dim3(static_cast<unsigned>(blocks < 1024 ? blocks : 1024), count), 256, 0, s>>>(all);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 route's first-Dense per-node gradients, one side: dx (rows, C) = dp . W^T-copy, and dW (C, C) =
// dp^T . x over the node rows (in chunks of rows, through transposed copies), partials summed in order.
int node_grads_f32(const float* dp, const float* x, const void* w_t, float* dx, float* dw, float* parts, void* tr_a,
                   void* tr_b, int ld_t, int rows, int C, int chunk_rows, int splits, cudaStream_t s) {
  int rc = gemm<float>(dp, C, w_t, C, rows, C, C, StorePairs{dx, C}, 0, 1, s);
  for (int r0 = 0; rc == 0 && r0 < rows; r0 += chunk_rows) {
    const int m = rows - r0 < chunk_rows ? rows - r0 : chunk_rows;
    const dim3 grid((C + kTr - 1) / kTr, (m + kTr - 1) / kTr);
    gnn_transpose_kernel<<<grid, 256, 0, s>>>(dp + static_cast<int64_t>(r0) * C, static_cast<float*>(tr_a), nullptr,
                                              m, C, ld_t, 0);
    gnn_transpose_kernel<<<grid, 256, 0, s>>>(x + static_cast<int64_t>(r0) * C, static_cast<float*>(tr_b), nullptr, m,
                                              C, ld_t, 0);
    rc = static_cast<int>(cudaGetLastError());
    if (rc == 0) rc = gemm<float>(tr_a, ld_t, tr_b, ld_t, C, C, m, AddPairs{parts, C, C, r0 > 0}, 0, splits, s);
  }
  const SumSeg seg{parts, dw, splits, static_cast<int64_t>(C) * C};
  return rc != 0 ? rc : sum_segs(&seg, 1, s);
}

// ---------------------------------------------------------------------------
// bf16: the backward GEMM's epilogues (gemm_sm90_mn.cuh)
// ---------------------------------------------------------------------------

using sm90mn::kMnMaxProblems;

// any of the pair types above, one per problem of a grouped launch (the K range's index as AddPairs' partial),
// the activation dispatched once a tile for the types that take one (ZPairs)
template <class P>
struct MnPairs {
  P p[kMnMaxProblems];
  int m[kMnMaxProblems];  // each problem's output rows
  int n, act;

  template <int BN, int A>
  __device__ __forceinline__ void walk(const float* acc, int pb, int sp, int m0, int n0, int r0, int c_lo) const {
    constexpr int kBatch = 8;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = m0 + r0 + 8 * q;
      if (row >= m[pb]) continue;
      const auto r = p[pb].at(sp, row);
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kBatch) {
        asm volatile("" ::: "memory");
        typename P::In in[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (n0 + 8 * (j0 + j) < n) in[j] = p[pb].fetch(r, n0 + 8 * (j0 + j) + c_lo);
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (n0 + 8 * (j0 + j) < n)
            p[pb].template put<A>(r, in[j], n0 + 8 * (j0 + j) + c_lo, acc[4 * (j0 + j) + 2 * q],
                                  acc[4 * (j0 + j) + 2 * q + 1]);
      }
    }
  }

  template <int BN>
  __device__ __forceinline__ void store(const float* acc, int pb, int sp, int m0, int n0, int r0, int c_lo,
                                        float*) const {
    if constexpr (P::kAct) {
#define GNN_BWD_MN(a) walk<BN, a>(acc, pb, sp, m0, n0, r0, c_lo)
      GNN_BWD_ACT_DISPATCH(act, GNN_BWD_MN)
#undef GNN_BWD_MN
    } else {
      walk<BN, 0>(acc, pb, sp, m0, n0, r0, c_lo);
    }
  }
};

// a hidden Dense's input gradient dh = round((dh' . W) * act'(z)) (one problem), and db's column sums of the
// rounded rows over each 64-row block of the chunk into db (blocks, C): written by the first chunk, added to by
// the others
struct DaSums {
  const float* z;
  bf16* out;
  float* db;
  int m, C, act, accumulate;

  template <int BN, int A>
  __device__ __forceinline__ void walk(const float* acc, int m0, int n0, int r0, int c_lo, float* sums) const {
    constexpr int kBatch = 8;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    bool ok[2];
    int64_t off[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = m0 + r0 + 8 * q;
      ok[q] = row < m;
      off[q] = static_cast<int64_t>(ok[q] ? row : 0) * C;
    }
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += kBatch) {
      asm volatile("" ::: "memory");
      float2 zz[kBatch][2];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = n0 + 8 * (j0 + j) + c_lo;
          zz[j][q] = ok[q] && col < C ? pair_at(z + off[q] + col) : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int col = n0 + 8 * (j0 + j) + c_lo;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (!ok[q] || col >= C) continue;
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * (j0 + j) + 2 * q] * act_grad<A, true>(zz[j][q].x),
                                                         acc[4 * (j0 + j) + 2 * q + 1] * act_grad<A, true>(zz[j][q].y));
          *reinterpret_cast<__nv_bfloat162*>(out + off[q] + col) = v;
          s0 += to_f(v.x);
          s1 += to_f(v.y);
        }
        s0 = rows_sum16(s0);
        s1 = rows_sum16(s1);
        if (lane < 4) {
          sums[warp * BN + 8 * (j0 + j) + c_lo] = s0;
          sums[warp * BN + 8 * (j0 + j) + c_lo + 1] = s1;
        }
      }
    }
  }

  template <int BN>
  __device__ __forceinline__ void store(const float* acc, int, int, int m0, int n0, int r0, int c_lo,
                                        float* sums) const {
#define GNN_BWD_DA(a) walk<BN, a>(acc, m0, n0, r0, c_lo, sums)
    GNN_BWD_ACT_DISPATCH(act, GNN_BWD_DA)
#undef GNN_BWD_DA
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int rb = m0 + (r0 / 64) * 64;  // the warpgroup's 64 rows of the tile
    named_barrier(1 + wg, 128);
    if (rb < m) {
      float* row = db + static_cast<int64_t>(rb / 64) * C;
      for (int c = t; c < BN; c += 128) {
        if (n0 + c >= C) continue;
        const float s = ((sums[c] + sums[BN + c]) + sums[2 * BN + c]) + sums[3 * BN + c];
        row[n0 + c] = accumulate ? row[n0 + c] + s : s;
      }
    }
    named_barrier(1 + wg, 128);
  }
};

// the backward GEMM's width of a tile: 256 where it divides C, else 128
inline int mn_bn(int C) { return C % 256 == 0 ? 256 : 128; }

// the product of `count` problems set in args (widths C, tiles of mn_bn(C) columns) under epi
template <bool kAMN, bool kBMN, class Epi>
int mn_gemm(sm90mn::MnArgs& args, int count, int C, const Epi& epi, cudaStream_t s) {
  return mn_bn(C) == 256 ? sm90mn::launch_mn_gemm<256, kAMN, kBMN>(args, count, epi, s)
                         : sm90mn::launch_mn_gemm<128, kAMN, kBMN>(args, count, epi, s);
}

// ---------------------------------------------------------------------------
// bf16, C in {32, 64, 128, 256}: the fused chain, a CTA per 64 consecutive edge rows
// ---------------------------------------------------------------------------

constexpr int kChainRows = 64;      // edge rows a CTA
constexpr int kChainThreads = 288;  // two consumer warpgroups (half of the columns each) and a producer warp
constexpr int kChainMaxDense = 4;
constexpr int kChainStages = 3;

template <int C>
struct Chain {
  static constexpr int kH = C / 2;                  // the columns a warpgroup owns
  static constexpr int kR = kH / 2;                 // its accumulator registers a thread
  static constexpr int kBK = C == 256 ? 32 : C < 64 ? C : 64;  // K of a weight slice (32 at C = 256: three stages fit)
  static constexpr int kSWB = 2 * kBK;              // a K-major slice's swizzle: rows of kBK bf16
  static constexpr int kKT = C / kBK;               // slices of a product
  static constexpr int kW = C * kBK * 2;            // one weight slice
  static constexpr int kNB = kH < 64 ? kH : 64;     // an MN-major slice's boxes: kBK rows x kNB columns
  static constexpr int kSWN = 2 * kNB;
  static constexpr int kMNBox = kBK * kSWN;
  static constexpr int kABlk = C < 64 ? C : 64;     // the A tile (e, a_i, dh_i): 64 rows in blocks of kABlk columns
  static constexpr int kSWA = 2 * kABlk;
  static constexpr int kABlkBytes = kChainRows * kSWA;
  static constexpr int kAOff = kChainStages * kW;
  static constexpr int kZOff = kAOff + kChainRows * C * 2;
  static constexpr int kZ = kChainRows * C * 4;     // one fp32 z tile
  __host__ __device__ static constexpr int sum_off(int n) { return kZOff + (n - 1) * kZ; }
  __host__ __device__ static constexpr int x_off(int n) { return sum_off(n) + 2 * 4 * 2 * kH * 4; }
  __host__ __device__ static constexpr int bar_off(int n) { return x_off(n) + 4 * 2 * kChainRows * 4; }
  __host__ __device__ static constexpr size_t smem(int n) { return 1024 + bar_off(n) + (2 * kChainStages + 1) * 8; }
};

struct ChainMaps {
  CUtensorMap e;                         // the chunk's edge rows (m, C), boxes of 64 x kABlk
  CUtensorMap fwd[kChainMaxDense];       // W_i (C, K) as it lies, boxes of C x kBK: K-major, the recompute
  CUtensorMap bwd[kChainMaxDense];       // the same, boxes of kBK x kNB: MN-major, the input gradients dh . W_i
  CUtensorMap a[kChainMaxDense - 1];     // a_i's chunk slot (m, C), boxes of 64 x kABlk: stored from the A tile
  CUtensorMap dh[kChainMaxDense];        // dh_i's
};

struct ChainArgs {
  const float* p_dst;
  const float* p_src;
  const int2* rows;
  const bf16* bias[kChainMaxDense];  // b_1 .. b_{n-1}
  const bf16* gamma;
  const bf16* g_msg;  // the chunk's rows
  const float* g_agg;
  float* de;          // the chunk's rows
  float* db_parts;    // (n, blocks, C)
  float* ln_parts;    // (blocks, 2, C)
  int m, blocks, n_dense, act, accumulate;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one box of shared memory to a 2-D tensor map's (col, row), asynchronously (a bulk group of this thread)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int col, int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(col), "r"(row)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// v[r] *= act'(z[r * 128 + t]) for a thread's N accumulators (z in the warpgroup's thread-major tile)
template <int N, int A>
__device__ __forceinline__ void mul_act_grad(float* v, const float* z, int t) {
#pragma unroll
  for (int r = 0; r < N; ++r) v[r] *= act_grad<A, true>(z[r * 128 + t]);
}

// A warpgroup's column sums (sums [4][ld] of its warps' 16-row sums, written before the barrier) in warp order
// into out (ncols), written or added to
__device__ __forceinline__ void flush_sums(const float* sums, int ld, float* out, int ncols, int accumulate, int wg) {
  named_barrier(2 + wg, 128);
  for (int c = threadIdx.x % 128; c < ncols; c += 128) {
    const float s = ((sums[c] + sums[ld + c]) + sums[2 * ld + c]) + sums[3 * ld + c];
    out[c] = accumulate ? out[c] + s : s;
  }
  named_barrier(2 + wg, 128);
}

// Per 64 edge rows, the whole chain in one CTA: the forward recomputed (z_i fp32 in shared memory, a_i rounded
// into the A tile, the next product's A operand, and stored from there by TMA), the LayerNorm backward, the
// input-gradient chain dh_{n-1} .. dh_0 (each W_i read MN-major; dh_i through the A tile and stored by TMA), de
// written once. Two consumer warpgroups split every product's N (the columns) and every epilogue, so each has
// C / 4 accumulator registers a thread and the SM eight warps for the epilogues' loads; the row statistics of
// the LayerNorm are summed across the two through shared memory. The weights (and, first, the e tile) stream
// through a three-stage ring that the producer warp fills by TMA. The column sums (dgamma, dbeta, db_i) are the
// tile's partials.
template <int C>
__global__ void __launch_bounds__(kChainThreads, 1)
gnn_bwd_chain_kernel(const __grid_constant__ ChainMaps maps, const ChainArgs args) {
  using L = Chain<C>;
  constexpr int kR = L::kR;
  constexpr int kH = L::kH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int n = args.n_dense;
  uint8_t* a_tile = smem + L::kAOff;
  float* zs = reinterpret_cast<float*>(smem + L::kZOff);
  float* xs = reinterpret_cast<float*>(smem + L::x_off(n));  // [exchange][warpgroup][row]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off(n));
  uint64_t* empty = full + kChainStages;
  uint64_t* e_full = empty + kChainStages;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int row0 = tile * kChainRows;
  const int products = 2 * n;
  if (tid == 0) {
    for (int s = 0; s < kChainStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // a consumer warp each
    }
    mbar_init(e_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: lane 0 issues every copy, in the consumers' order
    if (tid == 256) {
      mbar_expect_tx(e_full, kChainRows * C * 2);
      for (int x = 0; x < C / L::kABlk; ++x)
        tma_load_2d(a_tile + x * L::kABlkBytes, &maps.e, e_full, x * L::kABlk, row0);
      int p = 0;
      for (int g = 0; g < products; ++g) {
        for (int kt = 0; kt < L::kKT; ++kt, ++p) {
          const int s = p % kChainStages;
          if (p >= kChainStages) mbar_wait(empty + s, ((p / kChainStages) - 1) & 1);
          uint8_t* stage = smem + s * L::kW;
          mbar_expect_tx(full + s, L::kW);
          if (g < n) {  // the recompute: W_g's K columns kt kBK .. (Dense 0: W0[:, 2C:3C])
            tma_load_2d(stage, &maps.fwd[g], full + s, (g == 0 ? 2 * C : 0) + kt * L::kBK, 0);
          } else {  // dh_i . W_i: rows kt kBK .. of W_i (C_out), every column block (C_in)
            const int i = products - 1 - g;
            for (int x = 0; x < C / L::kNB; ++x)
              tma_load_2d(stage + x * L::kMNBox, &maps.bwd[i], full + s, (i == 0 ? 2 * C : 0) + x * L::kNB,
                          kt * L::kBK);
          }
        }
      }
    }
    return;
  }

  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);
  const int col0 = wg * kH;  // the warpgroup's columns: col0 + 8 j + c_lo, + 1
  float* sums = reinterpret_cast<float*>(smem + L::sum_off(n)) + wg * 4 * 2 * kH;  // [warp][2 kH]
  int rowq[2];
  bool ok[2];
  int2 rw[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    rowq[q] = row0 + r_lo + 8 * q;
    ok[q] = rowq[q] < args.m;
    rw[q] = ok[q] ? args.rows[rowq[q]] : make_int2(0, 0);
    if (!ok[q]) rowq[q] = 0;  // a row past the chunk reads row 0 and stores nothing
  }
  float acc[kR];
  int p = 0;
  constexpr int kBatch = kH / 8 < 8 ? kH / 8 : 8;  // column blocks whose loads an epilogue keeps in flight

  // acc (+)= A tile . B over product g's K slices, this warpgroup's columns: the recompute reads W_g K-major, the
  // input gradients W_i MN-major; product 0 adds to acc, the others overwrite it
  auto product = [&](int g) {
#pragma unroll
    for (int kt = 0; kt < L::kKT; ++kt) {
      const int s = p % kChainStages;
      mbar_wait(full + s, (p / kChainStages) & 1);
      const uint8_t* stage = smem + s * L::kW;
      fence_regs<kR>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < L::kBK / 16; ++k) {
        const int kk = kt * L::kBK + 16 * k;
        const uint64_t da = make_desc<L::kSWA>(a_tile + (kk / L::kABlk) * L::kABlkBytes + (kk % L::kABlk) * 2);
        const int sc = g == 0 || kt > 0 || k > 0;
        if (g < n) {
          WgmmaSST<kH, 0, 0>::mma(acc, da, make_desc<L::kSWB>(stage + col0 * L::kSWB + 32 * k), sc);
        } else {
          WgmmaSST<kH, 0, 1>::mma(
              acc, da, make_desc_mn_bits(stage + (col0 / L::kNB) * L::kMNBox + k * 16 * L::kSWN, L::kSWN, L::kMNBox),
              sc);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kR>(acc);
      if (lane == 0) mbar_arrive(empty + s);
      ++p;
    }
  };
  // the A tile's byte offset of (row, col) in the TMA's swizzle
  auto a_at = [&](int row, int col) {
    return (col / L::kABlk) * L::kABlkBytes + swizzle<L::kSWA>(row * L::kSWA + (col % L::kABlk) * 2);
  };
  // the A tile rewritten from acc (rounded) once the products that read it and the store of it are done, then
  // published to the next product and stored to `map` by TMA
  auto to_tile = [&](const CUtensorMap* map) {
    if (tid == 0) bulk_wait_read();
    named_barrier(1, 256);
#pragma unroll
    for (int j = 0; j < kH / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        *reinterpret_cast<uint32_t*>(a_tile + a_at(r_lo + 8 * q, col0 + 8 * j + c_lo)) =
            pack_bf16(acc[4 * j + 2 * q], acc[4 * j + 2 * q + 1]);
    fence_proxy_async();
    named_barrier(1, 256);
    if (tid == 0) {
      for (int x = 0; x < C / L::kABlk; ++x) tma_store_2d(map, a_tile + x * L::kABlkBytes, x * L::kABlk, row0);
      bulk_commit();
    }
  };
  // acc += the bias of Dense i
  auto add_bias = [&](int i) {
    const bf16* b = args.bias[i] + col0 + c_lo;
#pragma unroll
    for (int j = 0; j < kH / 8; ++j) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(b + 8 * j);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        acc[4 * j + 2 * q] += to_f(v.x);
        acc[4 * j + 2 * q + 1] += to_f(v.y);
      }
    }
  };
  // the sum over both warpgroups of a per-row value (v[q]: this warpgroup's part of row r_lo + 8 q, the same on
  // the quad's four lanes), through exchange slot x: warpgroup 0's part + warpgroup 1's
  auto row_sum = [&](float (&v)[2], int x) {
    float* mine = xs + (x * 2 + wg) * kChainRows;
    if (lane % 4 == 0) {
      mine[r_lo] = v[0];
      mine[r_lo + 8] = v[1];
    }
    named_barrier(1, 256);
    const float* x0 = xs + (x * 2) * kChainRows;
#pragma unroll
    for (int q = 0; q < 2; ++q) v[q] = x0[r_lo + 8 * q] + x0[kChainRows + r_lo + 8 * q];
  };

  // Dense 0: z_0 = (P_dst[dst] + P_src[src]) + e . W0[:, 2C:3C]^T, the gathered rows loaded while the e tile
  // and the first weight slices arrive
  {
    const float* pd[2] = {args.p_dst + static_cast<int64_t>(rw[0].x) * C + col0 + c_lo,
                          args.p_dst + static_cast<int64_t>(rw[1].x) * C + col0 + c_lo};
    const float* ps[2] = {args.p_src + static_cast<int64_t>(rw[0].y) * C + col0 + c_lo,
                          args.p_src + static_cast<int64_t>(rw[1].y) * C + col0 + c_lo};
#pragma unroll
    for (int j = 0; j < kH / 8; ++j) {
      if (j % kBatch == 0) asm volatile("" ::: "memory");  // a batch of column blocks' loads in flight, not all
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 x = *reinterpret_cast<const float2*>(pd[q] + 8 * j);
        const float2 y = *reinterpret_cast<const float2*>(ps[q] + 8 * j);
        acc[4 * j + 2 * q] = x.x + y.x;
        acc[4 * j + 2 * q + 1] = x.y + y.y;
      }
    }
  }
  mbar_wait(e_full, 0);
  const bf16* gm[2] = {args.g_msg + static_cast<int64_t>(rowq[0]) * C + col0 + c_lo,
                       args.g_msg + static_cast<int64_t>(rowq[1]) * C + col0 + c_lo};
  const float* ga[2] = {args.g_agg + static_cast<int64_t>(rw[0].x) * C + col0 + c_lo,
                        args.g_agg + static_cast<int64_t>(rw[1].x) * C + col0 + c_lo};
  // dmsg = g_msg + g_agg[dst] of the thread's column pair j, row q
  auto dmsg = [&](int q, int j) {
    const __nv_bfloat162 g = *reinterpret_cast<const __nv_bfloat162*>(gm[q] + 8 * j);
    const float2 a = *reinterpret_cast<const float2*>(ga[q] + 8 * j);
    return make_float2(to_f(g.x) + a.x, to_f(g.y) + a.y);
  };
  const bf16* gam = args.gamma + col0 + c_lo;
  // product g, then its epilogue: g < n - 1 a hidden Dense's z_g and a_g; g = n - 1 the LayerNorm's backward
  // and dh_{n-1}; then the input gradients dh_{i-1} = round((dh_i . W_i) * act'(z_{i-1})), i = 2n - 1 - g; the
  // last de = dmsg + dh_0 . W0[:, 2C:3C]. One loop, so that each step's code is inlined once.
  for (int g = 0; g < products; ++g) {
    product(g);
    if (g > 0 && g < n) add_bias(g);
    const CUtensorMap* out_map = &maps.a[g < n - 1 ? g : 0];
    if (g < n - 1) {
      float* z = zs + static_cast<size_t>(2 * g + wg) * kR * 128;
#pragma unroll
      for (int r = 0; r < kR; ++r) z[r * 128 + t] = acc[r];
      apply_act<kR, true>(acc, args.act);
    } else if (g == products - 1) {
#pragma unroll
      for (int j = 0; j < kH / 8; ++j) {
        if (j % kBatch == 0) asm volatile("" ::: "memory");
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (!ok[q]) continue;
          const float2 dm = dmsg(q, j);
          *reinterpret_cast<float2*>(args.de + static_cast<int64_t>(rowq[q]) * C + col0 + 8 * j + c_lo) =
              make_float2(dm.x + acc[4 * j + 2 * q], dm.y + acc[4 * j + 2 * q + 1]);
        }
      }
      break;
    } else {
      if (g == n - 1) {  // h in acc: the LayerNorm's backward; a row's columns sit in a quad of each warpgroup
        float mu[2], rs[2];
        {
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kH / 8; ++j) sum += acc[4 * j + 2 * q] + acc[4 * j + 2 * q + 1];
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            v[q] = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
          }
          row_sum(v, 0);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            mu[q] = v[q] / C;
            float sq = 0.f;
#pragma unroll
            for (int j = 0; j < kH / 8; ++j) {
              const float d0 = acc[4 * j + 2 * q] - mu[q], d1 = acc[4 * j + 2 * q + 1] - mu[q];
              sq += d0 * d0 + d1 * d1;
            }
            sq += __shfl_xor_sync(0xffffffffu, sq, 1);
            v[q] = sq + __shfl_xor_sync(0xffffffffu, sq, 2);
          }
          row_sum(v, 1);
#pragma unroll
          for (int q = 0; q < 2; ++q) rs[q] = rsqrtf(v[q] / C + 1e-6f);
        }
        float sdy[2] = {0.f, 0.f}, sdyx[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kH / 8; ++j) {
          if (j % kBatch == 0) asm volatile("" ::: "memory");
          const __nv_bfloat162 gg = *reinterpret_cast<const __nv_bfloat162*>(gam + 8 * j);
          float dg0 = 0.f, dg1 = 0.f, db0 = 0.f, db1 = 0.f;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float2 dm = dmsg(q, j);
            const float x0 = (acc[4 * j + 2 * q] - mu[q]) * rs[q], x1 = (acc[4 * j + 2 * q + 1] - mu[q]) * rs[q];
            if (ok[q]) {
              dg0 += dm.x * to_f(round_bf16(x0));
              dg1 += dm.y * to_f(round_bf16(x1));
              db0 += dm.x;
              db1 += dm.y;
            }
            const float dy0 = dm.x * to_f(gg.x), dy1 = dm.y * to_f(gg.y);
            sdy[q] += dy0 + dy1;
            sdyx[q] += dy0 * x0 + dy1 * x1;
          }
          dg0 = rows_sum16(dg0);
          dg1 = rows_sum16(dg1);
          db0 = rows_sum16(db0);
          db1 = rows_sum16(db1);
          if (lane < 4) {
            float* w = sums + warp * 2 * kH + 8 * j + c_lo;
            w[0] = dg0;
            w[1] = dg1;
            w[kH] = db0;
            w[kH + 1] = db1;
          }
        }
        {  // dgamma's and dbeta's partials: this warpgroup's columns of both
          named_barrier(2 + wg, 128);
          float* out = args.ln_parts + static_cast<int64_t>(tile) * 2 * C + col0;
          for (int c = t; c < 2 * kH; c += 128) {
            const int cc = c < kH ? c : C + c - kH;
            const float s = ((sums[c] + sums[2 * kH + c]) + sums[4 * kH + c]) + sums[6 * kH + c];
            out[cc] = args.accumulate ? out[cc] + s : s;
          }
          named_barrier(2 + wg, 128);
        }
        float mdy[2], mdyx[2];
        {
          float a[2], b[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            a[q] = sdy[q] + __shfl_xor_sync(0xffffffffu, sdy[q], 1);
            a[q] += __shfl_xor_sync(0xffffffffu, a[q], 2);
            b[q] = sdyx[q] + __shfl_xor_sync(0xffffffffu, sdyx[q], 1);
            b[q] += __shfl_xor_sync(0xffffffffu, b[q], 2);
          }
          row_sum(a, 2);
          row_sum(b, 3);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            mdy[q] = a[q] / C;
            mdyx[q] = b[q] / C;
          }
        }
#pragma unroll
        for (int j = 0; j < kH / 8; ++j) {
          if (j % kBatch == 0) asm volatile("" ::: "memory");
          const __nv_bfloat162 gg = *reinterpret_cast<const __nv_bfloat162*>(gam + 8 * j);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float2 dm = dmsg(q, j);
            const float x0 = (acc[4 * j + 2 * q] - mu[q]) * rs[q], x1 = (acc[4 * j + 2 * q + 1] - mu[q]) * rs[q];
            acc[4 * j + 2 * q] = rs[q] * (dm.x * to_f(gg.x) - mdy[q] - x0 * mdyx[q]);
            acc[4 * j + 2 * q + 1] = rs[q] * (dm.y * to_f(gg.y) - mdy[q] - x1 * mdyx[q]);
          }
        }
      } else {  // dh_i . W_i in acc, i = 2n - 1 - g: times act'(z_{i-1})
        const float* z = zs + static_cast<size_t>(2 * (products - 2 - g) + wg) * kR * 128;
#define GNN_BWD_CHAIN_DA(a) mul_act_grad<kR, a>(acc, z, t)
        GNN_BWD_ACT_DISPATCH(args.act, GNN_BWD_CHAIN_DA)
#undef GNN_BWD_CHAIN_DA
      }
      // acc holds dh_k in fp32, k = 2n - 2 - g: db_k's partial of the tile from the rounded values, then the A
      // tile and dh_k's slot
      const int k = products - 2 - g;
#pragma unroll
      for (int j = 0; j < kH / 8; ++j) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (!ok[q]) continue;
          s0 += to_f(round_bf16(acc[4 * j + 2 * q]));
          s1 += to_f(round_bf16(acc[4 * j + 2 * q + 1]));
        }
        s0 = rows_sum16(s0);
        s1 = rows_sum16(s1);
        if (lane < 4) {
          sums[warp * kH + 8 * j + c_lo] = s0;
          sums[warp * kH + 8 * j + c_lo + 1] = s1;
        }
      }
      flush_sums(sums, kH, args.db_parts + (static_cast<int64_t>(k) * args.blocks + tile) * C + col0, kH,
                 args.accumulate, wg);
      out_map = &maps.dh[k];
    }
    to_tile(out_map);
  }
  if (tid == 0) bulk_wait();  // dh_0's store has landed before the CTA ends
}

// the chain's launch over a chunk of m rows: e_c its edge rows, a and dh its slots' bases (rows chunk apart)
template <int C>
int launch_chain(const void* e_c, const void* const* dense, const void* a, const void* dh, int64_t chunk,
                 const ChainArgs& args, cudaStream_t s) {
  using L = Chain<C>;
  const int n = args.n_dense;
  const size_t smem = L::smem(n);
  if (n < 2 || n > kChainMaxDense || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  ChainMaps maps;
  int rc = make_map_bf16(&maps.e, e_c, args.m, C, C, kChainRows, L::kABlk);
  for (int i = 0; rc == 0 && i < n; ++i) {
    const int cols = i == 0 ? 3 * C : C;
    rc = make_map_bf16(&maps.fwd[i], dense[2 * i], C, cols, cols, C, L::kBK);
    if (rc == 0) rc = make_map_bf16(&maps.bwd[i], dense[2 * i], C, cols, cols, L::kBK, L::kNB);
    if (rc == 0)
      rc = make_map_bf16(&maps.dh[i], static_cast<const bf16*>(dh) + i * chunk * C, args.m, C, C, kChainRows, L::kABlk);
    if (rc == 0 && i < n - 1)
      rc = make_map_bf16(&maps.a[i], static_cast<const bf16*>(a) + i * chunk * C, args.m, C, C, kChainRows, L::kABlk);
  }
  if (rc != 0) return rc;
  auto kernel = gnn_bwd_chain_kernel<C>;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<(args.m + kChainRows - 1) / kChainRows, kChainThreads, smem, s>>>(maps, args);
  return static_cast<int>(cudaGetLastError());
}

int launch_chain_any(int C, const void* e_c, const void* const* dense, const void* a, const void* dh, int64_t chunk,
                     const ChainArgs& args, cudaStream_t s) {
  switch (C) {
    case 32: return launch_chain<32>(e_c, dense, a, dh, chunk, args, s);
    case 64: return launch_chain<64>(e_c, dense, a, dh, chunk, args, s);
    case 128: return launch_chain<128>(e_c, dense, a, dh, chunk, args, s);
    case 256: return launch_chain<256>(e_c, dense, a, dh, chunk, args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// the whole backward
// ---------------------------------------------------------------------------

// no edge: the edge MLP's gradients are 0, and so are the per-node sums and what comes of them
int zero_outputs(void* dx_dst, void* dx_src, void* dw, void* db, void* dln, int n_dense, int64_t rows_dst,
                 int64_t rows_src, int C, cudaStream_t s) {
  const size_t c4 = static_cast<size_t>(C) * sizeof(float);
  cudaMemsetAsync(dx_dst, 0, rows_dst * c4, s);
  cudaMemsetAsync(dx_src, 0, rows_src * c4, s);
  cudaMemsetAsync(dw, 0, (n_dense + 2) * C * c4, s);
  cudaMemsetAsync(db, 0, n_dense * c4, s);
  cudaMemsetAsync(dln, 0, 2 * c4, s);
  return static_cast<int>(cudaGetLastError());
}

// fp32: the CUDA-core tile of gemm_sm90.cuh for every product, the weight gradients through transposed copies
int launch_gnn_conv_bwd_f32(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                            const void* src, const void* colptr, const void* perm, const void* const* dense,
                            const void* const* dense_t, int n_dense, const void* ln_g, const void* g_agg,
                            const void* g_msg, void* p_dst, void* p_src, void* z, void* a, void* h, void* dh0,
                            void* dh1, void* rows, void* tr_a, void* tr_b, int ld_t, void* dw_parts, int splits,
                            void* db_parts, int db_blocks, void* ln_parts, int ln_blocks, int chunk_rows, void* de,
                            void* dp_dst, void* dp_src, void* dx_dst, void* dx_src, void* dw, void* db, void* dln,
                            int batch, int num_dst, int num_src, int E, int C, int c_ln, int act, cudaStream_t s) {
  using T = float;
  const size_t ln_smem = static_cast<size_t>(kLnBwdWarps) * 3 * C * sizeof(float);
  if (n_dense < 2 || n_dense > 2 * kMnMaxProblems + 2 || C % 8 != 0 || chunk_rows <= 0 || c_ln <= 0 || c_ln > C ||
      splits < 1 || ld_t < chunk_rows || ld_t % 8 != 0 || ln_smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0)
    return zero_outputs(dx_dst, dx_src, dw, db, dln, n_dense, static_cast<int64_t>(batch) * num_dst,
                        static_cast<int64_t>(batch) * num_src, C, s);
  const int64_t cc = static_cast<int64_t>(C) * C;
  float* dwf = static_cast<float*>(dw);
  float* parts = static_cast<float*>(dw_parts);
  auto ln_bwd = gnn_ln_bwd_kernel<T>;
  if (ln_smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(ln_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(ln_smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  float* pd = static_cast<float*>(p_dst);
  float* ps = static_cast<float*>(p_src);
  int rc = launch_prepass<T>(x_dst, x_src, dense[0], dense[1], pd, ps, batch * num_dst, batch * num_src, C, s);
  const T* w0 = static_cast<const T*>(dense[0]);
  const int2* rt = static_cast<const int2*>(rows);
  T* dhbuf[2] = {static_cast<T*>(dh0), static_cast<T*>(dh1)};
  const int64_t total = static_cast<int64_t>(batch) * E;
  const int64_t zc = static_cast<int64_t>(chunk_rows) * C;  // one chunk's (rows, C)
  for (int64_t r0 = 0; rc == 0 && r0 < total; r0 += chunk_rows) {
    const int m = static_cast<int>(total - r0 < chunk_rows ? total - r0 : chunk_rows);
    const int acc = r0 > 0;  // the partial sums: written by the first chunk, added to by the others
    const T* e_c = static_cast<const T*>(e) + r0 * C;
    float* de_c = static_cast<float*>(de) + r0 * C;
    auto zi = [&](int i) { return static_cast<float*>(z) + i * zc; };
    auto ai = [&](int i) { return static_cast<T*>(a) + i * zc; };
    // the forward recomputed: z_0 .. z_{n-2} and their activations, then h
    rc = launch_rows(rowptr, src, rows, r0, m, E, num_dst, num_src, batch, s);
    if (rc == 0)
      rc = gemm<T>(e_c, C, w0 + 2 * C, 3 * C, m, C, C, ZPairs<T>{zi(0), ai(0), nullptr, pd, ps, rt, C}, act, 1, s);
    for (int i = 1; rc == 0 && i < n_dense; ++i) {
      const bool last = i == n_dense - 1;
      rc = gemm<T>(ai(i - 1), C, dense[2 * i], C, m, C, C,
                   ZPairs<T>{last ? static_cast<float*>(h) : zi(i), last ? nullptr : ai(i),
                             static_cast<const T*>(dense[2 * i + 1]), nullptr, nullptr, nullptr, C},
                   act, 1, s);
    }
    if (rc != 0) break;
    // the LayerNorm's backward: de = dmsg, dh of the last Dense, dgamma and dbeta partials
    ln_bwd<<<(m + kLnBwdRows - 1) / kLnBwdRows, 32 * kLnBwdWarps, ln_smem, s>>>(
        static_cast<const float*>(h), static_cast<const T*>(g_msg) + r0 * C, static_cast<const float*>(g_agg), rt,
        static_cast<const T*>(ln_g), de_c, dhbuf[0], static_cast<float*>(ln_parts), nullptr, m, C, c_ln, acc);
    rc = static_cast<int>(cudaGetLastError());
    // each Dense, last to first: dW and db through the transposed chunk, and the gradient of its input
    int cur = 0;
    for (int i = n_dense - 1; rc == 0 && i >= 0; --i) {
      float* sums = static_cast<float*>(db_parts) + static_cast<int64_t>(i) * db_blocks * C;
      const dim3 grid((C + kTr - 1) / kTr, (m + kTr - 1) / kTr);
      gnn_transpose_kernel<<<grid, 256, 0, s>>>(dhbuf[cur], static_cast<float*>(tr_a), sums, m, C, ld_t, acc);
      gnn_transpose_kernel<<<grid, 256, 0, s>>>(i > 0 ? ai(i - 1) : e_c, static_cast<float*>(tr_b), nullptr, m, C,
                                                ld_t, 0);
      rc = static_cast<int>(cudaGetLastError());
      if (rc == 0)
        rc = gemm<T>(tr_a, ld_t, tr_b, ld_t, C, C, m, AddPairs{parts + static_cast<int64_t>(i) * splits * cc, C, C, acc},
                     0, splits, s);
      if (rc == 0 && i > 0) {
        rc = gemm<T>(dhbuf[cur], C, dense_t[i], C, m, C, C, DaPairs<T>{zi(i - 1), dhbuf[cur ^ 1], C}, act, 1, s);
        cur ^= 1;
      } else if (rc == 0) {
        rc = gemm<T>(dhbuf[cur], C, dense_t[0], C, m, C, C, AddPairs{de_c, 0, C, 1}, 0, 1, s);
      }
    }
    // Dense 0's per-edge gradient summed per destination and per source
    if (rc == 0)
      rc = csr_sums<T>(dhbuf[cur], rowptr, colptr, perm, static_cast<float*>(dp_dst), static_cast<float*>(dp_src),
                       nullptr, nullptr, r0, m, E, batch, num_dst, num_src, C, acc, s);
  }
  // the partials, in order
  SumSeg segs[4 * kMnMaxProblems + 7];
  int count = 0;
  for (int i = 0; i < n_dense; ++i) segs[count++] = {parts + i * splits * cc, dwf + i * cc, splits, cc};
  for (int i = 0; i < n_dense; ++i)
    segs[count++] = {static_cast<const float*>(db_parts) + static_cast<int64_t>(i) * db_blocks * C,
                     static_cast<float*>(db) + static_cast<int64_t>(i) * C, db_blocks, C};
  segs[count++] = {static_cast<const float*>(ln_parts), static_cast<float*>(dln), ln_blocks, 2 * static_cast<int64_t>(C)};
  for (int k = 0; rc == 0 && k < count; k += kMaxSegs) rc = sum_segs(segs + k, count - k < kMaxSegs ? count - k : kMaxSegs, s);
  // the first Dense's per-node gradients (the partials' first slot is free again)
  if (rc == 0)
    rc = node_grads_f32(static_cast<const float*>(dp_dst), static_cast<const float*>(x_dst), dense_t[n_dense],
                        static_cast<float*>(dx_dst), dwf + n_dense * cc, parts, tr_a, tr_b, ld_t, batch * num_dst, C,
                        chunk_rows, splits, s);
  if (rc == 0)
    rc = node_grads_f32(static_cast<const float*>(dp_src), static_cast<const float*>(x_src), dense_t[n_dense + 1],
                        static_cast<float*>(dx_src), dwf + (n_dense + 1) * cc, parts, tr_a, tr_b, ld_t,
                        batch * num_src, C, chunk_rows, splits, s);
  return rc;
}

// bf16: per chunk the fused chain (fused != 0: C in {32, 64, 128, 256}, at most kChainMaxDense Dense that fit
// its shared memory) or the layered chain (the recompute on gemm_sm90_ws.cuh, the LayerNorm row kernel, each
// input gradient on gemm_sm90_mn.cuh), then every Dense's weight gradient in one grouped launch and the CSR sums;
// then the node-level products, two grouped launches, and every partial sum in one
int launch_gnn_conv_bwd_bf16(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                             const void* src, const void* colptr, const void* perm, const void* const* dense,
                             int n_dense, const void* ln_g, const void* g_agg, const void* g_msg, void* p_dst,
                             void* p_src, void* z, void* a, void* h, void* dh, void* rows, void* node_t,
                             void* dw_parts, int splits, void* db_parts, int db_blocks, void* ln_parts, int ln_blocks,
                             int chunk_rows, int fused, void* de, void* dp_dst, void* dp_src, void* dx_dst,
                             void* dx_src, void* dw, void* db, void* dln, int batch, int num_dst, int num_src, int E,
                             int C, int c_ln, int act, cudaStream_t s) {
  using T = bf16;
  const size_t ln_smem = static_cast<size_t>(kLnBwdWarps) * 3 * C * sizeof(float);
  if (n_dense < 2 || n_dense > 2 * kMnMaxProblems + 2 || C % 8 != 0 || chunk_rows <= 0 || c_ln <= 0 || c_ln > C ||
      splits < 1 || ln_smem > 232448 || db_blocks != ln_blocks ||
      (fused && (c_ln != C || n_dense > kChainMaxDense)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows_dst = static_cast<int64_t>(batch) * num_dst, rows_src = static_cast<int64_t>(batch) * num_src;
  if (E == 0) return zero_outputs(dx_dst, dx_src, dw, db, dln, n_dense, rows_dst, rows_src, C, s);
  const int64_t cc = static_cast<int64_t>(C) * C;
  float* parts = static_cast<float*>(dw_parts);
  const int nv = (C + 127) / 128;  // the LayerNorm's row in registers up to C = 1024
  auto ln_bwd = nv == 1   ? gnn_ln_bwd_regs_kernel<T, 1>
                : nv == 2 ? gnn_ln_bwd_regs_kernel<T, 2>
                : nv <= 4 ? gnn_ln_bwd_regs_kernel<T, 4>
                : nv <= 8 ? gnn_ln_bwd_regs_kernel<T, 8>
                          : gnn_ln_bwd_kernel<T>;
  if (!fused && ln_smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(ln_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(ln_smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  float* pd = static_cast<float*>(p_dst);
  float* ps = static_cast<float*>(p_src);
  int rc = launch_prepass<T>(x_dst, x_src, dense[0], dense[1], pd, ps, static_cast<int>(rows_dst),
                             static_cast<int>(rows_src), C, s);
  const T* w0 = static_cast<const T*>(dense[0]);
  const int2* rt = static_cast<const int2*>(rows);
  T* node_dst = static_cast<T*>(node_t);
  T* node_src = node_dst + rows_dst * C;
  const int64_t total = static_cast<int64_t>(batch) * E;
  const int64_t zc = static_cast<int64_t>(chunk_rows) * C;
  auto dhi = [&](int i) { return static_cast<T*>(dh) + i * zc; };
  auto ai = [&](int i) { return static_cast<T*>(a) + i * zc; };
  for (int64_t r0 = 0; rc == 0 && r0 < total; r0 += chunk_rows) {
    const int m = static_cast<int>(total - r0 < chunk_rows ? total - r0 : chunk_rows);
    const int acc = r0 > 0;
    const bool last_chunk = r0 + chunk_rows >= total;
    const T* e_c = static_cast<const T*>(e) + r0 * C;
    const T* g_msg_c = static_cast<const T*>(g_msg) + r0 * C;
    float* de_c = static_cast<float*>(de) + r0 * C;
    rc = launch_rows(rowptr, src, rows, r0, m, E, num_dst, num_src, batch, s);
    if (rc == 0 && fused) {
      ChainArgs ca{};
      ca.p_dst = pd;
      ca.p_src = ps;
      ca.rows = rt;
      for (int i = 1; i < n_dense; ++i) ca.bias[i] = static_cast<const T*>(dense[2 * i + 1]);
      ca.gamma = static_cast<const T*>(ln_g);
      ca.g_msg = g_msg_c;
      ca.g_agg = static_cast<const float*>(g_agg);
      ca.de = de_c;
      ca.db_parts = static_cast<float*>(db_parts);
      ca.ln_parts = static_cast<float*>(ln_parts);
      ca.m = m;
      ca.blocks = db_blocks;
      ca.n_dense = n_dense;
      ca.act = act;
      ca.accumulate = acc;
      rc = launch_chain_any(C, e_c, dense, ai(0), dhi(0), chunk_rows, ca, s);
    } else if (rc == 0) {
      float* zf = static_cast<float*>(z);
      auto zi = [&](int i) { return zf + i * zc; };
      // the forward recomputed (W_i K-major): z_0 .. z_{n-2} and their activations, then h
      for (int i = 0; rc == 0 && i < n_dense; ++i) {
        const bool last = i == n_dense - 1;
        sm90mn::MnArgs args{};
        rc = sm90mn::set_mn_problem<false, false>(&args, 0, i > 0 ? static_cast<const void*>(ai(i - 1)) : e_c, C,
                                                  i > 0 ? dense[2 * i] : static_cast<const void*>(w0 + 2 * C),
                                                  i > 0 ? C : 3 * C, m, C, C, 1, mn_bn(C));
        MnPairs<ZPairs<T>> epi{};
        epi.p[0] = i > 0 ? ZPairs<T>{last ? static_cast<float*>(h) : zi(i), last ? nullptr : ai(i),
                                     static_cast<const T*>(dense[2 * i + 1]), nullptr, nullptr, nullptr, C}
                         : ZPairs<T>{zi(0), ai(0), nullptr, pd, ps, rt, C};
        epi.m[0] = m;
        epi.n = C;
        epi.act = act;
        if (rc == 0) rc = mn_gemm<false, false>(args, 1, C, epi, s);
      }
      if (rc != 0) break;
      // the LayerNorm's backward: de = dmsg, dh_{n-1}, the dgamma, dbeta and db_{n-1} partials
      ln_bwd<<<(m + kLnBwdRows - 1) / kLnBwdRows, 32 * kLnBwdWarps, ln_smem, s>>>(
          static_cast<const float*>(h), g_msg_c, static_cast<const float*>(g_agg), rt, static_cast<const T*>(ln_g),
          de_c, dhi(n_dense - 1), static_cast<float*>(ln_parts),
          static_cast<float*>(db_parts) + static_cast<int64_t>(n_dense - 1) * db_blocks * C, m, C, c_ln, acc);
      rc = static_cast<int>(cudaGetLastError());
      // the input gradients, W_i read as it lies (its C_out rows are the product's K)
      for (int i = n_dense - 1; rc == 0 && i >= 1; --i) {
        sm90mn::MnArgs args{};
        rc = sm90mn::set_mn_problem<false, true>(&args, 0, dhi(i), C, dense[2 * i], C, m, C, C, 1);
        const DaSums epi{zi(i - 1), dhi(i - 1),
                         static_cast<float*>(db_parts) + static_cast<int64_t>(i - 1) * db_blocks * C, m, C, act, acc};
        if (rc == 0) rc = mn_gemm<false, true>(args, 1, C, epi, s);
      }
      if (rc == 0) {  // de += dh_0 . W0[:, 2C:3C]
        sm90mn::MnArgs args{};
        rc = sm90mn::set_mn_problem<false, true>(&args, 0, dhi(0), C, w0 + 2 * C, 3 * C, m, C, C, 1);
        MnPairs<AddPairs> epi{};
        epi.p[0] = AddPairs{de_c, 0, C, 1};
        epi.m[0] = m;
        epi.n = C;
        if (rc == 0) rc = mn_gemm<false, true>(args, 1, C, epi, s);
      }
    }
    // every Dense's weight gradient dW_i = dh_i^T . a_{i-1} (a_{-1} = e) over the chunk's rows, one launch (one
    // per kMnMaxProblems Dense)
    for (int i0 = 0; rc == 0 && i0 < n_dense; i0 += kMnMaxProblems) {
      sm90mn::MnArgs args{};
      MnPairs<AddPairs> epi{};
      const int count = n_dense - i0 < kMnMaxProblems ? n_dense - i0 : kMnMaxProblems;
      for (int k = 0; rc == 0 && k < count; ++k) {
        const int i = i0 + k;
        rc = sm90mn::set_mn_problem<true, true>(&args, k, dhi(i), C, i > 0 ? static_cast<const void*>(ai(i - 1)) : e_c,
                                                C, C, C, m, splits);
        epi.p[k] = AddPairs{parts + static_cast<int64_t>(i) * splits * cc, C, C, acc};
        epi.m[k] = C;
      }
      epi.n = C;
      if (rc == 0) rc = mn_gemm<true, true>(args, count, C, epi, s);
    }
    // dh_0 summed per destination and per source; the last chunk's totals rounded for the node products
    if (rc == 0)
      rc = csr_sums<T>(dhi(0), rowptr, colptr, perm, static_cast<float*>(dp_dst), static_cast<float*>(dp_src),
                       last_chunk ? node_dst : nullptr, last_chunk ? node_src : nullptr, r0, m, E, batch, num_dst,
                       num_src, C, acc, s);
  }
  // the node-level input gradients dx = round(dp) . W0's node block, both sides in one launch
  if (rc == 0) {
    sm90mn::MnArgs args{};
    rc = sm90mn::set_mn_problem<false, true>(&args, 0, node_dst, C, w0, 3 * C, static_cast<int>(rows_dst), C, C, 1);
    if (rc == 0)
      rc = sm90mn::set_mn_problem<false, true>(&args, 1, node_src, C, w0 + C, 3 * C, static_cast<int>(rows_src), C, C, 1);
    MnPairs<StorePairs> epi{};
    epi.p[0] = StorePairs{static_cast<float*>(dx_dst), C};
    epi.p[1] = StorePairs{static_cast<float*>(dx_src), C};
    epi.m[0] = static_cast<int>(rows_dst);
    epi.m[1] = static_cast<int>(rows_src);
    epi.n = C;
    if (rc == 0) rc = mn_gemm<false, true>(args, 2, C, epi, s);
  }
  // and the node blocks of dW0 = round(dp)^T . x, both sides in one launch
  if (rc == 0) {
    sm90mn::MnArgs args{};
    rc = sm90mn::set_mn_problem<true, true>(&args, 0, node_dst, C, x_dst, C, C, C, static_cast<int>(rows_dst), splits);
    if (rc == 0)
      rc = sm90mn::set_mn_problem<true, true>(&args, 1, node_src, C, x_src, C, C, C, static_cast<int>(rows_src), splits);
    MnPairs<AddPairs> epi{};
    for (int k = 0; k < 2; ++k) {
      epi.p[k] = AddPairs{parts + static_cast<int64_t>(n_dense + k) * splits * cc, C, C, 0};
      epi.m[k] = C;
    }
    epi.n = C;
    if (rc == 0) rc = mn_gemm<true, true>(args, 2, C, epi, s);
  }
  // every partial, in order: one launch (one per kMaxSegs sums)
  SumSeg segs[4 * kMnMaxProblems + 7];
  int count = 0;
  float* dwf = static_cast<float*>(dw);
  for (int i = 0; i < n_dense + 2; ++i) segs[count++] = {parts + i * splits * cc, dwf + i * cc, splits, cc};
  for (int i = 0; i < n_dense; ++i)
    segs[count++] = {static_cast<const float*>(db_parts) + static_cast<int64_t>(i) * db_blocks * C,
                     static_cast<float*>(db) + static_cast<int64_t>(i) * C, db_blocks, C};
  segs[count++] = {static_cast<const float*>(ln_parts), static_cast<float*>(dln), ln_blocks, 2 * static_cast<int64_t>(C)};
  for (int k = 0; rc == 0 && k < count; k += kMaxSegs) rc = sum_segs(segs + k, count - k < kMaxSegs ? count - k : kMaxSegs, s);
  return rc;
}

}  // namespace

extern "C" {

// dense: each Dense's weight (C, K) in torch's Linear layout (K = 3C for the first) then its bias; g_agg
// (B Nd, C) fp32, g_msg (B E, C); the outputs: de (B E, C), dx_dst (B Nd, C), dx_src (B Ns, C), dw (n_dense + 2,
// C, C: Dense 0's edge block, each later Dense, then Dense 0's destination and source blocks), db (n_dense, C),
// dln (2, C: dgamma, dbeta), all fp32; dp_dst (B Nd, C) and dp_src (B Ns, C) fp32 scratch (the per-node sums,
// written by the first chunk). The LayerNorm's beta has no part in any gradient but its own.
//
// fp32 scratch: p_dst, p_src, z (n_dense - 1, chunk, C), h (chunk, C) fp32, a (n_dense - 1, chunk, C), dh0, dh1
// (chunk, C), rows (chunk) int2, tr_a, tr_b (C, ld_t), dw_parts (n_dense, splits, C, C), db_parts (n_dense,
// db_blocks, C), ln_parts (ln_blocks, 2, C); dense_t: W0[:, 2C:3C]^T, each later Dense's W^T, then W0[:, 0:C]^T
// and W0[:, C:2C]^T, contiguous (C, C); node_t unused
int gnn_conv_bwd_f32(const void* x_dst, const void* x_src, const void* e, const void* rowptr, const void* src,
                     const void* colptr, const void* perm, const void* const* dense, const void* const* dense_t,
                     int n_dense, const void* ln_g, const void* ln_b, const void* g_agg, const void* g_msg,
                     void* p_dst, void* p_src, void* z, void* a, void* h, void* dh0, void* dh1, void* rows,
                     void* tr_a, void* tr_b, int ld_t, void* node_t, void* dw_parts, int splits, void* db_parts,
                     int db_blocks, void* ln_parts, int ln_blocks, int chunk_rows, void* de, void* dp_dst,
                     void* dp_src, void* dx_dst, void* dx_src, void* dw, void* db, void* dln, int batch, int num_dst,
                     int num_src, int E, int C, int c_ln, int act, void* stream) {
  (void)ln_b;
  (void)node_t;
  return launch_gnn_conv_bwd_f32(x_dst, x_src, e, rowptr, src, colptr, perm, dense, dense_t, n_dense, ln_g, g_agg,
                                 g_msg, p_dst, p_src, z, a, h, dh0, dh1, rows, tr_a, tr_b, ld_t, dw_parts, splits,
                                 db_parts, db_blocks, ln_parts, ln_blocks, chunk_rows, de, dp_dst, dp_src, dx_dst,
                                 dx_src, dw, db, dln, batch, num_dst, num_src, E, C, c_ln, act,
                                 static_cast<cudaStream_t>(stream));
}

// bf16 scratch: p_dst, p_src fp32; z (n_dense - 1, chunk, C) and h (chunk, C) fp32 (the layered chain; unused by
// the fused one), a (n_dense - 1, chunk, C), dh (n_dense, chunk, C), rows (chunk) int2, node_t (B Nd + B Ns, C),
// dw_parts (n_dense + 2, splits, C, C), db_parts (n_dense, db_blocks, C), ln_parts (ln_blocks, 2, C) fp32,
// db_blocks = ln_blocks = the chunk's 64-row blocks; fused: 1 for the fused chain (ops/gnn_conv.py:_bwd_route)
int gnn_conv_bwd_bf16(const void* x_dst, const void* x_src, const void* e, const void* rowptr, const void* src,
                      const void* colptr, const void* perm, const void* const* dense, int n_dense, const void* ln_g,
                      const void* g_agg, const void* g_msg, void* p_dst, void* p_src, void* z, void* a, void* h,
                      void* dh, void* rows, void* node_t, void* dw_parts, int splits, void* db_parts, int db_blocks,
                      void* ln_parts, int ln_blocks, int chunk_rows, int fused, void* de, void* dp_dst, void* dp_src,
                      void* dx_dst, void* dx_src, void* dw, void* db, void* dln, int batch, int num_dst, int num_src,
                      int E, int C, int c_ln, int act, void* stream) {
  return launch_gnn_conv_bwd_bf16(x_dst, x_src, e, rowptr, src, colptr, perm, dense, n_dense, ln_g, g_agg, g_msg,
                                  p_dst, p_src, z, a, h, dh, rows, node_t, dw_parts, splits, db_parts, db_blocks,
                                  ln_parts, ln_blocks, chunk_rows, fused, de, dp_dst, dp_src, dx_dst, dx_src, dw, db,
                                  dln, batch, num_dst, num_src, E, C, c_ln, act, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
