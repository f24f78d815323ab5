// Hopper (sm_90a) backward of the GNN edge-MLP convolution, one route for
// every width C % 8 == 0 (the wrapper pads any other width with zero columns,
// and the LayerNorm's statistics run over the true width), every MLP depth
// and every activation of ops/gnn_conv.py:_ACT_CODES, in bf16 and fp32.
//
// The gradient of anemoi_models_tpu/ops/pallas/gnn_conv.py:_kernel (launched
// by slot_gnn_pallas; the JAX package's ops/slot_gnn.py:conv_bwd takes
// jax.vjp of its jnp twin and leaves every product to XLA). It computes the
// backward of ops/gnn_conv.py:gnn_conv_plain at the rounding points of
// gnn_conv_bwd_plain, per chunk of consecutive edge rows (a fixed count the
// wrapper sets, so the scratch is bounded and the work order fixed):
//
//   once     P_dst, P_src: the forward's pre-pass rerun (gnn_common.cuh)
//   recompute  (ZPairs)  z0 = (e . W0[:, 2C:3C]^T + P_dst[dst]) + P_src[src], then
//              z_i = a_{i-1} . W_i^T + b_i, with a_i = round(act(z_i)) and the last Dense's
//              output h in fp32, every z_i kept in fp32 for act'
//   LayerNorm  (gnn_ln_bwd_regs_kernel, the row in registers up to C = 1024; gnn_ln_bwd_kernel
//              above) a warp a row: dmsg = g_msg + g_agg[dst] (also de's direct part), dgamma
//              += dmsg round(xhat), dbeta += dmsg (per-CTA partials), dh = rs (dy - mean dy -
//              xhat mean(dy xhat)), dy = dmsg gamma, rounded
//   for each Dense, last to first:
//     transposes (gnn_transpose_kernel)  dh^T and a_{i-1}^T (e^T for Dense 0), with db's
//                per-64-row column sums
//     dW_i       (AddPairs) dh^T . a_{i-1}, K = the chunk's rows cut in fixed ranges,
//                each range's partial kept apart and added to across chunks
//     input grad (DaPairs) dh_{i-1} = round((dh . W_i) * act'(z_{i-1})), or for
//                Dense 0 (AddPairs) de += dh0 . W0[:, 2C:3C]
//   sums     dh0 per destination (the CSR rows) and per source (the transposed CSR), fp32
//   nodes    the per-node sums rounded to the compute dtype, then dx_dst = dp_dst . W0[:, 0:C],
//            dx_src = dp_src . W0[:, C:2C] (StorePairs) and dW0[:, 0:2C] = dp^T . x over the
//            node rows (AddPairs, in chunks of rows); db0 is the column sum of dh0
//   last     each partial sum added in a fixed order (gnn_sum_parts_kernel)
//
// Every product runs on the forward's GEMMs: in bf16 the warp-specialised
// wgmma pipeline of gemm_sm90_ws.cuh (both operands K-major: the weight
// gradients reduce over edge rows, so they read transposed copies of the
// chunk, and the input gradients the transposed C x C weights the wrapper
// copies), in fp32 gemm_sm90.cuh's CUDA-core tile. No atomics: each output
// element has one writer a launch, the launches run in order on one stream,
// and every split is a function of the shape, so two calls give the same bits.
//
// Bound on the H100 (989 TFLOP/s bf16): operations, three times the forward's
// (the recompute, then 4 C^2 per edge and Dense and 4 C^2 per node): at
// C = 1024 with three Dense on the O96 processor set (81,900 edges) 1.67
// TFLOP, 1.69 ms. The chain moves more than the forward's: per edge row and
// Dense the transposed copies and the fp32 z, about 60 C bytes a row.
//
// The entry points have a plain C interface, launch on the stream they are
// given, allocate nothing and return cudaGetLastError().

#include "gemm_sm90_ws.cuh"  // the warp-specialised bf16 GEMM
#include "gnn_common.cuh"    // the activations, the pre-pass, gnn_rows_kernel

namespace {

using namespace sm90;

constexpr int kLnBwdWarps = 4;
constexpr int kLnBwdRows = 64;  // rows a CTA of the LayerNorm backward sums: ops/gnn_conv.py:_LN_BWD_ROWS
constexpr int kTr = 64;         // transpose tile's rows and columns: ops/gnn_conv.py:_TRANSPOSE_ROWS

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

// d act(x) / dx, as torch's autograd takes it (gnn_conv.py:act_grad)
template <int A>
__device__ __forceinline__ float act_grad(float x) {
  if constexpr (A == 1) {
    const float s = 1.f / (1.f + expf(-x));
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
    const float s = 1.f / (1.f + expf(-x));
    return s * (1.f - s);
  } else if constexpr (A == 6) {
    return x > 0.f ? 1.f : 0.01f;
  } else if constexpr (A == 7) {
    return x > 0.f ? 1.f : expf(x);
  } else if constexpr (A == 8) {
    return 1.f / (1.f + expf(-x));
  } else if constexpr (A == 9) {
    const float t = tanhf(fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))));
    return t + x * (1.f / (1.f + expf(-x))) * (1.f - t * t);
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

// the warp-specialised GEMM's epilogue over any of the above (gemm_sm90_ws.cuh's accumulator layout): a row's
// column blocks in batches of 8, each batch's loads ahead of its stores
template <class P>
struct WsPairs {
  static constexpr bool kGather = false;
  P p;
  int m, n, act;

  template <int BN>
  __device__ __forceinline__ void rows(int, int, int, int, int*) const {}

  template <int BN, int A>
  __device__ __forceinline__ void walk(const float* acc, int pb, int m0, int n0, int r0, int c_lo) const {
    constexpr int kBatch = 8;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = m0 + r0 + 8 * q;
      if (row >= m) continue;
      const auto r = p.at(pb, row);
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kBatch) {
        asm volatile("" ::: "memory");
        typename P::In in[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (n0 + 8 * (j0 + j) < n) in[j] = p.fetch(r, n0 + 8 * (j0 + j) + c_lo);
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (n0 + 8 * (j0 + j) < n)
            p.template put<A>(r, in[j], n0 + 8 * (j0 + j) + c_lo, acc[4 * (j0 + j) + 2 * q],
                              acc[4 * (j0 + j) + 2 * q + 1]);
      }
    }
  }

  template <int BN>
  __device__ __forceinline__ void store(const float* acc, int pb, int m0, int n0, int r0, int c_lo, const int*,
                                        const int*) const {
    if constexpr (P::kAct) {
#define GNN_BWD_WALK(a) walk<BN, a>(acc, pb, m0, n0, r0, c_lo)
      GNN_BWD_ACT_DISPATCH(act, GNN_BWD_WALK)
#undef GNN_BWD_WALK
    } else {
      walk<BN, 0>(acc, pb, m0, n0, r0, c_lo);
    }
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

// out (m, n) pairs of epi(A (m, k; rows lda apart) . B (n, k; rows ldb apart)^T), K cut into `splits` ranges
template <typename T, class P>
int gemm(const void* a, int lda, const void* b, int ldb, int m, int n, int k, const P& p, int act, int splits,
         cudaStream_t s) {
  if (m <= 0 || n <= 0) return 0;
  if constexpr (std::is_same<T, bf16>::value) {
    const WsPairs<P> epi{p, m, n, act};
    sm90ws::WsArgs args{};
    if (n % 256 == 0) {
      const int rc = sm90ws::set_ws_problem<256>(&args.p[0], a, lda, b, ldb, m, n, k);
      return rc != 0 ? rc : sm90ws::launch_ws_gemm<256>(args, 1, k, epi, s, splits);
    }
    const int rc = sm90ws::set_ws_problem<128>(&args.p[0], a, lda, b, ldb, m, n, k);
    return rc != 0 ? rc : sm90ws::launch_ws_gemm<128>(args, 1, k, epi, s, splits);
  } else {
    const ProjF32Problem pr{static_cast<const float*>(a), static_cast<const float*>(b), nullptr, nullptr, m, n, lda,
                            ldb, 0};
    const int kchunk = (k + splits - 1) / splits;
    const dim3 grid((m + kF32BM - 1) / kF32BM, (n + kF32BN - 1) / kF32BN, splits);
    gnn_bwd_f32_kernel<P><<<grid, kF32Threads, 0, s>>>(pr, k, kchunk, p, act);
    return static_cast<int>(cudaGetLastError());
  }
}

// ---------------------------------------------------------------------------
// the LayerNorm backward, transposes, sums
// ---------------------------------------------------------------------------

// A warp a row of the chunk: the LayerNorm's statistics over the first c_ln columns recomputed from the fp32 h,
// dmsg = g_msg + g_agg[dst] written to de, dh = rs (dy - mean dy - xhat mean(dy xhat)) rounded; dgamma and
// dbeta summed per warp in shared memory, then over the CTA's warps in order into its partial (2, C).
template <typename T>
__global__ void __launch_bounds__(32 * kLnBwdWarps)
gnn_ln_bwd_kernel(const float* __restrict__ h, const T* __restrict__ g_msg, const float* __restrict__ g_agg,
                  const int2* __restrict__ rows, const T* __restrict__ gamma, float* __restrict__ de,
                  T* __restrict__ dh, float* __restrict__ parts, int m, int C, int c_ln, int accumulate) {
  extern __shared__ float sums[];  // [warp][dgamma C | dbeta C]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mine = sums + warp * 2 * C;
  for (int c = lane; c < 2 * C; c += 32) mine[c] = 0.f;
  const int r_lo = blockIdx.x * kLnBwdRows;
  const int r_hi = min(r_lo + kLnBwdRows, m);
  for (int r = r_lo + warp; r < r_hi; r += kLnBwdWarps) {
    const float* hr = h + static_cast<int64_t>(r) * C;
    float sum = 0.f;
    for (int c = lane; c < c_ln; c += 32) sum += hr[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / c_ln;
    float sq = 0.f;
    for (int c = lane; c < c_ln; c += 32) sq += (hr[c] - mu) * (hr[c] - mu);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rs = rsqrtf(sq / c_ln + 1e-6f);
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sdy += __shfl_xor_sync(0xffffffffu, sdy, off);
      sdyx += __shfl_xor_sync(0xffffffffu, sdyx, off);
    }
    const float mdy = sdy / c_ln, mdyx = sdyx / c_ln;
    T* dhr = dh + static_cast<int64_t>(r) * C;
    for (int c = lane; c < C; c += 32) {
      const float x = (hr[c] - mu) * rs;
      const float dy = der[c] * to_f(gamma[c]);
      dhr[c] = from_f<T>(c < c_ln ? rs * (dy - mdy - x * mdyx) : 0.f);
    }
  }
  __syncthreads();
  float* out = parts + static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kLnBwdWarps; ++w) v += sums[w * 2 * C + c];
    out[c] = accumulate ? out[c] + v : v;
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
                       T* __restrict__ dh, float* __restrict__ parts, int m, int C, int c_ln, int accumulate) {
  extern __shared__ float sums[];  // [warp][dgamma C | dbeta C]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mine = sums + warp * 2 * C;
  for (int c = lane; c < 2 * C; c += 32) mine[c] = 0.f;
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
      float dg[4] = {ga4.x, ga4.y, ga4.z, ga4.w}, db[4] = {gb4.x, gb4.y, gb4.z, gb4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float x = (hv[v][k] - mu) * rs;
        dm[v][k] = gv[k] + av[k];
        dg[k] += dm[v][k] * to_f(from_f<T>(x));
        db[k] += dm[v][k];
        if (c + k < c_ln) {
          const float dy = dm[v][k] * wv[k];
          sdy += dy;
          sdyx += dy * x;
        }
      }
      *acc = make_float4(dg[0], dg[1], dg[2], dg[3]);
      *accb = make_float4(db[0], db[1], db[2], db[3]);
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
        g[k] = c + k < c_ln ? rs * (dm[v][k] * wv[k] - mdy - x * mdyx) : 0.f;
      }
      store4(dhr + c, make_float4(g[0], g[1], g[2], g[3]));
    }
  }
  __syncthreads();
  float* out = parts + static_cast<int64_t>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kLnBwdWarps; ++w) v += sums[w * 2 * C + c];
    out[c] = accumulate ? out[c] + v : v;
  }
}

// two adjacent values as one load or store (4 bytes in bf16, 8 in fp32)
template <typename T>
struct Two;
template <>
struct Two<bf16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V make(bf16 a, bf16 b) { return V{a, b}; }
};
template <>
struct Two<float> {
  using V = float2;
  static __device__ __forceinline__ V make(float a, float b) { return make_float2(a, b); }
};

// out (C, ld) = in (m, C)^T, 64 x 64 tiles through shared memory, each value read and written as half of a
// 4-byte (bf16) or 8-byte (fp32) pair; with `sums`, each tile's column sums over its 64 rows into sums[row
// block] (written by the first chunk, added to by the others)
template <typename T>
__global__ void __launch_bounds__(256) gnn_transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                                                            float* __restrict__ sums, int m, int C, int ld,
                                                            int accumulate) {
  using V = typename Two<T>::V;
  __shared__ float tile[kTr][kTr + 1];  // exact for either dtype
  const int r0 = blockIdx.y * kTr, c0 = blockIdx.x * kTr;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const T zero = from_f<T>(0.f);
  for (int i = ty; i < kTr; i += 8) {  // input row r0 + i, columns c0 + 2 tx, + 1 (C % 8 == 0: both or none)
    const int r = r0 + i, c = c0 + 2 * tx;
    const V v = r < m && c < C ? *reinterpret_cast<const V*>(in + static_cast<int64_t>(r) * C + c)
                               : Two<T>::make(zero, zero);
    tile[i][2 * tx] = to_f(v.x);
    tile[i][2 * tx + 1] = to_f(v.y);
  }
  __syncthreads();
  for (int i = ty; i < kTr; i += 8) {  // output row c0 + i, columns r0 + 2 tx, + 1
    const int c = c0 + i, r = r0 + 2 * tx;
    if (c >= C || r >= m) continue;
    T* o = out + static_cast<int64_t>(c) * ld + r;
    if (r + 1 < m) {
      *reinterpret_cast<V*>(o) = Two<T>::make(from_f<T>(tile[2 * tx][i]), from_f<T>(tile[2 * tx + 1][i]));
    } else {
      *o = from_f<T>(tile[2 * tx][i]);
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

// dp[b, d] += the sum of dh's rows of (b, d)'s CSR range inside the chunk, in edge order: a CTA a (batch,
// destination), a thread a column
template <typename T>
__global__ void gnn_dst_sum_kernel(const T* __restrict__ dh, const int* __restrict__ rowptr, float* __restrict__ dp,
                                   int64_t r0, int m, int E, int num_dst, int C) {
  const int row = blockIdx.x;
  const int b = row / num_dst, d = row - b * num_dst;
  const int64_t base = static_cast<int64_t>(b) * E - r0;  // edge ee is chunk row base + ee
  const int64_t lo = max(static_cast<int64_t>(rowptr[d]), -base);
  const int64_t hi = min(static_cast<int64_t>(rowptr[d + 1]), m - base);
  if (lo >= hi) return;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int64_t ee = lo; ee < hi; ++ee) acc += to_f(dh[(base + ee) * C + c]);
    dp[static_cast<int64_t>(row) * C + c] += acc;
  }
}

// dp[b, s] += the sum of dh's rows of source s's edges inside the chunk, in the transposed CSR's order
template <typename T>
__global__ void gnn_src_sum_kernel(const T* __restrict__ dh, const int* __restrict__ colptr,
                                   const int* __restrict__ perm, float* __restrict__ dp, int64_t r0, int m, int E,
                                   int num_src, int C) {
  const int row = blockIdx.x;
  const int b = row / num_src, sidx = row - b * num_src;
  const int64_t base = static_cast<int64_t>(b) * E - r0;
  const int lo = colptr[sidx], hi = colptr[sidx + 1];
  if (base + E <= 0 || base >= m || lo >= hi) return;  // the batch's edges miss the chunk
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) {
      const int64_t r = base + perm[k];
      if (r >= 0 && r < m) acc += to_f(dh[r * C + c]);
    }
    dp[static_cast<int64_t>(row) * C + c] += acc;
  }
}

// out = in rounded to the compute dtype
template <typename T>
__global__ void gnn_round_kernel(const float* __restrict__ in, T* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = from_f<T>(in[i]);
}

// out[i] = sum over p of parts[p][i], p in order
__global__ void gnn_sum_parts_kernel(const float* __restrict__ parts, float* __restrict__ out, int n_parts,
                                     int64_t len) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  int p = 0;
  for (; p + 8 <= n_parts; p += 8) {  // eight loads in flight, added in order
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = parts[(p + k) * len + i];
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[k];
  }
  for (; p < n_parts; ++p) s += parts[p * len + i];
  out[i] = s;
}

template <typename T>
int transpose(const void* in, void* out, float* sums, int m, int C, int ld, int accumulate, cudaStream_t s) {
  const dim3 grid((C + kTr - 1) / kTr, (m + kTr - 1) / kTr);
  gnn_transpose_kernel<T><<<grid, 256, 0, s>>>(static_cast<const T*>(in), static_cast<T*>(out), sums, m, C, ld,
                                               accumulate);
  return static_cast<int>(cudaGetLastError());
}

int sum_parts(const float* parts, float* out, int n_parts, int64_t len, cudaStream_t s) {
  const int threads = 256;
  gnn_sum_parts_kernel<<<static_cast<int>((len + threads - 1) / threads), threads, 0, s>>>(parts, out, n_parts, len);
  return static_cast<int>(cudaGetLastError());
}

// One side of the first Dense's per-node gradients: dx (rows, C) fp32 = round(dp) . W^T-copy, and dW (C, C)
// fp32 = round(dp)^T . x, summed over chunks of rows into `parts` (splits, C, C) and then in order into dw.
template <typename T>
int node_grads(const float* dp, const T* x, const void* w_t, void* node_t, float* dx, float* dw, float* parts,
               void* tr_a, void* tr_b, int ld_t, int rows, int C, int chunk_rows, int splits, cudaStream_t s) {
  const T* pr = reinterpret_cast<const T*>(dp);
  int rc = 0;
  if constexpr (std::is_same<T, bf16>::value) {
    const int64_t n = static_cast<int64_t>(rows) * C;
    gnn_round_kernel<T><<<static_cast<int>((n + 255) / 256), 256, 0, s>>>(dp, static_cast<T*>(node_t), n);
    rc = static_cast<int>(cudaGetLastError());
    pr = static_cast<const T*>(node_t);
  }
  if (rc == 0) rc = gemm<T>(pr, C, w_t, C, rows, C, C, StorePairs{dx, C}, 0, 1, s);
  for (int r0 = 0; rc == 0 && r0 < rows; r0 += chunk_rows) {
    const int m = rows - r0 < chunk_rows ? rows - r0 : chunk_rows;
    rc = transpose<T>(pr + static_cast<int64_t>(r0) * C, tr_a, nullptr, m, C, ld_t, 0, s);
    if (rc == 0) rc = transpose<T>(x + static_cast<int64_t>(r0) * C, tr_b, nullptr, m, C, ld_t, 0, s);
    if (rc == 0) rc = gemm<T>(tr_a, ld_t, tr_b, ld_t, C, C, m, AddPairs{parts, C, C, r0 > 0}, 0, splits, s);
  }
  return rc != 0 ? rc : sum_parts(parts, dw, splits, static_cast<int64_t>(C) * C, s);
}

// ---------------------------------------------------------------------------
// the whole backward
// ---------------------------------------------------------------------------

template <typename T>
int launch_gnn_conv_bwd(const void* x_dst, const void* x_src, const void* e, const void* rowptr, const void* src,
                        const void* colptr, const void* perm, const void* const* dense, const void* const* dense_t,
                        int n_dense, const void* ln_g, const void* g_agg, const void* g_msg, void* p_dst,
                        void* p_src, void* z, void* a, void* h, void* dh0, void* dh1, void* rows, void* tr_a,
                        void* tr_b, int ld_t, void* node_t, void* dw_parts, int splits, void* db_parts, int db_blocks,
                        void* ln_parts, int ln_blocks, int chunk_rows, void* de, void* dp_dst, void* dp_src,
                        void* dx_dst, void* dx_src, void* dw, void* db, void* dln, int batch, int num_dst, int num_src,
                        int E, int C, int c_ln, int act, cudaStream_t s) {
  const size_t ln_smem = static_cast<size_t>(kLnBwdWarps) * 2 * C * sizeof(float);
  if (n_dense < 2 || C % 8 != 0 || chunk_rows <= 0 || c_ln <= 0 || c_ln > C || splits < 1 || ld_t < chunk_rows ||
      ld_t % 8 != 0 || ln_smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cc = static_cast<int64_t>(C) * C;
  float* dwf = static_cast<float*>(dw);
  float* parts = static_cast<float*>(dw_parts);
  const T* xd = static_cast<const T*>(x_dst);
  const T* xs = static_cast<const T*>(x_src);
  if (E == 0) {  // no edge: the edge MLP's gradients are 0 and so are dp_dst, dp_src (zeroed by the caller)
    cudaMemsetAsync(dw, 0, n_dense * cc * sizeof(float), s);
    cudaMemsetAsync(db, 0, static_cast<size_t>(n_dense) * C * sizeof(float), s);
    cudaMemsetAsync(dln, 0, 2 * static_cast<size_t>(C) * sizeof(float), s);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc == 0)
      rc = node_grads<T>(static_cast<const float*>(dp_dst), xd, dense_t[n_dense], node_t, static_cast<float*>(dx_dst),
                         dwf + n_dense * cc, parts, tr_a, tr_b, ld_t, batch * num_dst, C, chunk_rows, splits, s);
    if (rc == 0)
      rc = node_grads<T>(static_cast<const float*>(dp_src), xs, dense_t[n_dense + 1], node_t,
                         static_cast<float*>(dx_src), dwf + (n_dense + 1) * cc, parts, tr_a, tr_b, ld_t,
                         batch * num_src, C, chunk_rows, splits, s);
    return rc;
  }
  const int nv = (C + 127) / 128;  // the row in registers up to C = 1024
  auto ln_bwd = nv == 1   ? gnn_ln_bwd_regs_kernel<T, 1>
                : nv == 2 ? gnn_ln_bwd_regs_kernel<T, 2>
                : nv <= 4 ? gnn_ln_bwd_regs_kernel<T, 4>
                : nv <= 8 ? gnn_ln_bwd_regs_kernel<T, 8>
                          : gnn_ln_bwd_kernel<T>;
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
        static_cast<const T*>(ln_g), de_c, dhbuf[0], static_cast<float*>(ln_parts), m, C, c_ln, acc);
    rc = static_cast<int>(cudaGetLastError());
    // each Dense, last to first: dW, db, and the gradient of its input
    int cur = 0;
    for (int i = n_dense - 1; rc == 0 && i >= 0; --i) {
      float* sums = static_cast<float*>(db_parts) + static_cast<int64_t>(i) * db_blocks * C;
      rc = transpose<T>(dhbuf[cur], tr_a, sums, m, C, ld_t, acc, s);
      if (rc == 0) rc = transpose<T>(i > 0 ? static_cast<const void*>(ai(i - 1)) : e_c, tr_b, nullptr, m, C, ld_t, 0, s);
      if (rc == 0)
        rc = gemm<T>(tr_a, ld_t, tr_b, ld_t, C, C, m,
                     AddPairs{static_cast<float*>(dw_parts) + static_cast<int64_t>(i) * splits * cc, C, C, acc}, 0,
                     splits, s);
      if (rc == 0 && i > 0) {
        rc = gemm<T>(dhbuf[cur], C, dense_t[i], C, m, C, C, DaPairs<T>{zi(i - 1), dhbuf[cur ^ 1], C}, act, 1, s);
        cur ^= 1;
      } else if (rc == 0) {
        rc = gemm<T>(dhbuf[cur], C, dense_t[0], C, m, C, C, AddPairs{de_c, 0, C, 1}, 0, 1, s);
      }
    }
    if (rc != 0) break;
    // Dense 0's per-edge gradient summed per destination and per source
    const int threads = C < 256 ? ((C + 31) / 32) * 32 : 256;
    gnn_dst_sum_kernel<T><<<batch * num_dst, threads, 0, s>>>(dhbuf[cur], static_cast<const int*>(rowptr),
                                                              static_cast<float*>(dp_dst), r0, m, E, num_dst, C);
    gnn_src_sum_kernel<T><<<batch * num_src, threads, 0, s>>>(dhbuf[cur], static_cast<const int*>(colptr),
                                                              static_cast<const int*>(perm),
                                                              static_cast<float*>(dp_src), r0, m, E, num_src, C);
    rc = static_cast<int>(cudaGetLastError());
  }
  // the partials, in order
  for (int i = 0; rc == 0 && i < n_dense; ++i)
    rc = sum_parts(parts + static_cast<int64_t>(i) * splits * cc, dwf + i * cc, splits, cc, s);
  for (int i = 0; rc == 0 && i < n_dense; ++i)
    rc = sum_parts(static_cast<const float*>(db_parts) + static_cast<int64_t>(i) * db_blocks * C,
                   static_cast<float*>(db) + static_cast<int64_t>(i) * C, db_blocks, C, s);
  if (rc == 0) rc = sum_parts(static_cast<const float*>(ln_parts), static_cast<float*>(dln), ln_blocks, 2 * C, s);
  // the first Dense's per-node gradients (the partials' first slot is free again)
  if (rc == 0)
    rc = node_grads<T>(static_cast<const float*>(dp_dst), xd, dense_t[n_dense], node_t, static_cast<float*>(dx_dst),
                       dwf + n_dense * cc, parts, tr_a, tr_b, ld_t, batch * num_dst, C, chunk_rows, splits, s);
  if (rc == 0)
    rc = node_grads<T>(static_cast<const float*>(dp_src), xs, dense_t[n_dense + 1], node_t, static_cast<float*>(dx_src),
                       dwf + (n_dense + 1) * cc, parts, tr_a, tr_b, ld_t, batch * num_src, C, chunk_rows, splits, s);
  return rc;
}

}  // namespace

extern "C" {

// dense: each Dense's weight (C, K) in torch's Linear layout (K = 3C for the first) then its bias; dense_t:
// W0[:, 2C:3C]^T, each later Dense's W^T, then W0[:, 0:C]^T and W0[:, C:2C]^T, contiguous (C, C); g_agg
// (B Nd, C) fp32, g_msg (B E, C); the scratch: p_dst (B Nd, C), p_src (B Ns, C), z (n_dense - 1, chunk, C),
// h (chunk, C) fp32, a (n_dense - 1, chunk, C), dh0, dh1 (chunk, C), rows (chunk) int2, tr_a, tr_b (C, ld_t),
// node_t (max(B Nd, B Ns), C), dw_parts (n_dense, splits, C, C), db_parts (n_dense, db_blocks, C), ln_parts
// (ln_blocks, 2, C) fp32; the outputs: de (B E, C), dp_dst (B Nd, C) and dp_src (B Ns, C) (zeroed by the
// caller), dx_dst (B Nd, C), dx_src (B Ns, C), dw (n_dense + 2, C, C: Dense 0's edge block, each later Dense,
// then Dense 0's destination and source blocks), db (n_dense, C), dln (2, C: dgamma, dbeta), all fp32; ln_b is
// unused (the LayerNorm's beta has no part in any gradient but its own)
int gnn_conv_bwd_f32(const void* x_dst, const void* x_src, const void* e, const void* rowptr, const void* src,
                     const void* colptr, const void* perm, const void* const* dense, const void* const* dense_t,
                     int n_dense, const void* ln_g, const void* ln_b, const void* g_agg, const void* g_msg,
                     void* p_dst, void* p_src, void* z, void* a, void* h, void* dh0, void* dh1, void* rows,
                     void* tr_a, void* tr_b, int ld_t, void* node_t, void* dw_parts, int splits, void* db_parts,
                     int db_blocks, void* ln_parts, int ln_blocks, int chunk_rows, void* de, void* dp_dst,
                     void* dp_src, void* dx_dst, void* dx_src, void* dw, void* db, void* dln, int batch, int num_dst,
                     int num_src, int E, int C, int c_ln, int act, void* stream) {
  (void)ln_b;
  return launch_gnn_conv_bwd<float>(x_dst, x_src, e, rowptr, src, colptr, perm, dense, dense_t, n_dense, ln_g, g_agg,
                                    g_msg, p_dst, p_src, z, a, h, dh0, dh1, rows, tr_a, tr_b, ld_t, node_t, dw_parts,
                                    splits, db_parts, db_blocks, ln_parts, ln_blocks, chunk_rows, de, dp_dst, dp_src,
                                    dx_dst, dx_src, dw, db, dln, batch, num_dst, num_src, E, C, c_ln, act, static_cast<cudaStream_t>(stream));
}

int gnn_conv_bwd_bf16(const void* x_dst, const void* x_src, const void* e, const void* rowptr, const void* src,
                      const void* colptr, const void* perm, const void* const* dense, const void* const* dense_t,
                      int n_dense, const void* ln_g, const void* ln_b, const void* g_agg, const void* g_msg,
                      void* p_dst, void* p_src, void* z, void* a, void* h, void* dh0, void* dh1, void* rows,
                      void* tr_a, void* tr_b, int ld_t, void* node_t, void* dw_parts, int splits, void* db_parts,
                      int db_blocks, void* ln_parts, int ln_blocks, int chunk_rows, void* de, void* dp_dst,
                      void* dp_src, void* dx_dst, void* dx_src, void* dw, void* db, void* dln, int batch, int num_dst,
                      int num_src, int E, int C, int c_ln, int act, void* stream) {
  (void)ln_b;
  return launch_gnn_conv_bwd<bf16>(x_dst, x_src, e, rowptr, src, colptr, perm, dense, dense_t, n_dense, ln_g, g_agg,
                                   g_msg, p_dst, p_src, z, a, h, dh0, dh1, rows, tr_a, tr_b, ld_t, node_t, dw_parts,
                                   splits, db_parts, db_blocks, ln_parts, ln_blocks, chunk_rows, de, dp_dst, dp_src,
                                   dx_dst, dx_src, dw, db, dln, batch, num_dst, num_src, E, C, c_ln, act, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
