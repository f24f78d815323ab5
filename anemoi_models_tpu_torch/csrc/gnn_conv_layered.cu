// Hopper (sm_90a) kernels of the GNN edge-MLP convolution's layered route:
// every width C % 8 == 0 and every MLP depth that gnn_conv.cu's fused kernels
// do not take (they take C in {32, 64, 128, 256} with three Dense layers);
// the wrapper pads any other width to a multiple of 8 with zero columns, and
// the LayerNorm's statistics run over the true width.
//
// Replaces anemoi_models_tpu/ops/pallas/gnn_conv.py:_kernel as gnn_conv.cu
// does, and computes the same function with the same rounding points:
//
//   pre-pass        P_dst = x_dst . W0[:, 0:C]^T + b0, P_src = x_src .
//                   W0[:, C:2C]^T, fp32, once per node (gnn_common.cuh)
//   per chunk of consecutive CSR edge rows (a fixed count the wrapper
//   sets, so the scratch is bounded and the work order fixed):
//     gnn_dense_*<gnn_dense0_tag>   H = act(e . W0[:, 2C:3C]^T + P_dst[dst] + P_src[src]), rounded
//     gnn_dense_*<gnn_dense_tag>    H = act(H . Wi^T + bi), rounded, once per hidden Dense
//                                   after the first (ping-pong between two buffers)
//     gnn_dense_*<gnn_dense_last_tag>  h = H . Wlast^T + blast, fp32
//     gnn_ln_kernel                 msg = round(LN(h)) * gamma + beta + e (fp32 statistics,
//                                   eps 1e-6), rounded at the points of gnn_conv.cu
//   gnn_agg_kernel  the per-destination sum of the whole msg (gnn_common.cuh)
//
// Why not grow the fused kernel: its bf16 message kernel holds a 64 x C fp32
// accumulator per warpgroup (C / 2 registers a thread, 255 with 480 bytes of
// spills at C = 256) and 227 KB of shared memory at C = 256; its fp32 kernel
// 8 rows x C / 32 columns a thread. None of it scales to C = 1024. Here each
// Dense is one GEMM over the whole chunk, so every width tiles the same way.
//
// bf16 (gnn_dense_bf16_kernel): gemm_sm90.cuh's wgmma + TMA pipeline
// (128 x 128 tiles, K in 64-wide steps, 3-stage ring, two consumer
// warpgroups, two CTAs an SM) with epilogues of this file. W0[:, 2C:3C] is a
// strided K-major view: its tensor map takes the row stride 3C, so nothing is
// copied. Layer 0's accumulator starts at the gathered fp32 rows P_dst[dst] +
// P_src[src], loaded in the D-fragment layout while the first tiles arrive,
// as the fused kernel stages them; the destination of each of the tile's 128
// rows is looked up once (binary search in rowptr) into shared memory.
// fp32 (gnn_dense_f32_kernel): gemm_sm90.cuh's CUDA-core tile (exact fp32;
// TF32 would miss the 1e-5 gate) with the same epilogues, the P rows added
// after the product as the fused fp32 kernel adds them.
//
// Bound on the H100: operations. Each Dense is 2 C^2 per edge and the
// pre-pass 2 * 2 C^2 per node: at C = 1024 with three Dense, 6 C^2 per edge,
// 0.56 / 2.4 / 0.77 ms for the O96 processor / encoder / decoder at the bf16
// tensor-core rate. The scratch (two activations in the compute dtype and the
// fp32 h, per chunk) and the LayerNorm pass move 2 * (2 + 4) bytes a value on
// top of the products, which at these widths are the larger share.
//
// No split-K and no atomics: two calls are bit-identical. The entry points
// have a plain C interface, launch on the stream they are given, allocate
// nothing (P tables, activations and h are the caller's scratch) and return
// cudaGetLastError().

#include "gnn_common.cuh"  // the activations, dst_of, the pre-pass and gnn_agg_kernel

namespace {

using namespace sm90;  // bf16, the GEMM, TMA and wgmma helpers

struct gnn_dense0_tag {};      // layer 0: + P_dst[dst] + P_src[src], act, rounded
struct gnn_dense_tag {};       // a hidden Dense: + bias, act, rounded
struct gnn_dense_last_tag {};  // the last Dense: + bias, fp32

// What an epilogue reads beside the product.
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
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kDenseIdxOff = kProjBiasOff + kProjBN * sizeof(float);  // the tile's P rows: dst, src
constexpr size_t kDenseSmem = 1024 + kDenseIdxOff + 2 * kProjBM * sizeof(int);

template <typename Tag, typename OutT, bool kGather>
__global__ void __launch_bounds__(kProjThreads, 2)
gnn_dense_bf16_kernel(const __grid_constant__ ProjBatch batch, const DenseEpi epi) {
  const ProjProblem& pr = batch.p[0];
  const int m0 = blockIdx.x * kProjBM;
  const int n0 = blockIdx.y * kProjBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* bias = reinterpret_cast<float*>(smem + kProjBiasOff);
  int* d_rows = reinterpret_cast<int*>(smem + kDenseIdxOff);
  int* s_rows = d_rows + kProjBM;
  const int tid = threadIdx.x;
  const int ktiles = (batch.k + kProjBK - 1) / kProjBK;
  if constexpr (kGather) {
    // a row past the chunk looks up the chunk's last row: it is never stored
    if (tid < kProjBM) p_rows(epi, epi.row0 + min(m0 + tid, pr.m - 1), d_rows + tid, s_rows + tid);
  } else {
    if (tid < kProjBN) bias[tid] = n0 + tid < pr.n ? bias_at(pr.bias, pr.bias_kind, n0 + tid) : 0.f;
  }
  proj_bf16_start(pr, ktiles, m0, n0, smem);  // its barrier publishes d_rows, s_rows and bias

  constexpr int kR = kProjBN / 2;
  float acc[kR];
  const int lane = tid % 32;
  const int r_lo = (tid / 128) * 64 + ((tid % 128) / 32) * 16 + lane / 4;  // rows r_lo, r_lo + 8
  const int c_lo = 2 * (lane % 4);                                         // columns 8 j + c_lo, + 1
  if constexpr (kGather) {
    const float* pd[2] = {epi.p_dst + static_cast<int64_t>(d_rows[r_lo]) * epi.C + n0,
                          epi.p_dst + static_cast<int64_t>(d_rows[r_lo + 8]) * epi.C + n0};
    const float* ps[2] = {epi.p_src + static_cast<int64_t>(s_rows[r_lo]) * epi.C + n0,
                          epi.p_src + static_cast<int64_t>(s_rows[r_lo + 8]) * epi.C + n0};
#pragma unroll
    for (int j = 0; j < kProjBN / 8; ++j) {
      // four column blocks of loads in flight at a time, not all: the accumulator
      // leaves no room for 64 (the fused kernel's fence)
      if (j % 4 == 0) asm volatile("" ::: "memory");
      const bool live = n0 + 8 * j < pr.n;  // C % 8 == 0: a block of 8 columns is in or out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = live ? *reinterpret_cast<const float2*>(pd[h] + 8 * j + c_lo) : make_float2(0.f, 0.f);
        const float2 y = live ? *reinterpret_cast<const float2*>(ps[h] + 8 * j + c_lo) : make_float2(0.f, 0.f);
        acc[4 * j + 2 * h] = x.x + y.x;
        acc[4 * j + 2 * h + 1] = x.y + y.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = 0.f;
  }
  proj_bf16_run(pr, ktiles, m0, n0, smem, acc);

  if constexpr (!kGather) {
#pragma unroll
    for (int j = 0; j < kProjBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] += bias[8 * j + c_lo];
        acc[4 * j + 2 * h + 1] += bias[8 * j + c_lo + 1];
      }
    }
  }
  apply_act<kR, true>(acc, epi.act);
  proj_bf16_store<OutT, false>(acc, nullptr, pr.out, pr.m, pr.n, pr.ldo, m0, n0, smem);
}

// out (m, C) = epilogue(a (m, C) . w (C, C; rows ldw apart)^T)
template <typename Tag, typename OutT, bool kGather>
int dense_bf16(const void* a, const void* w, int ldw, const void* bias, void* out, int m, const DenseEpi& epi,
               cudaStream_t stream) {
  const int C = epi.C;
  ProjBatch batch{};
  const int rc = set_proj_problem(&batch.p[0], a, C, w, ldw, bias, bias ? kBiasBF16 : kNoBias, out, C, m, C, C);
  if (rc != 0) return rc;
  batch.k = C;
  auto kernel = gnn_dense_bf16_kernel<Tag, OutT, kGather>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDenseSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((m + kProjBM - 1) / kProjBM, (C + kProjBN - 1) / kProjBN);
  kernel<<<grid, kProjThreads, kDenseSmem, stream>>>(batch, epi);
  return static_cast<int>(cudaGetLastError());
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

// One Dense of the chunk in the compute dtype T (OutT: the output's type in bf16; fp32 is fp32 throughout).
template <typename T, typename Tag, typename OutT, bool kGather>
int dense_layer(const void* a, const void* w, int ldw, const void* bias, void* out, int m, const DenseEpi& epi,
                cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return dense_bf16<Tag, OutT, kGather>(a, w, ldw, bias, out, m, epi, stream);
  } else {
    return dense_f32<Tag, kGather>(a, w, ldw, bias, out, m, epi, stream);
  }
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

// ---------------------------------------------------------------------------
// the whole conv
// ---------------------------------------------------------------------------

template <typename T>
int launch_gnn_conv_layered(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                            const void* src, const void* const* dense, int n_dense, const void* ln_g,
                            const void* ln_b, void* p_dst, void* p_src, void* h0, void* h1, void* hf,
                            int chunk_rows, void* msg, void* agg, int batch, int num_dst, int num_src, int E, int C,
                            int c_ln, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dense < 2 || C % 8 != 0 || chunk_rows <= 0 || c_ln <= 0 || c_ln > C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (E > 0) {
    int rc = launch_prepass<T>(x_dst, x_src, dense[0], dense[1], static_cast<float*>(p_dst),
                               static_cast<float*>(p_src), batch * num_dst, batch * num_src, C, s);
    if (rc != 0) return rc;
    const T* w0 = static_cast<const T*>(dense[0]);
    void* hbuf[2] = {h0, h1};
    const int64_t rows = static_cast<int64_t>(batch) * E;
    for (int64_t r0 = 0; r0 < rows; r0 += chunk_rows) {
      const int m = static_cast<int>(rows - r0 < chunk_rows ? rows - r0 : chunk_rows);
      const T* e_c = static_cast<const T*>(e) + r0 * C;
      DenseEpi epi{static_cast<const float*>(p_dst), static_cast<const float*>(p_src),
                   static_cast<const int*>(rowptr), static_cast<const int*>(src), r0, E, num_dst, num_src, C, act};
      rc = dense_layer<T, gnn_dense0_tag, T, true>(e_c, w0 + 2 * C, 3 * C, nullptr, hbuf[0], m, epi, s);
      int cur = 0;
      for (int i = 1; rc == 0 && i < n_dense - 1; ++i, cur ^= 1) {
        rc = dense_layer<T, gnn_dense_tag, T, false>(hbuf[cur], dense[2 * i], C, dense[2 * i + 1], hbuf[cur ^ 1], m,
                                                     epi, s);
      }
      if (rc != 0) return rc;
      epi.act = 0;  // the last Dense has no activation
      rc = dense_layer<T, gnn_dense_last_tag, float, false>(hbuf[cur], dense[2 * (n_dense - 1)], C,
                                                            dense[2 * n_dense - 1], hf, m, epi, s);
      if (rc != 0) return rc;
      auto ln = c_ln == C ? gnn_ln_kernel<T, false> : gnn_ln_kernel<T, true>;
      ln<<<(m + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(
          static_cast<const float*>(hf), e_c, static_cast<const T*>(ln_g), static_cast<const T*>(ln_b),
          static_cast<T*>(msg) + r0 * C, m, C, c_ln);
      rc = static_cast<int>(cudaGetLastError());
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
