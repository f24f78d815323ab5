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
// positions. Three kernels, no atomics (each output element has one writer):
//
//   flash_bwd_delta_kernel   D_i = rowsum(dO_i * O_i), fp32, a warp a row
//   dK and dV, a CTA per block of 64 keys, walking the query tiles its keys'
//            band reaches: P = exp(S - lse_i) recomputed per tile, the dropped
//            weights P~ = keep P / (1 - p), dV += P~^T dO, dS = P (dP~ - D_i)
//            with dP~ = keep (dO v_j) / (1 - p), dK += dS^T Q scale
//   dQ, a CTA per block of 64 queries, walking its key tiles: dQ += dS K scale
//
// bf16 heads of 16, 32, 64 and 128 (the wrapper pads the others up to 128)
// run their five products a tile on the tensor cores: mma.sync m16n8k16 with
// fp32 accumulation, a warp on 16 rows, the operands staged in padded shared
// tiles, the walked tiles copied by cp.async into one of two buffers while
// the other is in use (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel),
// the fragments read by ldmatrix (transposed for the B operands that run
// along a tile's rows: dO and Q for dV and dK, K for dQ). S and dP come out
// in the accumulator layout, which is the A-operand layout of the next
// product, so P~ and dS go to dV, dK and dQ from registers, rounded to bf16.
// Each pass recomputes S and dP, so
// the two do 14 D operations a (query, key) pair against the 10 D the
// gradient needs. fp32 heads and bf16 heads above 128 run on the CUDA cores
// (flash_bwd_dkdv_rows_kernel, flash_bwd_dq_rows_kernel): a warp a key (or
// query) row, a lane D / 32 channels, the dot products summed by shuffles, as
// the forward's row kernel does.
//
// Bound on the H100: operations. At O96 (B*H = 4, N = 10,242, D = 64,
// w = 512) about 1,025 keys per query live in the band: 10 D per pair, 26.9
// GFLOP, 0.027 ms at the bf16 tensor-core peak, against about 47 MB of q, k,
// v, o, dO and the three fp32 gradients (0.014 ms).
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"  // the band, Philox dropout

namespace {

using bf16 = __nv_bfloat16;

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

// the queries [qlo, qhi] that see key j (qhi < qlo: none)
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

// ---------------------------------------------------------------------------
// bf16, D <= 128: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

// d (16 x 8 fp32) += a (16 x 16 bf16, row-major fragment) . b (16 x 8 bf16, column-major fragment)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory, lane l addressing row l % 8 of matrix l / 8; with .trans each
// thread gets a column pair of each matrix instead of a row pair
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a row-major tile (rows LD apart)
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// the B fragments (k0 .. k0 + 15) x (n0 .. n0 + 7) and x (n0 + 8 .. n0 + 15), b[0], b[1] and b[2], b[3], of a
// tile stored by n (k contiguous)
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* tile, int k0, int n0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8);
}

// the same from a tile stored by k (n contiguous), transposed by ldmatrix
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* tile, int k0, int n0, int lane) {
  ldsm_x4_trans(b, tile + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8);
}

// accumulator fragments of two 16 x 8 tiles -> the A fragment of their 16 x 16, rounded to bf16
__device__ __forceinline__ void to_frag_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack2(lo[0], lo[1]);
  a[1] = pack2(lo[2], lo[3]);
  a[2] = pack2(hi[0], hi[1]);
  a[3] = pack2(hi[2], hi[3]);
}

// asynchronous copies into shared memory: `bytes` (4 or 16) from src, or zeros where !valid
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + rows) of a (n, D) head matrix, rows sn apart, into a tile of rows LD apart (rows outside
// [0, n) as 0), by cp.async
template <int D, int LD>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* src, int64_t sn, int r0, int rows, int n) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool valid = r0 + r >= 0 && r0 + r < n;
    cp_async<16>(tile + r * LD + c, valid ? src + (r0 + r) * sn + c : src, valid);
  }
}

// values [i0, i0 + count) of a row statistic (outside [0, n) as 0), by cp.async
__device__ __forceinline__ void load_stats(float* dst, const float* src, int i0, int count, int n) {
  for (int r = threadIdx.x; r < count; r += blockDim.x) {
    const bool valid = i0 + r < n;
    cp_async<4>(dst + r, valid ? src + i0 + r : src, valid);
  }
}

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;                 // padded rows: ldmatrix's 8 rows hit distinct banks
  static constexpr int kRows = 64;                  // keys (dK, dV) or queries (dQ) a CTA, 16 a warp
  static constexpr int kInner = D <= 64 ? 64 : 32;  // the tiles walked: S, dP and the outputs fit the registers
  // the CTA's own two tiles, two buffers of the walked tiles' two, and (dK, dV) two buffers of two statistics
  static constexpr size_t kSmem = static_cast<size_t>(2 * kRows + 4 * kInner) * kLd * 2 + 4 * kInner * 4;
};

// P, the dropped weights and dS of one accumulator element (all 0 where the pair is masked)
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

// dK and dV of a block of 64 keys: the query tiles its band reaches, each copied into one of two buffers while
// the other is in use
template <int D, bool DROP>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_mma_kernel(const __grid_constant__ BwdArgs a) {
  using M = MmaTile<D>;
  constexpr int LD = M::kLd, BQ = M::kInner;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + M::kRows * LD;
  bf16* Qs = Vs + M::kRows * LD;  // [buffer][BQ][LD]
  bf16* Gs = Qs + 2 * BQ * LD;
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * LD);  // [buffer][BQ]
  float* Ds = Ls + 2 * BQ;
  const Band& bd = a.band;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * M::kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.ks[0] + h * a.ks[1];
  const bf16* go = static_cast<const bf16*>(a.g) + b * a.gs[0] + h * a.gs[1];
  const float* lse = a.lse + static_cast<int64_t>(bh) * bd.nq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * bd.nq;
  int qlo, qhi;
  query_range(bd, k0, k0 + M::kRows - 1, qlo, qhi);
  auto issue = [&](int i0, int buf) {
    load_rows<D, LD>(Qs + buf * BQ * LD, q, a.qs[2], i0, BQ, bd.nq);
    load_rows<D, LD>(Gs + buf * BQ * LD, go, a.gs[2], i0, BQ, bd.nq);
    load_stats(Ls + buf * BQ, lse, i0, BQ, bd.nq);
    load_stats(Ds + buf * BQ, delta, i0, BQ, bd.nq);
  };
  load_rows<D, LD>(Ks, k, a.ks[2], k0, M::kRows, bd.nk);
  load_rows<D, LD>(Vs, v, a.ks[2], k0, M::kRows, bd.nk);
  if (qlo <= qhi) issue(qlo, 0);
  cp_async_commit();
  const int kw = warp * 16;  // the warp's keys in the tile
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[n][r] = dv[n][r] = 0.f;

  for (int it = 0, i0 = qlo; i0 <= qhi; ++it, i0 += BQ) {
    const int buf = it & 1;
    if (i0 + BQ <= qhi) {  // the next tile into the other buffer, freed by the previous iteration's barrier
      issue(i0 + BQ, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qs + buf * BQ * LD;
    const bf16* Gb = Gs + buf * BQ * LD;
    const float* Lb = Ls + buf * BQ;
    const float* Db = Ds + buf * BQ;
    // S^T = K Q^T and dP^T = V dO^T: rows the warp's 16 keys, columns the tile's queries
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = dp[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<LD>(ak, Ks, kw, 16 * kk, lane);
      frag_a<LD>(av, Vs, kw, 16 * kk, lane);
#pragma unroll
      for (int n = 0; n < BQ / 8; n += 2) {
        uint32_t bq[4], bg[4];
        frag_b_nk<LD>(bq, Qb, 16 * kk, 8 * n, lane);
        frag_b_nk<LD>(bg, Gb, 16 * kk, 8 * n, lane);
        mma16816(s[n], ak, bq[0], bq[1]);
        mma16816(s[n + 1], ak, bq[2], bq[3]);
        mma16816(dp[n], av, bg[0], bg[1]);
        mma16816(dp[n + 1], av, bg[2], bg[3]);
      }
    }
    // element r of tile n: key k0 + kw + g + 8 (r / 2), query i0 + 8 n + 2 t + r % 2
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int il = 8 * n + 2 * t + (r & 1);
        pair_terms<DROP>(a, bh, i0 + il, k0 + kw + g + 8 * (r >> 1), s[n][r], dp[n][r], Lb[il], Db[il], s[n][r],
                         dp[n][r]);
      }
    }
    // dV += P~^T dO and dK += dS^T Q (scaled at the end)
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t pa[4], sa[4];
      to_frag_a(pa, s[2 * kq], s[2 * kq + 1]);
      to_frag_a(sa, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bg[4], bq[4];
        frag_b_kn<LD>(bg, Gb, 16 * kq, 8 * n, lane);
        frag_b_kn<LD>(bq, Qb, 16 * kq, 8 * n, lane);
        mma16816(dv[n], pa, bg[0], bg[1]);
        mma16816(dv[n + 1], pa, bg[2], bg[3]);
        mma16816(dk[n], sa, bq[0], bq[1]);
        mma16816(dk[n + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before the next iteration refills it
  }
  cp_async_wait<0>();  // no query tile: the K and V copies land before the CTA ends
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = k0 + kw + g + 8 * hf;
    if (j >= bd.nk) continue;
    float* dkr = a.dk + (static_cast<int64_t>(bh) * bd.nk + j) * D;
    float* dvr = a.dv + (static_cast<int64_t>(bh) * bd.nk + j) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n + 2 * t) = make_float2(dk[n][2 * hf] * a.scale, dk[n][2 * hf + 1] * a.scale);
      *reinterpret_cast<float2*>(dvr + 8 * n + 2 * t) = make_float2(dv[n][2 * hf], dv[n][2 * hf + 1]);
    }
  }
}

// dQ of a block of 64 queries: the key tiles its band reaches, double-buffered as above
template <int D, bool DROP>
__global__ void __launch_bounds__(128) flash_bwd_dq_mma_kernel(const __grid_constant__ BwdArgs a) {
  using M = MmaTile<D>;
  constexpr int LD = M::kLd, BK = M::kInner;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + M::kRows * LD;
  bf16* Ks = Gs + M::kRows * LD;  // [buffer][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;
  const Band& bd = a.band;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * M::kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.ks[0] + h * a.ks[1];
  const bf16* go = static_cast<const bf16*>(a.g) + b * a.gs[0] + h * a.gs[1];
  int lo, hi;
  key_range(bd, q0, min(q0 + M::kRows, bd.nq) - 1, lo, hi);
  auto issue = [&](int j0, int buf) {
    load_rows<D, LD>(Ks + buf * BK * LD, k, a.ks[2], j0, BK, bd.nk);
    load_rows<D, LD>(Vs + buf * BK * LD, v, a.ks[2], j0, BK, bd.nk);
  };
  load_rows<D, LD>(Qs, q, a.qs[2], q0, M::kRows, bd.nq);
  load_rows<D, LD>(Gs, go, a.gs[2], q0, M::kRows, bd.nq);
  if (lo <= hi) issue(lo, 0);
  cp_async_commit();
  const int qw = warp * 16;  // the warp's queries in the tile
  float lse[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = q0 + qw + g + 8 * hf;
    lse[hf] = i < bd.nq ? a.lse[static_cast<int64_t>(bh) * bd.nq + i] : 0.f;
    delta[hf] = i < bd.nq ? a.delta[static_cast<int64_t>(bh) * bd.nq + i] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[n][r] = 0.f;

  for (int it = 0, j0 = lo; j0 <= hi; ++it, j0 += BK) {
    const int buf = it & 1;
    if (j0 + BK <= hi) {
      issue(j0 + BK, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = dp[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      frag_a<LD>(aq, Qs, qw, 16 * kk, lane);
      frag_a<LD>(ag, Gs, qw, 16 * kk, lane);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t bk[4], bv[4];
        frag_b_nk<LD>(bk, Kb, 16 * kk, 8 * n, lane);
        frag_b_nk<LD>(bv, Vb, 16 * kk, 8 * n, lane);
        mma16816(s[n], aq, bk[0], bk[1]);
        mma16816(s[n + 1], aq, bk[2], bk[3]);
        mma16816(dp[n], ag, bv[0], bv[1]);
        mma16816(dp[n + 1], ag, bv[2], bv[3]);
      }
    }
    // element r of tile n: query q0 + qw + g + 8 (r / 2), key j0 + 8 n + 2 t + r % 2
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float pd;
        pair_terms<DROP>(a, bh, q0 + qw + g + 8 * (r >> 1), j0 + 8 * n + 2 * t + (r & 1), s[n][r], dp[n][r],
                         lse[r >> 1], delta[r >> 1], pd, dp[n][r]);
      }
    }
    // dQ += dS K (scaled at the end)
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      uint32_t sa[4];
      to_frag_a(sa, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bk[4];
        frag_b_kn<LD>(bk, Kb, 16 * kq, 8 * n, lane);
        mma16816(dq[n], sa, bk[0], bk[1]);
        mma16816(dq[n + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = q0 + qw + g + 8 * hf;
    if (i >= bd.nq) continue;
    float* dqr = a.dq + (static_cast<int64_t>(bh) * bd.nq + i) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dqr + 8 * n + 2 * t) = make_float2(dq[n][2 * hf] * a.scale, dq[n][2 * hf + 1] * a.scale);
  }
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

template <int D, bool DROP>
int launch_mma(const BwdArgs& a, int BH, cudaStream_t s) {
  using M = MmaTile<D>;
  auto dkdv = flash_bwd_dkdv_mma_kernel<D, DROP>;
  auto dq = flash_bwd_dq_mma_kernel<D, DROP>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(M::kSmem));
    return e != cudaSuccess ? e : cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       static_cast<int>(M::kSmem));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dkdv<<<dim3((a.band.nk + M::kRows - 1) / M::kRows, BH), 128, M::kSmem, s>>>(a);
  dq<<<dim3((a.band.nq + M::kRows - 1) / M::kRows, BH), 128, M::kSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NV, bool DROP>
int launch_rows(const BwdArgs& a, int BH, cudaStream_t s) {
  flash_bwd_dkdv_rows_kernel<T, NV, DROP>
      <<<dim3((a.band.nk + kRowWarps - 1) / kRowWarps, BH), 32 * kRowWarps, 0, s>>>(a);
  flash_bwd_dq_rows_kernel<T, NV, DROP><<<dim3((a.band.nq + kRowWarps - 1) / kRowWarps, BH), 32 * kRowWarps, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DROP>
int launch_grads(const BwdArgs& a, int BH, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    switch (a.D) {
      case 16: return launch_mma<16, DROP>(a, BH, s);
      case 32: return launch_mma<32, DROP>(a, BH, s);
      case 64: return launch_mma<64, DROP>(a, BH, s);
      case 128: return launch_mma<128, DROP>(a, BH, s);
      default: break;
    }
  }
  if (a.D <= 256) return launch_rows<T, 8, DROP>(a, BH, s);
  if (a.D <= 512) return launch_rows<T, 16, DROP>(a, BH, s);
  if (a.D <= 1024) return launch_rows<T, 32, DROP>(a, BH, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,
                     float* delta, float* dq, float* dk, float* dv, int B, int H, int Nq, int Nk, int D,
                     const int64_t qs[3], const int64_t ks[3], const int64_t os[3], const int64_t gs[3], int window,
                     int causal, int q_pos0, int k_pos0, int n_valid, float scale, const Dropout& dp,
                     cudaStream_t s) {
  if (D <= 0 || D > 1024 || B * H <= 0 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, o, g, lse, delta, dq, dk, dv, H, D, {qs[0], qs[1], qs[2]}, {ks[0], ks[1], ks[2]},
            {os[0], os[1], os[2]}, {gs[0], gs[1], gs[2]},
            make_band(Nq, Nk, window, causal, q_pos0, k_pos0, n_valid, qs, ks), scale, dp};
  const int BH = B * H;
  flash_bwd_delta_kernel<T><<<dim3((Nq + 3) / 4, BH), 128, 0, s>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return dp.on ? launch_grads<T, true>(a, BH, s) : launch_grads<T, false>(a, BH, s);
}

}  // namespace

extern "C" {

// q (B, H, Nq, D), k, v (B, H, Nk, D), o and dO (B, H, Nq, D) by their (batch, head, row) strides (channels
// contiguous; the bf16 tensor-core kernels read 16-byte rows); lse (B, H, Nq) fp32 from the forward; delta
// (B, H, Nq) fp32 scratch; dq, dk, dv contiguous fp32 outputs, zeroed by the caller (a key no query sees keeps
// 0); the band, offsets and dropout as flash_attention.cu's entry points take them
#define FLASH_BWD_ENTRY(name, T)                                                                                   \
  int name(const void* q, const void* k, const void* v, const void* o, const void* g, const float* lse,            \
           float* delta, float* dq, float* dk, float* dv, int B, int H, int Nq, int Nk, int D, int64_t qsb,          \
           int64_t qsh, int64_t qsn, int64_t ksb, int64_t ksh, int64_t ksn, int64_t osb, int64_t osh, int64_t osn,    \
           int64_t gsb, int64_t gsh, int64_t gsn, int window, int causal, int q_pos0, int k_pos0, int n_valid,        \
           float scale, int dropout, uint32_t keep_below, uint32_t k0, uint32_t k1, float rscale, void* stream) {    \
    const int64_t qs[3] = {qsb, qsh, qsn}, ks[3] = {ksb, ksh, ksn}, os[3] = {osb, osh, osn}, gs[3] = {gsb, gsh, gsn}; \
    return launch_flash_bwd<T>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Nq, Nk, D, qs, ks, os, gs, window,     \
                               causal, q_pos0, k_pos0, n_valid, scale, Dropout{dropout, keep_below, k0, k1, rscale}, \
                               static_cast<cudaStream_t>(stream));                                                   \
  }

FLASH_BWD_ENTRY(flash_attn_bwd_f32, float)
FLASH_BWD_ENTRY(flash_attn_bwd_bf16, bf16)

#undef FLASH_BWD_ENTRY

}  // extern "C"
