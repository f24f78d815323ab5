// Parts of the GNN edge-MLP convolution that both of its routes share: the
// fused kernels of gnn_conv.cu (C in {32, 64, 128, 256}, three Dense layers)
// and the layered route of gnn_conv_layered.cu (every other width and MLP
// depth) and its backward (gnn_conv_bwd.cu). The activation codes, the CSR
// destination lookup, the chunk's row table, the per-node pre-pass of the
// factored first Dense (on gemm_sm90.cuh's GEMM) and the per-destination sum
// of the messages.
//
// Everything sits in an unnamed namespace: each source that includes this
// header gets its own copies, so the two objects link without clashes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

using namespace sm90;  // bf16, the GEMM, TMA and wgmma helpers

struct gnn_prepass_tag {};  // names the pre-pass instantiations of gemm_sm90.cuh

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bf16 round_bf16(float x) { return __float2bfloat16(x); }

// the two bf16 of a 32-bit word (the lower address in the low half), exactly as floats
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// activation codes of ops/gnn_conv.py:_ACT_CODES. kFast (the bf16 kernel)
// divides by __fdividef: a 2-ulp fp32 quotient, rounded to bf16 after, with no
// slow-path call (IEEE division keeps one per element, beside a branch).
template <int A, bool kFast>
__device__ __forceinline__ float act_fn(float x) {
  if constexpr (A == 1) {
    return kFast ? __fdividef(x, 1.f + expf(-x)) : x / (1.f + expf(-x));  // SiLU
  } else if constexpr (A == 2) {
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));  // GELU, tanh form
  } else if constexpr (A == 3) {
    return fmaxf(x, 0.f);  // ReLU
  } else if constexpr (A == 4) {
    return tanhf(x);
  } else if constexpr (A == 5) {
    return kFast ? __fdividef(1.f, 1.f + expf(-x)) : 1.f / (1.f + expf(-x));  // sigmoid
  } else if constexpr (A == 6) {
    return x >= 0.f ? x : 0.01f * x;  // LeakyReLU, slope 0.01 (jax.nn and torch's default)
  } else if constexpr (A == 7) {
    return x > 0.f ? x : expm1f(x);  // ELU, alpha 1
  } else if constexpr (A == 8) {
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // softplus, as log(1 + e^x) that no x overflows
  } else if constexpr (A == 9) {
    return x * tanhf(fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))));  // mish: x tanh(softplus(x))
  } else {
    return x;
  }
}

template <int A, int N, bool kFast>
__device__ __forceinline__ void act_all(float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = act_fn<A, kFast>(v[i]);
}

// v[0:N] = act(v[0:N]) for a register array, with the switch outside the loop:
// a switch per element compiles to an indirect branch per element, and the
// epilogue then runs one element at a time
template <int N, bool kFast>
__device__ __forceinline__ void apply_act(float* v, int act) {
  switch (act) {
    case 1:
      act_all<1, N, kFast>(v);
      break;
    case 2:
      act_all<2, N, kFast>(v);
      break;
    case 3:
      act_all<3, N, kFast>(v);
      break;
    case 4:
      act_all<4, N, kFast>(v);
      break;
    case 5:
      act_all<5, N, kFast>(v);
      break;
    case 6:
      act_all<6, N, kFast>(v);
      break;
    case 7:
      act_all<7, N, kFast>(v);
      break;
    case 8:
      act_all<8, N, kFast>(v);
      break;
    case 9:
      act_all<9, N, kFast>(v);
      break;
    default:
      break;
  }
}

// the destination of CSR edge ee: the largest d with rowptr[d] <= ee
__device__ __forceinline__ int dst_of(const int* __restrict__ rowptr, int num_dst, int ee) {
  int lo = 0, hi = num_dst;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (rowptr[mid] <= ee) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// agg (B * Nd, C) fp32: one CTA per (batch, destination) sums its CSR row of
// the rounded msg in edge order, in fp32: one writer per row, no atomics,
// run-to-run deterministic. A thread sums the 16 bytes of V = 16 / sizeof(T)
// columns (C % 8 == 0 on both routes) from one load an edge, a few edges'
// loads in flight (one column a thread, 2 or 4 bytes a load, ran the bf16 sum
// at 41 % of the HBM rate on an H100).
template <typename T>
__global__ void gnn_agg_kernel(const T* __restrict__ msg, const int* __restrict__ rowptr,
                               float* __restrict__ agg, int num_dst, int E, int C) {
  constexpr int V = 16 / sizeof(T);
  const int row = blockIdx.x;  // batch * num_dst + destination
  const int b = row / num_dst;
  const int d = row - b * num_dst;
  const T* m = msg + (int64_t)b * E * C;
  const int lo = rowptr[d];
  const int hi = rowptr[d + 1];
  for (int c = V * threadIdx.x; c < C; c += V * blockDim.x) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int ee = lo; ee < hi; ++ee) {
      const uint4 raw = *reinterpret_cast<const uint4*>(m + (int64_t)ee * C + c);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (std::is_same<T, bf16>::value) {
          acc[2 * k] += bf16_lo(w[k]);
          acc[2 * k + 1] += bf16_hi(w[k]);
        } else {
          acc[k] += __uint_as_float(w[k]);
        }
      }
    }
    float4* o = reinterpret_cast<float4*>(agg + (int64_t)row * C + c);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) o[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  }
}

// Each chunk row's P rows for Dense 0, (B * Nd row, B * Ns row) of edge row
// r0 + r (batch b, CSR edge ee): a thread per (batch, destination) writes
// the rows of its CSR range that fall in the chunk. The table lives in the
// chunk's fp32 h scratch, which nothing reads until the last Dense writes it.
__global__ void gnn_rows_kernel(const int* __restrict__ rowptr, const int* __restrict__ src, int2* __restrict__ rows,
                                int64_t r0, int m, int E, int num_dst, int num_src, int batch) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * num_dst) return;
  const int b = t / num_dst;
  const int d = t - b * num_dst;
  const int64_t base = static_cast<int64_t>(b) * E - r0;  // edge ee is chunk row base + ee
  const int64_t lo = rowptr[d] > -base ? rowptr[d] : -base;
  const int64_t hi = rowptr[d + 1] < m - base ? rowptr[d + 1] : m - base;
  for (int64_t ee = lo; ee < hi; ++ee) rows[base + ee] = make_int2(b * num_dst + d, b * num_src + src[ee]);
}

int launch_rows(const void* rowptr, const void* src, void* rows, int64_t r0, int m, int E, int num_dst, int num_src,
                int batch, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (batch * num_dst + threads - 1) / threads;
  gnn_rows_kernel<<<blocks, threads, 0, stream>>>(static_cast<const int*>(rowptr), static_cast<const int*>(src),
                                                  static_cast<int2*>(rows), r0, m, E, num_dst, num_src, batch);
  return static_cast<int>(cudaGetLastError());
}

// P_dst = x_dst . W0[:, 0:C]^T + b0 and P_src = x_src . W0[:, C:2C]^T, fp32, one launch
template <typename T>
int launch_prepass(const void* x_dst, const void* x_src, const void* w0, const void* b0, float* p_dst,
                   float* p_src, int rows_dst, int rows_src, int C, cudaStream_t stream) {
  const T* w = static_cast<const T*>(w0);
  if constexpr (std::is_same<T, bf16>::value) {
    ProjBatch batch{};
    int rc = set_proj_problem(&batch.p[0], x_dst, C, w, 3 * C, b0, kBiasBF16, p_dst, C, rows_dst, C, C);
    if (rc == 0) rc = set_proj_problem(&batch.p[1], x_src, C, w + C, 3 * C, nullptr, kNoBias, p_src, C, rows_src, C, C);
    if (rc != 0) return rc;
    batch.k = C;
    return launch_proj_bf16<gnn_prepass_tag, float>(batch, 2, stream);
  } else {
    ProjF32Batch batch{};
    batch.p[0] = {static_cast<const float*>(x_dst), w, static_cast<const float*>(b0), p_dst, rows_dst, C, C, 3 * C, C};
    batch.p[1] = {static_cast<const float*>(x_src), w + C, nullptr, p_src, rows_src, C, C, 3 * C, C};
    batch.k = C;
    return launch_proj_f32<gnn_prepass_tag>(batch, 2, stream);
  }
}

template <typename T>
int launch_agg(const void* msg, const void* rowptr, void* agg, int batch, int num_dst, int E, int C,
               cudaStream_t stream) {
  const int vecs = C / (16 / static_cast<int>(sizeof(T)));
  const int threads = vecs < 256 ? ((vecs + 31) / 32) * 32 : 256;
  gnn_agg_kernel<T><<<batch * num_dst, threads, 0, stream>>>(
      static_cast<const T*>(msg), static_cast<const int*>(rowptr), static_cast<float*>(agg), num_dst, E, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
