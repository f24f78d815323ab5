// Hopper (sm_90a) backward of the GraphTransformer edge attention.
//
// Replaces anemoi_models_tpu/ops/pallas/edge_attention.py:_feats_bwd_kernel.
// Per block of destinations the TPU kernel recomputed the attention weights in
// the forward's m-gauge, gathered each slot's k/v row with a one-hot matmul and
// scattered the k/v cotangents into per-block slabs that were overlap-added
// afterwards (Mosaic can neither gather nor scatter in VMEM), and carried the
// edge-projection gradient dw_aug from one grid step to the next. On Hopper
// rows load by index and blocks run in no order, so the backward walks the
// same CSR edge lists as the forward (csrc/edge_attention.cu) in four phases:
//
//   dst pass   one CTA per (batch, destination) row, the forward's thread
//              layout. Recomputes, per edge e = (s -> t) and head h,
//                k_e = k[s] + a_e.w_aug,  v_e = v[s] + a_e.w_aug
//                w   = exp(min(scale <q[t], k_e>_h - m[t,h], 0))
//                dl  = w (<g_num[t], v_e>_h + g_den[t,h])
//              and writes dq[t] = sum_e scale dl k_e, the per-edge scalars
//              dl and w (B x E x H fp32) for the later phases, and the
//              per-destination factors P = <q[t], w_aug[r]>_h and
//              G = <g_num[t], w_aug[r]>_h that make da a sum over heads.
//              The CTAs stride over the rows in a fixed partition and each
//              keeps a private dw_aug partial in shared memory:
//                dw_aug[r, c] = sum_t scale q[t,c] sum_e a_e[r] dl_e
//                                   + g_num[t,c] sum_e a_e[r] w_e.
//   src pass   one CTA per (batch, source) row over the transposed CSR:
//                dk[s] = sum_e scale dl_e q[t],  dv[s] = sum_e w_e g_num[t].
//   edge pass  one thread per edge, summing over batch and heads:
//                da_e[r] = sum_b sum_h scale dl P[r,h] + w G[r,h].
//   dw reduce  the fixed-order sum of the dst pass's dw_aug partials.
//
// Every sum runs in a fixed order with no atomics, so the backward is
// run-to-run bit-identical. The logits are recomputed by the forward's own
// arithmetic (same per-thread fmaf chain, same shuffle tree), so w <= 1 holds
// with the forward's m; the exp argument is clamped at 0 all the same, as the
// TPU kernel clamps it.
//
// Bound on the H100: bytes. At the O96 encoder (E = 376,228, C = 256,
// A2 = 8, bf16) the function reads and writes about 173 MB once (0.052 ms at
// 3.35 TB/s), most of it the fp32 dkv; its fewest operations, about 10 C per
// edge once the edge term is factored through per-destination products with
// w_aug, are 1.3 GFLOP (0.0013 ms at the bf16 tensor peak, 0.02 ms at the
// fp32 peak). This first version keeps one edge in flight per warp, as the
// forward does, and relies on many resident CTAs to hide the dependent
// index -> row latency, which is what its time goes to.
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kMaxA2 = 16;  // kMaxA2 in csrc/edge_attention.cu
constexpr int kMaxRowThreads = 256;  // C / V; the wrapper checks it
constexpr int kEdgeThreads = 256;
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 8;

__device__ __forceinline__ float lane_sum(float s, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// ---------------------------------------------------------------------------
// dst pass. C / V threads, thread t owning channels [t*V, t*V + V) of head
// t*V / D; the D / V lanes of a head reduce with warp shuffles. The edge
// projection w_aug and the CTA's dw_aug partial live in shared memory
// (2 A2 C floats), each thread touching only its own channels, so they cost
// no registers: the kernel is bound by the latency of its dependent row
// loads and needs many resident CTAs. MAXA2 (8 or 16) sizes the per-edge
// attribute registers.
// ---------------------------------------------------------------------------

template <typename T, int V, int MAXA2>
__global__ void __launch_bounds__(kMaxRowThreads) edge_attn_bwd_dst_kernel(
    const T* __restrict__ q, const T* __restrict__ kv, const int* __restrict__ rowptr,
    const int* __restrict__ src, const T* __restrict__ a, const T* __restrict__ w_aug,
    const float* __restrict__ m_in, const float* __restrict__ g_num,
    const float* __restrict__ g_den, float* __restrict__ dq, float* __restrict__ dl_out,
    float* __restrict__ w_out, float* __restrict__ pg, float* __restrict__ dw_part, int rows,
    int num_dst, int num_src, int num_edges, int C, int H, int A2, int lanes, float scale) {
  extern __shared__ float smem[];
  float* w_s = smem;            // (A2, C) w_aug in fp32
  float* dw_s = smem + A2 * C;  // (A2, C) this CTA's dw_aug partial
  const int t = threadIdx.x;
  const int c0 = t * V;
  const int head = c0 / (C / H);
  const bool lead = t % lanes == 0;

  for (int r = 0; r < A2; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      w_s[r * C + c0 + v] = to_f(w_aug[r * C + c0 + v]);
      dw_s[r * C + c0 + v] = 0.f;
    }

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int bidx = row / num_dst;
    const int dst = row - bidx * num_dst;
    float qv[V], gv[V], dqa[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      qv[v] = to_f(q[(int64_t)row * C + c0 + v]);
      gv[v] = g_num[(int64_t)row * C + c0 + v];
      dqa[v] = 0.f;
    }
    const float m_h = m_in[(int64_t)row * H + head];
    const float gd_h = g_den[(int64_t)row * H + head];

    // per-destination factors of da: P[r] = <q, w_aug[r]>_h, G[r] = <g_num, w_aug[r]>_h
    float* pg_row = pg + (int64_t)row * 2 * A2 * H;
    for (int r = 0; r < A2; ++r) {
      float p = 0.f, g = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        p = fmaf(qv[v], w_s[r * C + c0 + v], p);
        g = fmaf(gv[v], w_s[r * C + c0 + v], g);
      }
      p = lane_sum(p, lanes);
      g = lane_sum(g, lanes);
      if (lead) {
        pg_row[r * H + head] = p;
        pg_row[(A2 + r) * H + head] = g;
      }
    }

    float adl[MAXA2], aw[MAXA2];
#pragma unroll
    for (int r = 0; r < MAXA2; ++r) adl[r] = aw[r] = 0.f;

    const T* kv_b = kv + (int64_t)bidx * num_src * 2 * C;
    float* dl_b = dl_out + (int64_t)bidx * num_edges * H;
    float* w_b = w_out + (int64_t)bidx * num_edges * H;
    const int e_end = rowptr[dst + 1];
    for (int e = rowptr[dst]; e < e_end; ++e) {
      const T* krow = kv_b + (int64_t)src[e] * 2 * C;
      const T* arow = a + (int64_t)e * A2;
      float ar[MAXA2], ev[V];
#pragma unroll
      for (int v = 0; v < V; ++v) ev[v] = 0.f;
#pragma unroll
      for (int r = 0; r < MAXA2; ++r) {
        ar[r] = r < A2 ? to_f(arow[r]) : 0.f;
        if (r < A2) {
#pragma unroll
          for (int v = 0; v < V; ++v) ev[v] = fmaf(ar[r], w_s[r * C + c0 + v], ev[v]);
        }
      }
      // the logit exactly as the forward computes it
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) s = fmaf(qv[v], to_f(krow[c0 + v]) + ev[v], s);
      s = lane_sum(s, lanes);
      const float w = expf(fminf(s * scale - m_h, 0.f));
      float s1 = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) s1 = fmaf(gv[v], to_f(krow[C + c0 + v]) + ev[v], s1);
      s1 = lane_sum(s1, lanes);
      const float dl = w * (s1 + gd_h);
      const float sdl = scale * dl;
#pragma unroll
      for (int v = 0; v < V; ++v) dqa[v] = fmaf(sdl, to_f(krow[c0 + v]) + ev[v], dqa[v]);
#pragma unroll
      for (int r = 0; r < MAXA2; ++r) {
        adl[r] = fmaf(ar[r], dl, adl[r]);
        aw[r] = fmaf(ar[r], w, aw[r]);
      }
      if (lead) {
        dl_b[(int64_t)e * H + head] = dl;
        w_b[(int64_t)e * H + head] = w;
      }
    }

#pragma unroll
    for (int v = 0; v < V; ++v) dq[(int64_t)row * C + c0 + v] = dqa[v];
#pragma unroll
    for (int r = 0; r < MAXA2; ++r)
      if (r < A2) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float* acc = dw_s + r * C + c0 + v;
          *acc = fmaf(scale * qv[v], adl[r], fmaf(gv[v], aw[r], *acc));
        }
      }
  }

  float* part = dw_part + (int64_t)blockIdx.x * A2 * C;
  for (int r = 0; r < A2; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) part[r * C + c0 + v] = dw_s[r * C + c0 + v];
}

// ---------------------------------------------------------------------------
// src pass: one CTA per (batch, source) row, walking the source's out-edges
// in the transposed CSR (edge ids ascending within a source).
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kMaxRowThreads) edge_attn_bwd_src_kernel(const T* __restrict__ q, const float* __restrict__ g_num,
                                         const int* __restrict__ colptr,
                                         const int* __restrict__ perm,
                                         const int* __restrict__ dst_of,
                                         const float* __restrict__ dl_in,
                                         const float* __restrict__ w_in, float* __restrict__ dkv,
                                         int num_dst, int num_src, int num_edges, int C, int H,
                                         float scale) {
  const int row = blockIdx.x;  // batch * num_src + source
  const int bidx = row / num_src;
  const int s = row - bidx * num_src;
  const int c0 = threadIdx.x * V;
  const int head = c0 / (C / H);

  float dk[V], dv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) dk[v] = dv[v] = 0.f;
  const float* dl_b = dl_in + (int64_t)bidx * num_edges * H;
  const float* w_b = w_in + (int64_t)bidx * num_edges * H;
  const int j_end = colptr[s + 1];
  for (int j = colptr[s]; j < j_end; ++j) {
    const int e = perm[j];
    const int64_t trow = (int64_t)bidx * num_dst + dst_of[e];
    const float sdl = scale * dl_b[(int64_t)e * H + head];
    const float w = w_b[(int64_t)e * H + head];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      dk[v] = fmaf(sdl, to_f(q[trow * C + c0 + v]), dk[v]);
      dv[v] = fmaf(w, g_num[trow * C + c0 + v], dv[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    dkv[(int64_t)row * 2 * C + c0 + v] = dk[v];
    dkv[(int64_t)row * 2 * C + C + c0 + v] = dv[v];
  }
}

// ---------------------------------------------------------------------------
// edge pass: da_e = de_e . w_aug^T with de_e = scale dl q[t] + w g_num[t],
// written as a sum over heads of the dst pass's per-destination factors, and
// over the batch (the edge attributes are batch-invariant).
// ---------------------------------------------------------------------------

__global__ void edge_attn_bwd_edge_kernel(const int* __restrict__ dst_of,
                                          const float* __restrict__ dl_in,
                                          const float* __restrict__ w_in,
                                          const float* __restrict__ pg, float* __restrict__ da,
                                          int batch, int num_dst, int num_edges, int H, int A2,
                                          float scale) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_edges) return;
  const int t = dst_of[e];
  float acc[kMaxA2];
#pragma unroll
  for (int r = 0; r < kMaxA2; ++r) acc[r] = 0.f;
  for (int b = 0; b < batch; ++b) {
    const float* pg_row = pg + ((int64_t)b * num_dst + t) * 2 * A2 * H;
    const float* dl_e = dl_in + ((int64_t)b * num_edges + e) * H;
    const float* w_e = w_in + ((int64_t)b * num_edges + e) * H;
    for (int h = 0; h < H; ++h) {
      const float sdl = scale * dl_e[h];
      const float w = w_e[h];
#pragma unroll
      for (int r = 0; r < kMaxA2; ++r)
        if (r < A2) acc[r] = fmaf(sdl, pg_row[r * H + h], fmaf(w, pg_row[(A2 + r) * H + h], acc[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxA2; ++r)
    if (r < A2) da[(int64_t)e * A2 + r] = acc[r];
}

// ---------------------------------------------------------------------------
// dw reduce: out[j] = sum_p part[p, j] in a fixed order (kReduceRows strided
// partial sums, then a fixed tree in shared memory).
// ---------------------------------------------------------------------------

__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int parts, int n) {
  __shared__ float sums[kReduceRows][kReduceCols + 1];
  const int j = blockIdx.x * kReduceCols + threadIdx.x;
  float acc = 0.f;
  if (j < n)
    for (int p = threadIdx.y; p < parts; p += kReduceRows) acc += part[(int64_t)p * n + j];
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kReduceRows; ++i) total += sums[i][threadIdx.x];
    out[j] = total;
  }
}

template <typename T, int V>
int launch_phases(const void* q, const void* kv, const void* rowptr, const void* src,
                  const void* a, const void* w_aug, const void* m, const void* g_num,
                  const void* g_den, const void* colptr, const void* perm, const void* dst_of,
                  void* dq, void* dkv, void* da, void* dw, void* dl, void* w, void* pg,
                  void* dw_part, int batch, int num_dst, int num_src, int num_edges, int C, int H,
                  int A2, int parts, cudaStream_t s) {
  const int D = C / H;
  const int lanes = D / V;
  const float scale = 1.0f / std::sqrt(static_cast<float>(D));
  const int rows = batch * num_dst;
  const size_t smem = 2 * sizeof(float) * A2 * C;
  auto dst_kernel = A2 <= 8 ? edge_attn_bwd_dst_kernel<T, V, 8> : edge_attn_bwd_dst_kernel<T, V, kMaxA2>;
  cudaFuncSetAttribute(dst_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  dst_kernel<<<parts, C / V, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const int*>(rowptr),
      static_cast<const int*>(src), static_cast<const T*>(a), static_cast<const T*>(w_aug),
      static_cast<const float*>(m), static_cast<const float*>(g_num),
      static_cast<const float*>(g_den), static_cast<float*>(dq), static_cast<float*>(dl),
      static_cast<float*>(w), static_cast<float*>(pg), static_cast<float*>(dw_part), rows,
      num_dst, num_src, num_edges, C, H, A2, lanes, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_src > 0) {
    edge_attn_bwd_src_kernel<T, V><<<batch * num_src, C / V, 0, s>>>(
        static_cast<const T*>(q), static_cast<const float*>(g_num),
        static_cast<const int*>(colptr), static_cast<const int*>(perm),
        static_cast<const int*>(dst_of), static_cast<const float*>(dl),
        static_cast<const float*>(w), static_cast<float*>(dkv), num_dst, num_src, num_edges, C,
        H, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_edges > 0) {
    edge_attn_bwd_edge_kernel<<<(num_edges + kEdgeThreads - 1) / kEdgeThreads, kEdgeThreads, 0,
                                s>>>(static_cast<const int*>(dst_of),
                                     static_cast<const float*>(dl), static_cast<const float*>(w),
                                     static_cast<const float*>(pg), static_cast<float*>(da),
                                     batch, num_dst, num_edges, H, A2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n = A2 * C;
  dw_reduce_kernel<<<(n + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceRows), 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<float*>(dw), parts, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge_attn_csr_bwd(const void* q, const void* kv, const void* rowptr, const void* src,
                             const void* a, const void* w_aug, const void* m, const void* g_num,
                             const void* g_den, const void* colptr, const void* perm,
                             const void* dst_of, void* dq, void* dkv, void* da, void* dw,
                             void* dl, void* w, void* pg, void* dw_part, int batch, int num_dst,
                             int num_src, int num_edges, int C, int H, int A2, int parts,
                             void* stream) {
  const int D = C / H;
  const int V = D > 32 ? D / 32 : 1;  // channels per thread; the wrapper checks D
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EDGE_ATTN_BWD_ARGS                                                                    \
  q, kv, rowptr, src, a, w_aug, m, g_num, g_den, colptr, perm, dst_of, dq, dkv, da, dw, dl, w, \
      pg, dw_part, batch, num_dst, num_src, num_edges, C, H, A2, parts, s
  int rc;
  if (V == 1) {
    rc = launch_phases<T, 1>(EDGE_ATTN_BWD_ARGS);
  } else if (V == 2) {
    rc = launch_phases<T, 2>(EDGE_ATTN_BWD_ARGS);
  } else {
    rc = launch_phases<T, 4>(EDGE_ATTN_BWD_ARGS);
  }
#undef EDGE_ATTN_BWD_ARGS
  return rc;
}

}  // namespace

extern "C" {

int edge_attn_csr_bwd_f32(const void* q, const void* kv, const void* rowptr, const void* src,
                          const void* a, const void* w_aug, const void* m, const void* g_num,
                          const void* g_den, const void* colptr, const void* perm,
                          const void* dst_of, void* dq, void* dkv, void* da, void* dw, void* dl,
                          void* w, void* pg, void* dw_part, int batch, int num_dst, int num_src,
                          int num_edges, int C, int H, int A2, int parts, void* stream) {
  return launch_edge_attn_csr_bwd<float>(q, kv, rowptr, src, a, w_aug, m, g_num, g_den, colptr,
                                         perm, dst_of, dq, dkv, da, dw, dl, w, pg, dw_part, batch,
                                         num_dst, num_src, num_edges, C, H, A2, parts, stream);
}

int edge_attn_csr_bwd_bf16(const void* q, const void* kv, const void* rowptr, const void* src,
                           const void* a, const void* w_aug, const void* m, const void* g_num,
                           const void* g_den, const void* colptr, const void* perm,
                           const void* dst_of, void* dq, void* dkv, void* da, void* dw, void* dl,
                           void* w, void* pg, void* dw_part, int batch, int num_dst, int num_src,
                           int num_edges, int C, int H, int A2, int parts, void* stream) {
  return launch_edge_attn_csr_bwd<__nv_bfloat16>(q, kv, rowptr, src, a, w_aug, m, g_num, g_den,
                                                 colptr, perm, dst_of, dq, dkv, da, dw, dl, w, pg,
                                                 dw_part, batch, num_dst, num_src, num_edges, C,
                                                 H, A2, parts, stream);
}

}  // extern "C"
