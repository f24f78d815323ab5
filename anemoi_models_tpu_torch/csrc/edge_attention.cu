// Hopper (sm_90a) kernels for the GraphTransformer edge attention.
//
// Replaces anemoi_models_tpu/ops/pallas/edge_attention.py:_feats_kernel, the
// TPU kernel of the commuted dataflow: per block of destinations it projected
// a narrow feature slab to [k|v] in VMEM, gathered each slot's row with a
// one-hot matmul (Mosaic cannot gather in VMEM) and emitted the merge-form
// softmax partials (num, den, m). On Hopper rows load by index, so the port
// splits that work in two plain kernels and runs straight off the CSR edge
// list, with no slab window, slot plan or outlier split:
//
//   kv_proj        kv = f . w^T + b, fp32 accumulation, rounded to the compute
//                  dtype (the rounding point of _feats_kernel's projection):
//                  the Hopper GEMM of gemm_sm90.cuh (wgmma fed by TMA in bf16,
//                  the CUDA cores in fp32), instantiated here under kv_proj_tag.
//   edge_attn_csr  one CTA per (batch, destination) walks the destination's
//                  edges with an online softmax per head and writes num, den
//                  and m in the m-gauge contract of ops/slot_attention.py.
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "gemm_sm90.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct kv_proj_tag {};  // names the kv_proj instantiations of gemm_sm90.cuh

// ---------------------------------------------------------------------------
// edge_attn_csr: merge-form attention partials over a CSR edge list.
//
//   e      = a[e] . w_aug                    (edge bias, fp32, bias row folded in)
//   logit  = q[dst] . (k[src] + e) / sqrt(D)  per head
//   m      = max live logit                  (-1e30 where a destination has no edge)
//   den    = sum exp(logit - m)
//   num    = sum exp(logit - m) (v[src] + e)
//
// One CTA per (batch, destination), C / V threads, thread t owning channels
// [t*V, t*V + V) of head t*V / D; the D / V lanes of a head reduce the logit
// with warp shuffles. The CTA walks its edges once with an online softmax, so
// any degree works and the forward has no atomics (run-to-run deterministic).
//
// Bound on the H100: the row reads, 2C compute-dtype values per edge (k and v)
// plus A2 attributes, about 90 MB per O96 processor layer in bf16, which sit
// in the 50 MB L2 for the most part (kv is 10.5 MB). This first version keeps
// one edge in flight per warp and leans on the many resident CTAs (16 per SM)
// to hide the dependent src -> row load latency.
// ---------------------------------------------------------------------------

constexpr int kMaxA2 = 16;
constexpr float kNeg = -1e30f;

template <typename T, int V>
__global__ void edge_attn_csr_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                                     const int* __restrict__ rowptr, const int* __restrict__ src,
                                     const T* __restrict__ a, const T* __restrict__ w_aug,
                                     float* __restrict__ num, float* __restrict__ den,
                                     float* __restrict__ m_out, int num_dst, int num_src, int C,
                                     int H, int A2, int lanes, float scale) {
  const int row = blockIdx.x;  // batch * num_dst + destination
  const int bidx = row / num_dst;
  const int dst = row - bidx * num_dst;
  const int t = threadIdx.x;
  const int c0 = t * V;

  float w_e[kMaxA2][V];
#pragma unroll
  for (int r = 0; r < kMaxA2; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) w_e[r][v] = r < A2 ? to_f(w_aug[r * C + c0 + v]) : 0.f;

  float qv[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    qv[v] = to_f(q[(int64_t)row * C + c0 + v]);
    acc[v] = 0.f;
  }
  float m = kNeg;
  float l = 0.f;

  const T* kv_b = kv + (int64_t)bidx * num_src * 2 * C;
  const int e_end = rowptr[dst + 1];
  for (int e = rowptr[dst]; e < e_end; ++e) {
    const T* krow = kv_b + (int64_t)src[e] * 2 * C;
    const T* arow = a + (int64_t)e * A2;
    float ev[V];
#pragma unroll
    for (int v = 0; v < V; ++v) ev[v] = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxA2; ++r) {
      if (r < A2) {
        const float ar = to_f(arow[r]);
#pragma unroll
        for (int v = 0; v < V; ++v) ev[v] = fmaf(ar, w_e[r][v], ev[v]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) s = fmaf(qv[v], to_f(krow[c0 + v]) + ev[v], s);
    for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float logit = s * scale;
    const float m_new = fmaxf(m, logit);
    const float corr = expf(m - m_new);
    const float p = expf(logit - m_new);
    l = fmaf(l, corr, p);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(acc[v], corr, p * (to_f(krow[C + c0 + v]) + ev[v]));
    m = m_new;
  }

#pragma unroll
  for (int v = 0; v < V; ++v) num[(int64_t)row * C + c0 + v] = acc[v];
  if (t % lanes == 0) {
    const int head = c0 / (C / H);
    den[(int64_t)row * H + head] = l;
    m_out[(int64_t)row * H + head] = m;
  }
}

template <typename T>
int launch_edge_attn_csr(const void* q, const void* kv, const void* rowptr, const void* src,
                         const void* a, const void* w_aug, void* num, void* den, void* m,
                         int batch, int num_dst, int num_src, int C, int H, int A2, void* stream) {
  const int D = C / H;
  const int V = D > 32 ? D / 32 : 1;  // channels per thread; the wrapper checks D
  const int lanes = D / V;
  const dim3 grid(batch * num_dst);
  const dim3 block(C / V);
  const float scale = 1.0f / std::sqrt(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EDGE_ATTN_ARGS                                                                          \
  static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const int*>(rowptr),         \
      static_cast<const int*>(src), static_cast<const T*>(a), static_cast<const T*>(w_aug),     \
      static_cast<float*>(num), static_cast<float*>(den), static_cast<float*>(m), num_dst,      \
      num_src, C, H, A2, lanes, scale
  if (V == 1) {
    edge_attn_csr_kernel<T, 1><<<grid, block, 0, s>>>(EDGE_ATTN_ARGS);
  } else if (V == 2) {
    edge_attn_csr_kernel<T, 2><<<grid, block, 0, s>>>(EDGE_ATTN_ARGS);
  } else {
    edge_attn_csr_kernel<T, 4><<<grid, block, 0, s>>>(EDGE_ATTN_ARGS);
  }
#undef EDGE_ATTN_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int kv_proj_f32(const void* f, const void* w, const void* b, void* out, int M, int N, int K, void* stream) {
  sm90::ProjF32Batch batch{};
  batch.p[0] = {static_cast<const float*>(f), static_cast<const float*>(w), static_cast<const float*>(b),
                static_cast<float*>(out), M, N, K, K, N};
  batch.k = K;
  return sm90::launch_proj_f32<kv_proj_tag>(batch, 1, static_cast<cudaStream_t>(stream));
}

// bf16 operands; the output is bf16, or fp32 with out_f32
int kv_proj_bf16(const void* f, const void* w, const void* b, void* out, int M, int N, int K, int out_f32,
                 void* stream) {
  sm90::ProjBatch batch{};
  int rc = sm90::set_proj_problem(&batch.p[0], f, K, w, K, b, sm90::kBiasF32, out, N, M, N, K);
  if (rc != 0) return rc;
  batch.k = K;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? sm90::launch_proj_bf16<kv_proj_tag, float>(batch, 1, s)
                 : sm90::launch_proj_bf16<kv_proj_tag, __nv_bfloat16>(batch, 1, s);
}

int edge_attn_csr_f32(const void* q, const void* kv, const void* rowptr, const void* src,
                      const void* a, const void* w_aug, void* num, void* den, void* m, int batch,
                      int num_dst, int num_src, int C, int H, int A2, void* stream) {
  return launch_edge_attn_csr<float>(q, kv, rowptr, src, a, w_aug, num, den, m, batch, num_dst,
                                     num_src, C, H, A2, stream);
}

int edge_attn_csr_bf16(const void* q, const void* kv, const void* rowptr, const void* src,
                       const void* a, const void* w_aug, void* num, void* den, void* m, int batch,
                       int num_dst, int num_src, int C, int H, int A2, void* stream) {
  return launch_edge_attn_csr<__nv_bfloat16>(q, kv, rowptr, src, a, w_aug, num, den, m, batch,
                                             num_dst, num_src, C, H, A2, stream);
}

}  // extern "C"
