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
//                  dtype (the rounding point of _feats_kernel's projection).
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

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// kv_proj: out (M, N) = f (M, K) . w (N, K)^T + b (N), fp32 accumulation.
//
// Bound on the H100: at the O96 processor shape (M=10,242, K=256, N=512) it is
// 2.7 GFLOP over 16 MB of traffic: bytes-bound in bf16 at the tensor-core
// peak (0.0048 ms), operation-bound in fp32 (0.040 ms). This first version is a
// plain shared-memory tiled GEMM on the CUDA cores (64x64 tile per CTA, 4x4
// outputs per thread, operands converted to fp32 on the way into shared
// memory); the tensor-core (wgmma) version is later work.
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kProjThreads = (kBM / kTM) * (kBN / kTN);  // 256

template <typename T>
__global__ void __launch_bounds__(kProjThreads)
kv_proj_kernel(const T* __restrict__ f, const T* __restrict__ w, const float* __restrict__ b,
               T* __restrict__ out, int M, int N, int K) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kProjThreads) {
      const int r = idx / kBK;
      const int c = idx % kBK;
      const int gk = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      As[c][r] = (gm < M && gk < K) ? to_f(f[(int64_t)gm * K + gk]) : 0.f;
      Bs[c][r] = (gn < N && gk < K) ? to_f(w[(int64_t)gn * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = As[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = Bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N) out[(int64_t)gm * N + gn] = from_f<T>(acc[i][j] + b[gn]);
    }
  }
}

template <typename T>
int launch_kv_proj(const void* f, const void* w, const void* b, void* out, int M, int N, int K,
                   void* stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kv_proj_kernel<T><<<grid, kProjThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

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

int kv_proj_f32(const void* f, const void* w, const void* b, void* out, int M, int N, int K,
                void* stream) {
  return launch_kv_proj<float>(f, w, b, out, M, N, K, stream);
}

int kv_proj_bf16(const void* f, const void* w, const void* b, void* out, int M, int N, int K,
                 void* stream) {
  return launch_kv_proj<__nv_bfloat16>(f, w, b, out, M, N, K, stream);
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
