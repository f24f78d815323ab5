// Hopper (sm_90a) kernels for the GNN flavor's edge-MLP convolution.
//
// Replaces anemoi_models_tpu/ops/pallas/gnn_conv.py:_kernel: per destination
// block it DMA'd a source slab, materialised x_i and x_j by one-hot matmuls
// (Mosaic cannot gather in VMEM), ran the edge MLP in VMEM and group-summed
// the slot messages, with the slot layout, slab window and outlier list that
// gather forced. On Hopper rows load by index, so the port runs straight off
// the destination-sorted CSR edge list (no cap, any degree), in two kernels
// behind one entry point:
//
//   gnn_msg_kernel  one CTA per (64 edges, batch) gathers [x_i | x_j | e]
//                   (rows 0:C, C:2C, 2C:3C of W0), runs
//                   h  = act(W0 . [x_i; x_j; e] + b0)      (fp32, rounded)
//                   h  = act(W1 . h + b1)                  (fp32, rounded)
//                   h  = W2 . h + b2                       (fp32)
//                   msg = LN(h) * gamma + beta + e         (compute dtype)
//                   with fp32 LayerNorm statistics (eps 1e-6), the normalised
//                   value rounded before gamma and beta, as the TPU kernel
//                   rounds; msg goes to memory in edge order.
//   gnn_agg_kernel  one CTA per (batch, destination) sums its CSR row of the
//                   rounded msg in edge order, in fp32: one writer per row, no
//                   atomics, run-to-run deterministic.
//
// Bound on the H100: operations at the bf16 tensor-core rate. The fewest
// operations factor x_i . W0[0:C] and x_j . W0[C:2C] once per node (2 * 2 C^2
// per node), leaving 2 * 3 C^2 per edge; at the O96 processor (10,242 nodes,
// 81,900 edges, C = 256) about 35 GFLOP per layer, 0.035 ms, against 0.025 ms
// of bytes (e read and msg written). This first version does not factor: the
// gathered rows go through the full 3C x C product (2 * 5 C^2 per edge), on
// the tensor cores through nvcuda::wmma (bf16 16x16x16 fragments, fp32
// accumulate), with the weights staged through shared memory in K tiles (W0
// is 384 KB in bf16 and does not fit); fp32 inputs take the CUDA cores. The
// loads are synchronous, so two CTAs per SM (GnnLayout) hide each other's.
// Each CTA re-reads the 640 KB of bf16 weights from L2; larger edge tiles,
// a cp.async / TMA pipeline, wgmma and the per-node factoring are later work.
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kTE = 64;  // edges per CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

template <typename T>
__device__ __forceinline__ T round_to(float x) { return from_f<T>(x); }

// activation codes of ops/gnn_conv.py:_ACT_CODES
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1:
      return x / (1.f + expf(-x));  // SiLU
    case 2:
      return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));  // GELU, tanh form
    case 3:
      return fmaxf(x, 0.f);  // ReLU
    case 4:
      return tanhf(x);
    case 5:
      return 1.f / (1.f + expf(-x));  // sigmoid
    default:
      return x;
  }
}

// Shared memory: the weight tile Wt, the gathered input tile At and the
// hidden activations H; after the last product the fp32 rows S for the
// LayerNorm take their place. Each warp stages one 16x16 fragment at a time
// for the bias and activation (bf16 path). About 85 KB at C = 256 in bf16,
// so two CTAs share an SM and one's loads overlap the other's products.
template <typename T, int C>
struct GnnLayout {
  static constexpr bool kTensor = std::is_same<T, bf16>::value;
  static constexpr int kKC = kTensor ? (C < 64 ? C : 64) : 32;  // K tile (divides C)
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLdW = C + kPad;   // weight tile rows (kKC of them)
  static constexpr int kLdA = kKC + kPad;  // gathered input tile rows (kTE)
  static constexpr int kLdH = C + kPad;   // hidden activations (kTE rows)
  static constexpr int kLdS = C + 4;      // fp32 rows for the LayerNorm (kTE)
  static constexpr size_t kW = (size_t)kKC * kLdW * sizeof(T);
  static constexpr size_t kA = (size_t)kTE * kLdA * sizeof(T);
  static constexpr size_t kH = (size_t)kTE * kLdH * sizeof(T);
  static constexpr size_t kS = (size_t)kTE * kLdS * sizeof(float);
  static constexpr size_t kUnion = kW + kA + kH > kS ? kW + kA + kH : kS;
  static constexpr size_t kStage = kTensor ? (size_t)kWarps * 16 * 16 * sizeof(float) : 0;
  static constexpr size_t kBytes = kUnion + kStage + 2 * kTE * sizeof(int);
};

struct GatherArgs {
  const void* x_dst;  // this batch element's (Nd, C) rows
  const void* x_src;  // (Ns, C)
  const void* e;      // (E, C)
  const int* dst_s;   // shared: destination / source of each of the tile's edges
  const int* src_s;
  int e0, E;
};

// A (kTE x K) . W (K x C) in fp32. With GATHER, A's K tiles are gathered rows
// of [x_dst | x_src | e]; otherwise A is H. With ACT the result goes to H as
// round(act(. + bias)); otherwise to S (fp32).
template <typename T, int C, bool GATHER, bool ACT>
__device__ void tile_gemm(const T* __restrict__ W, int K, T* Wt, T* At, T* H, float* S, float* stage,
                          const T* __restrict__ bias, int act, const GatherArgs& g) {
  using L = GnnLayout<T, C>;
  constexpr int kVec = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // bf16: warp w owns rows 16 (w % 4) and columns C/2 (w / 4); fp32: thread t
  // owns rows 8 (t / 32) .. + 8 and columns lane + 32 j
  constexpr int kNF = L::kTensor ? C / 32 : 1;
  constexpr int kRows = 8;
  constexpr int kCols = C / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_t[kNF];
  float acc_f[L::kTensor ? 1 : kRows][L::kTensor ? 1 : kCols];
  const int rb = (warp % 4) * 16;
  const int cb = (warp / 4) * (C / 2);
  if constexpr (L::kTensor) {
#pragma unroll
    for (int f = 0; f < kNF; ++f) wmma::fill_fragment(acc_t[f], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc_f[i][j] = 0.f;
  }

  for (int kc = 0; kc < K; kc += L::kKC) {
    __syncthreads();  // the previous tile's Wt / At are consumed
    for (int idx = tid; idx < L::kKC * (C / kVec); idx += kThreads) {
      const int r = idx / (C / kVec);
      const int c = (idx % (C / kVec)) * kVec;
      *reinterpret_cast<int4*>(Wt + r * L::kLdW + c) =
          *reinterpret_cast<const int4*>(W + (int64_t)(kc + r) * C + c);
    }
    if constexpr (GATHER) {
      const int seg = kc / C;  // 0: x_i (destination), 1: x_j (source), 2: e
      const int col0 = kc % C;
      for (int idx = tid; idx < kTE * (L::kKC / kVec); idx += kThreads) {
        const int r = idx / (L::kKC / kVec);
        const int c = (idx % (L::kKC / kVec)) * kVec;
        int4 val = make_int4(0, 0, 0, 0);
        const T* row = nullptr;
        if (seg == 0) {
          row = static_cast<const T*>(g.x_dst) + (int64_t)g.dst_s[r] * C;
        } else if (seg == 1) {
          row = static_cast<const T*>(g.x_src) + (int64_t)g.src_s[r] * C;
        } else if (g.e0 + r < g.E) {
          row = static_cast<const T*>(g.e) + (int64_t)(g.e0 + r) * C;
        }
        if (row != nullptr) val = *reinterpret_cast<const int4*>(row + col0 + c);
        *reinterpret_cast<int4*>(At + r * L::kLdA + c) = val;
      }
    }
    __syncthreads();

    const T* A = GATHER ? At : H + kc;
    const int lda = GATHER ? L::kLdA : L::kLdH;
    if constexpr (L::kTensor) {
#pragma unroll
      for (int kk = 0; kk < L::kKC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + rb * lda + kk, lda);
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Wt + kk * L::kLdW + cb + f * 16, L::kLdW);
          wmma::mma_sync(acc_t[f], a, b, acc_t[f]);
        }
      }
    } else {
      const int r0 = warp * kRows;
      for (int kk = 0; kk < L::kKC; ++kk) {
        float av[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) av[i] = to_f(A[(r0 + i) * lda + kk]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float w = to_f(Wt[kk * L::kLdW + lane + 32 * j]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc_f[i][j] = fmaf(av[i], w, acc_f[i][j]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done reading Wt, At and H before they are rewritten
  if constexpr (L::kTensor) {
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      if constexpr (ACT) {
        float* st = stage + warp * 256;
        wmma::store_matrix_sync(st, acc_t[f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int idx = lane; idx < 256; idx += 32) {
          const int col = cb + f * 16 + (idx % 16);
          H[(rb + idx / 16) * L::kLdH + col] = round_to<T>(activate(st[idx] + to_f(bias[col]), act));
        }
        __syncwarp();
      } else {
        wmma::store_matrix_sync(S + rb * L::kLdS + cb + f * 16, acc_t[f], L::kLdS, wmma::mem_row_major);
      }
    }
  } else {
    const int r0 = warp * kRows;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + 32 * j;
        if constexpr (ACT) {
          H[(r0 + i) * L::kLdH + col] = round_to<T>(activate(acc_f[i][j] + to_f(bias[col]), act));
        } else {
          S[(r0 + i) * L::kLdS + col] = acc_f[i][j];
        }
      }
  }
  __syncthreads();
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
gnn_msg_kernel(const T* __restrict__ x_dst, const T* __restrict__ x_src, const T* __restrict__ e,
               const int* __restrict__ rowptr, const int* __restrict__ src,
               const T* __restrict__ w0, const T* __restrict__ b0, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
               const T* __restrict__ ln_g, const T* __restrict__ ln_b, T* __restrict__ msg,
               int num_dst, int num_src, int E, int act) {
  using L = GnnLayout<T, C>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Wt = reinterpret_cast<T*>(smem);
  T* At = reinterpret_cast<T*>(smem + L::kW);
  T* H = reinterpret_cast<T*>(smem + L::kW + L::kA);
  float* S = reinterpret_cast<float*>(smem);  // after the last product only
  float* stage = reinterpret_cast<float*>(smem + L::kUnion);
  int* dst_s = reinterpret_cast<int*>(smem + L::kUnion + L::kStage);
  int* src_s = dst_s + kTE;

  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kTE;
  const int tid = threadIdx.x;
  if (tid < kTE) {
    const int ee = e0 + tid;
    int d = 0, s = 0;
    if (ee < E) {
      s = src[ee];
      int lo = 0, hi = num_dst;  // the largest d with rowptr[d] <= ee
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (rowptr[mid] <= ee) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      d = lo;
    }
    dst_s[tid] = d;
    src_s[tid] = s;
  }
  // (tile_gemm's first barrier publishes dst_s / src_s)

  const T* e_b = e + (int64_t)b * E * C;
  const GatherArgs g{x_dst + (int64_t)b * num_dst * C, x_src + (int64_t)b * num_src * C, e_b,
                     dst_s, src_s, e0, E};
  tile_gemm<T, C, true, true>(w0, 3 * C, Wt, At, H, S, stage, b0, act, g);
  tile_gemm<T, C, false, true>(w1, C, Wt, At, H, S, stage, b1, act, g);
  tile_gemm<T, C, false, false>(w2, C, Wt, At, H, S, stage, nullptr, act, g);

  // LayerNorm over each row (one warp per 8 rows), gamma, beta, + e
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int kCols = C / 32;
  for (int r = warp * (kTE / kWarps); r < (warp + 1) * (kTE / kWarps); ++r) {
    if (e0 + r >= E) break;
    float h[kCols];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      h[j] = S[r * L::kLdS + c] + to_f(b2[c]);
      sum += h[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) sq += (h[j] - mu) * (h[j] - mu);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rs = rsqrtf(sq / C + 1e-6f);
    const int64_t row = (int64_t)(e0 + r) * C;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      const T hn = round_to<T>((h[j] - mu) * rs);
      const T y = round_to<T>(to_f(round_to<T>(to_f(hn) * to_f(ln_g[c]))) + to_f(ln_b[c]));
      msg[(int64_t)b * E * C + row + c] = round_to<T>(to_f(y) + to_f(e_b[row + c]));
    }
  }
}

template <typename T>
__global__ void gnn_agg_kernel(const T* __restrict__ msg, const int* __restrict__ rowptr,
                               float* __restrict__ agg, int num_dst, int E, int C) {
  const int row = blockIdx.x;  // batch * num_dst + destination
  const int b = row / num_dst;
  const int d = row - b * num_dst;
  const T* m = msg + (int64_t)b * E * C;
  const int lo = rowptr[d];
  const int hi = rowptr[d + 1];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int ee = lo; ee < hi; ++ee) s += to_f(m[(int64_t)ee * C + c]);
    agg[(int64_t)row * C + c] = s;
  }
}

template <typename T, int C>
int launch_msg(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
               const void* src, const void* const* w, void* msg, int batch, int num_dst,
               int num_src, int E, int act, cudaStream_t stream) {
  using L = GnnLayout<T, C>;
  auto kernel = gnn_msg_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((E + kTE - 1) / kTE, batch);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(x_dst), static_cast<const T*>(x_src), static_cast<const T*>(e),
      static_cast<const int*>(rowptr), static_cast<const int*>(src), static_cast<const T*>(w[0]),
      static_cast<const T*>(w[1]), static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
      static_cast<const T*>(w[4]), static_cast<const T*>(w[5]), static_cast<const T*>(w[6]),
      static_cast<const T*>(w[7]), static_cast<T*>(msg), num_dst, num_src, E, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gnn_conv(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                    const void* src, const void* w0, const void* b0, const void* w1,
                    const void* b1, const void* w2, const void* b2, const void* ln_g,
                    const void* ln_b, void* msg, void* agg, int batch, int num_dst, int num_src,
                    int E, int C, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* w[8] = {w0, b0, w1, b1, w2, b2, ln_g, ln_b};
  if (E > 0) {
    int rc;
    switch (C) {  // the wrapper admits these widths only
      case 32:
        rc = launch_msg<T, 32>(x_dst, x_src, e, rowptr, src, w, msg, batch, num_dst, num_src, E, act, s);
        break;
      case 64:
        rc = launch_msg<T, 64>(x_dst, x_src, e, rowptr, src, w, msg, batch, num_dst, num_src, E, act, s);
        break;
      case 128:
        rc = launch_msg<T, 128>(x_dst, x_src, e, rowptr, src, w, msg, batch, num_dst, num_src, E, act, s);
        break;
      case 256:
        rc = launch_msg<T, 256>(x_dst, x_src, e, rowptr, src, w, msg, batch, num_dst, num_src, E, act, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
  }
  const int threads = C < 256 ? ((C + 31) / 32) * 32 : 256;
  gnn_agg_kernel<T><<<batch * num_dst, threads, 0, s>>>(
      static_cast<const T*>(msg), static_cast<const int*>(rowptr), static_cast<float*>(agg),
      num_dst, E, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gnn_conv_f32(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                 const void* src, const void* w0, const void* b0, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* ln_g, const void* ln_b, void* msg,
                 void* agg, int batch, int num_dst, int num_src, int E, int C, int act,
                 void* stream) {
  return launch_gnn_conv<float>(x_dst, x_src, e, rowptr, src, w0, b0, w1, b1, w2, b2, ln_g, ln_b,
                                msg, agg, batch, num_dst, num_src, E, C, act, stream);
}

int gnn_conv_bf16(const void* x_dst, const void* x_src, const void* e, const void* rowptr,
                  const void* src, const void* w0, const void* b0, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* ln_g, const void* ln_b, void* msg,
                  void* agg, int batch, int num_dst, int num_src, int E, int C, int act,
                  void* stream) {
  return launch_gnn_conv<bf16>(x_dst, x_src, e, rowptr, src, w0, b0, w1, b1, w2, b2, ln_g, ln_b,
                               msg, agg, batch, num_dst, num_src, E, C, act, stream);
}

}  // extern "C"
