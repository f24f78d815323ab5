// Hopper (sm_90a) kernel for band-masked (sliding-window) flash attention.
//
// Replaces anemoi_models_tpu/ops/pallas/flash_attention.py:_flash_kernel, the
// TPU kernel of the Transformer processor flavor: per (batch*head, q-block) a
// sequential grid axis walked the k-blocks of the window with an online
// softmax in VMEM scratch. On Hopper the CTAs run in parallel and in no order,
// so the k-loop is a loop inside the CTA:
//
//   flash_attn  one CTA per (q-block of 64 queries, batch*head). It walks only
//               the 64-key blocks that intersect [q0 - w, q1 - 1 + w] (every
//               block when there is no window; none past q1 - 1 when causal),
//               masks |i - j| <= w, j <= i (causal) and the ragged end of the
//               sequence per element, and keeps the running max m, sum l and
//               output rows in fp32 registers. Masked logits count as -1e30
//               with zero weight; the output is acc / max(l, 1e-30), as the TPU
//               kernel divides.
//
// q, k and v are read by stride (batch, head, position; the channel stride is
// 1), so the caller can pass the three column blocks of a fused [q | k | v]
// projection without copies; the output is written by stride too.
//
// Bound on the H100: operations. At O96 (B*H = 4, N = 10,242, D = 64,
// w = 512) about 1,025 keys per query live in the band: 4 * B*H * N * 1,025 *
// D = 10.7 GFLOP per layer, 0.011 ms at the bf16 tensor-core peak, against
// 21 MB of q, k, v and o (0.006 ms). This first version runs Q.K^T and P.V on
// the tensor cores through nvcuda::wmma (bf16 16x16x16 fragments, fp32
// accumulate) with the K/V tiles staged through shared memory one block at a
// time (no cp.async pipeline); fp32 inputs take the CUDA cores. wgmma with a
// TMA-fed ring of tiles is later work.
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

constexpr int kBM = 64;       // queries per CTA, 16 per warp
constexpr int kBN = 64;       // keys per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

template <typename T, int D>
struct FlashLayout {
  static constexpr int kPad = 16 / sizeof(T);  // one 16-byte vector per row
  static constexpr int kLdT = D + kPad;        // Q, K, V tile rows
  static constexpr int kLdP = kBN + kPad;      // P rows
  static constexpr int kLdS = (kBN > D ? kBN : D) + 4;  // fp32 staging rows
  static constexpr size_t kTile = (size_t)kBM * kLdT * sizeof(T);
  static constexpr size_t kS = (size_t)kWarps * 16 * kLdS * sizeof(float);
  static constexpr size_t kP = (size_t)kWarps * 16 * kLdP * sizeof(T);
  static constexpr size_t kBytes = 3 * kTile + kS + kP;
};

// Copies rows [row0, row0 + 64) of one (N, D) head matrix, rows past N as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t sn, int row0, int n) {
  using L = FlashLayout<T, D>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < kBM * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const int4*>(src + (int64_t)(row0 + r) * sn + c);
    *reinterpret_cast<int4*>(dst + r * L::kLdT + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int H, int N, int64_t sb, int64_t sh, int64_t sn, int64_t ob,
                  int64_t oh, int64_t on, int window, int causal, float scale) {
  using L = FlashLayout<T, D>;
  constexpr bool kTensor = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + L::kTile);
  T* Vs = reinterpret_cast<T*>(smem + 2 * L::kTile);
  float* Sw = reinterpret_cast<float*>(smem + 3 * L::kTile) + (threadIdx.x / 32) * 16 * L::kLdS;
  T* Pw = reinterpret_cast<T*>(smem + 3 * L::kTile + L::kS) + (threadIdx.x / 32) * 16 * L::kLdP;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;     // this lane's row within the warp's 16
  const int half = lane & 1;   // and which half of the keys / channels
  const int q0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int64_t in_off = (int64_t)(bh / H) * sb + (int64_t)(bh % H) * sh;
  const int64_t out_off = (int64_t)(bh / H) * ob + (int64_t)(bh % H) * oh;
  const int qpos = q0 + warp * 16 + r;

  load_tile<T, D>(Qs, q + in_off, sn, q0, N);

  int lo = 0, hi = N - 1;  // key range this CTA can see
  const int q1 = min(q0 + kBM, N) - 1;
  if (window >= 0) {
    lo = max(0, q0 - window);
    hi = min(N - 1, q1 + window);
  }
  if (causal) hi = min(hi, q1);

  float m = kNeg, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  for (int kb = lo / kBN; kb <= hi / kBN; ++kb) {
    const int k0 = kb * kBN;
    __syncthreads();  // the previous block's K and V are consumed
    load_tile<T, D>(Ks, k + in_off, sn, k0, N);
    load_tile<T, D>(Vs, v + in_off, sn, k0, N);
    __syncthreads();

    // s = Q_w . K^T for this lane's 32 keys
    float s[kBN / 2];
    if constexpr (kTensor) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[kBN / 16];
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::kLdT + kk, L::kLdT);
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, Ks + j * 16 * L::kLdT + kk, L::kLdT);
          wmma::mma_sync(sf[j], a, b, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j)
        wmma::store_matrix_sync(Sw + j * 16, sf[j], L::kLdS, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kBN / 2; ++c) s[c] = Sw[r * L::kLdS + half * (kBN / 2) + c];
    } else {
#pragma unroll
      for (int c = 0; c < kBN / 2; ++c) s[c] = 0.f;
      const T* qrow = Qs + (warp * 16 + r) * L::kLdT;
      for (int d = 0; d < D; ++d) {
        const float qd = to_f(qrow[d]);
#pragma unroll
        for (int c = 0; c < kBN / 2; ++c)
          s[c] = fmaf(qd, to_f(Ks[(half * (kBN / 2) + c) * L::kLdT + d]), s[c]);
      }
    }

    // online softmax over this block (two lanes per row)
    float mloc = kNeg;
#pragma unroll
    for (int c = 0; c < kBN / 2; ++c) {
      const int kpos = k0 + half * (kBN / 2) + c;
      bool live = kpos < N && qpos < N;
      if (window >= 0) live = live && abs(qpos - kpos) <= window;
      if (causal) live = live && kpos <= qpos;
      s[c] = live ? s[c] * scale : kNeg;
      mloc = fmaxf(mloc, s[c]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    const float m_new = fmaxf(m, mloc);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
    __syncwarp();  // every lane has read its logits out of Sw
#pragma unroll
    for (int c = 0; c < kBN / 2; ++c) {
      const float p = s[c] > 0.5f * kNeg ? expf(s[c] - m_new) : 0.f;
      lsum += p;
      Pw[r * L::kLdP + half * (kBN / 2) + c] = from_f<T>(p);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l = fmaf(l, corr, lsum);
    m = m_new;
    __syncwarp();

    // acc = acc * corr + P . V over this lane's D / 2 channels
    if constexpr (kTensor) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(of[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kBN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Pw + kk, L::kLdP);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Vs + kk * L::kLdT + j * 16, L::kLdT);
          wmma::mma_sync(of[j], a, b, of[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wmma::store_matrix_sync(Sw + j * 16, of[j], L::kLdS, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < D / 2; ++c)
        acc[c] = fmaf(acc[c], corr, Sw[r * L::kLdS + half * (D / 2) + c]);
      __syncwarp();  // Sw is free for the next block's logits
    } else {
#pragma unroll
      for (int c = 0; c < D / 2; ++c) acc[c] *= corr;
      for (int j = 0; j < kBN; ++j) {
        const float p = to_f(Pw[r * L::kLdP + j]);
        const T* vrow = Vs + j * L::kLdT + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; ++c) acc[c] = fmaf(p, to_f(vrow[c]), acc[c]);
      }
      __syncwarp();
    }
  }

  if (qpos < N) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + out_off + (int64_t)qpos * on + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = from_f<T>(acc[c] * inv);
  }
}

template <typename T, int D>
int launch_flash_d(const void* q, const void* k, const void* v, void* o, int BH, int H, int N,
                   int64_t sb, int64_t sh, int64_t sn, int64_t ob, int64_t oh, int64_t on,
                   int window, int causal, float scale, cudaStream_t stream) {
  using L = FlashLayout<T, D>;
  auto kernel = flash_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBM - 1) / kBM, BH);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, N, sb, sh, sn, ob, oh, on, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                 int64_t sb, int64_t sh, int64_t sn, int64_t ob, int64_t oh, int64_t on,
                 int window, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  switch (D) {  // the wrapper admits these head widths only
    case 16:
      return launch_flash_d<T, 16>(q, k, v, o, BH, H, N, sb, sh, sn, ob, oh, on, window, causal, scale, s);
    case 32:
      return launch_flash_d<T, 32>(q, k, v, o, BH, H, N, sb, sh, sn, ob, oh, on, window, causal, scale, s);
    case 64:
      return launch_flash_d<T, 64>(q, k, v, o, BH, H, N, sb, sh, sn, ob, oh, on, window, causal, scale, s);
    case 128:
      return launch_flash_d<T, 128>(q, k, v, o, BH, H, N, sb, sh, sn, ob, oh, on, window, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attn_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                   int64_t sb, int64_t sh, int64_t sn, int64_t ob, int64_t oh, int64_t on,
                   int window, int causal, float scale, void* stream) {
  return launch_flash<float>(q, k, v, o, B, H, N, D, sb, sh, sn, ob, oh, on, window, causal, scale,
                             stream);
}

int flash_attn_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                    int64_t sb, int64_t sh, int64_t sn, int64_t ob, int64_t oh, int64_t on,
                    int window, int causal, float scale, void* stream) {
  return launch_flash<bf16>(q, k, v, o, B, H, N, D, sb, sh, sn, ob, oh, on, window, causal, scale,
                            stream);
}

}  // extern "C"
