// Hopper (sm_90a) backward of the GraphTransformer edge attention.
//
// Replaces anemoi_models_tpu/ops/pallas/edge_attention.py:_feats_bwd_kernel.
// Per block of destinations the TPU kernel recomputed the attention weights in
// the forward's m-gauge, gathered each slot's k/v row with a one-hot matmul and
// scattered the k/v cotangents into per-block slabs that were overlap-added
// afterwards (Mosaic can neither gather nor scatter in VMEM), and carried the
// edge-projection gradient dw_aug from one grid step to the next. On Hopper
// rows load by index and blocks run in no order, so the backward walks the
// same CSR edge lists as the forward (csrc/edge_attention.cu) in three launches:
//
//   dst pass   a persistent grid (as many CTAs as fit the card) in which a warp
//              owns a destination, one edge at a time across all C channels:
//              each lane VB = C / 32 consecutive channels (a head is D / VB
//              lanes). The warp keeps kRing - 1 edges' k/v rows in flight in
//              its own ring of shared memory (cp.async), the source ids,
//              positions and attributes of 32 edges at a time in registers, and
//              the next destination's edge range, q and g_num rows and first
//              k/v rows in flight while it finishes the current one. w_aug
//              sits in shared memory in its own dtype. Per edge e = (s -> t),
//              head h, batch b:
//                k_e = k[s] + a_e.w_aug,  v_e = v[s] + a_e.w_aug
//                w   = exp(min(scale <q[t], k_e>_h - m[t,h], 0))
//                dl  = w (<g_num[t], v_e>_h + g_den[t,h])
//              and, in a fixed order, dq[t] = sum_e scale dl k_e, the edge
//              gradient da_e[r] = sum_b sum_h scale dl P[r,h] + w G[r,h] with
//              P = <q[t], w_aug[r]>_h, G = <g_num[t], w_aug[r]>_h (lane j of a
//              head keeps attribute j: one fmaf and a shuffle sum over the heads
//              an edge), and (dl, w) at the edge's position in the transposed
//              list (the inverse of perm). Each warp adds its destinations'
//                dw_aug[r, c] += scale q[t,c] adl[h(c),r] + g_num[t,c] aw[h(c),r]
//              (adl = sum_e a_e[r] dl, aw = sum_e a_e[r] w) into its own
//              partial in shared memory, and the CTA writes the sum of its
//              warps' partials: one row of dw_part a CTA.
//   src pass   a warp per (batch, source) over the transposed CSR, reading
//              (dl, w) contiguously and q[t], g_num[t] as 16-byte vectors, the
//              next edge's rows loaded before the current edge's arithmetic:
//                dk[s] = sum_e scale dl_e q[t],  dv[s] = sum_e w_e g_num[t].
//   dw reduce  the fixed-order sum of the dw_part rows.
//
// Every sum runs in a fixed order with no atomics, so the backward is
// run-to-run bit-identical. The logit is recomputed with the forward's exact
// arithmetic: the forward's thread owns VF = max(1, D / 32) channels and sums
// them in one fmaf chain, then a shuffle tree over the head's threads; here a
// lane holds VB / VF such chains and repeats the same tree, its upper levels
// across lanes and its lower levels inside the lane, so w <= 1 holds with the
// forward's m; the exp argument is clamped at 0 all the same, as the TPU kernel
// clamps it.
//
// Bound on the H100: bytes. At the O96 encoder (E = 376,228, C = 256,
// A2 = 8, bf16) the function reads and writes about 173 MB once (0.052 ms at
// 3.35 TB/s), most of it the fp32 dkv; its fewest operations, about 10 C per
// edge once the edge term is factored through per-destination products with
// w_aug, are 1.3 GFLOP (0.0013 ms at the bf16 tensor peak, 0.02 ms at the
// fp32 peak). The kernel reads more than that: every edge gathers a k/v row
// (dst pass) and a q and g_num row (src pass), from L2 for the most part, and
// the per-edge edge term a_e.w_aug (A2 C fmaf) is recomputed per channel to
// keep the logit exact, so the dst pass is bound by its instruction issue
// (about 250 a warp an edge at C = 256): the attribute loops are padded to
// MAXA2 with zeros (a zero term changes at most the sign of an exact zero) and
// the head count is a compile-time constant for 4 heads, so that they unroll
// with no branch.
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kMaxA2 = 16;  // kMaxA2 in csrc/edge_attention.cu
constexpr int kWarps = 4;   // warps per CTA of every pass
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// N consecutive values of T held as raw words: one load of 4, 8 or 16 bytes,
// or several 16-byte loads, converted to fp32 where used (N = VB >= 2).
template <typename T, int N>
struct Row {
  static constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes == 4 || kBytes == 8 || kBytes % 16 == 0, "a row chunk is 4, 8 or 16n bytes");
  uint32_t w[kBytes / 4];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p) + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
  }

  __device__ __forceinline__ void load_shared(const uint8_t* p) {  // this lane's own chunk of a ring stage
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const int4 v = reinterpret_cast<const int4*>(p)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned int*>(p);
    }
  }

  __device__ __forceinline__ float operator[](int i) const {  // i is a compile-time index after unrolling
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
    }
  }
};

template <int N>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    static_assert(N == 2, "a lane stores 2 or 4n floats");
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// cp.async of this lane's N values of T (4 to 64 bytes) into shared memory
template <typename T, int N>
__device__ __forceinline__ void copy_async(uint8_t* dst, const T* src) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes >= 4, "cp.async moves 4 bytes at least");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                   "l"(reinterpret_cast<const uint8_t*>(src) + 16 * i)
                   : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes) : "memory");
  }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the sum over the `lanes` lanes of an aligned group (a head), every lane
// getting the same bits
__device__ __forceinline__ float group_sum(float s, int lanes) {
#pragma unroll
  for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// ---------------------------------------------------------------------------
// dst pass. C = 32 VB channels; lane l owns channels [l VB, l VB + VB) of head
// l / LB (LB = D / VB lanes a head, H = 32 / LB heads). Warp g of the
// persistent grid takes destinations g, g + warps, ... Each warp keeps
// kRing - 1 edges' k/v rows in flight in its own ring of shared memory
// (cp.async, each lane copying and later reading only its own chunk), and the
// attributes of 32 edges at a time in registers, one edge a lane, shuffled out
// per edge. With SLOT (A2 <= LB) lane l keeps only attribute r = l % LB of its
// head's P, G, adl and aw, so da_e is one fmaf and a shuffle sum over the
// heads; otherwise every lane keeps all A2. HC, when not 0, is the head count
// at compile time. Shared memory: w_aug, the warps' rings, their q and g_num
// chunks of the next destination, their dw_aug partials.
// ---------------------------------------------------------------------------

constexpr int kRing = 3;  // ring stages a warp: kRing - 1 edges in flight

// The logit's dot product exactly as the forward sums it: the forward's
// thread owns VF channels (one fmaf chain), a lane holds P = VB / VF of those
// chains; the forward's shuffle tree runs across lanes for its levels of P
// threads and more, then inside the lane.
template <typename T, int VB, int VF>
__device__ __forceinline__ float exact_dot(const float* qv, const Row<T, VB>& kr, const float* ev, int LB) {
  constexpr int P = VB / VF;
  float s[P];
#pragma unroll
  for (int u = 0; u < P; ++u) {
    float x = 0.f;
#pragma unroll
    for (int f = 0; f < VF; ++f) x = fmaf(qv[u * VF + f], kr[u * VF + f] + ev[u * VF + f], x);
    s[u] = x;
  }
#pragma unroll
  for (int off = LB >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < P; ++u) s[u] += __shfl_xor_sync(kFull, s[u], off);
  }
#pragma unroll
  for (int off = P >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < off; ++u) s[u] = s[u] + s[u + off];
  }
  return s[0];
}

template <typename T, int VB>
__device__ __forceinline__ float exact_dot_vf(int vf, const float* qv, const Row<T, VB>& kr, const float* ev,
                                              int LB) {
  if constexpr (VB >= 4) {
    if (vf == 4) return exact_dot<T, VB, 4>(qv, kr, ev, LB);
  }
  if constexpr (VB >= 2) {
    if (vf == 2) return exact_dot<T, VB, 2>(qv, kr, ev, LB);
  }
  return exact_dot<T, VB, 1>(qv, kr, ev, LB);
}

template <typename T, int VB, int MAXA2, bool SLOT, int HC>
__global__ void __launch_bounds__(kThreads) bwd_dst_kernel(
    const T* __restrict__ q, const T* __restrict__ kv, const int* __restrict__ rowptr,
    const int* __restrict__ src, const T* __restrict__ a, const T* __restrict__ w_aug,
    const float* __restrict__ m_in, const float* __restrict__ g_num, const float* __restrict__ g_den,
    const int* __restrict__ pos, float* __restrict__ dq, float* __restrict__ da,
    float* __restrict__ dlw, float* __restrict__ dw_part, int batch, int num_dst, int num_src,
    int num_edges, int h_arg, int A2, float scale) {
  constexpr int C = 32 * VB;
  const int H = HC ? HC : h_arg;  // compile-time on the main path (HC = 4)
  const int vf = VB > H ? VB / H : 1;  // the forward's channels a thread: max(1, D / 32)
  constexpr int kChunk = VB * static_cast<int>(sizeof(T));      // a lane's bytes of a row
  constexpr int kStage = 2 * C * static_cast<int>(sizeof(T));  // k and v rows
  constexpr int RL = SLOT ? 1 : MAXA2;                          // attribute slots a lane keeps
  // w_aug (MAXA2, C) in T, the warps' rings, then the warps' dw_aug partials (MAXA2, C) in fp32
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int LB = 32 / H;
  const int head = lane / LB;
  const int j = lane % LB;  // SLOT: the attribute this lane keeps
  const bool head_lead = j == 0;
  const int c0 = lane * VB;
  const T* w_s = reinterpret_cast<const T*>(smem) + c0;  // this lane's channels of w_aug row r at r * C
  uint8_t* ring = smem + MAXA2 * C * sizeof(T) + warp * kRing * kStage + lane * kChunk;
  // this lane's chunks of the next destination's q and g_num rows (cp.async, read back by the lane)
  uint8_t* qg_q = smem + MAXA2 * C * sizeof(T) + kWarps * kRing * kStage + warp * C * (sizeof(T) + 4) +
                  lane * kChunk;
  uint8_t* qg_g = qg_q - lane * kChunk + C * sizeof(T) + lane * 4 * VB;
  float* dw_all = reinterpret_cast<float*>(smem + MAXA2 * C * sizeof(T) + kWarps * (kRing * kStage + C * (sizeof(T) + 4)));
  float* dw_s = dw_all + warp * MAXA2 * C + c0;  // this lane's channels of its warp's partial, row r at r * C
#pragma unroll
  for (int r = 0; r < MAXA2; ++r) {
    const float zero[VB] = {};
    store_row<VB>(dw_s + r * C, zero);
  }
  // persistent: warp g of the grid takes destinations g, g + warps, g + 2 warps, ...
  const int warps = gridDim.x * kWarps;
  int t = blockIdx.x * kWarps + warp;

  // a batch of this warp's edges (at most 32): lane l holds edge l's source, position and
  // attributes; prime(b) starts the batch's first kRing - 1 k/v rows of batch index b into the ring
  int cnt = 0, sid = 0, spos = 0;
  float areg[MAXA2];
  auto load_batch = [&](int base, int end) {
    cnt = min(32, end - base);
    const int64_t mine = base + lane;
    const bool have = lane < cnt;
    sid = have ? src[mine] : 0;
    spos = have ? pos[mine] : 0;
#pragma unroll
    for (int r = 0; r < MAXA2; ++r) areg[r] = have && r < A2 ? to_f(a[mine * A2 + r]) : 0.f;
  };
  auto prime = [&](int b) {
    const T* kv_b = kv + (int64_t)b * num_src * 2 * C + c0;
#pragma unroll
    for (int d = 0; d < kRing - 1; ++d) {
      if (d < cnt) {
        const T* krow = kv_b + (int64_t)__shfl_sync(kFull, sid, d) * 2 * C;
        copy_async<T, VB>(ring + d * kStage, krow);
        copy_async<T, VB>(ring + d * kStage + C * sizeof(T), krow + C);
      }
      copy_commit();
    }
  };

  int e_begin = t < num_dst ? rowptr[t] : 0;
  int e_end = t < num_dst ? rowptr[t + 1] : 0;
  // the first destination's edges, q and g_num rows and m, g_den, in flight together
  auto fetch_qg = [&](int tt) {
    if (tt < num_dst) {
      copy_async<T, VB>(qg_q, q + (int64_t)tt * C + c0);
      copy_async<float, VB>(qg_g, g_num + (int64_t)tt * C + c0);
    }
    copy_commit();
  };
  load_batch(e_begin, e_end);
  float m_next = t < num_dst ? m_in[(int64_t)t * H + head] : 0.f;
  float gd_next = t < num_dst ? g_den[(int64_t)t * H + head] : 0.f;
  fetch_qg(t);
  prime(0);
  // w_aug, a word at a time, zero rows past A2: every loop over attributes runs MAXA2 long with
  // no branch, and a zero term changes at most the sign of an exact zero in the edge term
  for (int i = threadIdx.x; i < MAXA2 * C * static_cast<int>(sizeof(T)) / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(smem)[i] =
        i < A2 * C * static_cast<int>(sizeof(T)) / 4 ? reinterpret_cast<const uint32_t*>(w_aug)[i] : 0u;
  __syncthreads();

  for (; t < num_dst; t += warps) {
    // the next destination's edge range, in flight during this one
    const int tn = t + warps;
    const int next_begin = tn < num_dst ? rowptr[tn] : 0;
    const int next_end = tn < num_dst ? rowptr[tn + 1] : 0;

    for (int b = 0; b < batch; ++b) {
      const int64_t row = (int64_t)b * num_dst + t;
      float qv[VB], gv[VB], dqa[VB];
      float m_h, gd_h;
      {
        Row<T, VB> qr;
        Row<float, VB> gr;
        if (b == 0) {  // fetched while the previous destination finished
          copy_wait<kRing - 1>();
          qr.load_shared(qg_q);
          gr.load_shared(qg_g);
          m_h = m_next;
          gd_h = gd_next;
        } else {
          qr.load(q + row * C + c0);
          gr.load(g_num + row * C + c0);
          m_h = m_in[row * H + head];
          gd_h = g_den[row * H + head];
        }
#pragma unroll
        for (int c = 0; c < VB; ++c) {
          qv[c] = qr[c];
          gv[c] = gr[c];
          dqa[c] = 0.f;
        }
      }

      // per-destination factors of da: P[r] = <q, w_aug[r]>_h, G[r] = <g_num, w_aug[r]>_h
      float pf[RL], gf[RL], adl[RL], aw[RL];
#pragma unroll
      for (int x = 0; x < RL; ++x) pf[x] = gf[x] = adl[x] = aw[x] = 0.f;
      if constexpr (SLOT && HC != 0 && 32 / (HC ? HC : 1) == MAXA2) {
        // a lane per attribute of its head: each lane's partial dots for every r, then
        // recursive halving across the head's lanes leaves lane j with attribute j's sums
        float vp[MAXA2], vg[MAXA2];
#pragma unroll
        for (int r = 0; r < MAXA2; ++r) {
          Row<T, VB> wv;
          wv.load_shared(reinterpret_cast<const uint8_t*>(w_s + r * C));
          float p = 0.f, g = 0.f;
#pragma unroll
          for (int c = 0; c < VB; ++c) {
            p = fmaf(qv[c], wv[c], p);
            g = fmaf(gv[c], wv[c], g);
          }
          vp[r] = p;
          vg[r] = g;
        }
#pragma unroll
        for (int half = MAXA2 / 2; half >= 1; half /= 2) {
          const bool upper = (lane & half) != 0;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float sp = upper ? vp[i] : vp[i + half];
            const float sg = upper ? vg[i] : vg[i + half];
            vp[i] = (upper ? vp[i + half] : vp[i]) + __shfl_xor_sync(kFull, sp, half);
            vg[i] = (upper ? vg[i + half] : vg[i]) + __shfl_xor_sync(kFull, sg, half);
          }
        }
        pf[0] = vp[0];
        gf[0] = vg[0];
      } else {
#pragma unroll
      for (int r = 0; r < MAXA2; ++r) {
        if (r < A2) {
          Row<T, VB> wv;
          wv.load_shared(reinterpret_cast<const uint8_t*>(w_s + r * C));
          float p = 0.f, g = 0.f;
#pragma unroll
          for (int c = 0; c < VB; ++c) {
            p = fmaf(qv[c], wv[c], p);
            g = fmaf(gv[c], wv[c], g);
          }
          p = group_sum(p, LB);
          g = group_sum(g, LB);
          if constexpr (SLOT) {
            if (r == j) {
              pf[0] = p;
              gf[0] = g;
            }
          } else {
            pf[r] = p;
            gf[r] = g;
          }
        }
      }
      }

      const T* kv_b = kv + (int64_t)b * num_src * 2 * C + c0;
      float* dlw_b = dlw + (int64_t)b * num_edges * H * 2;
      for (int base = e_begin; base < e_end; base += 32) {
        if (b > 0 || base != e_begin) {  // the first batch of b = 0 was loaded and primed ahead
          load_batch(base, e_end);
          prime(b);
        }
        for (int n = 0; n < cnt; ++n) {
          const int e = base + n;
          {  // the row kRing - 1 edges on, into the stage edge n - 1 freed
            const int nx = n + kRing - 1;
            if (nx < cnt) {
              uint8_t* st = ring + (nx % kRing) * kStage;
              const T* krow = kv_b + (int64_t)__shfl_sync(kFull, sid, nx) * 2 * C;
              copy_async<T, VB>(st, krow);
              copy_async<T, VB>(st + C * sizeof(T), krow + C);
            }
            copy_commit();
          }
          const int epos = __shfl_sync(kFull, spos, n);
          float ar[MAXA2];
#pragma unroll
          for (int r = 0; r < MAXA2; ++r) ar[r] = __shfl_sync(kFull, areg[r], n);
          copy_wait<kRing - 1>();  // this lane's copies of edge n have landed
          Row<T, VB> kr, vr;
          kr.load_shared(ring + (n % kRing) * kStage);
          vr.load_shared(ring + (n % kRing) * kStage + C * sizeof(T));

          // the edge term in the forward's order: ev = sum_r a_r w_aug[r], one fmaf chain a channel
          float ev[VB];
#pragma unroll
          for (int c = 0; c < VB; ++c) ev[c] = 0.f;
#pragma unroll
          for (int r = 0; r < MAXA2; ++r) {
            Row<T, VB> wv;
            wv.load_shared(reinterpret_cast<const uint8_t*>(w_s + r * C));
#pragma unroll
            for (int c = 0; c < VB; ++c) ev[c] = fmaf(ar[r], wv[c], ev[c]);
          }
          const float w = expf(fminf(exact_dot_vf<T, VB>(vf, qv, kr, ev, LB) * scale - m_h, 0.f));
          float s1 = 0.f;
#pragma unroll
          for (int c = 0; c < VB; ++c) s1 = fmaf(gv[c], vr[c] + ev[c], s1);
          s1 = group_sum(s1, LB);
          const float dl = w * (s1 + gd_h);
          const float sdl = scale * dl;
#pragma unroll
          for (int c = 0; c < VB; ++c) dqa[c] = fmaf(sdl, kr[c] + ev[c], dqa[c]);
          // da_e: this head's term, then the sum over heads (lanes LB, 2 LB, ... apart)
          float mine_da = 0.f;
          if constexpr (SLOT) {
            float a_j = 0.f;
#pragma unroll
            for (int r = 0; r < MAXA2; ++r)
              if (r == j) a_j = ar[r];
            adl[0] = fmaf(a_j, dl, adl[0]);
            aw[0] = fmaf(a_j, w, aw[0]);
            float x = fmaf(sdl, pf[0], w * gf[0]);
#pragma unroll
            for (int off = LB; off < 32; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
            mine_da = x;  // lane r < A2 <= LB: attribute r
          } else {
            float x[MAXA2];
#pragma unroll
            for (int r = 0; r < MAXA2; ++r) {
              adl[r] = fmaf(ar[r], dl, adl[r]);
              aw[r] = fmaf(ar[r], w, aw[r]);
              x[r] = fmaf(sdl, pf[r], w * gf[r]);
            }
#pragma unroll
            for (int off = LB; off < 32; off <<= 1) {
#pragma unroll
              for (int r = 0; r < MAXA2; ++r) x[r] += __shfl_xor_sync(kFull, x[r], off);
            }
#pragma unroll
            for (int r = 0; r < MAXA2; ++r)
              if (r == lane) mine_da = x[r];
          }
          if (lane < A2) {
            float* p = da + (int64_t)e * A2 + lane;
            *p = b == 0 ? mine_da : *p + mine_da;
          }
          if (head_lead)
            *reinterpret_cast<float2*>(dlw_b + ((int64_t)epos * H + head) * 2) = make_float2(dl, w);
        }
      }
      if (b == batch - 1) {  // the next destination's edges, m and g_den, in flight during the stores
        load_batch(next_begin, next_end);
        m_next = tn < num_dst ? m_in[(int64_t)tn * H + head] : 0.f;
        gd_next = tn < num_dst ? g_den[(int64_t)tn * H + head] : 0.f;
      }

      // dq[t], and this destination's dw_aug terms into the warp's partial:
      //   dw[r, c] += scale q[t,c] adl[h(c), r] + g_num[t,c] aw[h(c), r]
      // (with SLOT lane (h, j) holds head h's adl, aw of attribute j; otherwise every lane all of h's)
      store_row<VB>(dq + row * C + c0, dqa);
#pragma unroll
      for (int r = 0; r < MAXA2; ++r) {
        if (r < A2) {
          float adl_r, aw_r;
          if constexpr (SLOT) {
            adl_r = __shfl_sync(kFull, adl[0], head * LB + r);
            aw_r = __shfl_sync(kFull, aw[0], head * LB + r);
          } else {
            adl_r = adl[r];
            aw_r = aw[r];
          }
          const float sadl = scale * adl_r;
          Row<float, VB> part;
          part.load_shared(reinterpret_cast<const uint8_t*>(dw_s + r * C));
          float acc[VB];
#pragma unroll
          for (int c = 0; c < VB; ++c) acc[c] = fmaf(qv[c], sadl, fmaf(gv[c], aw_r, part[c]));
          store_row<VB>(dw_s + r * C, acc);
        }
      }
    }
    fetch_qg(tn);  // the next destination's q, g_num and first k/v rows
    prime(0);
    e_begin = next_begin;
    e_end = next_end;
  }

  // the CTA's dw_aug partial: its warps' partials summed in warp order
  __syncthreads();
  float* out = dw_part + (int64_t)blockIdx.x * A2 * C;
  for (int i = threadIdx.x; i < A2 * C; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += dw_all[w * MAXA2 * C + i];
    out[i] = sum;
  }
}

// ---------------------------------------------------------------------------
// src pass: a warp per (batch, source) row, walking the source's out-edges in
// the transposed CSR (edge ids ascending within a source): the edge ids and
// destinations 32 at a time, the next edge's q and g_num rows and (dl, w) in
// flight in registers during the current edge's arithmetic.
// ---------------------------------------------------------------------------

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads) bwd_src_kernel(
    const T* __restrict__ q, const float* __restrict__ g_num, const int* __restrict__ colptr,
    const int* __restrict__ perm, const int* __restrict__ dst_of, const float* __restrict__ dlw,
    float* __restrict__ dkv, int num_dst, int num_src, int num_edges, int H, int rows, float scale) {
  constexpr int C = 32 * VB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;  // batch * num_src + source
  if (row >= rows) return;
  const int bidx = row / num_src;
  const int s = row - bidx * num_src;
  const int head = lane / (32 / H);
  const int c0 = lane * VB;

  float dk[VB], dv[VB];
#pragma unroll
  for (int c = 0; c < VB; ++c) dk[c] = dv[c] = 0.f;
  const T* q_b = q + (int64_t)bidx * num_dst * C + c0;
  const float* g_b = g_num + (int64_t)bidx * num_dst * C + c0;
  const float2* dlw_b = reinterpret_cast<const float2*>(dlw) + (int64_t)bidx * num_edges * H + head;
  const int j_end = colptr[s + 1];
  for (int base = colptr[s]; base < j_end; base += 32) {
    const int cnt = min(32, j_end - base);
    const int tid = lane < cnt ? dst_of[perm[base + lane]] : 0;
    Row<T, VB> qr;
    Row<float, VB> gr;
    float2 lw;
    {
      const int64_t t = __shfl_sync(kFull, tid, 0);
      qr.load(q_b + t * C);
      gr.load(g_b + t * C);
      lw = dlw_b[(int64_t)base * H];
    }
    for (int n = 0; n < cnt; ++n) {
      Row<T, VB> qn;
      Row<float, VB> gn;
      const int nn = n + 1 < cnt ? n + 1 : n;
      const int64_t t = __shfl_sync(kFull, tid, nn);
      qn.load(q_b + t * C);
      gn.load(g_b + t * C);
      const float2 ln = dlw_b[(int64_t)(base + nn) * H];
      const float sdl = scale * lw.x;
#pragma unroll
      for (int c = 0; c < VB; ++c) {
        dk[c] = fmaf(sdl, qr[c], dk[c]);
        dv[c] = fmaf(lw.y, gr[c], dv[c]);
      }
      qr = qn;
      gr = gn;
      lw = ln;
    }
  }
  store_row<VB>(dkv + (int64_t)row * 2 * C + c0, dk);
  store_row<VB>(dkv + (int64_t)row * 2 * C + C + c0, dv);
}

// ---------------------------------------------------------------------------
// dw reduce: out[j] = sum_p part[p, j] in a fixed order (kReduceRows strided
// partial sums, then their sum in row order through shared memory).
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

struct BwdArgs {
  const void *q, *kv, *rowptr, *src, *a, *w_aug, *m, *g_num, *g_den, *colptr, *perm, *dst_of, *pos;
  void *dq, *dkv, *da, *dw, *dlw, *dw_part;
  int batch, num_dst, num_src, num_edges, C, H, A2, parts;
};

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int VB, int MAXA2, bool SLOT, int HC>
int launch_passes(const BwdArgs& x, cudaStream_t s) {
  constexpr int C = 32 * VB;
  const float scale = 1.0f / std::sqrt(static_cast<float>(C / x.H));

  auto dst_kernel = bwd_dst_kernel<T, VB, MAXA2, SLOT, HC>;
  const size_t dst_smem = (MAXA2 + static_cast<size_t>(kWarps) * kRing * 2) * C * sizeof(T) +
                          kWarps * C * (sizeof(T) + 4) + sizeof(float) * kWarps * MAXA2 * C;
  int rc = set_smem(dst_kernel, dst_smem);
  if (rc != 0) return rc;
  // a persistent grid: as many CTAs as fit the card at once, at most a warp a destination and
  // one CTA a row of dw_part
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dst_kernel, kThreads, dst_smem);
  const int grid =
      std::min(std::min((x.num_dst + kWarps - 1) / kWarps, std::max(per_sm, 1) * sms), x.parts);
  dst_kernel<<<grid, kThreads, dst_smem, s>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.kv), static_cast<const int*>(x.rowptr),
      static_cast<const int*>(x.src), static_cast<const T*>(x.a), static_cast<const T*>(x.w_aug),
      static_cast<const float*>(x.m), static_cast<const float*>(x.g_num), static_cast<const float*>(x.g_den),
      static_cast<const int*>(x.pos), static_cast<float*>(x.dq), static_cast<float*>(x.da),
      static_cast<float*>(x.dlw), static_cast<float*>(x.dw_part), x.batch, x.num_dst, x.num_src, x.num_edges,
      x.H, x.A2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows_src = x.batch * x.num_src;
  if (rows_src > 0) {
    bwd_src_kernel<T, VB><<<(rows_src + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        static_cast<const T*>(x.q), static_cast<const float*>(x.g_num), static_cast<const int*>(x.colptr),
        static_cast<const int*>(x.perm), static_cast<const int*>(x.dst_of), static_cast<const float*>(x.dlw),
        static_cast<float*>(x.dkv), x.num_dst, x.num_src, x.num_edges, x.H, rows_src, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int n = x.A2 * C;
  dw_reduce_kernel<<<(n + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceRows), 0, s>>>(
      static_cast<const float*>(x.dw_part), static_cast<float*>(x.dw), grid, n);
  return static_cast<int>(cudaGetLastError());
}

// One attribute slot a lane when A2 <= D / VB lanes a head; the head count
// compile-time for 4 heads (the flagship's), the wrapper admits D >= VB.
template <typename T, int VB>
int launch_vb(const BwdArgs& x, cudaStream_t s) {
  const int D = x.C / x.H;
  if (x.A2 > 8) return launch_passes<T, VB, kMaxA2, false, 0>(x, s);
  if (x.A2 > D / VB) return launch_passes<T, VB, 8, false, 0>(x, s);
  if (x.H == 4) return launch_passes<T, VB, 8, true, 4>(x, s);
  return launch_passes<T, VB, 8, true, 0>(x, s);
}

template <typename T>
int launch_bwd(const BwdArgs& x, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x.C) {
    case 64: return launch_vb<T, 2>(x, s);
    case 128: return launch_vb<T, 4>(x, s);
    case 256: return launch_vb<T, 8>(x, s);
    case 512: return launch_vb<T, 16>(x, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

BwdArgs make_args(const void* q, const void* kv, const void* rowptr, const void* src, const void* a,
                  const void* w_aug, const void* m, const void* g_num, const void* g_den, const void* colptr,
                  const void* perm, const void* dst_of, const void* pos, void* dq, void* dkv, void* da,
                  void* dw, void* dlw, void* dw_part, int batch, int num_dst, int num_src,
                  int num_edges, int C, int H, int A2, int parts) {
  return BwdArgs{q,  kv, rowptr, src,  a,    w_aug,   m,     g_num,   g_den,   colptr,    perm, dst_of, pos,
                 dq, dkv, da,    dw,   dlw,  dw_part, batch, num_dst, num_src, num_edges, C, H,
                 A2, parts};
}

}  // namespace

extern "C" {

// parts: the rows of dw_part, at least one a CTA of the dst pass's persistent grid
int edge_attn_csr_bwd_f32(const void* q, const void* kv, const void* rowptr, const void* src,
                          const void* a, const void* w_aug, const void* m, const void* g_num,
                          const void* g_den, const void* colptr, const void* perm,
                          const void* dst_of, const void* pos, void* dq, void* dkv, void* da, void* dw,
                          void* dlw, void* dw_part, int batch, int num_dst, int num_src,
                          int num_edges, int C, int H, int A2, int parts, void* stream) {
  return launch_bwd<float>(make_args(q, kv, rowptr, src, a, w_aug, m, g_num, g_den, colptr, perm, dst_of, pos, dq,
                                     dkv, da, dw, dlw, dw_part, batch, num_dst, num_src, num_edges, C, H, A2,
                                     parts),
                           stream);
}

int edge_attn_csr_bwd_bf16(const void* q, const void* kv, const void* rowptr, const void* src,
                           const void* a, const void* w_aug, const void* m, const void* g_num,
                           const void* g_den, const void* colptr, const void* perm,
                           const void* dst_of, const void* pos, void* dq, void* dkv, void* da, void* dw,
                           void* dlw, void* dw_part, int batch, int num_dst, int num_src,
                           int num_edges, int C, int H, int A2, int parts, void* stream) {
  return launch_bwd<__nv_bfloat16>(make_args(q, kv, rowptr, src, a, w_aug, m, g_num, g_den, colptr, perm, dst_of,
                                             pos, dq, dkv, da, dw, dlw, dw_part, batch, num_dst, num_src,
                                             num_edges, C, H, A2, parts),
                                   stream);
}

}  // extern "C"
