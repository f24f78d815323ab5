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
//   edge_attn_csr  a warp per (destination, head group) on a persistent grid
//                  walks the destination's edges, k/v rows in flight in a
//                  cp.async ring, with an online softmax per head, and writes
//                  num, den and m in the m-gauge contract of
//                  ops/slot_attention.py.
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "edge_logit.cuh"
#include "gemm_sm90.cuh"

namespace {

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
// A persistent grid, sized by occupancy; a CTA serves one head group (the
// lane layout of edge_logit.cuh: G channels of whole heads, VB a lane, at
// most 32 lanes, a head of D channels on D / VB lanes rounded up to a power
// of two; a head wider than 256 a group of its own, VB = 16 or 32, one chain
// a lane) and its warps take destinations cta, cta + ctas, ... one at a time.
// Per warp: the source ids of 32 edges at a time, one edge a lane, shuffled
// out per edge; a ring of kRing k/v row slices in shared memory filled by
// cp.async kRing - 1 edges ahead, each lane copying its own VB channels where
// they are whole 16-byte copies (else the warp, 16 bytes a lane); one online
// softmax per head over the destination's edges; and, while it stores a
// destination, the next one's edge range, ids, q row and first k/v rows
// already in flight (the decoder's destinations have 3 edges).
//
// The edge term is factored (edge_logit.cuh): per destination the factors
// qw[r, h] = <q, w_r>_h; per batch of 32 edges the terms sum_r a_r qw[r, h]
// by (edge, head) pair, so an edge's logit costs its q . k and one value read
// from shared memory; and the numerator's part sum_e p_e e_e =
// sum_r (sum_e p_e a_er) w_r is added at the batch's end, in the gauge of the
// running max m then: the batch's logits kept in shared memory give
// p_e = exp(logit_e - m), their sums s[r, h] = sum_e p_e a_er by (attribute,
// head) pair, and each lane adds s[r, h] w_r[c] to its channels. Attributes
// stream in chunks (attr_chunk): where one chunk holds them all the factors
// are taken once a destination, else again for every batch and chunk. w_aug
// is read from device memory (L2, a few KB); a warp's shared memory holds its
// ring and four small tables of the chunk's factors and sums and the batch's
// terms and logits. HC, when not 0, is the heads of a group at compile time
// (4: the flagship's C = 256, and C = 1024 with 16 heads) and unrolls the
// shuffle trees; FLAT, one group of 32 lanes (C = 32 VB at compile time: the
// row strides fold into the addresses). No atomics: two calls give the same
// bits, and the backward replays the logit with edge_logit.cuh's arithmetic.
//
// Bound on the H100: at O96 the function's bytes (q, kv, a once, the fp32
// outputs) take 8-23 us at 3.35 TB/s, but every edge gathers a k/v row from
// L2 and runs its softmax step alone, so the kernel is bound by its
// instruction rate and the latency of its per-edge chain.
// ---------------------------------------------------------------------------

using edge_logit::kFull;
using edge_logit::kNeg;
using edge_logit::Layout;
using edge_logit::Row;
using edge_logit::to_f;

constexpr int kWarps = 4;  // warps a CTA
constexpr int kThreads = 32 * kWarps;
// ring stages a warp: kRing - 1 edges in flight (a fourth stage gains 1-3 % in bf16, loses as much in fp32)
template <typename T>
constexpr int kRingOf = sizeof(T) == 2 ? 4 : 3;

// a warp's tables in bytes, 16-byte rounded: the chunk's factors qw and sums s (rc x HG each) and the
// batch's edge terms (32 x HG) in the wide type (acc bytes), then the batch's logits (32 x HG) and the
// heads' running max (HG) in fp32
__host__ __device__ inline int fwd_table_bytes(int rc, int HG, int acc) {
  return ((2 * rc * HG + 32 * HG) * acc + (32 * HG + HG) * 4 + 15) / 16 * 16;
}

template <typename T, int VB, int HC, bool FLAT>
__global__ void __launch_bounds__(kThreads) edge_attn_csr_kernel(
    const T* __restrict__ q, const T* __restrict__ kv, const int* __restrict__ rowptr,
    const int* __restrict__ src, const T* __restrict__ a, const T* __restrict__ w_aug,
    float* __restrict__ num, float* __restrict__ den, float* __restrict__ m_out, int batch, int num_dst,
    int num_src, int c_arg, int H, Layout L, int A2, float scale) {
  using A = edge_logit::wide_t<T>;
  constexpr int kTs = static_cast<int>(sizeof(T));
  constexpr int kRing = kRingOf<T>;
  const int C = FLAT ? 32 * VB : c_arg;
  const int G = (HC || FLAT) ? 32 * VB : L.G;
  const int LB = HC ? 32 / HC : L.LB;  // lanes of a head
  const int HG = HC ? HC : L.HG;
  const int lanes = (HC || FLAT) ? 32 : L.lanes;
  const int groups = FLAT ? 1 : L.groups;
  const int stage = 2 * G * kTs;  // a k slice, then a v slice
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = blockIdx.x % groups;
  const int ctas = gridDim.x / groups;
  // idle lanes (lanes < 32) shadow the first head's lanes: finite work, shuffles among themselves, no stores
  const bool active = lane < lanes;
  const int ll = active ? lane : lane % LB;
  bool owns;  // false on a lane that pads its head (D not a power of two): q reads as 0, no store
  const int c0 = edge_logit::lane_channel(ll, LB, HC ? LB : L.DV, HC ? LB * VB : L.D, VB, &owns);  // in the group
  const int hl = ll / LB;  // head of the group
  const int head = grp * HG + hl;
  const bool lead = active && ll % LB == 0;  // the head's first lane writes its per-head values
  uint8_t* ring = smem + warp * kRing * stage;
  const int64_t gc0 = static_cast<int64_t>(grp) * G;  // the group's first channel
  const T* w_lane = w_aug + gc0 + c0;  // this lane's channels of w_aug's row 0
  const int rc = edge_logit::attr_chunk(A2, HG, sizeof(A));
  const bool one_chunk = rc == A2;
  A* qw_s = reinterpret_cast<A*>(smem + kWarps * kRing * stage + warp * fwd_table_bytes(rc, HG, sizeof(A)));
  A* s_s = qw_s + rc * HG;  // the chunk's sum_e p_e a_er, (r, h) at r HG + h
  A* e_s = s_s + rc * HG;   // the batch's edge terms, (n, h) at n HG + h
  float* lg_s = reinterpret_cast<float*>(e_s + 32 * HG);  // the batch's logits, then exp(logit - m)
  float* m_s = lg_s + 32 * HG;                            // the heads' running max

  int cnt = 0, sid = 0;
  auto load_batch = [&](int base, int end) {  // lane l: edge base + l's source
    cnt = min(32, end - base);
    sid = lane < cnt ? src[base + lane] : 0;
  };
  constexpr int kChunk = VB * kTs;  // a lane's bytes of a slice
  auto copy_rows = [&](uint8_t* st, const T* krow) {  // the group's k and v slices of one row
    edge_logit::slice_copy_async<kChunk>(st, krow, c0 * kTs, G * kTs, lane);
    edge_logit::slice_copy_async<kChunk>(st + G * kTs, krow + C, c0 * kTs, G * kTs, lane);
  };
  auto prime = [&](int b) {  // the batch's first kRing - 1 rows, into stages 0 .. kRing - 2
    const T* kv_b = kv + (int64_t)b * num_src * 2 * C + gc0;
    edge_logit::slice_sync<kChunk>();  // every lane is done with the stages it overwrites
#pragma unroll
    for (int d = 0; d < kRing - 1; ++d) {
      if (d < cnt) copy_rows(ring + d * stage, kv_b + (int64_t)__shfl_sync(kFull, sid, d) * 2 * C);
      edge_logit::copy_commit();
    }
  };

  int t = (blockIdx.x / groups) * kWarps + warp;
  const int step = ctas * kWarps;
  int e_begin = t < num_dst ? rowptr[t] : 0;
  int e_end = t < num_dst ? rowptr[t + 1] : 0;
  Row<T, VB> q_next;  // the next destination's q (batch 0), in flight during the current one's stores
  if (t < num_dst) q_next.load(q + (int64_t)t * C + gc0 + c0);
  load_batch(e_begin, e_end);
  prime(0);

  for (; t < num_dst; t += step) {
    const int tn = t + step;
    const int next_begin = tn < num_dst ? rowptr[tn] : 0;
    const int next_end = tn < num_dst ? rowptr[tn + 1] : 0;
    for (int b = 0; b < batch; ++b) {
      const int64_t row = (int64_t)b * num_dst + t;
      float qv[VB], acc[VB];
      {
        Row<T, VB> qr;
        if (b == 0) {
          qr = q_next;
        } else {
          qr.load(q + row * C + gc0 + c0);
        }
#pragma unroll
        for (int c = 0; c < VB; ++c) {
          qv[c] = owns ? qr[c] : 0.f;
          acc[c] = 0.f;
        }
      }
      if (one_chunk && e_begin < e_end) {  // the factors of every attribute, once for the destination
        __syncwarp();  // every lane is done with the previous destination's factors
        edge_logit::head_factors<T, VB, false>(qw_s, nullptr, qv, nullptr, w_lane, C, 0, A2, LB, HG, hl, lead);
      }
      float m = kNeg;
      float l = 0.f;
      const T* kv_b = kv + (int64_t)b * num_src * 2 * C + gc0;
      for (int base = e_begin; base < e_end; base += 32) {
        if (b > 0 || base != e_begin) {  // the first batch of b = 0 was loaded and primed ahead
          load_batch(base, e_end);
          prime(b);
        }
        // the batch's edge terms sum_r a_r qw[r, h], chunk by chunk
        for (int r0 = 0; r0 < A2; r0 += rc) {
          const int rn = min(rc, A2 - r0);
          __syncwarp();
          if (!one_chunk) {
            edge_logit::head_factors<T, VB, false>(qw_s, nullptr, qv, nullptr, w_lane, C, r0, rn, LB, HG, hl, lead);
            __syncwarp();
          }
          edge_logit::edge_terms<T, false>(e_s, nullptr, qw_s, nullptr, a, A2, base, cnt, HG, r0, rn, r0 > 0, lane);
        }
        __syncwarp();
        for (int n = 0, rd = 0; n < cnt; ++n, rd = rd == kRing - 1 ? 0 : rd + 1) {  // rd: edge n's stage
          {  // the row kRing - 1 edges on, into the stage edge n - 1 freed
            edge_logit::slice_sync<kChunk>();
            const int nx = n + kRing - 1;
            if (nx < cnt)
              copy_rows(ring + (rd == 0 ? kRing - 1 : rd - 1) * stage,
                        kv_b + (int64_t)__shfl_sync(kFull, sid, nx) * 2 * C);
            edge_logit::copy_commit();
          }
          const A term = e_s[n * HG + hl];
          edge_logit::copy_wait<kRing - 1>();  // this lane's copies of edge n have landed,
          edge_logit::slice_sync<kChunk>();     // and every other lane's
          const uint8_t* st = ring + rd * stage + c0 * kTs;
          Row<T, VB> kr, vr;
          kr.load_shared(st);
          vr.load_shared(st + G * kTs);
          const float logit = edge_logit::logit_sum<T, VB>(qv, kr, term, LB) * scale;
          if (lead) lg_s[n * HG + hl] = logit;
          const float m_new = fmaxf(m, logit);
          const float corr = expf(m - m_new);
          const float p = expf(logit - m_new);
          l = fmaf(l, corr, p);
#pragma unroll
          for (int c = 0; c < VB; ++c) acc[c] = fmaf(acc[c], corr, p * vr[c]);
          m = m_new;
        }
        // the batch's part of sum_e p_e e_e in the gauge of m: s[r, h] = sum_n exp(logit_n - m) a_nr,
        // then acc[c] += sum_r s[r, h] w_r[c], both sums in A
        if (lead) m_s[hl] = m;
        __syncwarp();
        for (int p = lane; p < cnt * HG; p += 32) lg_s[p] = expf(lg_s[p] - m_s[p % HG]);
        A ea[VB];
#pragma unroll
        for (int c = 0; c < VB; ++c) ea[c] = 0;
        for (int r0 = 0; r0 < A2; r0 += rc) {
          const int rn = min(rc, A2 - r0);
          __syncwarp();
          for (int p = lane; p < rn * HG; p += 32) {
            const int i = p / HG, h = p - i * HG;
            const T* ar = a + (int64_t)base * A2 + r0 + i;
            A x = 0;
            for (int n = 0; n < cnt; ++n) x = edge_logit::fma_as<A>(lg_s[n * HG + h], to_f(ar[(int64_t)n * A2]), x);
            s_s[p] = x;
          }
          __syncwarp();
#pragma unroll 4
          for (int i = 0; i < rn; ++i) {
            Row<T, VB> wv;
            wv.load(w_lane + (int64_t)(r0 + i) * C);
            const A sv = s_s[i * HG + hl];
#pragma unroll
            for (int c = 0; c < VB; ++c) ea[c] = edge_logit::fma_as<A>(sv, wv[c], ea[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < VB; ++c) acc[c] += static_cast<float>(ea[c]);
      }
      if (b == batch - 1) {  // the next destination's edges and q, in flight during the stores
        load_batch(next_begin, next_end);
        if (tn < num_dst) q_next.load(q + (int64_t)tn * C + gc0 + c0);
      }
      if (active && owns) {
        edge_logit::store_row<VB>(num + row * C + gc0 + c0, acc);
        if (lead) {
          den[row * H + head] = l;
          m_out[row * H + head] = m;
        }
      }
    }
    prime(0);  // the next destination's first k/v rows
    e_begin = next_begin;
    e_end = next_end;
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

struct FwdArgs {
  const void *q, *kv, *rowptr, *src, *a, *w_aug;
  void *num, *den, *m;
  int batch, num_dst, num_src, C, H, A2, G, VB;
  int Dt;  // the head width before padding: the logit's scale is 1 / sqrt(Dt)
};

template <typename T, int VB, int HC, bool FLAT>
int launch_fwd(const FwdArgs& x, const Layout& L, cudaStream_t s) {
  auto kernel = edge_attn_csr_kernel<T, VB, HC, FLAT>;
  using A = edge_logit::wide_t<T>;
  const int rc = edge_logit::attr_chunk(x.A2, L.HG, sizeof(A));
  const size_t smem = static_cast<size_t>(kWarps) *
                      (2 * kRingOf<T> * L.G * sizeof(T) + fwd_table_bytes(rc, L.HG, sizeof(A)));
  int rc_set = set_smem(kernel, smem);
  if (rc_set != 0) return rc_set;
  // a persistent grid: as many CTAs as fit the card at once, split evenly over the head groups
  static size_t sized_for = 0;  // the occupancy of this instantiation, per shared-memory size
  static int per_sm = 0;
  if (sized_for != smem) {
    const int rc_occ = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem));
    if (rc_occ != 0) return rc_occ;
    sized_for = smem;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int ctas = std::max(1, std::min((x.num_dst + kWarps - 1) / kWarps, std::max(per_sm, 1) * sms / L.groups));
  const float scale = 1.0f / std::sqrt(static_cast<float>(x.Dt));
  kernel<<<ctas * L.groups, kThreads, smem, s>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.kv), static_cast<const int*>(x.rowptr),
      static_cast<const int*>(x.src), static_cast<const T*>(x.a), static_cast<const T*>(x.w_aug),
      static_cast<float*>(x.num), static_cast<float*>(x.den), static_cast<float*>(x.m), x.batch, x.num_dst,
      x.num_src, x.C, x.H, L, x.A2, scale);
  return static_cast<int>(cudaGetLastError());
}

// the heads of a group compile-time for 4 unpadded heads on 32 lanes, the whole row one such group
// (C = 32 VB) compile-time too; a head wider than 256 (VB = 16, 32) is a group of its own, with no
// compile-time variant
template <typename T, int VB>
int launch_vb(const FwdArgs& x, cudaStream_t s) {
  Layout L;
  if (!edge_logit::make_layout<VB>(x.C, x.H, x.G, sizeof(T), &L) || x.Dt <= 0 || x.Dt > L.D)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (VB <= 8) {
    if (L.lanes == 32 && L.HG == 4 && L.DV == L.LB) {
      return L.groups == 1 ? launch_fwd<T, VB, 4, true>(x, L, s) : launch_fwd<T, VB, 4, false>(x, L, s);
    }
  }
  return launch_fwd<T, VB, 0, false>(x, L, s);
}

template <typename T>
int launch_edge_attn_csr(const FwdArgs& x, void* stream) {
  if (x.A2 <= 0 || x.num_dst <= 0 || x.batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x.VB) {
    case 1: return launch_vb<T, 1>(x, s);
    case 2: return launch_vb<T, 2>(x, s);
    case 4: return launch_vb<T, 4>(x, s);
    case 8: return launch_vb<T, 8>(x, s);
    case 16: return launch_vb<T, 16>(x, s);
    case 32: return launch_vb<T, 32>(x, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// G and VB: the lane layout of ops/edge_attention.py:_lane_layout; Dt: the head width C / H had
// before the wrapper padded it (C / H itself where it did not)
int edge_attn_csr_f32(const void* q, const void* kv, const void* rowptr, const void* src,
                      const void* a, const void* w_aug, void* num, void* den, void* m, int batch,
                      int num_dst, int num_src, int C, int H, int A2, int G, int VB, int Dt, void* stream) {
  return launch_edge_attn_csr<float>(
      FwdArgs{q, kv, rowptr, src, a, w_aug, num, den, m, batch, num_dst, num_src, C, H, A2, G, VB, Dt}, stream);
}

int edge_attn_csr_bf16(const void* q, const void* kv, const void* rowptr, const void* src,
                       const void* a, const void* w_aug, void* num, void* den, void* m, int batch,
                       int num_dst, int num_src, int C, int H, int A2, int G, int VB, int Dt, void* stream) {
  return launch_edge_attn_csr<__nv_bfloat16>(
      FwdArgs{q, kv, rowptr, src, a, w_aug, num, den, m, batch, num_dst, num_src, C, H, A2, G, VB, Dt}, stream);
}

}  // extern "C"
