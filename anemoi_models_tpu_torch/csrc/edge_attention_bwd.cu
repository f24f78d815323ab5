// Hopper (sm_90a) backward of the GraphTransformer edge attention.
//
// Replaces anemoi_models_tpu/ops/pallas/edge_attention.py:_feats_bwd_kernel.
// Per block of destinations the TPU kernel recomputed the attention weights in
// the forward's m-gauge, gathered each slot's k/v row with a one-hot matmul and
// scattered the k/v cotangents into per-block slabs that were overlap-added
// afterwards (Mosaic can neither gather nor scatter in VMEM), and carried the
// edge-projection gradient dw_aug from one grid step to the next. On Hopper
// rows load by index and blocks run in no order, so the backward walks the
// same CSR edge lists as the forward (csrc/edge_attention.cu) in four launches:
//
//   dst pass   a persistent grid of CTAs striding over the destinations, in
//              which a warp owns a destination and walks its head groups in
//              sequence, one edge at a time: the forward's lane layout
//              (edge_logit.cuh; a group of G <= 256 channels of whole heads,
//              or one head of up to 1024 on 32 lanes of VB = 16 or 32, VB
//              consecutive channels a lane, at most 32 lanes, so any width
//              the forward takes), each group reading only its slice of the
//              k/v rows. The warp keeps kRing - 1 edges' k/v row slices in
//              flight in its own ring of shared memory, and the next
//              destination's edge range, q and g_num slices and first k/v
//              rows in flight while it finishes the current one. Per edge
//              e = (s -> t), head h, batch b, with the edge term e_e =
//              a_e.w_aug factored (edge_logit.cuh):
//                w   = exp(min(scale <q[t], k[s] + e_e>_h - m[t,h], 0))
//                dl  = w (<g_num[t], v[s] + e_e>_h + g_den[t,h])
//              and dq[t] = sum_e scale dl (k[s] + e_e), da_e[r] = sum_b sum_h
//              scale dl P[r,h] + w G[r,h] with the per-destination factors
//              P = <q[t], w_aug[r]>_h, G = <g_num[t], w_aug[r]>_h, (dl, w) at
//              the edge's position in the transposed list (the inverse of
//              perm), and the destination's
//                adl[t, h, r] = sum_e a_er dl,  aw[t, h, r] = sum_e a_er w
//              into device memory: dw_aug's terms without the per-warp A2 x C
//              partials of the first design.
//   src pass   a warp per (batch, source, head group) over the transposed
//              CSR, reading
//              (dl, w) contiguously and q[t], g_num[t] as 16-byte vectors, the
//              next edge's rows loaded before the current edge's arithmetic:
//                dk[s] = sum_e scale dl_e q[t],  dv[s] = sum_e w_e g_num[t].
//   dw parts   dw_aug[r, c] = sum_t scale q[t,c] adl[t,h(c),r] + g_num[t,c] aw[t,h(c),r]
//              over a fixed split of the destinations into parts,
//   dw reduce  then the fixed-order sum of the parts.
//
// Every sum runs in a fixed order with no atomics, so the backward is
// run-to-run bit-identical. The logit is recomputed with the forward's exact
// arithmetic (edge_logit.cuh), so w <= 1 holds with the forward's m; the exp
// argument is clamped at 0 all the same, as the TPU kernel clamps it.
//
// Bound on the H100: bytes. At the O96 encoder (E = 376,228, C = 256,
// A2 = 8, bf16) the function reads and writes about 173 MB once (0.052 ms at
// 3.35 TB/s), most of it the fp32 dkv; its fewest operations, about 10 C per
// edge with the edge term factored, are 1.3 GFLOP (0.0013 ms at the bf16
// tensor peak, 0.02 ms at the fp32 peak). The kernel reads more than that:
// every edge gathers a k/v row (dst pass) and a q and g_num row (src pass),
// from L2 for the most part, and runs its steps one edge after another, so
// the dst pass is bound by its instruction rate and latency; the attribute
// work is per destination and per batch of 32 edges, by (edge, head) and
// (attribute, head) pairs over the warp's lanes.
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "edge_logit.cuh"

namespace {

using edge_logit::kFull;
using edge_logit::Layout;
using edge_logit::Row;
using edge_logit::store_row;
using edge_logit::to_f;

constexpr int kWarps = 4;   // warps per CTA of every pass
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 32;
constexpr int kDwCols = 128;  // dw pass: columns of w_aug a CTA, one a thread
constexpr int kDwRows = 8;    // dw pass: rows of w_aug a CTA, in registers

// ---------------------------------------------------------------------------
// dst pass. The lane layout of edge_logit.cuh: a head group of G channels,
// lane l < lanes of head l / LB of the group (LB lanes a head: D / VB rounded
// up to a power of two) owning VB channels of it (none on a lane that pads its
// head); the other lanes shadow the first head's lanes and store nothing.
// Warp g of a persistent grid takes destinations g, g + warps, ... and walks
// each destination's head groups in sequence, so every sum over heads runs
// in one fixed order. Each warp keeps kRing - 1 edges' k/v row slices in
// flight in its own ring of shared memory (cp.async, each lane its own VB
// channels where they are whole 16-byte copies, else the warp 16 bytes a
// lane), and the source ids and positions of 32 edges at a time in
// registers, one edge a lane, shuffled out per edge.
//
// The edge term is factored as in the forward (edge_logit.cuh): per
// destination and group the factors P[r, h] = <q, w_r>_h and G[r, h] =
// <g_num, w_r>_h; per batch of 32 edges their edge terms by (edge, head) pair,
// so an edge's logit (the forward's bits) and <g_num, v + e>_h cost one dot
// each and a value read from shared memory. At the batch's end, by pair:
//   adl[r, h] = sum_e a_er dl_e,h and aw[r, h] = sum_e a_er w_e,h, added to
//     the destination's rows of adl / aw in device memory (the dw pass reads
//     them), and scale sum_r adl[r, h] w_r[c] added to dq[t, c];
//   da_e[r] += sum_h scale dl_e,h P[r, h] + w_e,h G[r, h], in (batch, group,
//     head) order.
// The attributes stream in chunks (attr_chunk): where one chunk holds them
// all the factors are taken once a destination and group, else again for
// every batch and chunk. HC, when not 0, is the heads of a group at compile
// time (on 32 lanes); FLAT, one group of 32 lanes (C = 32 VB at compile
// time, the flagship's C = 256: the row strides fold into the addresses).
// Shared memory: the warps' rings, their q and g_num slices of the next
// destination's first group, and their tables (dst_table_floats).
// ---------------------------------------------------------------------------

constexpr int kRing = 3;  // ring stages a warp: kRing - 1 edges in flight

// a warp's tables in bytes, 16-byte rounded: the chunk's factors P, G and sums adl (rc x HG each) and
// the batch's edge terms of q and g_num (32 x HG each) in the wide type (acc bytes), then its dl and w
// (32 x HG each) in fp32
__host__ __device__ inline int dst_table_bytes(int rc, int HG, int acc) {
  return ((3 * rc * HG + 64 * HG) * acc + 64 * HG * 4 + 15) / 16 * 16;
}

size_t dst_smem_bytes(int G, int rc, int HG, int item, int acc) {
  return static_cast<size_t>(kWarps) * (kRing * 2 * G * item + G * (item + 4) + dst_table_bytes(rc, HG, acc));
}

template <typename T, int VB, int HC, bool FLAT>
__global__ void __launch_bounds__(kThreads) bwd_dst_kernel(
    const T* __restrict__ q, const T* __restrict__ kv, const int* __restrict__ rowptr,
    const int* __restrict__ src, const T* __restrict__ a, const T* __restrict__ w_aug,
    const float* __restrict__ m_in, const float* __restrict__ g_num, const float* __restrict__ g_den,
    const int* __restrict__ pos, float* __restrict__ dq, float* __restrict__ da,
    float* __restrict__ dlw, float* __restrict__ adl_g, float* __restrict__ aw_g, int batch, int num_dst,
    int num_src, int num_edges, int c_arg, int h_arg, Layout L, int A2, float scale) {
  using A = edge_logit::wide_t<T>;
  constexpr int kTs = static_cast<int>(sizeof(T));
  const int C = FLAT ? 32 * VB : c_arg;
  const int H = FLAT && HC ? HC : h_arg;
  const int G = (HC || FLAT) ? 32 * VB : L.G;
  const int LB = HC ? 32 / HC : L.LB;  // lanes of a head
  const int HG = HC ? HC : L.HG;
  const int lanes = (HC || FLAT) ? 32 : L.lanes;
  const int groups = FLAT ? 1 : L.groups;
  const int stage = 2 * G * kTs;  // a k slice, then a v slice
  // the warps' rings, their q and g_num slices, then their tables
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool active = lane < lanes;
  const int ll = active ? lane : lane % LB;
  const int hl = ll / LB;   // head of the group
  const bool lead = active && ll % LB == 0;
  bool owns;  // false on a lane that pads its head (D not a power of two): q, g_num read as 0, no store
  const int c0 = edge_logit::lane_channel(ll, LB, HC ? LB : L.DV, HC ? LB * VB : L.D, VB, &owns);  // in the group
  constexpr int kChunk = VB * kTs;  // a lane's bytes of a k or v slice
  constexpr bool kOwn = kChunk % 16 == 0;  // each lane copies and reads only its own chunk
  // own chunks: the lane's offset folds into the ring's and the rows' base addresses
  uint8_t* ring = smem + warp * kRing * stage + (kOwn ? c0 * kTs : 0);
  const int own = kOwn ? 0 : c0 * kTs;
  uint8_t* qg_q = smem + kWarps * kRing * stage + warp * G * (kTs + 4);
  uint8_t* qg_g = qg_q + G * kTs;
  const int rc = edge_logit::attr_chunk(A2, HG, sizeof(A));
  const bool one_chunk = rc == A2;
  A* pf_s = reinterpret_cast<A*>(smem + kWarps * (kRing * stage + G * (kTs + 4)) +
                                 warp * dst_table_bytes(rc, HG, sizeof(A)));
  A* gf_s = pf_s + rc * HG;  // G[r, h] at r HG + h
  A* ad_s = gf_s + rc * HG;  // the batch's adl of the chunk
  A* ep_s = ad_s + rc * HG;  // the batch's edge terms of q, (n, h) at n HG + h
  A* eg_s = ep_s + 32 * HG;  // and of g_num
  float* dl_s = reinterpret_cast<float*>(eg_s + 32 * HG);  // the batch's dl
  float* w_s = dl_s + 32 * HG;                             // and w
  // warp g of the grid takes destinations g, g + warps, g + 2 warps, ...
  const int warps = gridDim.x * kWarps;
  int t = blockIdx.x * kWarps + warp;

  // a batch of this warp's edges (at most 32): lane l holds edge l's source and position;
  // prime(b, k) starts the first kRing - 1 k/v row slices of group k, batch index b
  int cnt = 0, sid = 0, spos = 0;
  auto load_batch = [&](int base, int end) {
    cnt = min(32, end - base);
    const bool have = lane < cnt;
    sid = have ? src[base + lane] : 0;
    spos = have ? pos[base + lane] : 0;
  };
  auto copy_rows = [&](uint8_t* st, const T* krow) {
    edge_logit::slice_copy_async<kChunk>(st, krow, own, G * kTs, lane);
    edge_logit::slice_copy_async<kChunk>(st + G * kTs, krow + C, own, G * kTs, lane);
  };
  auto prime = [&](int b, int k) {
    const T* kv_b = kv + (int64_t)b * num_src * 2 * C + k * G + (kOwn ? c0 : 0);
    edge_logit::slice_sync<kChunk>();  // every lane is done with the stages it overwrites
#pragma unroll
    for (int d = 0; d < kRing - 1; ++d) {
      if (d < cnt) copy_rows(ring + d * stage, kv_b + (int64_t)__shfl_sync(kFull, sid, d) * 2 * C);
      edge_logit::copy_commit();
    }
  };
  // the first group's q and g_num slices of destination tt (batch 0)
  auto fetch_qg = [&](int tt) {
    edge_logit::slice_sync<kChunk>();
    edge_logit::slice_sync<VB * 4>();
    if (tt < num_dst) {
      edge_logit::slice_copy_async<kChunk>(qg_q, q + (int64_t)tt * C, c0 * kTs, G * kTs, lane);
      edge_logit::slice_copy_async<VB * 4>(qg_g, g_num + (int64_t)tt * C, c0 * 4, G * 4, lane);
    }
    edge_logit::copy_commit();
  };

  int e_begin = t < num_dst ? rowptr[t] : 0;
  int e_end = t < num_dst ? rowptr[t + 1] : 0;
  // the first destination's edges, q and g_num slices and m, g_den, in flight together
  load_batch(e_begin, e_end);
  float m_next = t < num_dst ? m_in[(int64_t)t * H + hl] : 0.f;
  float gd_next = t < num_dst ? g_den[(int64_t)t * H + hl] : 0.f;
  fetch_qg(t);
  prime(0, 0);

  for (; t < num_dst; t += warps) {
    // the next destination's edge range, in flight during this one
    const int tn = t + warps;
    const int next_begin = tn < num_dst ? rowptr[tn] : 0;
    const int next_end = tn < num_dst ? rowptr[tn + 1] : 0;

    for (int b = 0; b < batch; ++b) {
      const int64_t row = (int64_t)b * num_dst + t;
      for (int k = 0; k < groups; ++k) {
        const int ck = k * G + c0;  // this lane's first channel
        const int h0 = k * HG;      // the group's first head
        const bool first = b == 0 && k == 0;
        float qv[VB], gv[VB], dqa[VB];
        float m_h, gd_h;
        {
          Row<T, VB> qr;
          Row<float, VB> gr;
          if (first) {  // fetched while the previous destination finished
            edge_logit::copy_wait<kRing - 1>();
            edge_logit::slice_sync<kChunk>();
            edge_logit::slice_sync<VB * 4>();
            qr.load_shared(qg_q + c0 * kTs);
            gr.load_shared(qg_g + c0 * 4);
            m_h = m_next;
            gd_h = gd_next;
          } else {
            qr.load(q + row * C + ck);
            gr.load(g_num + row * C + ck);
            m_h = m_in[row * H + h0 + hl];
            gd_h = g_den[row * H + h0 + hl];
          }
#pragma unroll
          for (int c = 0; c < VB; ++c) {
            qv[c] = owns ? qr[c] : 0.f;
            gv[c] = owns ? gr[c] : 0.f;
            dqa[c] = 0.f;
          }
        }
        const T* w_lane = w_aug + ck;  // this lane's channels of w_aug's row 0
        float* adl_row = adl_g + (row * H + h0) * A2;  // (head, attribute) at h A2 + r
        float* aw_row = aw_g + (row * H + h0) * A2;
        __syncwarp();  // every lane is done with the previous group's tables
        if (e_begin == e_end) {  // no edge: this destination adds nothing to dw_aug
          for (int p = lane; p < HG * A2; p += 32) adl_row[p] = aw_row[p] = 0.f;
        } else if (one_chunk) {  // the factors of every attribute, once for the destination and group
          edge_logit::head_factors<T, VB, true>(pf_s, gf_s, qv, gv, w_lane, C, 0, A2, LB, HG, hl, lead);
        }

        const T* kv_b = kv + (int64_t)b * num_src * 2 * C + k * G + (kOwn ? c0 : 0);
        float* dlw_b = dlw + (int64_t)b * num_edges * H * 2;
        for (int base = e_begin; base < e_end; base += 32) {
          if (!first || base != e_begin) {  // the first batch of b = 0, k = 0 was loaded and primed ahead
            load_batch(base, e_end);
            prime(b, k);
          }
          // the batch's edge terms of q and g_num, chunk by chunk
          for (int r0 = 0; r0 < A2; r0 += rc) {
            const int rn = min(rc, A2 - r0);
            __syncwarp();
            if (!one_chunk) {
              edge_logit::head_factors<T, VB, true>(pf_s, gf_s, qv, gv, w_lane, C, r0, rn, LB, HG, hl, lead);
              __syncwarp();
            }
            edge_logit::edge_terms<T, true>(ep_s, eg_s, pf_s, gf_s, a, A2, base, cnt, HG, r0, rn, r0 > 0, lane);
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
            const int epos = __shfl_sync(kFull, spos, n);
            const A term_q = ep_s[n * HG + hl];
            const A term_g = eg_s[n * HG + hl];
            edge_logit::copy_wait<kRing - 1>();  // this lane's copies of edge n have landed,
            edge_logit::slice_sync<kChunk>();     // and every other lane's
            const uint8_t* st = ring + rd * stage + own;
            Row<T, VB> kr, vr;
            kr.load_shared(st);
            vr.load_shared(st + G * kTs);
            // the forward's logit, bit for bit
            const float w = expf(fminf(edge_logit::logit_sum<T, VB>(qv, kr, term_q, LB) * scale - m_h, 0.f));
            const float s1 = edge_logit::logit_sum<T, VB>(gv, vr, term_g, LB);  // <g_num, v + e>_h
            const float dl = w * (s1 + gd_h);
            const float sdl = scale * dl;
#pragma unroll
            for (int c = 0; c < VB; ++c) dqa[c] = fmaf(sdl, kr[c], dqa[c]);
            if (lead) {
              dl_s[n * HG + hl] = dl;
              w_s[n * HG + hl] = w;
              *reinterpret_cast<float2*>(dlw_b + ((int64_t)epos * H + h0 + hl) * 2) = make_float2(dl, w);
            }
          }
          // the batch's attribute sums, chunk by chunk: adl, aw (into device memory and dq's
          // e-term) and da, in A
          A ea[VB];
#pragma unroll
          for (int c = 0; c < VB; ++c) ea[c] = 0;
          for (int r0 = 0; r0 < A2; r0 += rc) {
            const int rn = min(rc, A2 - r0);
            __syncwarp();
            if (!one_chunk) {
              edge_logit::head_factors<T, VB, true>(pf_s, gf_s, qv, gv, w_lane, C, r0, rn, LB, HG, hl, lead);
            }
            for (int p = lane; p < rn * HG; p += 32) {  // (attribute, head) pairs
              const int i = p / HG, h = p - i * HG;
              const T* ar = a + (int64_t)base * A2 + r0 + i;
              A x = 0, y = 0;
              for (int n = 0; n < cnt; ++n) {
                const float av = to_f(ar[(int64_t)n * A2]);
                x = edge_logit::fma_as<A>(av, dl_s[n * HG + h], x);
                y = edge_logit::fma_as<A>(av, w_s[n * HG + h], y);
              }
              ad_s[p] = x;
              const int gi = h * A2 + r0 + i;
              adl_row[gi] = base == e_begin ? static_cast<float>(x) : adl_row[gi] + static_cast<float>(x);
              aw_row[gi] = base == e_begin ? static_cast<float>(y) : aw_row[gi] + static_cast<float>(y);
            }
            __syncwarp();
            for (int p = lane; p < cnt * rn; p += 32) {  // (edge, attribute) pairs
              const int n = p / rn, i = p - n * rn;
              A x = 0;
              for (int h = 0; h < HG; ++h)
                x += edge_logit::fma_as<A>(scale * dl_s[n * HG + h], pf_s[i * HG + h],
                                           static_cast<A>(w_s[n * HG + h]) * gf_s[i * HG + h]);
              float* d = da + (int64_t)(base + n) * A2 + r0 + i;
              *d = first ? static_cast<float>(x) : *d + static_cast<float>(x);
            }
#pragma unroll 4
            for (int i = 0; i < rn; ++i) {
              Row<T, VB> wv;
              wv.load(w_lane + (int64_t)(r0 + i) * C);
              const A sv = scale * ad_s[i * HG + hl];
#pragma unroll
              for (int c = 0; c < VB; ++c) ea[c] = edge_logit::fma_as<A>(sv, wv[c], ea[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < VB; ++c) dqa[c] += static_cast<float>(ea[c]);
        }
        if (b == batch - 1 && k == groups - 1) {  // the next destination's edges, m and g_den, in flight
          load_batch(next_begin, next_end);
          m_next = tn < num_dst ? m_in[(int64_t)tn * H + hl] : 0.f;
          gd_next = tn < num_dst ? g_den[(int64_t)tn * H + hl] : 0.f;
        }
        if (active && owns) store_row<VB>(dq + row * C + ck, dqa);
      }
    }
    fetch_qg(tn);  // the next destination's q, g_num and first k/v rows
    prime(0, 0);
    e_begin = next_begin;
    e_end = next_end;
  }
}

// ---------------------------------------------------------------------------
// dw pass: the per-destination terms summed over the destinations, per head
// an (A2 x rows) . (rows x D) product,
//   dw_aug[r, c] = sum_row scale q[row, c] adl[row, h(c), r] + g_num[row, c] aw[row, h(c), r],
// in a fixed order: CTA (column tile, part, row tile) sums its part's `span`
// rows, a thread a column, kDwRows rows of w_aug in registers, into
// part[p, r, c]; dw_reduce then sums the parts in order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kDwCols) dw_parts_kernel(
    const T* __restrict__ q, const float* __restrict__ g_num, const float* __restrict__ adl,
    const float* __restrict__ aw, float* __restrict__ part, int rows, int C, int H, int D, int A2, int span,
    float scale) {
  const int c = blockIdx.x * kDwCols + threadIdx.x;
  const int p = blockIdx.y;
  const int r0 = blockIdx.z * kDwRows;
  const int rn = min(kDwRows, A2 - r0);
  if (c >= C) return;
  const int h = c / D;
  float acc[kDwRows];
#pragma unroll
  for (int i = 0; i < kDwRows; ++i) acc[i] = 0.f;
  const int lo = p * span, hi = min(rows, lo + span);
  for (int row = lo; row < hi; ++row) {
    const float qv = scale * to_f(q[(int64_t)row * C + c]);
    const float gv = g_num[(int64_t)row * C + c];
    const float* ad = adl + ((int64_t)row * H + h) * A2 + r0;
    const float* aw_r = aw + ((int64_t)row * H + h) * A2 + r0;
#pragma unroll
    for (int i = 0; i < kDwRows; ++i)
      if (i < rn) acc[i] = fmaf(qv, ad[i], fmaf(gv, aw_r[i], acc[i]));
  }
#pragma unroll
  for (int i = 0; i < kDwRows; ++i)
    if (i < rn) part[((int64_t)p * A2 + r0 + i) * C + c] = acc[i];
}

// ---------------------------------------------------------------------------
// src pass: a warp per (batch, source, head group), walking the source's
// out-edges in the transposed CSR (edge ids ascending within a source): the
// edge ids and destinations 32 at a time, the next edge's q and g_num slices
// and (dl, w) in flight in registers during the current edge's arithmetic.
// Lane l < lanes owns the channels it owns in the dst pass; the other lanes
// (and those that pad a head) shadow the head's first lane and store nothing.
// ---------------------------------------------------------------------------

template <typename T, int VB, bool FLAT>
__global__ void __launch_bounds__(kThreads) bwd_src_kernel(
    const T* __restrict__ q, const float* __restrict__ g_num, const int* __restrict__ colptr,
    const int* __restrict__ perm, const int* __restrict__ dst_of, const float* __restrict__ dlw,
    float* __restrict__ dkv, int num_dst, int num_src, int num_edges, int c_arg, int H, Layout L, int units,
    float scale) {
  const int C = FLAT ? 32 * VB : c_arg;  // FLAT: one group of 32 lanes, as in the dst pass
  const int groups = FLAT ? 1 : L.groups;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int unit = blockIdx.x * kWarps + warp;  // (batch * num_src + source) * groups + group
  if (unit >= units) return;
  const int row = unit / groups;
  const int k = unit - row * groups;
  const int bidx = row / num_src;
  const int s = row - bidx * num_src;
  bool owns = true;  // as in the dst pass: a lane that pads its head stores nothing
  const int cg = FLAT ? lane * VB : edge_logit::lane_channel(lane < L.lanes ? lane : 0, L.LB, L.DV, L.D, VB, &owns);
  const bool active = FLAT || (lane < L.lanes && owns);
  const int c0 = k * L.G + cg;
  const int head = c0 / L.D;

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
  if (active) {
    store_row<VB>(dkv + (int64_t)row * 2 * C + c0, dk);
    store_row<VB>(dkv + (int64_t)row * 2 * C + C + c0, dv);
  }
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
  void *dq, *dkv, *da, *dw, *dlw, *adl, *aw, *dw_part;
  int batch, num_dst, num_src, num_edges, C, H, A2, G, VB, parts;
  int Dt;  // the head width before padding: the logit's scale is 1 / sqrt(Dt)
};

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// The four launches: the dst pass on a persistent grid (as many CTAs as the card holds at once; no
// sum depends on which warp takes which destination), the src pass, and dw_aug's `parts` partial
// sums (ops/edge_attention.py:_bwd_parts, a function of the shape alone) then their fixed-order sum.
template <typename T, int VB, int HC, bool FLAT>
int launch_passes(const BwdArgs& x, const Layout& L, cudaStream_t s) {
  const float scale = 1.0f / std::sqrt(static_cast<float>(x.Dt));
  auto dst_kernel = bwd_dst_kernel<T, VB, HC, FLAT>;
  using A = edge_logit::wide_t<T>;
  const size_t dst_smem =
      dst_smem_bytes(L.G, edge_logit::attr_chunk(x.A2, L.HG, sizeof(A)), L.HG, sizeof(T), sizeof(A));
  int rc = set_smem(dst_kernel, dst_smem);
  if (rc != 0) return rc;
  static size_t sized_for = 0;  // the occupancy of this instantiation, per shared-memory size
  static int per_sm = 0;
  if (sized_for != dst_smem) {
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dst_kernel, kThreads, dst_smem));
    if (rc != 0) return rc;
    sized_for = dst_smem;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int grid = std::max(1, std::min((x.num_dst + kWarps - 1) / kWarps, std::max(per_sm, 1) * sms));
  dst_kernel<<<grid, kThreads, dst_smem, s>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.kv), static_cast<const int*>(x.rowptr),
      static_cast<const int*>(x.src), static_cast<const T*>(x.a), static_cast<const T*>(x.w_aug),
      static_cast<const float*>(x.m), static_cast<const float*>(x.g_num), static_cast<const float*>(x.g_den),
      static_cast<const int*>(x.pos), static_cast<float*>(x.dq), static_cast<float*>(x.da),
      static_cast<float*>(x.dlw), static_cast<float*>(x.adl), static_cast<float*>(x.aw), x.batch, x.num_dst,
      x.num_src, x.num_edges, x.C, x.H, L, x.A2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int units = x.batch * x.num_src * L.groups;
  if (units > 0) {
    auto src_kernel = L.groups == 1 && L.lanes == 32 && L.DV == L.LB ? bwd_src_kernel<T, VB, true>
                                                                       : bwd_src_kernel<T, VB, false>;
    src_kernel<<<(units + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        static_cast<const T*>(x.q), static_cast<const float*>(x.g_num), static_cast<const int*>(x.colptr),
        static_cast<const int*>(x.perm), static_cast<const int*>(x.dst_of), static_cast<const float*>(x.dlw),
        static_cast<float*>(x.dkv), x.num_dst, x.num_src, x.num_edges, x.C, x.H, L, units, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int rows = x.batch * x.num_dst;
  const int span = (rows + x.parts - 1) / x.parts;
  dw_parts_kernel<T><<<dim3((x.C + kDwCols - 1) / kDwCols, x.parts, (x.A2 + kDwRows - 1) / kDwRows), kDwCols, 0,
                       s>>>(static_cast<const T*>(x.q), static_cast<const float*>(x.g_num),
                            static_cast<const float*>(x.adl), static_cast<const float*>(x.aw),
                            static_cast<float*>(x.dw_part), rows, x.C, x.H, x.C / x.H, x.A2, span, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = x.A2 * x.C;
  dw_reduce_kernel<<<(n + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceRows), 0, s>>>(
      static_cast<const float*>(x.dw_part), static_cast<float*>(x.dw), x.parts, n);
  return static_cast<int>(cudaGetLastError());
}

// The heads of a group compile-time for 4 on 32 lanes (the flagship's C = 256, and C = 1024 with
// 16 heads), the whole row one such group (C = 32 VB) compile-time too. A head wider than 256
// (VB = 16, 32) is a group of its own on 32 lanes, with no compile-time variant.
template <typename T, int VB>
int launch_vb(const BwdArgs& x, cudaStream_t s) {
  Layout L;
  if (!edge_logit::make_layout<VB>(x.C, x.H, x.G, sizeof(T), &L) || x.Dt <= 0 || x.Dt > L.D)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (VB <= 8) {
    if (L.lanes == 32 && L.HG == 4 && L.DV == L.LB) {
      return L.groups == 1 ? launch_passes<T, VB, 4, true>(x, L, s) : launch_passes<T, VB, 4, false>(x, L, s);
    }
  }
  return launch_passes<T, VB, 0, false>(x, L, s);
}

template <typename T>
int launch_bwd(const BwdArgs& x, void* stream) {
  if (x.A2 <= 0 || x.num_dst <= 0 || x.batch <= 0 || x.parts <= 0) return static_cast<int>(cudaErrorInvalidValue);
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

// G and VB: the lane layout of ops/edge_attention.py:_lane_layout; adl, aw: (batch num_dst, H, A2)
// fp32 scratch; dw_part: (parts, A2, C) fp32 scratch, parts from ops/edge_attention.py:_bwd_parts;
// Dt: the head width C / H had before the wrapper padded it
#define EDGE_ATTN_CSR_BWD(NAME, T)                                                                            \
  int NAME(const void* q, const void* kv, const void* rowptr, const void* src, const void* a,                 \
           const void* w_aug, const void* m, const void* g_num, const void* g_den, const void* colptr,        \
           const void* perm, const void* dst_of, const void* pos, void* dq, void* dkv, void* da, void* dw,    \
           void* dlw, void* adl, void* aw, void* dw_part, int batch, int num_dst, int num_src, int num_edges, \
           int C, int H, int A2, int G, int VB, int parts, int Dt, void* stream) {                           \
    return launch_bwd<T>(BwdArgs{q,  kv,  rowptr, src, a,   w_aug, m,       g_num, g_den,   colptr,    perm,   \
                                 dst_of, pos, dq,  dkv, da,  dw,    dlw,     adl,   aw,      dw_part, batch,  \
                                 num_dst, num_src, num_edges, C, H, A2, G, VB, parts, Dt},                     \
                         stream);                                                                             \
  }

EDGE_ATTN_CSR_BWD(edge_attn_csr_bwd_f32, float)
EDGE_ATTN_CSR_BWD(edge_attn_csr_bwd_bf16, __nv_bfloat16)

}  // extern "C"
