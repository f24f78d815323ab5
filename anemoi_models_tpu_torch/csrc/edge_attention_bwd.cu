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
//   dst pass   a grid of CTAs striding over the destinations, in which a warp
//              owns a destination and walks its head groups in sequence, one
//              edge at a time: the forward's lane layout (edge_logit.cuh; a
//              group of G <= 256 channels of whole heads, or one head of up
//              to 1024 on 32 lanes of VB = 16 or 32, VB consecutive
//              channels a lane, at most 32 lanes, so any width the forward
//              takes), each group reading only its slice of the k/v rows. The
//              warp keeps kRing - 1 edges' k/v row slices in flight in its own
//              ring of shared memory (cp.async by the whole warp), the source
//              ids, positions and attributes of 32 edges at a time in
//              registers, and the next destination's edge range, q and g_num
//              slices and first k/v rows in flight while it finishes the
//              current one. w_aug sits in shared memory in its own dtype. Per
//              edge e = (s -> t), head h, batch b:
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
//              warps' partials: one row of dw_part a CTA. The grid, and with
//              it which warp sums which destinations, follows the shape alone
//              (launch_passes), so every card gives the same bits.
//   src pass   a warp per (batch, source, head group) over the transposed
//              CSR, reading
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
// the heads of a group are a compile-time constant for 4, so that they unroll
// with no branch. The logit's arithmetic is edge_logit.cuh's, which the
// forward includes too.
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

using edge_logit::group_sum;
using edge_logit::kFull;
using edge_logit::Layout;
using edge_logit::Row;
using edge_logit::store_row;
using edge_logit::to_f;

constexpr int kMaxA2 = 32;  // kMaxA2 in csrc/edge_attention.cu: attribute loops 8, 16 or 32 long
constexpr int kWarps = 4;   // warps per CTA of every pass (the dst pass takes fewer where its partials need it)
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 32;
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a CTA can have on the H100

// ---------------------------------------------------------------------------
// dst pass. The lane layout of edge_logit.cuh: a head group of G channels,
// lane l < lanes of head l / LB of the group (LB lanes a head: D / VB rounded
// up to a power of two) owning VB channels of it (none on a lane that pads its
// head); the other lanes shadow the first head's lanes and store nothing.
// Warp g of the grid takes destinations g, g + warps, ... and walks each destination's head
// groups in sequence, so every sum over heads runs in one fixed order. Each
// warp keeps kRing - 1 edges' k/v row slices in flight in its own ring of
// shared memory (cp.async, each lane its own VB channels where they are whole
// 16-byte copies, else the warp 16 bytes a lane), and the
// attributes of 32 edges at a time in registers, one edge a lane, shuffled
// out per edge. With SLOT (A2 <= LB) lane l keeps only attribute r = l % LB
// of its head's P, G, adl and aw, so da_e is one fmaf and a shuffle sum over
// the heads; otherwise every lane keeps all A2. HC, when not 0, is the heads
// of a group at compile time (on 32 lanes); FLAT, one group of 32 lanes (C =
// 32 VB at compile time, the flagship's C = 256: the row strides fold into
// the addresses). Shared memory: w_aug, the warps' rings, their q and g_num
// slices of the next destination's first group, and their dw_aug partials
// (A2 x C fp32 a warp: at C = 1024 these bound the CTA to one an SM).
// ---------------------------------------------------------------------------

constexpr int kRing = 3;  // ring stages a warp: kRing - 1 edges in flight

size_t dst_smem_bytes(int C, int G, int A2, int maxa2, int item, int warps) {
  return static_cast<size_t>(maxa2) * C * item +
         static_cast<size_t>(warps) * (kRing * 2 * G * item + G * (item + 4) + static_cast<size_t>(A2) * C * 4);
}

template <typename T, int VB, int MAXA2, bool SLOT, int HC, bool FLAT>
__global__ void __launch_bounds__(kThreads) bwd_dst_kernel(
    const T* __restrict__ q, const T* __restrict__ kv, const int* __restrict__ rowptr,
    const int* __restrict__ src, const T* __restrict__ a, const T* __restrict__ w_aug,
    const float* __restrict__ m_in, const float* __restrict__ g_num, const float* __restrict__ g_den,
    const int* __restrict__ pos, float* __restrict__ dq, float* __restrict__ da,
    float* __restrict__ dlw, float* __restrict__ dw_part, int batch, int num_dst, int num_src,
    int num_edges, int c_arg, int h_arg, Layout L, int A2, float scale) {
  constexpr int kTs = static_cast<int>(sizeof(T));
  constexpr int RL = SLOT ? 1 : MAXA2;  // attribute slots a lane keeps
  const int C = FLAT ? 32 * VB : c_arg;
  const int H = FLAT && HC ? HC : h_arg;
  const int G = (HC || FLAT) ? 32 * VB : L.G;
  const int LB = HC ? 32 / HC : L.LB;  // lanes of a head
  const int HG = HC ? HC : L.HG;
  const int lanes = (HC || FLAT) ? 32 : L.lanes;
  const int vf = HC ? (VB >= 4 ? VB / 4 : 1) : L.vf;  // HC = 4: D = 8 VB
  const int groups = FLAT ? 1 : L.groups;
  const int nwarps = blockDim.x / 32;
  const int stage = 2 * G * kTs;  // a k slice, then a v slice
  // w_aug (MAXA2, C) in T, the warps' rings, their q and g_num slices, then their dw_aug partials (A2, C) fp32
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool active = lane < lanes;
  const int ll = active ? lane : lane % LB;
  const int hl = ll / LB;   // head of the group
  const int j = ll % LB;    // SLOT: the attribute this lane keeps
  const bool head_lead = active && j == 0;
  bool owns;  // false on a lane that pads its head (D not a power of two): q, g_num read as 0, no store
  const int c0 = edge_logit::lane_channel(ll, LB, HC ? LB : L.DV, HC ? LB * VB : L.D, VB, &owns);  // in the group
  // w_aug by group: group k's rows at k * MAXA2 * G, row r of it at r * G
  const T* w_s = reinterpret_cast<const T*>(smem) + c0;
  constexpr int kChunk = VB * kTs;  // a lane's bytes of a k or v slice
  constexpr bool kOwn = kChunk % 16 == 0;  // each lane copies and reads only its own chunk
  // own chunks: the lane's offset folds into the ring's and the rows' base addresses
  uint8_t* ring = smem + MAXA2 * C * kTs + warp * kRing * stage + (kOwn ? c0 * kTs : 0);
  const int own = kOwn ? 0 : c0 * kTs;
  uint8_t* qg_q = smem + MAXA2 * C * kTs + nwarps * kRing * stage + warp * G * (kTs + 4);
  uint8_t* qg_g = qg_q + G * kTs;
  float* dw_all = reinterpret_cast<float*>(smem + MAXA2 * C * kTs + nwarps * (kRing * stage + G * (kTs + 4)));
  float* dw_w = dw_all + warp * A2 * C;  // this warp's partial, row r at r * C
  for (int i = 4 * lane; i < A2 * C; i += 4 * 32)
    *reinterpret_cast<float4*>(dw_w + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  // warp g of the grid takes destinations g, g + warps, g + 2 warps, ...
  const int warps = gridDim.x * nwarps;
  int t = blockIdx.x * nwarps + warp;

  // a batch of this warp's edges (at most 32): lane l holds edge l's source, position and
  // attributes; prime(b, k) starts the first kRing - 1 k/v row slices of group k, batch index b
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
  // w_aug by group, a word at a time, zero rows past A2: every loop over attributes runs MAXA2
  // long with no branch, and a zero term changes at most the sign of an exact zero in the edge term
  {
    const int words = G * kTs / 4;  // a row of a group
    for (int i = threadIdx.x; i < groups * MAXA2 * words; i += blockDim.x) {
      const int kr = i / words;  // group k * MAXA2 + row r
      const int k = kr / MAXA2, r = kr - k * MAXA2;
      reinterpret_cast<uint32_t*>(smem)[i] =
          r < A2 ? reinterpret_cast<const uint32_t*>(w_aug + r * C + k * G)[i - kr * words] : 0u;
    }
  }
  __syncthreads();

  for (; t < num_dst; t += warps) {
    // the next destination's edge range, in flight during this one
    const int tn = t + warps;
    const int next_begin = tn < num_dst ? rowptr[tn] : 0;
    const int next_end = tn < num_dst ? rowptr[tn + 1] : 0;

    for (int b = 0; b < batch; ++b) {
      const int64_t row = (int64_t)b * num_dst + t;
      for (int k = 0; k < groups; ++k) {
        const int ck = k * G + c0;  // this lane's first channel
        const int head = k * HG + hl;
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
            m_h = m_in[row * H + head];
            gd_h = g_den[row * H + head];
          }
#pragma unroll
          for (int c = 0; c < VB; ++c) {
            qv[c] = owns ? qr[c] : 0.f;
            gv[c] = owns ? gr[c] : 0.f;
            dqa[c] = 0.f;
          }
        }
        const T* w_k = w_s + k * MAXA2 * G;  // this lane's channels of group k's w_aug row r at r * G

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
            wv.load_shared(reinterpret_cast<const uint8_t*>(w_k + r * G));
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
              wv.load_shared(reinterpret_cast<const uint8_t*>(w_k + r * G));
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

        const T* kv_b = kv + (int64_t)b * num_src * 2 * C + k * G + (kOwn ? c0 : 0);
        float* dlw_b = dlw + (int64_t)b * num_edges * H * 2;
        for (int base = e_begin; base < e_end; base += 32) {
          if (!first || base != e_begin) {  // the first batch of b = 0, k = 0 was loaded and primed ahead
            load_batch(base, e_end);
            prime(b, k);
          }
          for (int n = 0, rd = 0; n < cnt; ++n, rd = rd == kRing - 1 ? 0 : rd + 1) {  // rd: edge n's stage
            const int e = base + n;
            {  // the row kRing - 1 edges on, into the stage edge n - 1 freed
              edge_logit::slice_sync<kChunk>();
              const int nx = n + kRing - 1;
              if (nx < cnt)
                copy_rows(ring + (rd == 0 ? kRing - 1 : rd - 1) * stage,
                          kv_b + (int64_t)__shfl_sync(kFull, sid, nx) * 2 * C);
              edge_logit::copy_commit();
            }
            const int epos = __shfl_sync(kFull, spos, n);
            float ar[MAXA2];
#pragma unroll
            for (int r = 0; r < MAXA2; ++r) ar[r] = __shfl_sync(kFull, areg[r], n);
            edge_logit::copy_wait<kRing - 1>();  // this lane's copies of edge n have landed,
            edge_logit::slice_sync<kChunk>();     // and every other lane's
            const uint8_t* st = ring + rd * stage + own;
            Row<T, VB> kr, vr;
            kr.load_shared(st);
            vr.load_shared(st + G * kTs);

            // the edge term in the forward's order: ev = sum_r a_r w_aug[r], one fmaf chain a channel
            float ev[VB];
            edge_logit::edge_term<T, VB, MAXA2>(ev, ar, w_k, G);
            const float w =
                expf(fminf(edge_logit::exact_dot_vf<T, VB>(vf, qv, kr, ev, LB) * scale - m_h, 0.f));
            float s1 = 0.f;
#pragma unroll
            for (int c = 0; c < VB; ++c) s1 = fmaf(gv[c], vr[c] + ev[c], s1);
            s1 = group_sum(s1, LB);
            const float dl = w * (s1 + gd_h);
            const float sdl = scale * dl;
#pragma unroll
            for (int c = 0; c < VB; ++c) dqa[c] = fmaf(sdl, kr[c] + ev[c], dqa[c]);
            // da_e: this head's term, then the sum over the group's heads (lanes LB, 2 LB, ... apart;
            // idle lanes add 0), added to the earlier groups' and batch indices' in that order
            float mine_da = 0.f;
            if constexpr (SLOT) {
              float a_j = 0.f;
#pragma unroll
              for (int r = 0; r < MAXA2; ++r)
                if (r == j) a_j = ar[r];
              adl[0] = fmaf(a_j, dl, adl[0]);
              aw[0] = fmaf(a_j, w, aw[0]);
              float x = active ? fmaf(sdl, pf[0], w * gf[0]) : 0.f;
#pragma unroll
              for (int off = LB; off < 32; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
              mine_da = x;  // lane r < A2 <= LB: attribute r
            } else {
              float x[MAXA2];
#pragma unroll
              for (int r = 0; r < MAXA2; ++r) {
                adl[r] = fmaf(ar[r], dl, adl[r]);
                aw[r] = fmaf(ar[r], w, aw[r]);
                x[r] = active ? fmaf(sdl, pf[r], w * gf[r]) : 0.f;
              }
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
              *p = first ? mine_da : *p + mine_da;
            }
            if (head_lead)
              *reinterpret_cast<float2*>(dlw_b + ((int64_t)epos * H + head) * 2) = make_float2(dl, w);
          }
        }
        if (b == batch - 1 && k == groups - 1) {  // the next destination's edges, m and g_den, in flight
          load_batch(next_begin, next_end);
          m_next = tn < num_dst ? m_in[(int64_t)tn * H + hl] : 0.f;
          gd_next = tn < num_dst ? g_den[(int64_t)tn * H + hl] : 0.f;
        }

        // dq[t], and this destination's dw_aug terms into the warp's partial:
        //   dw[r, c] += scale q[t,c] adl[h(c), r] + g_num[t,c] aw[h(c), r]
        // (with SLOT lane (h, j) holds head h's adl, aw of attribute j; otherwise every lane all of h's)
        if (active && owns) store_row<VB>(dq + row * C + ck, dqa);
#pragma unroll
        for (int r = 0; r < MAXA2; ++r) {
          if (r < A2) {
            float adl_r, aw_r;
            if constexpr (SLOT) {
              adl_r = __shfl_sync(kFull, adl[0], hl * LB + r);
              aw_r = __shfl_sync(kFull, aw[0], hl * LB + r);
            } else {
              adl_r = adl[r];
              aw_r = aw[r];
            }
            if (active && owns) {
              const float sadl = scale * adl_r;
              float* part_p = dw_w + r * C + ck;
              Row<float, VB> part;
              part.load_shared(reinterpret_cast<const uint8_t*>(part_p));
              float acc[VB];
#pragma unroll
              for (int c = 0; c < VB; ++c) acc[c] = fmaf(qv[c], sadl, fmaf(gv[c], aw_r, part[c]));
              store_row<VB>(part_p, acc);
            }
          }
        }
      }
    }
    fetch_qg(tn);  // the next destination's q, g_num and first k/v rows
    prime(0, 0);
    e_begin = next_begin;
    e_end = next_end;
  }

  // the CTA's dw_aug partial: its warps' partials summed in warp order
  __syncthreads();
  float* out = dw_part + (int64_t)blockIdx.x * A2 * C;
  for (int i = threadIdx.x; i < A2 * C; i += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < nwarps; ++w) sum += dw_all[w * A2 * C + i];
    out[i] = sum;
  }
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
  void *dq, *dkv, *da, *dw, *dlw, *dw_part;
  int batch, num_dst, num_src, num_edges, C, H, A2, G, VB, parts;
  int Dt;  // the head width before padding: the logit's scale is 1 / sqrt(Dt)
};

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// The dst pass's warps a CTA (4, fewer where its dw_aug partials do not fit), its shared memory,
// and its grid: `parts` CTAs, one a row of dw_part, the count the wrapper takes from the shape
// alone (ops/edge_attention.py:_bwd_parts: at most a warp a destination, at most what an H100 SXM
// holds at once), so which warp sums which destinations' dw_aug terms, and in what order, is the
// same on every card. Where the card holds fewer CTAs at once, the rest wait for a free slot.
// With `per_sm` it launches nothing and reports the CTAs an SM holds (the runtime's occupancy,
// against which a test holds the wrapper's model of it).
template <typename T, int VB, int MAXA2, bool SLOT, int HC, bool FLAT>
int launch_passes(const BwdArgs& x, const Layout& L, cudaStream_t s, int* per_sm = nullptr) {
  const float scale = 1.0f / std::sqrt(static_cast<float>(x.Dt));
  auto dst_kernel = bwd_dst_kernel<T, VB, MAXA2, SLOT, HC, FLAT>;
  int warps = kWarps;
  size_t dst_smem = dst_smem_bytes(x.C, L.G, x.A2, MAXA2, sizeof(T), warps);
  while (dst_smem > kMaxSmem && warps > 1) dst_smem = dst_smem_bytes(x.C, L.G, x.A2, MAXA2, sizeof(T), warps /= 2);
  if (dst_smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int rc = set_smem(dst_kernel, dst_smem);
  if (rc != 0) return rc;
  if (per_sm) return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, dst_kernel, 32 * warps,
                                                                                      dst_smem));
  const int grid = x.parts;
  dst_kernel<<<grid, 32 * warps, dst_smem, s>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.kv), static_cast<const int*>(x.rowptr),
      static_cast<const int*>(x.src), static_cast<const T*>(x.a), static_cast<const T*>(x.w_aug),
      static_cast<const float*>(x.m), static_cast<const float*>(x.g_num), static_cast<const float*>(x.g_den),
      static_cast<const int*>(x.pos), static_cast<float*>(x.dq), static_cast<float*>(x.da),
      static_cast<float*>(x.dlw), static_cast<float*>(x.dw_part), x.batch, x.num_dst, x.num_src, x.num_edges,
      x.C, x.H, L, x.A2, scale);
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

  const int n = x.A2 * x.C;
  dw_reduce_kernel<<<(n + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceRows), 0, s>>>(
      static_cast<const float*>(x.dw_part), static_cast<float*>(x.dw), grid, n);
  return static_cast<int>(cudaGetLastError());
}

// One attribute slot a lane when A2 <= LB lanes a head; the heads of a group compile-time for 4
// on 32 lanes (the flagship's C = 256, and C = 1024 with 16 heads), the whole row one such group
// (C = 32 VB) compile-time too. A head wider than 256 (VB = 16, 32) is a group of its own on 32
// lanes, so A2 <= 8 always takes the slot path, with no compile-time variant.
template <typename T, int VB>
int launch_vb(const BwdArgs& x, cudaStream_t s, int* per_sm) {
  Layout L;
  if (!edge_logit::make_layout<VB>(x.C, x.H, x.G, sizeof(T), &L) || x.Dt <= 0 || x.Dt > L.D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x.A2 > 16) return launch_passes<T, VB, kMaxA2, false, 0, false>(x, L, s, per_sm);
  if (x.A2 > 8) return launch_passes<T, VB, 16, false, 0, false>(x, L, s, per_sm);
  if constexpr (VB <= 8) {
    if (x.A2 > L.LB) return launch_passes<T, VB, 8, false, 0, false>(x, L, s, per_sm);
    if (L.lanes == 32 && L.HG == 4 && L.DV == L.LB) {
      return L.groups == 1 ? launch_passes<T, VB, 8, true, 4, true>(x, L, s, per_sm)
                           : launch_passes<T, VB, 8, true, 4, false>(x, L, s, per_sm);
    }
  }
  return launch_passes<T, VB, 8, true, 0, false>(x, L, s, per_sm);
}

template <typename T>
int launch_bwd(const BwdArgs& x, void* stream, int* per_sm = nullptr) {
  if (x.A2 <= 0 || x.A2 > kMaxA2 || x.num_dst <= 0 || x.batch <= 0 || x.parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x.VB) {
    case 1: return launch_vb<T, 1>(x, s, per_sm);
    case 2: return launch_vb<T, 2>(x, s, per_sm);
    case 4: return launch_vb<T, 4>(x, s, per_sm);
    case 8: return launch_vb<T, 8>(x, s, per_sm);
    case 16: return launch_vb<T, 16>(x, s, per_sm);
    case 32: return launch_vb<T, 32>(x, s, per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

BwdArgs make_args(const void* q, const void* kv, const void* rowptr, const void* src, const void* a,
                  const void* w_aug, const void* m, const void* g_num, const void* g_den, const void* colptr,
                  const void* perm, const void* dst_of, const void* pos, void* dq, void* dkv, void* da,
                  void* dw, void* dlw, void* dw_part, int batch, int num_dst, int num_src,
                  int num_edges, int C, int H, int A2, int G, int VB, int parts, int Dt) {
  return BwdArgs{q,  kv, rowptr, src,  a,    w_aug,   m,     g_num,   g_den,   colptr,    perm, dst_of, pos,
                 dq, dkv, da,    dw,   dlw,  dw_part, batch, num_dst, num_src, num_edges, C, H,
                 A2, G, VB, parts, Dt};
}

}  // namespace

extern "C" {

// G and VB: the lane layout of ops/edge_attention.py:_lane_layout; parts: the rows of dw_part and
// the dst pass's grid (ops/edge_attention.py:_bwd_parts); Dt: the head width C / H had before the
// wrapper padded it
int edge_attn_csr_bwd_f32(const void* q, const void* kv, const void* rowptr, const void* src,
                          const void* a, const void* w_aug, const void* m, const void* g_num,
                          const void* g_den, const void* colptr, const void* perm,
                          const void* dst_of, const void* pos, void* dq, void* dkv, void* da, void* dw,
                          void* dlw, void* dw_part, int batch, int num_dst, int num_src,
                          int num_edges, int C, int H, int A2, int G, int VB, int parts, int Dt, void* stream) {
  return launch_bwd<float>(make_args(q, kv, rowptr, src, a, w_aug, m, g_num, g_den, colptr, perm, dst_of, pos, dq,
                                     dkv, da, dw, dlw, dw_part, batch, num_dst, num_src, num_edges, C, H, A2, G,
                                     VB, parts, Dt),
                           stream);
}

int edge_attn_csr_bwd_bf16(const void* q, const void* kv, const void* rowptr, const void* src,
                           const void* a, const void* w_aug, const void* m, const void* g_num,
                           const void* g_den, const void* colptr, const void* perm,
                           const void* dst_of, const void* pos, void* dq, void* dkv, void* da, void* dw,
                           void* dlw, void* dw_part, int batch, int num_dst, int num_src,
                           int num_edges, int C, int H, int A2, int G, int VB, int parts, int Dt, void* stream) {
  return launch_bwd<__nv_bfloat16>(make_args(q, kv, rowptr, src, a, w_aug, m, g_num, g_den, colptr, perm, dst_of,
                                             pos, dq, dkv, da, dw, dlw, dw_part, batch, num_dst, num_src,
                                             num_edges, C, H, A2, G, VB, parts, Dt),
                                   stream);
}

// The dst pass's CTAs an SM for this shape (the runtime's occupancy); launches nothing.
int edge_attn_csr_bwd_per_sm_f32(int C, int H, int A2, int G, int VB, int* per_sm) {
  BwdArgs x{};
  x.batch = 1, x.num_dst = 1, x.C = C, x.H = H, x.A2 = A2, x.G = G, x.VB = VB, x.parts = 1, x.Dt = H > 0 ? C / H : 0;
  return launch_bwd<float>(x, nullptr, per_sm);
}

int edge_attn_csr_bwd_per_sm_bf16(int C, int H, int A2, int G, int VB, int* per_sm) {
  BwdArgs x{};
  x.batch = 1, x.num_dst = 1, x.C = C, x.H = H, x.A2 = A2, x.G = G, x.VB = VB, x.parts = 1, x.Dt = H > 0 ? C / H : 0;
  return launch_bwd<__nv_bfloat16>(x, nullptr, per_sm);
}

}  // extern "C"
