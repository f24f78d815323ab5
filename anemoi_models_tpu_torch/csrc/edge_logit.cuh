// Shared pieces of the GraphTransformer edge-attention kernels
// (edge_attention.cu, the forward; edge_attention_bwd.cu, the backward).
//
// Both kernels walk a destination's edges with one warp on one head group
// (the lane layout of ops/edge_attention.py:_lane_layout): a group of G
// channels of whole heads, lane l owning channels [l VB, l VB + VB) of the
// group, a head spanning LB = D / VB lanes. The backward recomputes the
// forward's logit and has to get the same bits, so the logit's arithmetic
// lives here once:
//
//   the edge term   ev[c] = sum_r a_r w_aug[r, c], one fmaf chain a channel in
//                   r order (rows past A2 are zero: a zero term changes at most
//                   the sign of an exact zero);
//   the dot         <q, k + ev>_h as the first edge kernel summed it: a thread
//                   of VF = max(1, D / 32) channels ran one fmaf chain, then an
//                   xor shuffle tree over the head's threads, highest level
//                   first. A lane holds P = VB / VF such chains and runs the
//                   tree's upper levels across lanes, its lower ones inside.
//                   Where D is not a power of two (no first kernel ran it),
//                   VF = VB: one chain a lane, then the tree over the lanes.
//
// A head of D channels spans LB lanes, D / VB rounded up to a power of two:
// where D is not a power of two (D = 48, 96, 192, ...), the lanes past D / VB
// pad the head, owning no channel and adding zeros to every sum over it.
//
// Plus the row and copy helpers both kernels use: rows move into shared memory
// by cp.async, each lane copying its own VB values where they are whole
// 16-byte copies, else the whole warp 16 bytes a lane, and each lane reads its
// own VB values back.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edge_logit {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;  // the m of a destination with no edge

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// N consecutive values of T held as raw words: one load of 2, 4, 8 or 16
// bytes, or several 16-byte loads, converted to fp32 where used.
template <typename T, int N>
struct Row {
  static constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes == 2 || kBytes == 4 || kBytes == 8 || kBytes % 16 == 0, "a row chunk is 2, 4, 8 or 16n bytes");
  uint32_t w[kBytes < 4 ? 1 : kBytes / 4];

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
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  __device__ __forceinline__ void load_shared(const uint8_t* p) {
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
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const unsigned int*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
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
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    static_assert(N == 1, "a lane stores 1, 2 or 4n floats");
    *p = v[0];
  }
}

__device__ __forceinline__ void copy16_async(uint8_t* dst, const uint8_t* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async of `bytes` (a multiple of 16, both ends 16-byte aligned) by the whole
// warp, 16 bytes a lane at a time. Before a lane reads what another copied:
// copy_wait, then __syncwarp.
__device__ __forceinline__ void warp_copy_async(uint8_t* dst, const void* src, int bytes, int lane) {
  for (int i = 16 * lane; i < bytes; i += 16 * 32) copy16_async(dst + i, static_cast<const uint8_t*>(src) + i);
}

// cp.async of a slice of `bytes` whose lanes own kChunk bytes each, the lane's
// at byte `own`. Where a chunk is whole 16-byte copies every lane copies its
// own chunk and reads only what it copied (no __syncwarp needed: an idle lane
// shadowing another copies that lane's chunk again, the same bytes); else the
// whole warp copies the slice (warp_copy_async) and slice_sync() orders it.
template <int kChunk>
__device__ __forceinline__ void slice_copy_async(uint8_t* dst, const void* src, int own, int bytes, int lane) {
  if constexpr (kChunk % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kChunk; i += 16) copy16_async(dst + own + i, static_cast<const uint8_t*>(src) + own + i);
  } else {
    warp_copy_async(dst, src, bytes, lane);
  }
}

template <int kChunk>
__device__ __forceinline__ void slice_sync() {
  if constexpr (kChunk % 16 != 0) __syncwarp();
}

// the sum over the `lanes` lanes of an aligned group (a head), every lane
// getting the same bits
__device__ __forceinline__ float group_sum(float s, int lanes) {
#pragma unroll
  for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// ev[c] = sum_r a_r w[r, c] for this lane's VB channels, one fmaf chain a
// channel in r order; w points at the lane's channels of row 0 in shared
// memory, rows `stride` values apart.
template <typename T, int VB, int MAXA2>
__device__ __forceinline__ void edge_term(float* ev, const float* ar, const T* w, int stride) {
#pragma unroll
  for (int c = 0; c < VB; ++c) ev[c] = 0.f;
#pragma unroll
  for (int r = 0; r < MAXA2; ++r) {
    Row<T, VB> wv;
    wv.load_shared(reinterpret_cast<const uint8_t*>(w + r * stride));
#pragma unroll
    for (int c = 0; c < VB; ++c) ev[c] = fmaf(ar[r], wv[c], ev[c]);
  }
}

// <q, k + ev> over the head, exactly as the first edge kernel summed it (see
// the top of this file); LB lanes a head.
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
  if constexpr (VB >= 16) {  // a head wider than 256: one chain a lane
    if (vf == VB) return exact_dot<T, VB, VB>(qv, kr, ev, LB);
  }
  if constexpr (VB >= 8) {
    if (vf == 8) return exact_dot<T, VB, 8>(qv, kr, ev, LB);
  }
  if constexpr (VB >= 4) {
    if (vf == 4) return exact_dot<T, VB, 4>(qv, kr, ev, LB);
  }
  if constexpr (VB >= 2) {
    if (vf == 2) return exact_dot<T, VB, 2>(qv, kr, ev, LB);
  }
  return exact_dot<T, VB, 1>(qv, kr, ev, LB);
}

// Where a layout's runtime values must agree with the compile-time ones.
struct Layout {
  int G;      // channels of a head group
  int lanes;  // lanes of the group: HG LB (the padded lanes included)
  int D;      // channels of a head
  int LB;     // lanes of a head: D / VB rounded up to a power of two
  int DV;     // lanes of a head that own channels: D / VB (DV < LB pads the head)
  int HG;     // heads of a group
  int groups; // C / G
  int vf;     // channels of one fmaf chain of the dot: max(1, D / 32) for a power-of-two D
              // (the first kernel's threads), else VB
};

// The layout of (C, H) with group width G, checked: D at most 1024, a power
// of two or a multiple of 8, that VB divides; a group of whole heads, each on
// LB lanes (a power of two: the shuffle trees run over it; its lanes past DV
// own no channel and add zeros), HG LB <= 32 lanes in all, so VF divides VB
// (a head wider than 256 is a group of its own on 32 lanes of VB = 16 or 32
// channels, one chain a lane); and a group's rows 16-byte multiples. Returns
// false where the kernels cannot run it. A head width that no layout takes is
// padded with zero channels by the wrapper (ops/edge_attention.py:_kernel_head).
template <int VB>
inline bool make_layout(int C, int H, int G, int item, Layout* out) {
  if (H <= 0 || G <= 0 || C % H != 0 || C % G != 0) return false;
  const int D = C / H;
  const bool pow2 = (D & (D - 1)) == 0;
  if (D > 1024 || !(pow2 || D % 8 == 0) || D % VB != 0 || G % D != 0 || (G * item) % 16 != 0) return false;
  const int DV = D / VB;
  int LB = 1;
  while (LB < DV) LB *= 2;
  if ((G / D) * LB > 32) return false;
  *out = Layout{G, (G / D) * LB, D, LB, DV, G / D, C / G, pow2 ? (D > 32 ? D / 32 : 1) : VB};
  return true;
}

// Lane ll's first channel within its group and whether it owns channels: lane
// j of head h (j = ll % LB) owns [h D + j VB, h D + j VB + VB) for j < DV; a
// padding lane (j >= DV) reads its head's first channels and must add zeros.
__device__ __forceinline__ int lane_channel(int ll, int LB, int DV, int D, int VB, bool* owns) {
  const int j = ll % LB;
  *owns = j < DV;
  return (ll / LB) * D + (j < DV ? j : 0) * VB;
}

}  // namespace edge_logit
