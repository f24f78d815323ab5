// Shared pieces of the GraphTransformer edge-attention kernels
// (edge_attention.cu, the forward; edge_attention_bwd.cu, the backward).
//
// Both kernels walk a destination's edges with one warp on one head group
// (the lane layout of ops/edge_attention.py:_lane_layout): a group of G
// channels of whole heads, lane l owning channels [l VB, l VB + VB) of the
// group, a head spanning LB = D / VB lanes. The backward recomputes the
// forward's logit and has to get the same bits, so the logit's arithmetic
// lives here once, in the factored form of the edge term (below):
//
//   the factors     qw[r, h] = <q, w_aug[r]>_h, once a destination: a lane's
//                   fma chain over its channels, then the sum over the head;
//   the edge term   sum_r a_r qw[r, h], by (edge, head) pair: four fma chains
//                   a chunk of attributes (chunk_dot), the chunks added in order;
//   the logit       (the head's sum of a lane's fmaf chain q . k) + the edge
//                   term, rounded to fp32, times 1 / sqrt(D);
// the factors and the edge term in wide_t<T> (fp64 for fp32 operands).
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

#include <type_traits>

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

// The edge term, factored (a_r attribute r of the edge, w_r row r of w_aug,
// <.,.>_h a dot over head h's channels):
//   <q, k + a.w_aug>_h = <q, k>_h + sum_r a_r <q, w_r>_h,
// so a destination's per-head factors <x, w_r>_h are taken once (x = q, or
// g_num in the backward) and an edge needs A2 products a head. The attributes
// stream in chunks of attr_chunk rows, whose factors a warp keeps in its
// shared memory (kAttrBytes at most), so A2 is bounded by nothing but device
// memory. The factors and the sums over attributes accumulate in wide_t<T>:
// fp64 for fp32 operands, whose sums over many attributes would otherwise
// round at the level of the fp32 bound a kernel is held to (a plain fp32
// version of the same function is itself that far from the exact value at
// 64 attributes of unit scale); fp32 for bf16 ones.
constexpr int kAttrBytes = 4096;  // the factors of one chunk a warp: rows x heads of the group

template <typename T>
struct Wide {
  using type = float;
};
template <>
struct Wide<float> {
  using type = double;
};
template <typename T>
using wide_t = typename Wide<T>::type;

template <typename A>
__device__ __forceinline__ A fma_as(A a, A b, A c) {
  if constexpr (std::is_same_v<A, double>) {
    return fma(a, b, c);
  } else {
    return fmaf(a, b, c);
  }
}

// the attribute rows of a chunk: as many as fit kAttrBytes of factors of acc_bytes each for HG heads
__host__ __device__ __forceinline__ int attr_chunk(int A2, int HG, int acc_bytes) {
  const int rows = kAttrBytes / (acc_bytes * HG) > 0 ? kAttrBytes / (acc_bytes * HG) : 1;
  return A2 < rows ? A2 : rows;
}

// the sum over the head's LB lanes in A (every lane of the head gets the same bits)
template <typename A>
__device__ __forceinline__ A group_sum(A s, int lanes) {
#pragma unroll
  for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// <x, row>_h in A: one fma chain over the lane's VB channels, then the sum over the head's lanes
template <typename A, typename T, int VB>
__device__ __forceinline__ A head_dot(const float* xv, const Row<T, VB>& row, int LB) {
  A s = 0;
#pragma unroll
  for (int c = 0; c < VB; ++c) s = fma_as<A>(xv[c], row[c], s);
  return group_sum<A>(s, LB);
}

// out0[(r - r0) HG + h] = <x0, w_r>_h (and out1 of x1 where TWO) for rows r0 .. r0 + rn - 1 of
// w_aug, in wide_t<T>, x0 and x1 the lane's VB channels (zeros on a lane that pads its head); w
// points at the lane's channels of row 0 in device memory, rows C apart. Written by each head's
// first lane.
template <typename T, int VB, bool TWO>
__device__ __forceinline__ void head_factors(wide_t<T>* out0, wide_t<T>* out1, const float* x0, const float* x1,
                                             const T* w, int C, int r0, int rn, int LB, int HG, int hl,
                                             bool lead) {
  using A = wide_t<T>;
#pragma unroll 4
  for (int i = 0; i < rn; ++i) {
    Row<T, VB> wv;
    wv.load(w + static_cast<int64_t>(r0 + i) * C);
    const A p0 = head_dot<A, T, VB>(x0, wv, LB);
    if (lead) out0[i * HG + hl] = p0;
    if constexpr (TWO) {
      const A p1 = head_dot<A, T, VB>(x1, wv, LB);
      if (lead) out1[i * HG + hl] = p1;
    }
  }
}

// sum_i a_i f_i over a chunk of rn attributes in A: four fma chains (attributes i = j mod 4),
// summed pairwise
template <typename A, typename T>
__device__ __forceinline__ A chunk_dot(const T* ar, const A* f, int HG, int rn) {
  A x[4] = {0, 0, 0, 0};
  int i = 0;
  for (; i + 4 <= rn; i += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = fma_as<A>(to_f(ar[i + j]), f[(i + j) * HG], x[j]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (i + j < rn) x[j] = fma_as<A>(to_f(ar[i + j]), f[(i + j) * HG], x[j]);
  return (x[0] + x[1]) + (x[2] + x[3]);
}

// The edge terms of a batch of cnt edges (edge base + n), by (edge, head) pair p = n HG + h over
// the warp's lanes: out0[p] (+)= sum_i a[base + n, r0 + i] f0[i HG + h], i < rn (and out1 of f1
// where TWO), a chunk_dot a pair and chunk, added to the earlier chunks' (add) in chunk order.
template <typename T, bool TWO>
__device__ __forceinline__ void edge_terms(wide_t<T>* out0, wide_t<T>* out1, const wide_t<T>* f0,
                                           const wide_t<T>* f1, const T* a, int A2, int base, int cnt, int HG,
                                           int r0, int rn, bool add, int lane) {
  using A = wide_t<T>;
  for (int p = lane; p < cnt * HG; p += 32) {
    const int n = p / HG, h = p - n * HG;
    const T* ar = a + static_cast<int64_t>(base + n) * A2 + r0;
    const A x0 = chunk_dot<A, T>(ar, f0 + h, HG, rn);
    out0[p] = add ? out0[p] + x0 : x0;
    if constexpr (TWO) {
      const A x1 = chunk_dot<A, T>(ar, f1 + h, HG, rn);
      out1[p] = add ? out1[p] + x1 : x1;
    }
  }
}

// The logit's sum before the scale, as both kernels take it: <q, k>_h in fp32 (a lane's chain,
// then the head's lanes), plus the edge's term in wide_t<T>, rounded once to fp32
template <typename T, int VB>
__device__ __forceinline__ float logit_sum(const float* qv, const Row<T, VB>& kr, wide_t<T> term, int LB) {
  return static_cast<float>(static_cast<wide_t<T>>(head_dot<float, T, VB>(qv, kr, LB)) + term);
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
};

// The layout of (C, H) with group width G, checked: D at most 1024, a power
// of two or a multiple of 8, that VB divides; a group of whole heads, each on
// LB lanes (a power of two: the shuffle trees run over it; its lanes past DV
// own no channel and add zeros), HG LB <= 32 lanes in all (a head wider than
// 256 is a group of its own on 32 lanes of VB = 16 or 32 channels); and a
// group's rows 16-byte multiples. Returns
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
  *out = Layout{G, (G / D) * LB, D, LB, DV, G / D, C / G};
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
