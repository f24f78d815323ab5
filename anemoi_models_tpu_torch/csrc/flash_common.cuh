// What the band-masked attention kernels of flash_attention.cu (forward) and
// flash_attention_bwd.cu (backward) share: which keys a query sees (the band,
// the causal mask, queries and keys at offsets in a longer sequence) and the
// attention-weight dropout's Philox4x32-10 draw, so that the backward redraws
// the forward's mask bit for bit.
//
// Everything sits in an unnamed namespace: each source that includes this
// header gets its own copies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// attention-weight dropout: on (0 or 1), the keep threshold round((1 - p) 2^32), the Philox key and
// 1 / (1 - p)
struct Dropout {
  int on;
  uint32_t keep_below, k0, k1;
  float rscale;
};

// which keys each query sees, in the key tensor's local indices: query i sits at key position i + delta
// (delta = q_pos0 - k_pos0), and keys [jlo, jhi] are those at global positions [0, n_valid)
struct Band {
  int nq, nk;          // query and key rows
  int delta;           // q_pos0 - k_pos0
  int jlo, jhi;        // the valid keys
  int window, causal;  // window < 0: none
  int q_pos0, k_pos0;  // global positions of row 0 (the dropout counter's)
  int off;             // any of the above off its single-sequence value, or k's strides not q's: the OFF kernels
};

Band make_band(int nq, int nk, int window, int causal, int q_pos0, int k_pos0, int n_valid, const int64_t qs[3],
               const int64_t ks[3]) {
  const int jlo = k_pos0 < 0 ? -k_pos0 : 0;
  const int jend = n_valid - k_pos0 < nk ? n_valid - k_pos0 : nk;
  const int off = q_pos0 != 0 || k_pos0 != 0 || nq != nk || n_valid != nk || qs[0] != ks[0] || qs[1] != ks[1] ||
                  qs[2] != ks[2];
  return Band{nq, nk, q_pos0 - k_pos0, jlo, jend - 1, window, causal, q_pos0, k_pos0, off};
}

// the band a kernel runs: without OFF, the single-sequence values (one length N), known at compile time
template <bool OFF>
__device__ __forceinline__ Band local_band(Band bd) {
  if constexpr (!OFF) {
    bd.delta = bd.jlo = bd.q_pos0 = bd.k_pos0 = 0;
    bd.nk = bd.nq;
    bd.jhi = bd.nq - 1;
  }
  return bd;
}

// [lo, hi]: the keys query rows [qa, qb] can see (hi < lo: none)
__device__ __forceinline__ void key_range(const Band& bd, int qa, int qb, int& lo, int& hi) {
  lo = bd.jlo;
  hi = bd.jhi;
  if (bd.window >= 0) {
    lo = max(lo, qa + bd.delta - bd.window);
    hi = min(hi, qb + bd.delta + bd.window);
  }
  if (bd.causal) hi = min(hi, qb + bd.delta);
}

// whether query row i sees key j: live (the pair in range) and in the band (window and causal mask)
__device__ __forceinline__ bool in_band(const Band& bd, int i, int j, bool live) {
  if (bd.window >= 0) live = live && abs(i + bd.delta - j) <= bd.window;
  if (bd.causal) live = live && j <= i + bd.delta;
  return live;
}

// whether key j is valid: without OFF, below N, the single-sequence kernels' test
template <bool OFF>
__device__ __forceinline__ bool valid_key(const Band& bd, int j) {
  return OFF ? j >= bd.jlo && j <= bd.jhi : j < bd.nk;
}

// Philox4x32-10 (Salmon et al., SC 2011): ten rounds of two 32 x 32 -> 64-bit products, the key
// bumped by the Weyl constants between rounds
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// whether pair (i, j) of head bh survives
__device__ __forceinline__ bool keep(const Dropout& dp, int bh, int i, int j) {
  const uint4 u = philox4x32_10(make_uint4(static_cast<uint32_t>(j) >> 2, i, bh, 0), dp.k0, dp.k1);
  return word(u, j & 3) < dp.keep_below;
}

}  // namespace
