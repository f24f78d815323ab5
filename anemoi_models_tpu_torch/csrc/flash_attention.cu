// Hopper (sm_90a) kernels for band-masked (sliding-window) flash attention.
//
// Replaces anemoi_models_tpu/ops/pallas/flash_attention.py:_flash_kernel, the
// TPU kernel of the Transformer processor flavor: per (batch*head, q-block) a
// sequential grid axis walked the k-blocks of the window with an online
// softmax in VMEM scratch. On Hopper the CTAs run in parallel and in no order,
// so the k-loop is a loop inside the CTA. Both kernels walk only the key
// blocks that intersect [q0 - w, q1 - 1 + w] (every block when there is no
// window; none past q1 - 1 when causal), mask |i - j| <= w, j <= i (causal)
// and the ragged end of the sequence, and keep the running max m, sum l and
// output rows in fp32 registers. Masked logits count as -1e30 with zero
// weight; the output is acc / max(l, 1e-30), as the TPU kernel divides.
//
// flash_attn_bf16_kernel (bf16, head widths 16, 32, 64, 128, 256 and 512;
// the wrapper pads any other head width up to 512 with zero channels), in the
// style of FlashAttention-3, specialised by warp:
//   - one CTA per (128 queries, batch*head): warps 0-7 are two consumer
//     warpgroups of 64 query rows each, warp 8 the producer;
//   - the producer's lane 0 copies the CTA's Q tile once and the K and V tiles
//     of each key block into a ring of stages by TMA (4-D tensor maps over the
//     strided (batch, head, position, channel) views: q, k and v may be the
//     column blocks of one fused projection), each stage guarded by a "full"
//     mbarrier (bytes landed) and an "empty" one (all 256 consumer threads
//     done with it);
//   - S = Q . K^T by wgmma.mma_async m64nBNk16 from shared memory (128-, 64-
//     or 32-byte swizzle, the TMA's), the fp32 accumulator in registers;
//   - the online softmax runs in the accumulator's register layout (each row
//     lives on the four lanes of a quad), with exp2 and scale * log2(e)
//     folded into one fmaf; only blocks that straddle the band's edges, the
//     causal diagonal or the ragged end evaluate the mask, interior blocks
//     take none, and blocks outside a warpgroup's band are skipped;
//   - P is rounded to bf16 in registers and fed to O += P . V as the register
//     A operand of wgmma (the accumulator layout is the A-fragment layout), V
//     read MN-major from its row-major tile (imm-trans-b); O stays in
//     registers and is rescaled there;
//   - the output goes through a padded shared-memory tile and out in 16-byte
//     stores (D <= 128; at D = 256 the tile would not fit beside the ring,
//     and the registers are stored directly).
// Key blocks are 128 wide (64 for D = 128 and 32 for D >= 256, where S, O and
// P would not fit a thread's registers), 3 stages (2 for D = 128 and 512). At
// D = 256 O = P . V runs as two m64n128 products over the halves of V's
// columns. At D = 512 a CTA takes 64 queries and its two warpgroups split D:
// each reduces Q . K^T over its half of the channels, the two partial S tiles
// are summed through shared memory (a + b == b + a: both get the same S and
// the same softmax), and each computes P . V for its half of V's columns.
//
// flash_attn_f32_kernel (fp32, head widths 16, 32, 64, 128; the wrapper pads
// the others up to 128): exact fp32 on the CUDA cores, one CTA per 64
// queries and (batch*head), two lanes a query row, K and V staged through
// shared memory one block at a time.
//
// flash_attn_rows_kernel (either dtype, head widths above the two kernels'
// above: 129-1024 in fp32, 513-1024 in bf16), a first plain design: a warp
// per R consecutive query rows, a lane per D / 32 channels (strided by 32,
// so a row loads coalesced), every key of the rows' band read once per warp
// (from L2), the dot summed across the warp by shuffles, the same online
// softmax in fp32. The shuffle chain of each (row, key) bounds it: staging
// the band in shared memory for a CTA's rows gained nothing on an H100.
//
// Queries and keys at offsets (every kernel): q holds Nq rows at global positions q_pos0, q_pos0 + 1, ...
// and k, v hold Nk rows at k_pos0, ...; query i attends key j where |(q_pos0 + i) - (k_pos0 + j)| <= w,
// k_pos0 + j <= q_pos0 + i when causal, and 0 <= k_pos0 + j < n_valid. So a rank of a sequence split over
// ranks runs its own query rows against its halo-extended keys (or every key), and its output rows are the
// unsharded call's. A query tile walks only the key tiles its band reaches, in the key tensor's indices; a
// query that sees no key gets 0. Offsets are a template parameter (OFF) of each kernel: with the defaults
// (q_pos0 = k_pos0 = 0, Nq = Nk = n_valid = N, and k, v at q's strides) every field of the band takes its
// single-sequence value at compile time and k, v are read at q's strides, so the kernels keep the code and
// bits they had before offsets.
//
// Attention-weight dropout (every kernel): the JAX package drops normalized
// probabilities, out_i = sum_j keep_ij p_ij v_j / ((1 - p) l_i), with l_i the
// sum of every p_ij, the dropped pairs' included. So the online softmax keeps
// l undropped, P . V takes keep_ij p_ij, and the epilogue scales by
// 1 / (1 - p). keep_ij is a pure function of the call's 64-bit key and of
// (b h, i, j) at global positions: word j % 4 of Philox4x32-10 at counter (j / 4, i, b H + h, 0),
// kept where it is below round((1 - p) 2^32) (ops/flash_attention.py:
// dropout_keep draws the same bits in torch), so a sharded call drops the pairs the unsharded one drops.
// The bf16 kernel draws one Philox for four registers; it lays its key tiles at global multiples of 4
// (a TMA box may start at a negative row, which it fills with zeros). Dropout is a template
// parameter of each kernel: without it none of its code is compiled in, and
// the kernels keep their earlier code and bits.
//
// Bound on the H100: operations. At O96 (B*H = 4, N = 10,242, D = 64,
// w = 512) about 1,025 keys per query live in the band: 4 * B*H * N * 1,025 *
// D = 10.7 GFLOP per layer, 0.011 ms at the bf16 tensor-core peak, against
// 21 MB of q, k, v and o (0.006 ms).
//
// Every entry point has a plain C interface, launches on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"  // the band, Philox dropout
#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

template <int D>
struct Flash {
  static constexpr bool kSplit = D > 256;           // both warpgroups on one 64-row tile, D split between them
  static constexpr int kDW = kSplit ? D / 2 : D;    // channels a warpgroup reduces Q . K^T over and outputs
  static constexpr int kBM = kSplit ? 64 : 128;     // queries per CTA
  static constexpr int kBN = D <= 64 ? 128 : D <= 128 ? 64 : 32;  // keys per block
  static constexpr int kStages = D == 128 || kSplit ? 2 : 3;
  static constexpr int kSw = D >= 64 ? 128 : 2 * D;  // swizzle bytes = bytes of a box row
  static constexpr int kBoxCols = kSw / 2;           // bf16 columns per TMA box
  static constexpr int kBoxes = D / kBoxCols;        // boxes across D (2 for D = 128)
  static constexpr int kConsumers = 256;             // two warpgroups
  static constexpr int kThreads = kConsumers + 32;   // and the producer warp
  static constexpr int kQBox = kBM * kSw;            // bytes of one Q box
  static constexpr int kKVBox = kBN * kSw;           // bytes of one K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;   // one K (or V) tile
  static constexpr int kStage = 2 * kKVBytes;
  static constexpr int kLdO = D + 8;                 // padded output rows (bf16)
  static constexpr bool kOTile = D <= 128;           // the output through shared memory
  static constexpr int kOOff = kQBytes + kStages * kStage;
  static constexpr int kXOff = kOOff + (kOTile ? kBM * kLdO * 2 : 0);  // kSplit: the partial S exchange
  static constexpr int kBarOff = kXOff + (kSplit ? 2 * kConsumers * (kBN / 2) * 4 : 0);
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (2 * kStages + 1);
};

struct FlashMaps {
  CUtensorMap q, k, v;  // (D, N, H, B) bf16, boxes of kBoxCols x rows
};

template <int D, bool DROP, bool OFF>
__global__ void __launch_bounds__(Flash<D>::kThreads, 1)
flash_attn_bf16_kernel(const __grid_constant__ FlashMaps maps, bf16* __restrict__ o, int H, int64_t ob, int64_t oh,
                       int64_t on, Band band, float scale, Dropout dp, float* __restrict__ lse) {
  using F = Flash<D>;
  const Band bd = local_band<OFF>(band);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::kBarOff);
  uint64_t* empty = full + F::kStages;
  uint64_t* qbar = empty + F::kStages;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * F::kBM;
  const int bh = blockIdx.y;
  const int bidx = bh / H, hidx = bh % H;

  // the keys this CTA can see, in key tiles laid at global multiples of 4 under dropout (a Philox counter
  // then covers four keys of one tile): tile t holds keys [t kBN - a, (t + 1) kBN - a)
  int lo, hi;
  key_range(bd, q0, min(q0 + F::kBM, bd.nq) - 1, lo, hi);
  const int a = DROP && OFF ? (bd.k_pos0 & 3) : 0;
  const int kb0 = (lo + a) / F::kBN;
  const int nblocks = OFF && hi < lo ? 0 : (hi + a) / F::kBN - kb0 + 1;  // without OFF a row sees a key

  if (tid == 0) {
    for (int s = 0; s < F::kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, F::kConsumers);
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= F::kConsumers) {  // the producer warp: lane 0 issues every copy
    if (tid == F::kConsumers) {
      sm90::mbar_expect_tx(qbar, F::kQBytes);
      for (int x = 0; x < F::kBoxes; ++x)
        sm90::tma_load_4d(smem + x * F::kQBox, &maps.q, qbar, x * F::kBoxCols, q0, hidx, bidx);
      for (int i = 0; i < nblocks; ++i) {
        const int s = i % F::kStages;
        if (i >= F::kStages) sm90::mbar_wait(empty + s, ((i / F::kStages) - 1) & 1);
        uint8_t* stage = smem + F::kQBytes + s * F::kStage;
        const int k0 = (kb0 + i) * F::kBN - a;
        sm90::mbar_expect_tx(full + s, F::kStage);
        for (int x = 0; x < F::kBoxes; ++x) {
          sm90::tma_load_4d(stage + x * F::kKVBox, &maps.k, full + s, x * F::kBoxCols, k0, hidx, bidx);
          sm90::tma_load_4d(stage + F::kKVBytes + x * F::kKVBox, &maps.v, full + s, x * F::kBoxCols, k0, hidx,
                            bidx);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = t % 32;
  const int r0 = q0 + (F::kSplit ? 0 : 64 * wg);           // the warpgroup's first row
  const int rowa = r0 + 16 * (t / 32) + lane / 4;           // this thread's rows: rowa, rowa + 8
  const float sl2 = scale * kLog2e;

  constexpr int kS = F::kBN / 2;     // S accumulator registers
  constexpr int kO = F::kDW / 2;     // O accumulator registers
  const int c0 = F::kSplit ? wg * F::kDW : 0;  // the warpgroup's first channel of Q . K^T and of O
  float sacc[kS], oacc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) oacc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  const uint8_t* q_tile = smem + (F::kSplit ? 0 : 64 * wg * F::kSw);  // this warpgroup's rows of box 0
  int exchanges = 0;  // kSplit: partial S tiles exchanged so far
  sm90::mbar_wait(qbar, 0);

  for (int i = 0; i < nblocks; ++i) {
    const int s = i % F::kStages;
    const uint8_t* k_tile = smem + F::kQBytes + s * F::kStage;
    const uint8_t* v_tile = k_tile + F::kKVBytes;
    const int k0 = (kb0 + i) * F::kBN - a;
    const int k1 = k0 + F::kBN - 1;
    // what this warpgroup's 64 rows (at key positions rk ... rk + 63) need of the block
    const int rk = r0 + bd.delta;
    bool dead = r0 >= bd.nq;
    bool masked = k1 > bd.jhi;
    if constexpr (OFF) {
      dead = dead || k1 < bd.jlo || k0 > bd.jhi;
      masked = masked || k0 < bd.jlo;
    }
    if (bd.window >= 0) {
      dead = dead || k0 > rk + 63 + bd.window || k1 < rk - bd.window;
      masked = masked || k1 - rk > bd.window || rk + 63 - k0 > bd.window;
    }
    if (bd.causal) {
      dead = dead || k0 > rk + 63;
      masked = masked || k1 > rk;
    }
    sm90::mbar_wait(full + s, (i / F::kStages) & 1);
    if (!dead) {
      // S = Q . K^T
      sm90::fence_regs<kS>(sacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::kDW / 16; ++kk) {
        const int box = (c0 + kk * 16) / F::kBoxCols;
        const int off = ((c0 + kk * 16) % F::kBoxCols) * 2;
        sm90::Wgmma<F::kBN>::mma(sacc, sm90::make_desc<F::kSw>(q_tile + box * F::kQBox + off),
                                 sm90::make_desc<F::kSw>(k_tile + box * F::kKVBox + off), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs<kS>(sacc);
      if constexpr (F::kSplit) {
        // S = the two warpgroups' partial sums over their halves of D, through shared memory: thread t of
        // each holds the same (row, key) in register r; a + b == b + a, so both get the same bits.
        // Two buffers by the parity of the exchanges (both warpgroups skip the same blocks): a warpgroup
        // writes the next exchange's while the other still reads this one's.
        float* xs = reinterpret_cast<float*>(smem + F::kXOff) + (exchanges++ & 1) * F::kConsumers * kS;
#pragma unroll
        for (int r = 0; r < kS; ++r) xs[(wg * kS + r) * 128 + t] = sacc[r];
        sm90::named_barrier(3, F::kConsumers);
#pragma unroll
        for (int r = 0; r < kS; ++r) sacc[r] += xs[((1 - wg) * kS + r) * 128 + t];
      }

      // register r: row rowa + 8 ((r / 2) % 2), key k0 + 8 (r / 4) + 2 (lane % 4) + r % 2
      if (masked) {
#pragma unroll
        for (int r = 0; r < kS; ++r) {
          const int qi = rowa + 8 * ((r / 2) % 2);
          const int kj = k0 + 8 * (r / 4) + 2 * (lane % 4) + (r % 2);
          if (!in_band(bd, qi, kj, valid_key<OFF>(bd, kj))) sacc[r] = kNeg;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int r = 0; r < kS; ++r) mx[(r / 2) % 2] = fmaxf(mx[(r / 2) % 2], sacc[r]);
      float corr[2], msc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f((m[h] - mx[h]) * sl2);
        msc[h] = mx[h] * sl2;
        m[h] = mx[h];
      }
      uint32_t pf[F::kBN / 16][4];  // P in bf16, as the A fragments of P . V
      float ls[2] = {0.f, 0.f};
      // dropout: registers r, r + 1 (row h = 0) and r + 2, r + 3 (h = 1) hold keys kj, kj + 1 of one Philox
      // counter, (k_pos0 + kj) / 4, which lanes 2m and 2m + 1 share (the tiles sit at global multiples of 4 and
      // their kj differ by 2): the even lane draws row h = 0's four words, the odd lane row h = 1's, and they
      // swap, so a lane draws one Philox for four registers
      uint64_t kept = 0;  // bit r: register r's pair survives
      if constexpr (DROP) {
#pragma unroll
        for (int r = 0; r < kS; r += 4) {
          const int kj = bd.k_pos0 + k0 + 8 * (r / 4) + 2 * (lane % 4);  // global
          const int odd = lane & 1;
          const uint4 mine = philox4x32_10(
              make_uint4(static_cast<uint32_t>(kj) >> 2, bd.q_pos0 + rowa + 8 * odd, bh, 0), dp.k0, dp.k1);
          const uint4 theirs = make_uint4(__shfl_xor_sync(0xffffffffu, mine.x, 1), __shfl_xor_sync(0xffffffffu, mine.y, 1),
                                          __shfl_xor_sync(0xffffffffu, mine.z, 1), __shfl_xor_sync(0xffffffffu, mine.w, 1));
          const uint4 u0 = odd ? theirs : mine, u1 = odd ? mine : theirs;
          const int w = kj & 3;
          kept |= static_cast<uint64_t>(word(u0, w) < dp.keep_below) << r;
          kept |= static_cast<uint64_t>(word(u0, w + 1) < dp.keep_below) << (r + 1);
          kept |= static_cast<uint64_t>(word(u1, w) < dp.keep_below) << (r + 2);
          kept |= static_cast<uint64_t>(word(u1, w + 1) < dp.keep_below) << (r + 3);
        }
      }
#pragma unroll
      for (int r = 0; r < kS; r += 2) {
        const int h = (r / 2) % 2;
        float p0 = exp2f(fmaf(sacc[r], sl2, -msc[h]));
        float p1 = exp2f(fmaf(sacc[r + 1], sl2, -msc[h]));
        if (masked) {
          p0 = sacc[r] > 0.5f * kNeg ? p0 : 0.f;
          p1 = sacc[r + 1] > 0.5f * kNeg ? p1 : 0.f;
        }
        ls[h] += p0 + p1;  // the normalizer sums every pair, dropped or not
        if constexpr (DROP) {
          p0 = (kept >> r) & 1 ? p0 : 0.f;
          p1 = (kept >> (r + 1)) & 1 ? p1 : 0.f;
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
        pf[r / 8][(r % 8) / 2] = *reinterpret_cast<const uint32_t*>(&pair);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], corr[h], ls[h]);
#pragma unroll
      for (int r = 0; r < kO; ++r) oacc[r] *= corr[(r / 2) % 2];

      // O += P . V, V MN-major
      sm90::fence_regs<kO>(oacc);
      sm90::wgmma_fence();
      if constexpr (D <= 128) {
#pragma unroll
        for (int kk = 0; kk < F::kBN / 16; ++kk)
          sm90::WgmmaRS<D>::mma(oacc, pf[kk], sm90::make_desc_mn_bits(v_tile + kk * 16 * F::kSw, F::kSw, F::kKVBox),
                                1);
      } else {  // halves of the warpgroup's V columns, two boxes each: registers 64 hf + r hold columns
                // c0 + 128 hf + ...
#pragma unroll
        for (int hf = 0; hf < F::kDW / 128; ++hf) {
#pragma unroll
          for (int kk = 0; kk < F::kBN / 16; ++kk)
            sm90::WgmmaRS<128>::mma(oacc + 64 * hf, pf[kk],
                                    sm90::make_desc_mn_bits(v_tile + (c0 / F::kBoxCols + hf * 2) * F::kKVBox +
                                                                kk * 16 * F::kSw,
                                                            F::kSw, F::kKVBox),
                                    1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs<kO>(oacc);
    }
    sm90::mbar_arrive(empty + s);
  }

  // epilogue: O / max(l, 1e-30) in bf16 through a padded shared tile, out in 16-byte stores
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[h] = 1.f / fmaxf(lt, 1e-30f);
    if constexpr (DROP) inv[h] *= dp.rscale;
    const int row = rowa + 8 * h;  // the row statistics, where asked: one lane of the quad, one warpgroup at D = 512
    if (lse != nullptr && lane % 4 == 0 && (!F::kSplit || wg == 0) && row < bd.nq)
      lse[(int64_t)bh * bd.nq + row] = lt > 0.f ? m[h] * scale + logf(lt) : __int_as_float(0x7f800000);
  }
  bf16* out = o + (int64_t)bidx * ob + (int64_t)hidx * oh;
  const int orow = 16 * (t / 32) + lane / 4;
  if constexpr (!F::kOTile) {  // straight from the registers: two bf16 a store
#pragma unroll
    for (int r = 0; r < kO; r += 2) {
      const int h = (r / 2) % 2;
      const int row = r0 + orow + 8 * h;
      if (row < bd.nq)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * on + c0 + 8 * (r / 4) + 2 * (lane % 4)) =
            __floats2bfloat162_rn(oacc[r] * inv[h], oacc[r + 1] * inv[h]);
    }
    return;
  }
  bf16* otile = reinterpret_cast<bf16*>(smem + F::kOOff) + 64 * wg * F::kLdO;
#pragma unroll
  for (int r = 0; r < kO; r += 2) {
    const int h = (r / 2) % 2;
    const int col = 8 * (r / 4) + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(otile + (orow + 8 * h) * F::kLdO + col) =
        __floats2bfloat162_rn(oacc[r] * inv[h], oacc[r + 1] * inv[h]);
  }
  sm90::named_barrier(1 + wg, 128);
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = t; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    if (r0 + r < bd.nq)
      *reinterpret_cast<int4*>(out + (int64_t)(r0 + r) * on + c) =
          *reinterpret_cast<const int4*>(otile + r * F::kLdO + c);
  }
}

// a kernel without dropout compiles none of its code
template <int D, bool DROP, bool OFF>
int launch_bf16_kernel(dim3 grid, const FlashMaps& maps, void* o, int H, int64_t ob, int64_t oh, int64_t on,
                       const Band& bd, float scale, const Dropout& dp, float* lse, cudaStream_t stream) {
  using F = Flash<D>;
  auto kernel = flash_attn_bf16_kernel<D, DROP, OFF>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(F::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, F::kThreads, F::kSmem, stream>>>(maps, static_cast<bf16*>(o), H, ob, oh, on, bd, scale, dp, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_flash_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, const int64_t qs[3],
                      const int64_t ks[3], int64_t ob, int64_t oh, int64_t on, const Band& bd, float scale,
                      const Dropout& dp, float* lse, cudaStream_t stream) {
  using F = Flash<D>;
  FlashMaps maps;
  const int64_t qdims[4] = {D, bd.nq, H, B};
  const int64_t kdims[4] = {D, bd.nk, H, B};
  const int64_t qstrides[3] = {qs[2], qs[1], qs[0]};
  const int64_t kstrides[3] = {ks[2], ks[1], ks[0]};
  int rc = sm90::make_map_bf16_4d(&maps.q, q, qdims, qstrides, F::kBM, F::kBoxCols);
  if (rc == 0) rc = sm90::make_map_bf16_4d(&maps.k, k, kdims, kstrides, F::kBN, F::kBoxCols);
  if (rc == 0) rc = sm90::make_map_bf16_4d(&maps.v, v, kdims, kstrides, F::kBN, F::kBoxCols);
  if (rc != 0) return rc;
  const dim3 grid((bd.nq + F::kBM - 1) / F::kBM, B * H);
  if (dp.on)
    return bd.off ? launch_bf16_kernel<D, true, true>(grid, maps, o, H, ob, oh, on, bd, scale, dp, lse, stream)
                  : launch_bf16_kernel<D, true, false>(grid, maps, o, H, ob, oh, on, bd, scale, dp, lse, stream);
  return bd.off ? launch_bf16_kernel<D, false, true>(grid, maps, o, H, ob, oh, on, bd, scale, dp, lse, stream)
                : launch_bf16_kernel<D, false, false>(grid, maps, o, H, ob, oh, on, bd, scale, dp, lse, stream);
}

// ---------------------------------------------------------------------------
// fp32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32BM = 64;  // queries per CTA, 16 per warp, two lanes a row
constexpr int kF32BN = 64;  // keys per block
constexpr int kF32Threads = 128;

template <int D>
struct F32Layout {
  static constexpr int kLdT = D + 4;       // Q, K, V tile rows
  static constexpr int kLdP = kF32BN + 4;  // P rows
  static constexpr size_t kTile = (size_t)kF32BM * kLdT * sizeof(float);
  static constexpr size_t kP = (size_t)kF32BM * kLdP * sizeof(float);
  static constexpr size_t kBytes = 3 * kTile + kP;
};

// Copies rows [row0, row0 + 64) of one (N, D) head matrix, rows past N as 0.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int64_t sn, int row0, int n) {
  using L = F32Layout<D>;
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kF32BM * kPerRow; idx += kF32Threads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) val = *reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * sn + c);
    *reinterpret_cast<float4*>(dst + r * L::kLdT + c) = val;
  }
}

template <int D, bool DROP, bool OFF>
__global__ void __launch_bounds__(kF32Threads)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      float* __restrict__ o, int H, int64_t qb, int64_t qh, int64_t qn, int64_t kb_, int64_t kh,
                      int64_t kn, int64_t ob, int64_t oh, int64_t on, Band band, float scale, Dropout dp,
                      float* __restrict__ lse) {
  using L = F32Layout<D>;
  const Band bd = local_band<OFF>(band);
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);
  float* Ks = reinterpret_cast<float*>(smem_f32 + L::kTile);
  float* Vs = reinterpret_cast<float*>(smem_f32 + 2 * L::kTile);
  float* Pw = reinterpret_cast<float*>(smem_f32 + 3 * L::kTile) + (threadIdx.x / 32) * 16 * L::kLdP;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;     // this lane's row within the warp's 16
  const int half = lane & 1;   // and which half of the keys / channels
  const int q0 = blockIdx.x * kF32BM;
  const int bh = blockIdx.y;
  const int64_t q_off = (int64_t)(bh / H) * qb + (int64_t)(bh % H) * qh;
  // without OFF, k and v have q's strides: the single-sequence kernel's addressing
  const int64_t k_off = OFF ? (int64_t)(bh / H) * kb_ + (int64_t)(bh % H) * kh : q_off;
  const int64_t ksn = OFF ? kn : qn;
  const int64_t out_off = (int64_t)(bh / H) * ob + (int64_t)(bh % H) * oh;
  const int qpos = q0 + warp * 16 + r;

  load_tile_f32<D>(Qs, q + q_off, qn, q0, bd.nq);

  int lo, hi;  // key range this CTA can see
  key_range(bd, q0, min(q0 + kF32BM, bd.nq) - 1, lo, hi);

  float m = kNeg, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  const int kb_last = OFF && hi < lo ? lo / kF32BN - 1 : hi / kF32BN;  // no keys: no block (only with OFF)
  for (int kb = lo / kF32BN; kb <= kb_last; ++kb) {
    const int k0 = kb * kF32BN;
    __syncthreads();  // the previous block's K and V are consumed
    load_tile_f32<D>(Ks, k + k_off, ksn, k0, bd.nk);
    load_tile_f32<D>(Vs, v + k_off, ksn, k0, bd.nk);
    __syncthreads();

    // s = q_row . K^T for this lane's 32 keys
    float s[kF32BN / 2];
#pragma unroll
    for (int c = 0; c < kF32BN / 2; ++c) s[c] = 0.f;
    const float* qrow = Qs + (warp * 16 + r) * L::kLdT;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int c = 0; c < kF32BN / 2; ++c) s[c] = fmaf(qd, Ks[(half * (kF32BN / 2) + c) * L::kLdT + d], s[c]);
    }

    // online softmax over this block (two lanes per row)
    float mloc = kNeg;
#pragma unroll
    for (int c = 0; c < kF32BN / 2; ++c) {
      const int kpos = k0 + half * (kF32BN / 2) + c;
      const bool live = in_band(bd, qpos, kpos, valid_key<OFF>(bd, kpos) && qpos < bd.nq);
      s[c] = live ? s[c] * scale : kNeg;
      mloc = fmaxf(mloc, s[c]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    const float m_new = fmaxf(m, mloc);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int c = 0; c < kF32BN / 2; ++c) {
      const float p = s[c] > 0.5f * kNeg ? expf(s[c] - m_new) : 0.f;
      lsum += p;  // the normalizer sums every pair, dropped or not
      Pw[r * L::kLdP + half * (kF32BN / 2) + c] =
          DROP && !keep(dp, bh, bd.q_pos0 + qpos, bd.k_pos0 + k0 + half * (kF32BN / 2) + c) ? 0.f : p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l = fmaf(l, corr, lsum);
    m = m_new;
    __syncwarp();

    // acc = acc * corr + P . V over this lane's D / 2 channels
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] *= corr;
    for (int j = 0; j < kF32BN; ++j) {
      const float p = Pw[r * L::kLdP + j];
      const float* vrow = Vs + j * L::kLdT + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) acc[c] = fmaf(p, vrow[c], acc[c]);
    }
    __syncwarp();
  }

  if (qpos < bd.nq) {
    const float inv = DROP ? 1.f / fmaxf(l, 1e-30f) * dp.rscale : 1.f / fmaxf(l, 1e-30f);
    float* orow = o + out_off + (int64_t)qpos * on + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = acc[c] * inv;
    if (lse != nullptr && half == 0) lse[(int64_t)bh * bd.nq + qpos] = l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
  }
}

template <int D>
int launch_flash_f32(const void* q, const void* k, const void* v, void* o, int B, int H, const int64_t qs[3],
                     const int64_t ks[3], int64_t ob, int64_t oh, int64_t on, const Band& bd, float scale,
                     const Dropout& dp, float* lse, cudaStream_t stream) {
  using L = F32Layout<D>;
  auto kernel = dp.on ? (bd.off ? flash_attn_f32_kernel<D, true, true> : flash_attn_f32_kernel<D, true, false>)
                      : (bd.off ? flash_attn_f32_kernel<D, false, true> : flash_attn_f32_kernel<D, false, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((bd.nq + kF32BM - 1) / kF32BM, B * H);
  kernel<<<grid, kF32Threads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], ob, oh, on, bd, scale, dp, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wide heads: a warp per R query rows on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 4;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// lane l owns channels l, l + 32, ..., l + 32 (NV - 1) below D; R rows a warp share every key row
template <typename T, int NV, int R, bool DROP, bool OFF>
__global__ void __launch_bounds__(32 * kRowWarps)
flash_attn_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                       int H, int D, int64_t qb, int64_t qh, int64_t qn, int64_t kb, int64_t kh, int64_t kn,
                       int64_t ob, int64_t oh, int64_t on, Band band, float scale, Dropout dp,
                       float* __restrict__ lse) {
  const Band bd = local_band<OFF>(band);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int i0 = (blockIdx.x * kRowWarps + warp) * R;
  if (i0 >= bd.nq) return;
  const int64_t q_off = (int64_t)(bh / H) * qb + (int64_t)(bh % H) * qh;
  // without OFF, k and v have q's strides: the single-sequence kernel's addressing
  const int64_t k_off = OFF ? (int64_t)(bh / H) * kb + (int64_t)(bh % H) * kh : q_off;
  const int64_t ksn = OFF ? kn : qn;
  const int64_t out_off = (int64_t)(bh / H) * ob + (int64_t)(bh % H) * oh;
  float qv[R][NV], acc[R][NV], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int ch = lane + 32 * c;
      qv[r][c] = i0 + r < bd.nq && ch < D ? load_f(q + q_off + (int64_t)(i0 + r) * qn + ch) : 0.f;
      acc[r][c] = 0.f;
    }
  }
  int lo, hi;
  key_range(bd, i0, min(i0 + R - 1, bd.nq - 1), lo, hi);
  for (int j = lo; j <= hi; ++j) {
    float kr[NV], vr[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int ch = lane + 32 * c;
      kr[c] = ch < D ? load_f(k + k_off + (int64_t)j * ksn + ch) : 0.f;
      vr[c] = ch < D ? load_f(v + k_off + (int64_t)j * ksn + ch) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) s = fmaf(qv[r][c], kr[c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const int i = i0 + r;  // every branch below is uniform over the warp
      if (!in_band(bd, i, j, i < bd.nq)) continue;  // j is valid: key_range keeps it there
      const float logit = s * scale;
      const float m_new = fmaxf(m[r], logit);
      const float corr = expf(m[r] - m_new);
      const float p = expf(logit - m_new);
      l[r] = fmaf(l[r], corr, p);  // the normalizer sums every pair, dropped or not
      const float pk = DROP && !keep(dp, bh, bd.q_pos0 + i, bd.k_pos0 + j) ? 0.f : p;
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[r][c] = fmaf(acc[r][c], corr, pk * vr[c]);
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + r >= bd.nq) break;
    const float inv = DROP ? 1.f / fmaxf(l[r], 1e-30f) * dp.rscale : 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int ch = lane + 32 * c;
      if (ch < D) store_f(o + out_off + (int64_t)(i0 + r) * on + ch, acc[r][c] * inv);
    }
    if (lse != nullptr && lane == 0) lse[(int64_t)bh * bd.nq + i0 + r] = l[r] > 0.f ? m[r] + logf(l[r]) : __int_as_float(0x7f800000);
  }
}

template <typename T, int NV>
int launch_rows(const void* q, const void* k, const void* v, void* o, int B, int H, int D, const int64_t qs[3],
                const int64_t ks[3], int64_t ob, int64_t oh, int64_t on, const Band& bd, float scale,
                const Dropout& dp, float* lse, cudaStream_t stream) {
  constexpr int R = 64 / NV;  // rows a warp: 64 accumulators a lane
  const dim3 grid((bd.nq + kRowWarps * R - 1) / (kRowWarps * R), B * H);
  auto kernel = dp.on ? (bd.off ? flash_attn_rows_kernel<T, NV, R, true, true>
                                : flash_attn_rows_kernel<T, NV, R, true, false>)
                      : (bd.off ? flash_attn_rows_kernel<T, NV, R, false, true>
                                : flash_attn_rows_kernel<T, NV, R, false, false>);
  kernel<<<grid, 32 * kRowWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), H, D, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], ob, oh, on, bd, scale, dp, lse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows_any(const void* q, const void* k, const void* v, void* o, int B, int H, int D, const int64_t qs[3],
                    const int64_t ks[3], int64_t ob, int64_t oh, int64_t on, const Band& bd, float scale,
                    const Dropout& dp, float* lse, cudaStream_t s) {
  if (D <= 256) return launch_rows<T, 8>(q, k, v, o, B, H, D, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
  if (D <= 512) return launch_rows<T, 16>(q, k, v, o, B, H, D, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
  if (D <= 1024) return launch_rows<T, 32>(q, k, v, o, B, H, D, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, H, Nq, D) and k, v (B, H, Nk, D) by their (batch, head, row) strides qs and ks (channels contiguous);
// q_pos0, k_pos0: the global positions of q's and k's row 0; keys outside [0, n_valid) are masked; window < 0:
// none. dropout: 0 or 1; keep_below = round((1 - p) 2^32); k0, k1: the Philox key; rscale = 1 / (1 - p);
// lse: null, or (B, H, Nq) fp32 for each row's log-sum-exp of its scaled logits (+inf for a row that sees no
// key), which the backward (flash_attention_bwd.cu) recomputes P from; the output's bits do not depend on it
int flash_attn_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk, int D,
                   int64_t qsb, int64_t qsh, int64_t qsn, int64_t ksb, int64_t ksh, int64_t ksn, int64_t ob,
                   int64_t oh, int64_t on, int window, int causal, int q_pos0, int k_pos0, int n_valid, float scale,
                   int dropout, uint32_t keep_below, uint32_t k0, uint32_t k1, float rscale, float* lse,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dp{dropout, keep_below, k0, k1, rscale};
  const int64_t qs[3] = {qsb, qsh, qsn}, ks[3] = {ksb, ksh, ksn};
  const Band bd = make_band(Nq, Nk, window, causal, q_pos0, k_pos0, n_valid, qs, ks);
  switch (D) {  // the wrapper pads every head width up to 128 to one of these
    case 16: return launch_flash_f32<16>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    case 32: return launch_flash_f32<32>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    case 64: return launch_flash_f32<64>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    case 128: return launch_flash_f32<128>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    default:
      if (D > 128) return launch_rows_any<float>(q, k, v, o, B, H, D, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attn_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk, int D,
                    int64_t qsb, int64_t qsh, int64_t qsn, int64_t ksb, int64_t ksh, int64_t ksn, int64_t ob,
                    int64_t oh, int64_t on, int window, int causal, int q_pos0, int k_pos0, int n_valid, float scale,
                    int dropout, uint32_t keep_below, uint32_t k0, uint32_t k1, float rscale, float* lse,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dp{dropout, keep_below, k0, k1, rscale};
  const int64_t qs[3] = {qsb, qsh, qsn}, ks[3] = {ksb, ksh, ksn};
  const Band bd = make_band(Nq, Nk, window, causal, q_pos0, k_pos0, n_valid, qs, ks);
  switch (D) {  // the wrapper pads every head width up to 512 to one of these
    case 16: return launch_flash_bf16<16>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    case 32: return launch_flash_bf16<32>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    case 64: return launch_flash_bf16<64>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    case 128: return launch_flash_bf16<128>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    case 256: return launch_flash_bf16<256>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    case 512: return launch_flash_bf16<512>(q, k, v, o, B, H, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
    default:
      if (D > 512) return launch_rows_any<bf16>(q, k, v, o, B, H, D, qs, ks, ob, oh, on, bd, scale, dp, lse, s);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
