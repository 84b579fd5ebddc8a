// Flash attention backward on Hopper's tensor cores (sm_90a), bf16 in,
// f32 sums, bf16 out: the gradient of flash_attention_sm90.cu.
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/
// flash_attention.py has no backward, and the reference differentiates
// its attention through XLA (src/repro/models/attention.py: `_attend`'s
// einsums, or `_attend_blocked`'s scan over 512-key blocks). For q
// (B, H, S, D), k, v (B, K, S, D) and the output's gradient dO, with the
// forward's scale, softcap and mask, and for every row i and allowed key j:
//   s_ij = (q_i . k_j) scale; t = tanh(s_ij / cap), s_ij = cap t (softcap)
//   P_ij = exp(s_ij - m_i) / l_i      (m_i, l_i: the row's max and sum)
//   dP_ij = dO_i . v_j,  D_i = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - D_i) (1 - t^2) scale
//   dq_i = sum_j dS_ij k_j,  dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
// with dk and dv also summed over the query heads of a kv group. float32
// inputs take flash_attention_bwd_f32.cu (flash_attention_bwd.h), whose
// f32 products hold the f32 tolerance that no bf16 product can.
//
// Numerics. Every product is `wgmma.mma_async ... .f32.bf16.bf16`: the
// bf16 inputs multiply exactly and sum in f32. S and dP take the bf16
// inputs as they are. P and dS are formed in f32 and enter dV += P^T dO
// and dK += dS^T Q as wgmma's register A operand, each as a bf16 hi/lo
// pair, hi = bf16(x) and lo = bf16(x - hi), two products that carry 16
// bits of it; dQ += dS K takes dS as a triple, hi, mid = bf16(x - hi) and
// lo = bf16(x - hi - mid), three products that carry all 24 bits of the
// f32 dS. Rounded once (as the reference rounds them: _attend
// casts the probabilities to v's type before the PV einsum, and XLA's
// transpose of its scores' f32 cast rounds dS to bf16), two terms of a
// short sum come out exact opposites often enough that a gradient
// element is exactly 0 where the f32 gradient is not: a row's dS sums to
// about 0, so dq of a row with two allowed keys is 0 in every column where
// the keys' bf16 values are equal, and a key read by two queries can lose
// dk or dv the same way (phase 25 (a) of chip_smoke.py counts such a zero
// as lost gradient, and found such zeros in dq and in dk). A row's f32 dS
// do not cancel exactly where the sum in f32 does not: a hi/lo pair of dS
// still gave dq exact zeros where the f32 gradient holds its rounding
// (phase 16 (a), which counts a zero lost wherever the plain version's is
// not 0); the triple gives dq the f32 sum's. D is formed from the
// recomputed f32 P and dP, not from the saved bf16 output
// (attention_backward_plain says why); each row's m and l are kept as
// lse = m + log2 l (base-2 units), so P = exp2(x - lse) for x = s log2(e).
//
// What bounds it: operations. At a training microbatch's shape (B 1,
// H 8, K 4, S 2048, D 256, causal, bf16) the five products of the
// gradient are 10 B H D a causal pair, 43 GFLOP, 0.043 ms at the bf16
// tensor rate, against 29 MB of q, k, v, dO, dq, dk and dv. This design
// does thirteen products a pair, every one on the tensor cores:
//   1. flash_attention_bwd_dq_sm90_kernel, one block per (batch x query
//      head, 64 query rows), the longest first: pass 1 over the key tiles
//      the mask lets its rows read recomputes S = Q K^T and dP = dO V^T
//      and keeps each row's running max, sum and rescaled sum of
//      exp2(x - m) dP (an online softmax whose values are dP); lse and D
//      go to a (B H, Sq rounded up to 64) float2 buffer. Pass 2 recomputes
//      S and dP, forms dS and accumulates dQ += dS K (hi, mid and lo) in
//      registers. 7 products. Both consumer warpgroups take the block's
//      64 rows and alternate key tiles: after pass 1 they merge their
//      rows' (max, sum, D sum) through shared memory, warpgroup 0's first,
//      and at the end warpgroup 1 hands its dQ to warpgroup 0, which adds
//      it to its own. 64-row blocks are twice as many as 128-row ones: at
//      a training microbatch's (1, 8, 2048) 256 blocks, whose causal work
//      the card balances over its 132 SMs, where 128 blocks would be one
//      wave held by its longest block.
//   2. flash_attention_bwd_dkdv_sm90_kernel, one block per (batch x kv
//      head, 64 keys): K and V stay in shared memory, and the block walks
//      the group's query heads in order and, for each, the 64-row query
//      tiles the mask lets read its keys. The two consumer warpgroups
//      split the products, not the columns: warpgroup 0 forms S^T = K Q^T,
//      P^T and accumulates dV += P^T dO; warpgroup 1 forms dP^T = V dO^T
//      and accumulates dK += dS^T Q. Warpgroup 0 hands P (1 - t^2) scale
//      to warpgroup 1 through 16 KB of shared memory, under two named
//      barriers (written, read). Each warpgroup holds one 64 x D f32
//      accumulator (128 registers a thread at D 256). 6 products. Where
//      B K Sk/64 blocks would be fewer than the SMs (less than one wave)
//      and a group has heads to split (a training microbatch's (1, 8 over
//      4, 2048): 128 blocks, the longest under causal twice the mean), the
//      wrapper
//      passes `part` and each block takes one query head, writing f32
//      partial dk and dv; a third launch,
//      flash_attention_bwd_reduce_kernel, sums them in head order.
// No atomics: dq is summed inside its block, dk and dv inside theirs (or
// by the head-sum launch), a group's heads and each head's query tiles in
// a fixed order, so two calls give the same bits. Nothing of size
// (Sq, Sk) is written.
//
// Both launches are the forward's design (flash_attention_sm90.cu): 3
// warpgroups, warpgroup 2 the producer (one thread issues every TMA load;
// setmaxnreg 24), warpgroups 0 and 1 consumers (setmaxnreg 240); tiles
// in 128-byte-swizzled rows by TMA from 4-d tensor maps over the strided
// (D, S, heads, B) views, zero-filled past S (and past D = 80 or 112 in
// 128-column tiles); a ring of K/V tiles (launch 1) or of Q, dO
// and the rows' lse and D (launch 2, a 512-byte bulk copy beside the
// tiles), each stage's arrival and release on mbarriers. S and dP (S^T,
// dP^T) are `ss` products, both operands K-major in shared memory; dV,
// dK and dQ are `rs_tb` products, A from registers and B read MN-major
// through the descriptor's transpose bit. Tiles that the mask removes
// entirely are skipped (the forward's key range of a row block; under
// causal the query tiles wholly before a key tile unless it starts inside
// the prefix, with a window those from k0 + 63 + window on). Masked
// pairs give P = dS = 0 by selection; rows past Sq get lse = D = 0.
// Keys per tile in launch 1: 64 at D 64, 80, 112, 128; 32 at D 256; its
// ring has 4 stages, 2 a consumer. Shared memory at D 256: (1) Q and dO
// 64 KB + 4 x (K 16 KB + V 16 KB) + 6 KB = 199 KB, (2) K and V 64 KB +
// 2 x (Q 32 KB + dO 32 KB + 512 B) + 16 KB = 209 KB: one block per SM.
//
// The TMA unit needs 16-byte aligned operands with (b, h, s) strides that
// are multiples of 8 elements; the wrapper (kernels/flash_attention.py)
// copies any other input into a fresh dense tensor before the call, so an
// unaligned view takes the same kernel on the same values.
//
// Build without --use_fast_math: IEEE exp2f and division where not
// written otherwise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_scope.h"
#include "sm90_common.h"

namespace {

constexpr int kWG = 128;                  // threads a warpgroup
constexpr int kThreads = 3 * kWG;         // 2 consumers and a producer
constexpr int kStages = 2;                // (2): ring depth
constexpr int kDqStages = 4;              // (1): ring depth, 2 a consumer
constexpr int kBM = 64;                   // (1): query rows a block
constexpr int kBT = 64;                   // (2): keys a block, queries a tile
constexpr int kStatRows = 64;             // lse/D rows padded to this
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBarWritten = 1;            // (2): named barriers
constexpr int kBarRead = 2;
constexpr int kBarMerged = 1;             // (1): named barriers
constexpr int kBarRingDone = 2;
constexpr int kBarHanded = 3;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// (1): keys a tile, by the tiles' head dim
template <int DT> struct DqKeys;
template <> struct DqKeys<64> { static constexpr int value = 64; };
template <> struct DqKeys<128> { static constexpr int value = 64; };
template <> struct DqKeys<256> { static constexpr int value = 32; };

struct Params {
  __nv_bfloat16 *dq, *dk, *dv;
  long long dqs_b, dqs_h, dqs_s;  // element strides; D has stride 1
  long long dks_b, dks_h, dks_s;
  long long dvs_b, dvs_h, dvs_s;
  float2* stats;                  // (B H, Sq_pad): lse, D
  float* part;                    // (2, group, B K, Sk, D) f32: dv, dk of
                                  // one head a block, or null
  int B, H, K, group, Sq, Sk, Sq_pad;
  int causal, window, prefix;     // window 0 and prefix 0: none
  float scale;                    // D**-0.5
  float scale_log2;               // D**-0.5 * log2(e)
  float scale_over_cap;           // D**-0.5 / cap (softcap only)
  float cap_log2;                 // cap * log2(e), 0 without a softcap
};

// tanh x = 1 - 2 / (2^(2 log2(e) |x|) + 1), signed: exp2f and a fast
// division, within 4e-7 of tanhf absolutely (what a score needs: its
// error times cap), for a fraction of tanhf's instructions
__device__ __forceinline__ float tanh_exp2(float x) {
  const float e = exp2f(2.8853900817779268f * fabsf(x));
  return copysignf(1.0f - __fdividef(2.0f, e + 1.0f), x);
}

// the scaled, softcapped score in log2 units; t = tanh(s / cap) (0
// without a cap), for the softcap's derivative
__device__ __forceinline__ float score2(const Params& p, float s, float& t) {
  if (p.cap_log2 > 0.0f) {
    t = tanh_exp2(s * p.scale_over_cap);
    return p.cap_log2 * t;
  }
  t = 0.0f;
  return s * p.scale_log2;
}

// acc (64 rows x BN) = A B^T over D in steps of 16 for a and b K-major
// tiles of 128-byte rows (`a_chunk`, `b_chunk`: bytes between their
// 64-column chunks); columns past D are never read
template <int D, int BN>
__device__ __forceinline__ void product_ss(float (&acc)[BN / 2], uint32_t a,
                                           uint32_t a_chunk, uint32_t b,
                                           uint32_t b_chunk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 32 bytes a step in a row
    Wgmma<BN>::ss(acc, desc(a + (kk / 4) * a_chunk + off, 16),
                  desc(b + (kk / 4) * b_chunk + off, 16), kk > 0);
  }
}

// acc (64 x D) += A B over `keys` rows of b: A the bf16 fragments `pa`
// (16 rows of b a step), b a tile of 128-byte rows read MN-major
template <int D, int KS>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2],
                                           const uint32_t (&pa)[KS][4],
                                           uint32_t b, uint32_t b_chunk) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    Wgmma<D>::rs_tb(acc, pa[kk], desc(b + kk * 16 * kRowBytes, b_chunk), 1);
}

// an accumulator of 64 rows x 16 KS columns as rs_tb's A fragments, a
// bf16 hi/lo pair: hi = bf16(x), lo = bf16(x - hi); with `mid`, a triple
// hi, mid = bf16(x - hi), lo = bf16(x - hi - mid), which holds all 24
// bits of an f32 x
template <int KS>
__device__ __forceinline__ void to_fragments_hilo(uint32_t (&hi)[KS][4],
                                                  uint32_t (&lo)[KS][4],
                                                  const float (&x)[8 * KS],
                                                  uint32_t (*mid)[4] = nullptr) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = x[8 * kk + 2 * j], b = x[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      a -= __low2float(h);
      b -= __high2float(h);
      if (mid != nullptr) {
        const __nv_bfloat162 m = __floats2bfloat162_rn(a, b);
        mid[kk][j] = *reinterpret_cast<const uint32_t*>(&m);
        a -= __low2float(m);
        b -= __high2float(m);
      }
      lo[kk][j] = pack_bf16(a, b);
    }
}

// rows r0 and r0 + 8 of a 64 x D accumulator as bf16 into `out` (row
// stride rs), rows at or past `limit` not stored
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long rs,
                                           int r0, int c0, int limit,
                                           const float (&acc)[D / 2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= limit) continue;
    __nv_bfloat16* o = out + row * rs + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// one mbarrier `bar_one` of one arrival, and a ring of `stages` stages:
// full (the producer's expect_tx) and empty (`releases` arrivals, lane 0
// of each consumer warp that reads the stage)
__device__ __forceinline__ void init_ring(uint32_t bar_one, uint32_t bar_full,
                                          uint32_t bar_empty, int stages,
                                          int releases) {
  mbar_init(bar_one, 1);
  for (int s = 0; s < stages; ++s) {
    mbar_init(bar_full + 8 * s, 1);
    mbar_init(bar_empty + 8 * s, releases);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---- (1) dq, and each row's lse and D ----------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                       const __grid_constant__ CUtensorMap tdo,
                                       const __grid_constant__ CUtensorMap tk,
                                       const __grid_constant__ CUtensorMap tv,
                                       const Params p) {
  constexpr int DT = kTileDim<D>;
  constexpr int BN = DqKeys<DT>::value;
  constexpr int NCH = DT / kChunk;
  constexpr uint32_t Q_CHUNK = kBM * kRowBytes;
  constexpr uint32_t KV_CHUNK = BN * kRowBytes;
  constexpr uint32_t Q_BYTES = NCH * Q_CHUNK;
  constexpr uint32_t KV_BYTES = NCH * KV_CHUNK;
  static_assert(kDqStages * KV_BYTES >= kBM * D * 4, "dQ hand-over");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ = (base + 1023u) & ~1023u;
  const uint32_t sDO = sQ + Q_BYTES;
  const uint32_t sK = sDO + Q_BYTES;               // + stage * KV_BYTES
  const uint32_t sV = sK + kDqStages * KV_BYTES;   // + stage * KV_BYTES
  const uint32_t sM = sV + kDqStages * KV_BYTES;   // [wg][m l dd][row][tid]
  const uint32_t bar_q = sM + 2 * 3 * 2 * kWG * 4;
  const uint32_t bar_full = bar_q + 8;             // + stage * 8
  const uint32_t bar_empty = bar_full + 8 * kDqStages;
  float* merge = reinterpret_cast<float*>(smem_raw + (sM - base));
  // after both warpgroups' last tile the K ring holds warpgroup 1's dQ
  float* handover = reinterpret_cast<float*>(smem_raw + (sK - base));

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // long rows first
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kh = h / p.group;
  const int2 tiles = tile_range(p, q0, kBM, BN);
  const int n_tiles = tiles.y - tiles.x;

  if (threadIdx.x == 0)
    init_ring(bar_q, bar_full, bar_empty, kDqStages, 4);  // one warpgroup
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    // ---- producer: Q and dO once, then every key tile twice ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * kWG) {
      mbar_expect_tx(bar_q, 2 * Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        tma_load(sQ + c * Q_CHUNK, &tq, bar_q, c * kChunk, q0, h, b);
        tma_load(sDO + c * Q_CHUNK, &tdo, bar_q, c * kChunk, q0, h, b);
      }
      for (int u = 0; u < 2 * n_tiles; ++u) {
        const int s = u % kDqStages;
        if (u >= kDqStages)
          mbar_wait(bar_empty + 8 * s, (u / kDqStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const int k_row = (tiles.x + u % n_tiles) * BN;
        mbar_expect_tx(full, 2 * KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          tma_load(sK + s * KV_BYTES + c * KV_CHUNK, &tk, full, c * kChunk,
                   k_row, kh, b);
          tma_load(sV + s * KV_BYTES + c * KV_CHUNK, &tv, full, c * kChunk,
                   k_row, kh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: both warpgroups take rows q0 .. q0 + 63, warpgroup
  // wg the tiles u = wg, wg + 2, ... of each pass ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tid = threadIdx.x % kWG;
  const int r0 = q0 + warp * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);             // and columns c0, c0 + 1 of 8
  const bool capped = p.cap_log2 > 0.0f;

  // S and dP of the tile in stage s
  float sc[BN / 2], dp[BN / 2];
  auto products = [&](int s) {
    wgmma_fence();
    product_ss<D, BN>(sc, sQ, Q_CHUNK, sK + s * KV_BYTES, KV_CHUNK);
    product_ss<D, BN>(dp, sDO, Q_CHUNK, sV + s * KV_BYTES, KV_CHUNK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
  };
  // whether some pair of key tile t may be masked for the block's rows,
  // and whether element i of it is allowed
  auto edge = [&](int t) {
    const int k0 = t * BN;
    return (p.causal && k0 + BN - 1 > q0) || k0 + BN > p.Sk ||
           (p.window > 0 && k0 <= q0 + kBM - 1 - p.window);
  };
  auto keep = [&](int t, int i) {
    const int kp = t * BN + 8 * (i / 4) + c0 + (i % 2);
    return kp < p.Sk && allowed(p, r0 + 8 * ((i / 2) % 2), kp);
  };

  if (n_tiles > wg) mbar_wait(bar_q, 0);

  // pass 1: each row's max m, sum l and sum of exp2(x - m) dP over this
  // warpgroup's tiles
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, dd[2] = {0.0f, 0.0f};
  for (int u = wg; u < n_tiles; u += 2) {
    const int s = u % kDqStages;
    mbar_wait(bar_full + 8 * s, (u / kDqStages) & 1);
    products(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    const int t = tiles.x + u;
    const bool masked = edge(t);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float th;
      sc[i] = masked && !keep(t, i) ? kNegInf : score2(p, sc[i], th);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
      dd[r] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i / 2) % 2;
      const float e = exp2f(sc[i] - m[r]);
      l[r] += e;  // this thread's share; summed over the quad below
      dd[r] += e * dp[i];
    }
  }
  // the two warpgroups' (m, l, dd) of each row merged, warpgroup 0's
  // first, by both: a thread and its counterpart hold the same rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
    dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
    merge[((wg * 3 + 0) * 2 + r) * kWG + tid] = m[r];
    merge[((wg * 3 + 1) * 2 + r) * kWG + tid] = l[r];
    merge[((wg * 3 + 2) * 2 + r) * kWG + tid] = dd[r];
  }
  named_sync(kBarMerged, 2 * kWG);
  float lse[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* w0 = merge + r * kWG + tid;           // warpgroup 0's
    const float* w1 = merge + (3 * 2 + r) * kWG + tid;  // warpgroup 1's
    const float mm = fmaxf(w0[0], w1[0]);
    const float a0 = exp2f(w0[0] - mm), a1 = exp2f(w1[0] - mm);
    const float ll = w0[2 * kWG] * a0 + w1[2 * kWG] * a1;
    const float dsum = w0[4 * kWG] * a0 + w1[4 * kWG] * a1;
    const int row = r0 + 8 * r;
    const bool valid = row < p.Sq;
    lse[r] = valid ? mm + log2f(ll) : 0.0f;
    drow[r] = valid ? dsum / ll : 0.0f;
    if (wg == 0 && lane % 4 == 0 && row < p.Sq_pad)
      p.stats[(long long)bh * p.Sq_pad + row] = make_float2(lse[r], drow[r]);
  }

  // pass 2: dS, and dQ += dS K over this warpgroup's tiles
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  for (int u = n_tiles + ((n_tiles + wg) & 1); u < 2 * n_tiles; u += 2) {
    const int s = u % kDqStages, t = tiles.x + u - n_tiles;
    mbar_wait(bar_full + 8 * s, (u / kDqStages) & 1);
    products(s);
    const bool masked = edge(t);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i / 2) % 2;
      float th;
      const float x = score2(p, sc[i], th);
      const float pr = masked && !keep(t, i) ? 0.0f : exp2f(x - lse[r]);
      float ds = pr * (dp[i] - drow[r]);
      if (capped) ds *= 1.0f - th * th;
      sc[i] = ds * p.scale;
    }
    uint32_t pa[BN / 16][4], pm[BN / 16][4], pl[BN / 16][4];  // dS in 3
    to_fragments_hilo<BN / 16>(pa, pl, sc, pm);
    fence_regs(acc);
    fence_regs(pa);
    fence_regs(pm);
    fence_regs(pl);
    wgmma_fence();
    product_rs<D, BN / 16>(acc, pa, sK + s * KV_BYTES, KV_CHUNK);
    product_rs<D, BN / 16>(acc, pm, sK + s * KV_BYTES, KV_CHUNK);
    product_rs<D, BN / 16>(acc, pl, sK + s * KV_BYTES, KV_CHUNK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }
  // dq = warpgroup 0's sum + warpgroup 1's, through the K ring once both
  // are done with it (the producer's last load has landed: every tile was
  // waited for)
  named_sync(kBarRingDone, 2 * kWG);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) handover[i * kWG + tid] = acc[i];
    named_arrive(kBarHanded, 2 * kWG);
    return;
  }
  named_sync(kBarHanded, 2 * kWG);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] += handover[i * kWG + tid];
  store_rows<D>(p.dq + b * p.dqs_b + h * p.dqs_h, p.dqs_s, r0, c0, p.Sq, acc);
}

// ---- (2) dk and dv ------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_sm90_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int DT = kTileDim<D>;
  constexpr int NCH = DT / kChunk;
  constexpr uint32_t CHUNK = kBT * kRowBytes;     // one chunk of any tile
  constexpr uint32_t TILE = NCH * CHUNK;          // one 64-row tile
  constexpr uint32_t STAT_BYTES = kBT * sizeof(float2);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + TILE;
  const uint32_t sQ = sV + TILE;                  // + stage * TILE
  const uint32_t sDO = sQ + kStages * TILE;       // + stage * TILE
  const uint32_t sST = sDO + kStages * TILE;      // + stage * STAT_BYTES
  const uint32_t sX = sST + kStages * STAT_BYTES;  // 64 x 64 f32
  const uint32_t bar_kv = sX + kBT * kBT * 4;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t base = smem_u32(smem_raw);
  const float2* stat_tiles = reinterpret_cast<const float2*>(smem_raw + (sST - base));
  float* xch = reinterpret_cast<float*>(smem_raw + (sX - base));

  // key tiles on y, so that the first (read most under causal) launch
  // first; with `part` one block a query head of the group, else one a kv
  // head, its group's heads in order
  const bool split = p.part != nullptr;
  const int k0 = blockIdx.y * kBT;
  const int bk = split ? blockIdx.x / p.group : blockIdx.x;
  const int g0 = split ? blockIdx.x % p.group : 0;
  const int b = bk / p.K, kh = bk % p.K;
  // query tiles [qt0, qt1) hold every row that may read the block's keys
  const int qt0 = p.causal && k0 >= p.prefix ? k0 / kBT : 0;
  const int q_end = p.window > 0 ? min(p.Sq, k0 + kBT - 1 + p.window) : p.Sq;
  const int qt1 = (q_end + kBT - 1) / kBT;
  const int n_q = max(qt1 - qt0, 0);
  const int total = (split ? 1 : p.group) * n_q;  // (head, tile), heads outer

  if (threadIdx.x == 0)
    init_ring(bar_kv, bar_full, bar_empty, kStages, 8);  // both consumers
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    // ---- producer: K and V once, then each (head, query tile) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * kWG && total > 0) {
      mbar_expect_tx(bar_kv, 2 * TILE);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        tma_load(sK + c * CHUNK, &tk, bar_kv, c * kChunk, k0, kh, b);
        tma_load(sV + c * CHUNK, &tv, bar_kv, c * kChunk, k0, kh, b);
      }
      for (int u = 0; u < total; ++u) {
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(bar_empty + 8 * s, (u / kStages - 1) & 1);
        const int h = kh * p.group + g0 + u / n_q;
        const int q_row = (qt0 + u % n_q) * kBT;
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * TILE + STAT_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          tma_load(sQ + s * TILE + c * CHUNK, &tq, full, c * kChunk, q_row, h,
                   b);
          tma_load(sDO + s * TILE + c * CHUNK, &tdo, full, c * kChunk, q_row,
                   h, b);
        }
        bulk_load(sST + s * STAT_BYTES,
                  p.stats + (long long)(b * p.H + h) * p.Sq_pad + q_row,
                  STAT_BYTES, full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup 0 P^T and dV, warpgroup 1 dP^T, dS^T, dK ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tid = threadIdx.x % kWG;
  const int r0 = warp * 16 + lane / 4;   // this thread's keys k0 + r0, + 8
  const int c0 = 2 * (lane % 4);         // and queries c0, c0 + 1 of 8
  const bool capped = p.cap_log2 > 0.0f;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float st[kBT / 2];                     // S^T (wg 0) or dP^T (wg 1)
  uint32_t pa[kBT / 16][4], pl[kBT / 16][4];  // P^T or dS^T, hi and lo

  if (total > 0) mbar_wait(bar_kv, 0);
  for (int u = 0; u < total; ++u) {
    const int s = u % kStages;
    const int q0 = (qt0 + u % n_q) * kBT;
    const uint32_t q_s = sQ + s * TILE, do_s = sDO + s * TILE;
    const float2* stat = stat_tiles + s * kBT;
    mbar_wait(bar_full + 8 * s, (u / kStages) & 1);
    wgmma_fence();
    if (wg == 0)
      product_ss<D, kBT>(st, sK, CHUNK, q_s, CHUNK);
    else
      product_ss<D, kBT>(st, sV, CHUNK, do_s, CHUNK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    if (wg == 0) {
      // P^T from the rows' lse; P (1 - t^2) scale to warpgroup 1
      const bool edge = (p.causal && q0 < k0 + kBT - 1) || k0 + kBT > p.Sk ||
                        q0 + kBT > p.Sq ||
                        (p.window > 0 && q0 + kBT - 1 >= k0 + p.window);
      if (u > 0) named_sync(kBarRead, 2 * kWG);
#pragma unroll
      for (int i = 0; i < kBT / 2; ++i) {
        const int qc = 8 * (i / 4) + c0 + (i % 2);
        const int kp = k0 + r0 + 8 * ((i / 2) % 2), qp = q0 + qc;
        float t;
        const float x = score2(p, st[i], t);
        const bool ok = !edge || (qp < p.Sq && kp < p.Sk && allowed(p, qp, kp));
        const float pr = ok ? exp2f(x - stat[qc].x) : 0.0f;
        xch[i * kWG + tid] = (capped ? pr * (1.0f - t * t) : pr) * p.scale;
        st[i] = pr;
      }
      named_arrive(kBarWritten, 2 * kWG);
    } else {
      // dS^T = P (1 - t^2) scale (dP^T - D)
      named_sync(kBarWritten, 2 * kWG);
#pragma unroll
      for (int i = 0; i < kBT / 2; ++i) {
        const int qc = 8 * (i / 4) + c0 + (i % 2);
        st[i] = xch[i * kWG + tid] * (st[i] - stat[qc].y);
      }
      if (u + 1 < total) named_arrive(kBarRead, 2 * kWG);
    }
    to_fragments_hilo<kBT / 16>(pa, pl, st);
    fence_regs(acc);
    fence_regs(pa);
    fence_regs(pl);
    wgmma_fence();
    product_rs<D, kBT / 16>(acc, pa, wg == 0 ? do_s : q_s, CHUNK);
    product_rs<D, kBT / 16>(acc, pl, wg == 0 ? do_s : q_s, CHUNK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }
  if (split) {
    // this head's dv (warpgroup 0) or dk (1), for the reduction
    float* out = p.part + (((long long)wg * p.group + g0) * p.B * p.K + bk) *
                              p.Sk * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k0 + r0 + 8 * r;
      if (row >= p.Sk) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + (long long)row * D + c0 + 8 * j) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  } else if (wg == 0) {
    store_rows<D>(p.dv + b * p.dvs_b + kh * p.dvs_h, p.dvs_s, k0 + r0, c0,
                  p.Sk, acc);
  } else {
    store_rows<D>(p.dk + b * p.dks_b + kh * p.dks_h, p.dks_s, k0 + r0, c0,
                  p.Sk, acc);
  }
}

// (2b) with `part`: dv and dk = the sums over the group's heads of their
// blocks' f32 partials, in head order, as bf16; a thread a column pair
template <int D>
__global__ void __launch_bounds__(256)
    flash_attention_bwd_reduce_kernel(const Params p) {
  const long long plane = (long long)p.B * p.K * p.Sk * D;  // one head's
  const long long n = plane;  // column pairs of both planes
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = 2 * i;              // (which, bk, row, column)
    const int which = int(e / plane);
    const long long at = e % plane;
    const int col = int(at % D);
    const long long rows = at / D;
    const int row = int(rows % p.Sk), bk = int(rows / p.Sk);
    const float* src = p.part + which * p.group * plane + at;
    float2 sum = make_float2(0.0f, 0.0f);
    for (int g = 0; g < p.group; ++g) {
      const float2 x = *reinterpret_cast<const float2*>(src + g * plane);
      sum.x += x.x;
      sum.y += x.y;
    }
    const int b = bk / p.K, kh = bk % p.K;
    __nv_bfloat16* out =
        which == 0 ? p.dv + b * p.dvs_b + kh * p.dvs_h + row * p.dvs_s
                   : p.dk + b * p.dks_b + kh * p.dks_h + row * p.dks_s;
    *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(sum.x, sum.y);
  }
}

// ---- host side ----------------------------------------------------------

// dynamic shared memory of each launch, 1024 bytes to align the tiles for
// the 128-byte swizzle, and the mbarriers
template <int D>
constexpr int dq_smem_bytes() {
  constexpr int DT = kTileDim<D>;
  return (2 * kBM + 2 * kDqStages * DqKeys<DT>::value) * DT * 2 +
         2 * 3 * 2 * kWG * 4 + 1024 + 8 * (1 + 2 * kDqStages);
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 + 2 * kStages) * kBT * kTileDim<D> * 2 +
         kStages * kBT * int(sizeof(float2)) + kBT * kBT * 4 + 1024 +
         8 * (1 + 2 * kStages);
}

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float2* stats;
  float* part;
  int B, H, K, Sq, Sk;
  const long long* st;  // (b, h, s) of q, k, v, dout, dq, dk, dv
  int causal, window, prefix;
  float scale, cap;
};

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BN = DqKeys<kTileDim<D>>::value;
  constexpr int smem1 = dq_smem_bytes<D>();
  constexpr int smem2 = dkdv_smem_bytes<D>();
  static_assert(smem1 <= 232448 && smem2 <= 232448, "shared memory");
  CUtensorMap q1, do1, k1, v1, q2, do2, k2, v2;
  cudaError_t err = make_map(&q1, a.q, a.B, a.H, a.Sq, D, a.st + 0, kBM);
  if (err == cudaSuccess)
    err = make_map(&do1, a.dout, a.B, a.H, a.Sq, D, a.st + 9, kBM);
  if (err == cudaSuccess)
    err = make_map(&k1, a.k, a.B, a.K, a.Sk, D, a.st + 3, BN);
  if (err == cudaSuccess)
    err = make_map(&v1, a.v, a.B, a.K, a.Sk, D, a.st + 6, BN);
  if (err == cudaSuccess)
    err = make_map(&q2, a.q, a.B, a.H, a.Sq, D, a.st + 0, kBT);
  if (err == cudaSuccess)
    err = make_map(&do2, a.dout, a.B, a.H, a.Sq, D, a.st + 9, kBT);
  if (err == cudaSuccess)
    err = make_map(&k2, a.k, a.B, a.K, a.Sk, D, a.st + 3, kBT);
  if (err == cudaSuccess)
    err = make_map(&v2, a.v, a.B, a.K, a.Sk, D, a.st + 6, kBT);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return err;
  Params p;
  p.dq = static_cast<__nv_bfloat16*>(a.dq);
  p.dk = static_cast<__nv_bfloat16*>(a.dk);
  p.dv = static_cast<__nv_bfloat16*>(a.dv);
  p.dqs_b = a.st[12];
  p.dqs_h = a.st[13];
  p.dqs_s = a.st[14];
  p.dks_b = a.st[15];
  p.dks_h = a.st[16];
  p.dks_s = a.st[17];
  p.dvs_b = a.st[18];
  p.dvs_h = a.st[19];
  p.dvs_s = a.st[20];
  p.stats = a.stats;
  p.part = a.part;
  p.B = a.B;
  p.H = a.H;
  p.K = a.K;
  p.group = a.H / a.K;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.Sq_pad = (a.Sq + kStatRows - 1) / kStatRows * kStatRows;
  p.causal = a.causal;
  p.window = a.window;
  p.prefix = a.prefix;
  p.scale = a.scale;
  p.scale_log2 = a.scale * kLog2e;
  p.scale_over_cap = a.cap > 0.0f ? a.scale / a.cap : 0.0f;
  p.cap_log2 = a.cap > 0.0f ? a.cap * kLog2e : 0.0f;
  flash_attention_bwd_dq_sm90_kernel<D>
      <<<dim3(a.B * a.H, (a.Sq + kBM - 1) / kBM), kThreads, smem1,
         stream>>>(q1, do1, k1, v1, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_sm90_kernel<D>
      <<<dim3(a.B * a.K * (a.part ? p.group : 1), (a.Sk + kBT - 1) / kBT),
         kThreads, smem2, stream>>>(q2, do2, k2, v2, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.part == nullptr) return err;
  const long long blocks = (long long)a.B * a.K * a.Sk * D / 256 + 1;
  flash_attention_bwd_reduce_kernel<D>
      <<<int(blocks < 2048 ? blocks : 2048), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The bf16 route's C entry: strides (b, h, s) in elements for q, k, v,
// dout, dq, dk, dv in that order (those of q, k, v and dout multiples of 8
// and their pointers 16-byte aligned: the TMA unit's rules); stats
// 2 B H Sq_pad floats of scratch, Sq_pad = Sq rounded up to 64 (each row's
// lse and D); part null, or 2 H/K B K Sk D floats of scratch for one
// block a query head (dv, dk of each head, summed by a third launch);
// window 0 and prefix 0 mean none (a window or a prefix needs Sq == Sk);
// cap <= 0 means no softcap. Returns a cudaError_t.
extern "C" int flash_attention_bwd_bf16_launch(
    int device, const void* q, const void* k, const void* v,
    const void* dout, void* dq, void* dk, void* dv, float* stats, float* part,
    int B,
    int H, int K, int Sq, int Sk, int D, const long long* strides, int causal,
    int window, int prefix, float scale, float cap, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (K <= 0 || H % K != 0 || window < 0 || prefix < 0)
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, dq, dk, dv, reinterpret_cast<float2*>(stats),
               part, B, H, K, Sq, Sk, strides, causal, window, prefix, scale,
               cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return int(launch<64>(a, s));
    case 80: return int(launch<80>(a, s));
    case 112: return int(launch<112>(a, s));
    case 128: return int(launch<128>(a, s));
    case 256: return int(launch<256>(a, s));
    default: return int(cudaErrorInvalidValue);
  }
}
