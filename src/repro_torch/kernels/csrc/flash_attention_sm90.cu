// Flash attention forward on Hopper's tensor cores (sm_90a), bf16 in,
// f32 softmax state, bf16 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:74-113
// (`flash_attention`, body `_kernel`) for bfloat16 inputs; float32 inputs
// stay on the SIMT kernel csrc/flash_attention.cu. For q (B, H, Sq, D) and
// k, v (B, K, Sk, D) with H % K == 0, query head h reads kv head
// h / (H / K) (grouped kv-major), and for every query row
//   s   = (q . k) * D**-0.5, then cap * tanh(s / cap) if a softcap is set,
//         then -1e30 where the mask forbids key j to query i (positions
//         from 0 on both sides): under causal unless j <= i or both are
//         below `prefix`, and with a window unless j > i - window (the
//         reference model's _mask_bias; window 0 and prefix 0 mean none);
//   out = sum_t p_t v_t / max(sum_t p_t, 1e-30),  p_t = exp(s_t - m),
// with f32 running max m, sum l and accumulator. One numerical change
// from the SIMT kernel: p is rounded to bf16 before the product with V
// (the tensor cores take bf16 operands); l sums the unrounded f32 p. The
// softcap uses IEEE tanhf, as the SIMT kernel does.
//
// What bounds it: operations. At the serving path's shape (B 4, H 8, K 4,
// S 2048, D 256, causal, bf16) the two products are 4 B H S^2 D / 2 =
// 68.7 GFLOP a launch, ~0.069 ms at the 989 TFLOP/s bf16 tensor-core rate,
// against ~0.030 ms for the 101 MB of q, k, v and out. The design puts
// both products on the tensor cores and keeps them fed:
//   * S = Q K^T is `wgmma.mma_async ... .f32.bf16.bf16` with Q and K read
//     from shared memory through matrix descriptors, f32 accumulator in
//     registers. Scale, softcap (tanhf) and mask are applied to the
//     S fragment in registers; m and l are updated per row with quad
//     shuffles. P is cast to bf16 in registers and is wgmma's register A
//     operand for O += P V; V is the shared-memory B operand read
//     MN-major through the descriptor's transpose bit, so V is never
//     transposed in memory;
//   * every operand tile arrives by TMA (cp.async.bulk.tensor, 128-byte
//     swizzle, the layout the descriptors name) from one 4-d tensor map per
//     operand over the strided (D, S, heads, B) view, so the model's
//     (B, S, heads, D) activations need no copy. Rows past S are zero-
//     filled by the TMA unit. K and V go through a ring of 2 stages, each
//     stage's arrival signalled on an mbarrier and its release on another;
//   * warp specialisation: a block is 3 warpgroups. Warpgroup 2 is the
//     producer: one thread issues the Q load and then keeps the ring full;
//     the warpgroup gives its registers away (setmaxnreg 24). Warpgroups 0
//     and 1 are consumers, 64 query rows each (a 128-row query tile per
//     block), and take 240 registers a thread: at D = 256 the O
//     accumulator alone is 128 f32 registers;
//   * kv tiles that the mask forbids to every row of the block are not
//     loaded: under causal those wholly above the diagonal (or above the
//     prefix, for blocks that start inside it), with a window those wholly
//     at or below i - window for the block's first row. Producer and
//     consumers walk the same tile range (`tile_range` of the block's
//     rows), so the ring's stage and parity are the tile's place in it;
//     each consumer computes only its own rows' range inside it and only
//     waits and releases on the rest. A skipped tile would have given
//     p = 0, alpha = 1: exact.
//     Key i is always allowed to row i, so no row is ever empty; a row
//     whose first tiles are all masked holds m = -1e30 until its first
//     allowed key, whose alpha = exp2(-1e30 - m) = 0 clears what those
//     tiles added. The longest query tiles of every head are scheduled
//     first;
//   * ragged lengths: keys at or past Sk are masked to -1e30, rows at or
//     past Sq are computed on zeros and not stored.
// Keys per tile: 64 at D = 256 (S takes 32 registers beside O's 128), 128
// at D = 64, 80, 112 and 128. Shared memory at D = 256: Q 64 KB + 2 x (K 32 KB +
// V 32 KB) = 192 KB of the 227 KB a block may have, so one block per SM.
// D = 80 (hubert-xlarge) is 160 bytes a row, which the 128-byte swizzle
// cannot hold in one chunk: the tiles are laid out as at D = 128 (two
// chunks) and the TMA unit zero-fills columns 80-127 of the second,
// which it reads past the tensor's end. Q K^T then takes 5 k-steps of 16
// (K = 80) and O += P V an N of 80 (m64n80k16); the output stores 80
// columns. D = 112 (zamba2-7b's shared attention) is laid out the same
// way, 224 bytes a row with columns 112-127 zero-filled: Q K^T takes 7
// k-steps, O += P V an N of 112 (m64n112k16, 56 f32 accumulators a
// thread), and the output stores 112 columns.
//
// The mbarrier, TMA, wgmma and tensor-map helpers it shares with the
// gradient's kernel (flash_attention_bwd_bf16.cu) are in sm90_common.h.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.h"
#include "sm90_common.h"

namespace {

constexpr int kBM = 64;                      // query rows per consumer
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kBQ = kBM * kConsumers;        // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                   // K/V ring depth
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// keys per tile, by the tiles' head dim
template <int DT> struct KeysPerTile;
template <> struct KeysPerTile<64> { static constexpr int value = 128; };
template <> struct KeysPerTile<128> { static constexpr int value = 128; };
template <> struct KeysPerTile<256> { static constexpr int value = 64; };

struct Params {
  __nv_bfloat16* o;
  long long os_b, os_h, os_s;  // element strides of o; D has stride 1
  int H, group, Sq, Sk, causal;
  int window, prefix;    // 0: none
  float scale_log2;      // D**-0.5 * log2(e)
  float scale_over_cap;  // D**-0.5 / cap (softcap only)
  float cap_log2;        // cap * log2(e), 0 without a softcap
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const Params p) {
  constexpr int DT = kTileDim<D>;               // the tiles' head dim
  constexpr int BN = KeysPerTile<DT>::value;
  constexpr int NCH = DT / kChunk;               // 128-byte column chunks
  constexpr uint32_t Q_CHUNK = kBQ * kRowBytes;  // one chunk of the Q tile
  constexpr uint32_t KV_CHUNK = BN * kRowBytes;  // one chunk of a K/V tile
  constexpr uint32_t Q_BYTES = NCH * Q_CHUNK;
  constexpr uint32_t KV_BYTES = NCH * KV_CHUNK;  // K or V, one stage

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Q_BYTES;               // + stage * KV_BYTES
  const uint32_t sV = sK + kStages * KV_BYTES;    // + stage * KV_BYTES
  const uint32_t bar_q = sV + kStages * KV_BYTES;
  const uint32_t bar_full = bar_q + 8;            // + stage * 8
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // long rows first
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kh = h / p.group;
  const int2 tiles = tile_range(p, q0, kBQ, BN);  // the block's tiles
  const int n_tiles = tiles.y - tiles.x;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * kConsumers);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load(sQ + c * Q_CHUNK, &tq, bar_q, c * kChunk, q0, h, b);
      for (int u = 0; u < n_tiles; ++u) {  // tile tiles.x + u
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(bar_empty + 8 * s, (u / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const int k_row = (tiles.x + u) * BN;
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
  } else {
    // ---- consumer warpgroup `wg`: query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int qw = q0 + wg * kBM;             // first row of this warpgroup
    const int r0 = qw + warp * 16 + lane / 4;  // this thread's rows r0, r0 + 8
    const int c0 = 2 * (lane % 4);            // and columns c0, c0 + 1 of 8
    // this warpgroup's tiles, inside the block's; none past Sq
    const int2 mine = qw < p.Sq ? tile_range(p, qw, kBM, BN) : make_int2(0, 0);
    const uint32_t sQw = sQ + wg * kBM * kRowBytes;
    const bool capped = p.cap_log2 > 0.0f;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    if (mine.y > mine.x) mbar_wait(bar_q, 0);
    for (int u = 0; u < n_tiles; ++u) {
      const int s = u % kStages, t = tiles.x + u;
      mbar_wait(bar_full + 8 * s, (u / kStages) & 1);
      if (t >= mine.x && t < mine.y) {
        const uint32_t k_s = sK + s * KV_BYTES, v_s = sV + s * KV_BYTES;
        // S = Q K^T over D in steps of 16 (columns past D are not read)
        float sc[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          // chunk kk / 4; inside a swizzled row, 32 bytes a step
          const uint32_t off = (kk % 4) * 32;
          Wgmma<BN>::ss(sc, desc(sQw + (kk / 4) * Q_CHUNK + off, 16),
                        desc(k_s + (kk / 4) * KV_CHUNK + off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale and softcap, in log2 units; then the mask
        if (capped) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            sc[i] = p.cap_log2 * tanhf(sc[i] * p.scale_over_cap);
        } else {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) sc[i] *= p.scale_log2;
        }
        // elementwise only where some pair of the tile may be masked
        const int k0 = t * BN;
        if ((p.causal && k0 + BN - 1 > qw) || k0 + BN > p.Sk ||
            (p.window > 0 && k0 <= qw + kBM - 1 - p.window)) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int kp = k0 + 8 * (i / 4) + c0 + (i % 2);
            const int qp = r0 + 8 * ((i / 2) % 2);
            if (kp >= p.Sk || !allowed(p, qp, kp)) sc[i] = kNegInf;
          }
        }

        // online softmax: row maxima over the quad, rescale, exponentiate
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i / 2) % 2;
          sc[i] = exp2f(sc[i] - m[r]);
          l[r] += sc[i];  // this thread's share; summed over the quad last
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

        // P to bf16 as wgmma's A fragments: k-step kk holds keys 16 kk ..
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

        // O += P V over the tile's keys in steps of 16
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          Wgmma<D>::rs_tb(o, pa[kk], desc(v_s + kk * 16 * kRowBytes, KV_CHUNK),
                          1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    // out = O / max(l, 1e-30), rows past Sq not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= p.Sq) continue;
      __nv_bfloat16* out = p.o + b * p.os_b + h * p.os_h + row * p.os_s + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
    }
  }
}

// ---- host side ----------------------------------------------------------

// dynamic shared memory of one block: the Q tile, the K/V ring, the
// barriers, and 1024 bytes to align the tiles for the 128-byte swizzle
template <int D>
constexpr int smem_bytes() {
  constexpr int DT = kTileDim<D>;
  return (kBQ + 2 * kStages * KeysPerTile<DT>::value) * DT * 2 + 1024 +
         8 * (1 + 2 * kStages);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int Sq, int Sk,
                   const long long* st, int causal, int window, int prefix,
                   float scale, float cap, cudaStream_t stream) {
  constexpr int BN = KeysPerTile<kTileDim<D>>::value;
  constexpr int smem = smem_bytes<D>();
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, H, Sq, D, st + 0, kBQ);
  if (err == cudaSuccess) err = make_map(&tk, k, B, K, Sk, D, st + 3, BN);
  if (err == cudaSuccess) err = make_map(&tv, v, B, K, Sk, D, st + 6, BN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.os_b = st[9];
  p.os_h = st[10];
  p.os_s = st[11];
  p.H = H;
  p.group = H / K;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.prefix = prefix;
  p.scale_log2 = scale * kLog2e;
  p.scale_over_cap = cap > 0.0f ? scale / cap : 0.0f;
  p.cap_log2 = cap > 0.0f ? cap * kLog2e : 0.0f;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attention_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv,
                                                                    p);
  return cudaGetLastError();
}

}  // namespace

// dtype 1 (bfloat16) only, the SIMT source's code. strides: (b, h, s) in
// elements for q, k, v, o in that order; those of q, k and v are
// multiples of 8 and the pointers 16-byte aligned (the TMA unit's rules).
// window 0 and prefix 0 mean none; a window or a prefix needs Sq == Sk.
// cap <= 0 means no softcap. Returns a cudaError_t.
extern "C" int flash_attention_sm90_launch(int device, int dtype,
                                           const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int H, int K, int Sq, int Sk, int D,
                                           const long long* strides,
                                           int causal, int window, int prefix,
                                           float scale, float cap,
                                           void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  if (dtype != 1) return int(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (K <= 0 || H % K != 0 || window < 0 || prefix < 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return int(launch<64>(q, k, v, o, B, H, K, Sq, Sk, strides,
                                   causal, window, prefix, scale, cap, s));
    case 80: return int(launch<80>(q, k, v, o, B, H, K, Sq, Sk, strides,
                                   causal, window, prefix, scale, cap, s));
    case 112: return int(launch<112>(q, k, v, o, B, H, K, Sq, Sk, strides,
                                     causal, window, prefix, scale, cap, s));
    case 128: return int(launch<128>(q, k, v, o, B, H, K, Sq, Sk, strides,
                                     causal, window, prefix, scale, cap, s));
    case 256: return int(launch<256>(q, k, v, o, B, H, K, Sq, Sk, strides,
                                     causal, window, prefix, scale, cap, s));
    default: return int(cudaErrorInvalidValue);
  }
}
