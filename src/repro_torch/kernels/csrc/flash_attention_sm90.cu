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
// cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
// the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.h"

namespace {

constexpr int kBM = 64;                      // query rows per consumer
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kBQ = kBM * kConsumers;        // query rows per block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                   // K/V ring depth
constexpr int kChunk = 64;                   // bf16 per 128-byte row
constexpr int kRowBytes = 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// head dim of the shared tiles: whole 128-byte rows (80, 112 -> 128)
template <int D> constexpr int kTileDim = (D + kChunk - 1) / kChunk * kChunk;

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

// ---- shared memory, barriers, TMA ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------

// Matrix descriptor of a tile in 128-byte-swizzled rows (the TMA layout):
// start address, leading and stride byte offsets in 16-byte units, layout
// type 1 (128B swizzle) in bits 62-63. Every 8-row atom is 1024-aligned.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// m64nNk16, f32 += bf16 x bf16. ss: A and B K-major in shared memory, D
// scaled by 0 (overwritten) when scale_d is 0. rs_tb: A from registers
// (four bf16 pairs a thread), B MN-major in shared memory.
template <int N> struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs_tb(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void rs_tb(float (&d)[40],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void rs_tb(float (&d)[56],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs_tb(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs_tb(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool allowed(const Params& p, int qp, int kp) {
  if (p.causal && kp > qp && !(qp < p.prefix && kp < p.prefix)) return false;
  return p.window == 0 || kp > qp - p.window;
}

// the kv tiles [first, last) that hold every key rows r0 .. r0 + rows - 1
// may read
__device__ __forceinline__ int2 tile_range(const Params& p, int r0, int rows,
                                           int bn) {
  const int end =
      p.causal ? min(p.Sk, max(r0 + rows, r0 < p.prefix ? p.prefix : 0))
               : p.Sk;
  const int begin = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
  return make_int2(begin / bn, (end + bn - 1) / bn);
}

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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a bf16 (B, heads, S, D) operand with element strides (b, h, s) as the
// 4-d map (D, S, heads, B), boxes of 64 columns x `rows` rows, 128-byte
// swizzle, zero fill out of bounds
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int heads,
                     int S, int D, const long long* st, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(heads),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {cuuint32_t(kChunk), cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

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
