// Flash attention forward for Hopper (sm_90a): online softmax over kv
// tiles, one block per (batch x query head, 64-row query tile).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:74-113
// (`flash_attention`, body `_kernel`). For q (B, H, Sq, D) and k, v
// (B, K, Sk, D) with H % K == 0, query head h reads kv head h / (H / K)
// (grouped kv-major), and for every query row
//   s   = (q . k) * D**-0.5, then cap * tanh(s / cap) if a softcap is set,
//         then -1e30 where the mask forbids key j to query i (positions
//         from 0 on both sides): under causal unless j <= i or both are
//         below `prefix`, and with a window unless j > i - window (the
//         reference model's _mask_bias; window 0 and prefix 0 mean none);
//   out = sum_t exp(s_t - m) v_t / max(sum_t exp(s_t - m), 1e-30)
// with f32 running max m, sum l and accumulator, whatever the input type
// (f32 or bf16); the output has the input's type.
//
// Bound at the serving path's shape (B 4, H 8, K 4, S 2048, D 256,
// causal, bf16): operations. The two products are 4 B H S^2 D / 2 =
// 68.7 GFLOP a launch against about 101 MB of q, k, v and out, so the
// least time is ~0.069 ms at the 989 TFLOP/s bf16 tensor rate against
// ~0.030 ms of bytes. This first design does the products on the f32
// SIMT units (67 TFLOP/s peak), so it cannot come near that bound; it
// keeps the work that the TPU kernel keeps out of device memory out of
// it too, and is built to be right first:
//   * the TPU's sequential kv grid axis is a loop inside the block; the
//     query tile (64 x D, f32) stays in shared memory for the whole loop,
//     and each kv tile (32 x D of k and of v) is read once per block;
//   * 256 threads as 16 x 16: thread (ty, tx) owns query rows 4 ty .. +3.
//     For the scores it takes key columns tx and tx + 16 (float4 reads
//     along D); for the output, D / 16 columns, in float4 groups where D
//     is a multiple of 64 and columns tx + 16 c at D = 80 and 112 (5 and
//     7 a thread), so the f32 accumulator (64 floats a thread at D = 256)
//     lives in registers;
//   * a row's 16 owners sit in one half-warp: its max and sum are
//     shuffle reductions, and P goes through shared memory transposed so
//     the product with V reads 4 rows as one float4;
//   * kv tiles that the mask forbids to every row of the block are
//     skipped: under causal those wholly above the diagonal (or above the
//     prefix, for blocks that start inside it), with a window those
//     wholly at or below i - window for the block's first row. This is
//     exact: such a tile would give p = 0 and alpha = 1. Key i is always
//     allowed to row i, so no row is ever empty; a row whose first tiles
//     are all masked holds m = -1e30 until its first allowed key, whose
//     alpha = exp(-1e30 - m) = 0 then clears what those tiles added. The
//     longest rows' query tiles are scheduled first;
//   * a ragged last tile (S not a multiple of 64 or 32) is zero-filled
//     and masked, so any S works (the Pallas wrapper asks for multiples
//     of 128);
//   * the tiles take (64 + 2 * 32) (D + 4) + 32 * 68 floats of dynamic
//     shared memory, 141,824 bytes at D = 256, above the 48 KB static
//     limit: the launcher raises the limit with cudaFuncSetAttribute.
// Tensor cores (mma / wgmma on bf16), TMA loads and overlapping the next
// tile's loads with this tile's products are for a later design.
//
// Build without --use_fast_math: IEEE expf, tanhf and division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_scope.h"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per shared row
constexpr int kLP = kBQ + kPad;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// element strides of one (B, heads, S, D) operand; D has stride 1
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// dst[r][d] = src[row0 + r][d] as f32 for r < rows, zero past `limit`
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int limit) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    dst[r * (D + kPad) + d] =
        row < limit ? to_float(src[row * row_stride + d]) : 0.0f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// the mask (see the header); window 0 and prefix 0 mean none
struct Mask {
  int causal, window, prefix;
};

__device__ __forceinline__ bool allowed(const Mask& mk, int qp, int kp) {
  if (mk.causal && kp > qp && !(qp < mk.prefix && kp < mk.prefix))
    return false;
  return mk.window == 0 || kp > qp - mk.window;
}

// output columns: D / 16 a thread, 4 tx + 64 (c / 4) + c % 4 (float4
// groups) where D is a multiple of 64, else tx + 16 c
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D % 64 == 0) return 4 * tx + 64 * (c / 4) + c % 4;
  return tx + 16 * c;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int H, int group, int Sq, int Sk, Strides qs,
                           Strides ks, Strides vs, Strides os, Mask mk,
                           float scale, float cap) {
  static_assert(D % 16 == 0, "16 threads share a row's output columns");
  constexpr int LD = D + kPad;
  constexpr int NC = D / 16;  // output columns per thread and row
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // kBQ x LD
  float* sk = sq + kBQ * LD;                    // kBK x LD
  float* sv = sk + kBK * LD;                    // kBK x LD
  float* sp = sv + kBK * LD;                    // kBK x kLP, P transposed

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // long rows first
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  T* ob = o + b * os.b + h * os.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(sq, qb, qs.s, q0, kBQ, Sq);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // keys [kv_begin, kv_end) hold every one the block's rows may read
  const int kv_end =
      mk.causal ? min(Sk, max(q0 + kBQ, q0 < mk.prefix ? mk.prefix : 0))
                : Sk;
  const int kv_begin =
      mk.window > 0 ? max(0, q0 - mk.window + 1) / kBK * kBK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sk, kb, ks.s, k0, kBK, Sk);
    load_tile<T, D>(sv, vb, vs.s, k0, kBK, Sk);
    __syncthreads();

    // scores of rows 4 ty + i against keys tx and tx + 16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k0v = *reinterpret_cast<const float4*>(&sk[tx * LD + d]);
      const float4 k1v =
          *reinterpret_cast<const float4*>(&sk[(tx + 16) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sq[(4 * ty + i) * LD + d]);
        s[i][0] += qv.x * k0v.x;
        s[i][0] += qv.y * k0v.y;
        s[i][0] += qv.z * k0v.z;
        s[i][0] += qv.w * k0v.w;
        s[i][1] += qv.x * k1v.x;
        s[i][1] += qv.y * k1v.y;
        s[i][1] += qv.z * k1v.z;
        s[i][1] += qv.w * k1v.w;
      }
    }

    // scale, softcap, mask; online softmax update per row
    float p[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        if (kp >= Sk || !allowed(mk, qp, kp)) x = kNegInf;
        s[i][j] = x;
      }
      const float m_new = fmaxf(m[i], half_warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      p[i][0] = expf(s[i][0] - m_new);
      p[i][1] = expf(s[i][1] - m_new);
      l[i] = alpha * l[i] + half_warp_sum(p[i][0] + p[i][1]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(&sp[(tx + 16 * j) * kLP + 4 * ty]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      const float4 pv =
          *reinterpret_cast<const float4*>(&sp[t * kLP + 4 * ty]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      if constexpr (D % 64 == 0) {
#pragma unroll
        for (int c = 0; c < NC / 4; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sv[t * LD + 4 * tx + 64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * c + 0] += pr[i] * vv.x;
            acc[i][4 * c + 1] += pr[i] * vv.y;
            acc[i][4 * c + 2] += pr[i] * vv.z;
            acc[i][4 * c + 3] += pr[i] * vv.w;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = sv[t * LD + out_col<D>(tx, c)];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += pr[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = ob + row * os.s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[out_col<D>(tx, c)] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int Sq, int Sk, Strides qs,
                   Strides ks, Strides vs, Strides os, Mask mk,
                   float scale, float cap, cudaStream_t stream) {
  const int smem = int(((kBQ + 2 * kBK) * (D + kPad) + kBK * kLP) *
                       sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / K, Sq, Sk, qs, ks,
      vs, os, mk, scale, cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int K, int Sq, int Sk, Strides qs,
                     Strides ks, Strides vs, Strides os, Mask mk,
                     float scale, float cap, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs, os,
                                  mk, scale, cap, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs, os,
                                  mk, scale, cap, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs,
                                    os, mk, scale, cap, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs,
                                    os, mk, scale, cap, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs,
                                    os, mk, scale, cap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16. strides: (b, h, s) in elements for q, k,
// v, o in that order. window 0 and prefix 0 mean none; a window or a
// prefix needs Sq == Sk. cap <= 0 means no softcap. Returns a cudaError_t.
extern "C" int flash_attention_launch(int device, int dtype, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int H, int K, int Sq, int Sk,
                                      int D, const long long* strides,
                                      int causal, int window, int prefix,
                                      float scale, float cap, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (K <= 0 || H % K != 0 || window < 0 || prefix < 0)
    return int(cudaErrorInvalidValue);
  const Mask mk{causal, window, prefix};
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_d<float>(D, q, k, v, o, B, H, K, Sq, Sk, qs, ks,
                                       vs, os, mk, scale, cap, s));
    case 1: return int(launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, K, Sq, Sk,
                                               qs, ks, vs, os, mk, scale,
                                               cap, s));
    default: return int(cudaErrorInvalidValue);
  }
}
