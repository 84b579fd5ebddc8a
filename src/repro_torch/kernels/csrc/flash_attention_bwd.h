#pragma once

// Flash attention backward for float32 inputs (sm_90a): the gradient of
// flash_attention.cu, recomputed tile by tile, every product on the f32
// SIMT units. Built as flash_attention_bwd_f32.cu; bfloat16 inputs take
// flash_attention_bwd_bf16.cu, whose products run on the tensor cores.
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/
// flash_attention.py has no backward, and the reference differentiates
// its attention through XLA (src/repro/models/attention.py: `_attend`'s
// einsums, or `_attend_blocked` (attn_impl="blocked"), a lax.scan over
// 512-key blocks that XLA differentiates block by block). This is that
// blocked schedule on the backward pass. For q (B, H, S, D), k, v and the
// output's gradient dO (B, K, S, D / B, H, S, D), with the forward's
// scale, softcap and mask (see flash_attention.cu), and for every row i
// and allowed key j:
//   s_ij = (q_i . k_j) scale; t = tanh(s_ij / cap), s_ij = cap t (softcap)
//   P_ij = exp(s_ij - m_i) / l_i      (m_i, l_i: the row's max and sum)
//   dP_ij = dO_i . v_j,  D_i = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - D_i) (1 - t^2) scale
//   dq_i = sum_j dS_ij k_j,  dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i
// with dk and dv also summed over the query heads of a kv group. D is
// formed from the recomputed P, not from the output
// (kernels/flash_attention.py, attention_backward_plain).
//
// Two launches, no atomics, so two calls give the same bits:
//   1. flash_attention_bwd_dq_kernel, one block per (batch x query head,
//      64-row query tile). Pass 1 over the allowed key tiles recomputes S
//      and dP and keeps the row's running max m, sum l and the rescaled
//      sum of exp(s - m) dP (an online softmax whose "values" are dP), so
//      D = that sum / l; m, l and D go to a (3, B H Sq) f32 buffer. Pass 2
//      recomputes S and dP, forms dS and accumulates dq = dS K in
//      registers.
//   2. flash_attention_bwd_dkdv_kernel, one block per (batch x kv head,
//      32-key tile). It keeps its K and V tile in shared memory and dk,
//      dv in registers, and walks the group's query heads in order and,
//      for each, the query tiles the mask lets read its keys: S^T and dP^T
//      recomputed, P and dS from the stored m, l and D, then dv += P^T dO
//      and dk += dS^T Q. Each (key, column) sum runs in one thread in a
//      fixed order.
// Nothing of size (Sq, Sk) is written: besides dq, dk and dv the kernel
// writes 12 bytes a query row. Every product and sum is f32, so the result
// agrees with the plain f32 version (attention_backward_plain) to f32
// rounding: the 2e-5 tolerance that no bf16 or TF32 product holds.
//
// Bound: operations, the gradient's five products (S, dP, dV, dK, dQ),
// 10 B H D a pair, at the f32 SIMT rate of 67 TFLOP/s. This design does
// nine products a pair (S and dP three times each):
//   * 256 threads as 16 x 16. In (1) thread (ty, tx) owns query rows
//     4 ty .. +3 and, for the scores, keys tx and tx + 16 of a 32-key tile
//     (a row's 16 owners share one half-warp: its max and sums are
//     shuffle reductions), and dq columns as the forward's output; dS goes
//     through shared memory transposed, so the product with K reads 4
//     rows at once. In (2) thread (ty, tx) owns keys 2 ty, 2 ty + 1 and,
//     for the scores, queries tx + 16 j (j < 4) of a 64-row tile; P and
//     dS go through shared memory as [query][key], and its dk and dv
//     columns are the forward's output columns;
//   * tiles the mask removes entirely are skipped: in (1) the forward's
//     key range of the block's rows, in (2) under causal the query tiles
//     wholly before the key tile (unless it starts inside the prefix),
//     with a window those from k0 + 32 - 1 + window on. Masked scores are
//     -1e30, so P = exp(-1e30 - m) / l = 0 for a valid row; rows past Sq
//     and keys past Sk are zero-filled and masked;
//   * shared memory: the q, dO, k and v tiles, rows padded by 16 bytes,
//     loaded 16 bytes a thread with four loads in flight where the inputs
//     are aligned (element by element otherwise), and f32 scratch. At
//     D 256: (1) 208,384 bytes, (2) 217,088: one block a multiprocessor.
//     The launcher raises the dynamic limit.
//
// Build without --use_fast_math: IEEE expf, tanhf and division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_scope.h"

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16, 8 warps
constexpr int kLP = kBQ + 4;     // (1): dS transposed, [key][query]
constexpr int kLT = kBK + 2;     // (2): P and dS, [query][key]
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// a shared tile's row: D elements of the input type and 16 bytes of
// padding (rows 16-byte aligned for float4)
template <typename T, int D>
constexpr int kLD = D + 16 / int(sizeof(T));

// element strides of one (B, heads, S, D) operand; D has stride 1
struct Strides {
  long long b, h, s;
};

// the mask (flash_attention.cu); window 0 and prefix 0 mean none
struct Mask {
  int causal, window, prefix;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// four and one values of a shared tile
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }

// dst[r][d] = src[row0 + r][d] for r < rows, zero past `limit`, in the
// input type. Where src and its row stride are 16-byte aligned (the
// model's views are), 16 bytes a load, kVecBatch loads in flight a
// thread before their stores; else element by element.
constexpr int kVecBatch = 4;

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int limit) {
  constexpr int LD = kLD<T, D>;
  constexpr int V = 16 / int(sizeof(T));  // elements a load
  constexpr int VR = D / V;                // loads a row
  static_assert(D % V == 0, "rows of whole 16-byte loads");
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         uintptr_t(row_stride * sizeof(T))) & 15) == 0;
  if (aligned) {
    const int n = rows * VR;
    for (int i0 = threadIdx.x; i0 < n; i0 += kVecBatch * kThreads) {
      uint4 buf[kVecBatch];
#pragma unroll
      for (int u = 0; u < kVecBatch; ++u) {
        const int i = i0 + u * kThreads;
        const int row = row0 + i / VR;
        buf[u] = i < n && row < limit
                     ? *reinterpret_cast<const uint4*>(
                           src + row * row_stride + (i % VR) * V)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kVecBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n)
          *reinterpret_cast<uint4*>(dst + (i / VR) * LD + (i % VR) * V) =
              buf[u];
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    dst[r * LD + d] =
        row < limit ? src[row * row_stride + d] : from_float<T>(0.0f);
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

__device__ __forceinline__ bool allowed(const Mask& mk, int qp, int kp) {
  if (mk.causal && kp > qp && !(qp < mk.prefix && kp < mk.prefix))
    return false;
  return mk.window == 0 || kp > qp - mk.window;
}

// thread tx's columns: D / 16 of them, 4 tx + 64 (c / 4) + c % 4 (groups
// of four) where D is a multiple of 64, else tx + 16 c
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D % 64 == 0) return 4 * tx + 64 * (c / 4) + c % 4;
  return tx + 16 * c;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s += a.x * b.x;
  s += a.y * b.y;
  s += a.z * b.z;
  s += a.w * b.w;
  return s;
}

// the scaled, softcapped and masked score; t is tanh(s / cap) (0 without
// a cap), for the softcap's derivative
__device__ __forceinline__ float masked_score(float s, float scale, float cap,
                                              bool keep, float& t) {
  float x = s * scale;
  t = 0.0f;
  if (cap > 0.0f) {
    t = tanhf(x / cap);
    x = cap * t;
  }
  return keep ? x : kNegInf;
}

// dS of one (row, key): P (dP - D), times 1 - t^2 with a softcap, times
// the scale (attention_backward_plain's order)
__device__ __forceinline__ float dscore(float p, float dp, float drow,
                                        float t, float scale, float cap) {
  float ds = p * (dp - drow);
  if (cap > 0.0f) ds *= 1.0f - t * t;
  return ds * scale;
}

// acc[i][c] += sum over the tile's kBK keys of a[key][row 4 ty + i] *
// b[key][out_col(tx, c)]; a (f32) is [key][row] with rows kLP apart, b a
// tile of the input type
template <typename T, int D>
__device__ __forceinline__ void rows_times_tile(float (&acc)[4][D / 16],
                                                const float* a, const T* b,
                                                int tx, int ty) {
  constexpr int LD = kLD<T, D>;
  constexpr int NC = D / 16;
#pragma unroll 4
  for (int t = 0; t < kBK; ++t) {
    const float4 av = *reinterpret_cast<const float4*>(&a[t * kLP + 4 * ty]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    if constexpr (D % 64 == 0) {
#pragma unroll
      for (int c = 0; c < NC / 4; ++c) {
        const float4 bv = ld4(&b[t * LD + 4 * tx + 64 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] += ar[i] * bv.x;
          acc[i][4 * c + 1] += ar[i] * bv.y;
          acc[i][4 * c + 2] += ar[i] * bv.z;
          acc[i][4 * c + 3] += ar[i] * bv.w;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float bv = ld1(&b[t * LD + out_col<D>(tx, c)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += ar[i] * bv;
      }
    }
  }
}

// (1) rows 4 ty + i against keys tx and tx + 16 of the tile: s = q . k,
// dp = dO . v, in registers on the SIMT units
template <typename T, int D>
__device__ __forceinline__ void row_scores(const T* sq, const T* sdo,
                                           const T* sk, const T* sv, int tx,
                                           int ty, float (&s)[4][2],
                                           float (&dp)[4][2]) {
  constexpr int LD = kLD<T, D>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 k0 = ld4(&sk[tx * LD + d]);
    const float4 k1 = ld4(&sk[(tx + 16) * LD + d]);
    const float4 v0 = ld4(&sv[tx * LD + d]);
    const float4 v1 = ld4(&sv[(tx + 16) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qv = ld4(&sq[(4 * ty + i) * LD + d]);
      const float4 dv = ld4(&sdo[(4 * ty + i) * LD + d]);
      s[i][0] = dot4(qv, k0, s[i][0]);
      s[i][1] = dot4(qv, k1, s[i][1]);
      dp[i][0] = dot4(dv, v0, dp[i][0]);
      dp[i][1] = dot4(dv, v1, dp[i][1]);
    }
  }
}

// (2) keys 2 ty + i against queries tx + 16 j of the tile: s = k . q,
// dp = v . dO, as row_scores
template <typename T, int D>
__device__ __forceinline__ void key_scores(const T* sk, const T* sv,
                                           const T* sq, const T* sdo, int tx,
                                           int ty, float (&s)[2][4],
                                           float (&dp)[2][4]) {
  constexpr int LD = kLD<T, D>;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 k0v = ld4(&sk[(2 * ty) * LD + d]);
    const float4 k1v = ld4(&sk[(2 * ty + 1) * LD + d]);
    const float4 v0v = ld4(&sv[(2 * ty) * LD + d]);
    const float4 v1v = ld4(&sv[(2 * ty + 1) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 qv = ld4(&sq[(tx + 16 * j) * LD + d]);
      const float4 dov = ld4(&sdo[(tx + 16 * j) * LD + d]);
      s[0][j] = dot4(qv, k0v, s[0][j]);
      s[1][j] = dot4(qv, k1v, s[1][j]);
      dp[0][j] = dot4(dov, v0v, dp[0][j]);
      dp[1][j] = dot4(dov, v1v, dp[1][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const T* __restrict__ dout,
                                  T* __restrict__ dq,
                                  float* __restrict__ stats, int H, int group,
                                  int Sq, int Sk, Strides qs, Strides ks,
                                  Strides vs, Strides dos, Strides dqs,
                                  Mask mk, float scale, float cap) {
  static_assert(D % 16 == 0, "16 threads share a row's dq columns");
  constexpr int LD = kLD<T, D>;
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  T* sq = reinterpret_cast<T*>(smem4);  // kBQ x LD
  T* sdo = sq + kBQ * LD;               // kBQ x LD
  T* sk = sdo + kBQ * LD;               // kBK x LD
  T* sv = sk + kBK * LD;                // kBK x LD
  float* sds = reinterpret_cast<float*>(sv + kBK * LD);  // kBK x kLP, dS^T

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // long rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / group;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(sq, q + b * qs.b + h * qs.h, qs.s, q0, kBQ, Sq);
  load_tile<T, D>(sdo, dout + b * dos.b + h * dos.h, dos.s, q0, kBQ, Sq);

  // keys [kv_begin, kv_end) hold every one the block's rows may read
  const int kv_end =
      mk.causal ? min(Sk, max(q0 + kBQ, q0 < mk.prefix ? mk.prefix : 0))
                : Sk;
  const int kv_begin =
      mk.window > 0 ? max(0, q0 - mk.window + 1) / kBK * kBK : 0;

  // pass 1: the row's max m, sum l and D = sum exp(s - m) dP / l
  float m[4], l[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = dd[i] = 0.0f;
  }
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sk, kb, ks.s, k0, kBK, Sk);
    load_tile<T, D>(sv, vb, vs.s, k0, kBK, Sk);
    __syncthreads();
    float s[4][2], dp[4][2];
    row_scores<T, D>(sq, sdo, sk, sv, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float x[2], t;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        x[j] = masked_score(s[i][j], scale, cap,
                            kp < Sk && allowed(mk, qp, kp), t);
      }
      const float m_new = fmaxf(m[i], half_warp_max(fmaxf(x[0], x[1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
      l[i] = alpha * l[i] + half_warp_sum(p0 + p1);
      dd[i] = alpha * dd[i] + half_warp_sum(p0 * dp[i][0] + p1 * dp[i][1]);
      m[i] = m_new;
    }
  }
  float drow[4];
  const long long plane = (long long)gridDim.y * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    drow[i] = dd[i] / l[i];
    const int row = q0 + 4 * ty + i;
    if (tx == 0 && row < Sq) {
      float* st = stats + (long long)bh * Sq + row;
      st[0] = m[i];
      st[plane] = l[i];
      st[2 * plane] = drow[i];
    }
  }

  // pass 2: dq = sum over keys of dS k
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_tile<T, D>(sk, kb, ks.s, k0, kBK, Sk);
    load_tile<T, D>(sv, vb, vs.s, k0, kBK, Sk);
    __syncthreads();
    float s[4][2], dp[4][2];
    row_scores<T, D>(sq, sdo, sk, sv, tx, ty, s, dp);
    float ds[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        float t;
        const float x = masked_score(s[i][j], scale, cap,
                                     kp < Sk && allowed(mk, qp, kp), t);
        const float p = expf(x - m[i]) / l[i];
        ds[i][j] = dscore(p, dp[i][j], drow[i], t, scale, cap);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(&sds[(tx + 16 * j) * kLP + 4 * ty]) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();
    rows_times_tile<T, D>(acc, sds, sk, tx, ty);
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    T* out = dqb + row * dqs.s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[out_col<D>(tx, c)] = from_float<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const T* __restrict__ dout,
                                    T* __restrict__ dk, T* __restrict__ dv,
                                    const float* __restrict__ stats, int H,
                                    int K, int Sq, int Sk, Strides qs,
                                    Strides ks, Strides vs, Strides dos,
                                    Strides dks, Strides dvs, Mask mk,
                                    float scale, float cap) {
  constexpr int LD = kLD<T, D>;
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  T* sk = reinterpret_cast<T*>(smem4);  // kBK x LD
  T* sv = sk + kBK * LD;                // kBK x LD
  T* sq = sv + kBK * LD;                // kBQ x LD
  T* sdo = sq + kBQ * LD;               // kBQ x LD
  float* sp = reinterpret_cast<float*>(sdo + kBQ * LD);  // kBQ x kLT, P
  float* sds = sp + kBQ * kLT;                           // kBQ x kLT, dS

  const int k0 = blockIdx.x * kBK;  // under causal the first keys are read most
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int group = H / K;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D>(sk, k + b * ks.b + kh * ks.h, ks.s, k0, kBK, Sk);
  load_tile<T, D>(sv, v + b * vs.b + kh * vs.h, vs.s, k0, kBK, Sk);

  // queries [q_begin, q_end) hold every one that may read the tile's keys
  const int q_begin = mk.causal && k0 >= mk.prefix ? min(k0, Sq) : 0;
  const int q_end =
      mk.window > 0 ? min(Sq, k0 + kBK - 1 + mk.window) : Sq;
  const long long plane = (long long)gridDim.y / K * H * Sq;

  float akd[2][NC], avd[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) akd[i][c] = avd[i][c] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const float* st = stats + (long long)(b * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(sq, qb, qs.s, q0, kBQ, Sq);
      load_tile<T, D>(sdo, dob, dos.s, q0, kBQ, Sq);
      // the stored m, l and D of queries tx + 16 j (neutral past Sq,
      // where every score is masked)
      float mj[4], lj[4], dj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + tx + 16 * j;
        const bool in = qp < Sq;
        mj[j] = in ? st[qp] : 0.0f;
        lj[j] = in ? st[plane + qp] : 1.0f;
        dj[j] = in ? st[2 * plane + qp] : 0.0f;
      }
      __syncthreads();

      float s[2][4], dp[2][4];
      key_scores<T, D>(sk, sv, sq, sdo, tx, ty, s, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + tx + 16 * j;
        float p[2], ds[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kp = k0 + 2 * ty + i;
          float t;
          const float x = masked_score(
              s[i][j], scale, cap, qp < Sq && kp < Sk && allowed(mk, qp, kp),
              t);
          p[i] = expf(x - mj[j]) / lj[j];
          ds[i] = dscore(p[i], dp[i][j], dj[j], t, scale, cap);
        }
        *reinterpret_cast<float2*>(&sp[(tx + 16 * j) * kLT + 2 * ty]) =
            make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(&sds[(tx + 16 * j) * kLT + 2 * ty]) =
            make_float2(ds[0], ds[1]);
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q over the tile's queries, in order
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        const float2 pv = *reinterpret_cast<const float2*>(&sp[r * kLT + 2 * ty]);
        const float2 dsv =
            *reinterpret_cast<const float2*>(&sds[r * kLT + 2 * ty]);
        if constexpr (D % 64 == 0) {
#pragma unroll
          for (int c = 0; c < NC / 4; ++c) {
            const float4 dov = ld4(&sdo[r * LD + 4 * tx + 64 * c]);
            const float4 qv = ld4(&sq[r * LD + 4 * tx + 64 * c]);
            const float dor[4] = {dov.x, dov.y, dov.z, dov.w};
            const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              avd[0][4 * c + e] += pv.x * dor[e];
              avd[1][4 * c + e] += pv.y * dor[e];
              akd[0][4 * c + e] += dsv.x * qr[e];
              akd[1][4 * c + e] += dsv.y * qr[e];
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float dov = ld1(&sdo[r * LD + out_col<D>(tx, c)]);
            const float qv = ld1(&sq[r * LD + out_col<D>(tx, c)]);
            avd[0][c] += pv.x * dov;
            avd[1][c] += pv.y * dov;
            akd[0][c] += dsv.x * qv;
            akd[1][c] += dsv.y * qv;
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + kh * dks.h;
  T* dvb = dv + b * dvs.b + kh * dvs.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + 2 * ty + i;
    if (row >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkb[row * dks.s + out_col<D>(tx, c)] = from_float<T>(akd[i][c]);
      dvb[row * dvs.s + out_col<D>(tx, c)] = from_float<T>(avd[i][c]);
    }
  }
}

// shared memory: the four tiles in the input type, then the f32 scratch
// (dS, and P in (2))
template <typename T, int D>
constexpr int dq_smem_bytes() {
  return int((2 * kBQ + 2 * kBK) * kLD<T, D> * sizeof(T) +
             kBK * kLP * sizeof(float));
}

template <typename T, int D>
constexpr int dkdv_smem_bytes() {
  return int((2 * kBK + 2 * kBQ) * kLD<T, D> * sizeof(T) +
             2 * kBQ * kLT * sizeof(float));
}

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  float* stats;
  int B, H, K, Sq, Sk;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  Mask mk;
  float scale, cap;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem1 = dq_smem_bytes<T, D>();
  constexpr int smem2 = dkdv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  flash_attention_bwd_dq_kernel<T, D>
      <<<dim3((a.Sq + kBQ - 1) / kBQ, a.B * a.H), kThreads, smem1, stream>>>(
          q, k, v, dout, static_cast<T*>(a.dq), a.stats, a.H, a.H / a.K, a.Sq,
          a.Sk, a.qs, a.ks, a.vs, a.dos, a.dqs, a.mk, a.scale, a.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_kernel<T, D>
      <<<dim3((a.Sk + kBK - 1) / kBK, a.B * a.K), kThreads, smem2, stream>>>(
          q, k, v, dout, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
          a.stats, a.H, a.K, a.Sq, a.Sk, a.qs, a.ks, a.vs, a.dos, a.dks,
          a.dvs, a.mk, a.scale, a.cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 112: return launch<T, 112>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The C entry of flash_attention_bwd_f32.cu: strides
// (b, h, s) in elements for q, k, v, dout, dq, dk, dv in that order;
// stats 3 B H Sq floats of scratch (m, l, D); window 0 and prefix 0 mean
// none (a window or a prefix needs Sq == Sk); cap <= 0 means no softcap.
// Returns a cudaError_t.
template <typename T>
int bwd_entry(int device, const void* q, const void* k, const void* v,
              const void* dout, void* dq, void* dk, void* dv, float* stats,
              int B, int H, int K, int Sq, int Sk, int D,
              const long long* strides, int causal, int window, int prefix,
              float scale, float cap, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (K <= 0 || H % K != 0 || window < 0 || prefix < 0)
    return int(cudaErrorInvalidValue);
  const auto st = [&](int i) {
    return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  const Args a{q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Sk,
               st(0), st(1), st(2), st(3), st(4), st(5), st(6),
               Mask{causal, window, prefix}, scale, cap};
  return int(launch_d<T>(D, a, static_cast<cudaStream_t>(stream)));
}

}  // namespace
