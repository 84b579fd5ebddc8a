// Counter-keyed Philox4x32-10 uniforms for Hopper (sm_90a): row t of the
// output holds `cols` uniforms in [1e-7, 1) drawn at the coordinates
// (cells[t], rows[t]), and at nothing else.
//
// Replaces the reference's per-request and per-block key folding
// (`jax.random.fold_in(key, rid)` in src/repro/serve/scheduler.py:162 and
// `fold_in(key, block)` in src/repro/fleet/runner.py), which XLA lowered;
// the reference has no Pallas kernel for it. The port's earlier source
// seeded one torch.Generator per cell on the host (a SeedSequence, a
// generator and about five launches a cell); here the host derives one key
// per (source seed, tag, strategy, replication, draw name) and one launch
// forms every row of a draw.
//
// The generator is Philox4x32 with 10 rounds as Salmon et al. (SC'11)
// define it: multipliers 0xD2511F53 and 0xCD9E8D57, Weyl constants
// 0x9E3779B9 and 0xBB67AE85. Counter words (cell low 32 bits, cell high 32
// bits, row, column / 4); output word column % 4 becomes
//   u = (x >> 8) * 2^-24            (exact: 24 bits times a power of two)
//   u = max(u * span + minval, minval)
// the map of sim/draws.py:to_uniform. __fmul_rn and __fadd_rn keep nvcc
// from contracting the affine map into an FMA, so every value equals the
// plain PyTorch version's (kernels/philox.py) bit for bit.
//
// Bound: bytes. A row reads two int64 coordinates (16 bytes) and writes
// 4 * cols bytes; the ten rounds are 20 32-bit multiplies (10 of them
// high halves) and about 40 integer operations per four outputs, well
// under the integer pipe's rate for the bytes they produce. Design: one
// thread per (row, group of four columns), neighbouring threads on
// neighbouring groups of one row and then the next row, so a warp's
// stores cover one contiguous span of the output.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_scope.h"

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr float kTwoPowMinus24 = 5.9604644775390625e-08f;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float to_uniform(uint32_t x, float span,
                                            float minval) {
  const float u = __fmul_rn(float(x >> 8), kTwoPowMinus24);
  return fmaxf(__fadd_rn(__fmul_rn(u, span), minval), minval);
}

__global__ void __launch_bounds__(kThreads)
philox_rows_kernel(const long long* __restrict__ cells,
                   const long long* __restrict__ rows, long long n_rows,
                   int cols, uint32_t k0, uint32_t k1, float span,
                   float minval, float* __restrict__ out) {
  const int groups = (cols + 3) >> 2;
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n_rows * groups) return;
  const long long t = i / groups;
  const int g = int(i - t * groups);
  const unsigned long long cell = (unsigned long long)cells[t];
  const uint4 x = philox10(
      make_uint4(uint32_t(cell), uint32_t(cell >> 32), uint32_t(rows[t]),
                 uint32_t(g)),
      k0, k1);
  float* o = out + t * cols + 4 * g;
  const int n = min(4, cols - 4 * g);
  o[0] = to_uniform(x.x, span, minval);
  if (n > 1) o[1] = to_uniform(x.y, span, minval);
  if (n > 2) o[2] = to_uniform(x.z, span, minval);
  if (n > 3) o[3] = to_uniform(x.w, span, minval);
}

// The raw generator on n (counter, key) pairs: the known-answer check.
__global__ void philox_raw_kernel(const uint32_t* __restrict__ ctr,
                                  const uint32_t* __restrict__ key, int n,
                                  uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 x = philox10(make_uint4(ctr[4 * i], ctr[4 * i + 1],
                                      ctr[4 * i + 2], ctr[4 * i + 3]),
                           key[2 * i], key[2 * i + 1]);
  out[4 * i] = x.x;
  out[4 * i + 1] = x.y;
  out[4 * i + 2] = x.z;
  out[4 * i + 3] = x.w;
}

}  // namespace

// cells, rows: (n_rows,) int64; out: (n_rows, cols) f32. Returns the CUDA
// error of the launch (0 on success).
extern "C" int philox_rows_launch(int device, const long long* cells,
                                  const long long* rows, long long n_rows,
                                  int cols, unsigned int k0, unsigned int k1,
                                  float span, float minval, float* out,
                                  void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  if (n_rows <= 0 || cols <= 0) return 0;
  const long long work = n_rows * ((cols + 3) / 4);
  const long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  philox_rows_kernel<<<unsigned(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      cells, rows, n_rows, cols, k0, k1, span, minval, out);
  return int(cudaGetLastError());
}

// ctr: (n, 4), key: (n, 2), out: (n, 4), all uint32.
extern "C" int philox_raw_launch(int device, const unsigned int* ctr,
                                 const unsigned int* key, int n,
                                 unsigned int* out, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  if (n <= 0) return 0;
  philox_raw_kernel<<<(n + 127) / 128, 128, 0,
                      static_cast<cudaStream_t>(stream)>>>(ctr, key, n, out);
  return int(cudaGetLastError());
}
