// Slot-dispatch recursion of the finite-capacity replay, for Hopper (sm_90a).
//
// Replaces XLA's lowering of the reference's serial `lax.scan`
// (src/repro/cluster/events.py: `_pool_step` under `dispatch_scan` and
// `dispatch_prefix_scan`); the reference has no Pallas kernel for it.
//
// Semantics. Rows are attempt-units already in dispatch order. Each of the
// first `*count` rows takes the earliest-idle slot si of a pool of K slots
// (the lowest slot index among equal minima) and
//     start = fmaxf(release, free[si]);  free[si] = start + hold   (f32)
// Rows at or past `*count` report their release and touch no slot. The
// pool's initial state is read from `pool` and its final state written
// back there (the reference's SlotPool carry). The reference takes the
// argmin over a two-level (G, g) grid with a cached minimum per group; the
// first group whose minimum is the least holds the lowest flat index that
// reaches it, so any layout that takes the lowest index among equal
// minima gives its starts bit for bit.
//
// What bounds it: neither bytes nor operations but the serial chain. Each
// step depends on the pool the previous step left, so one warp walks the
// rows one at a time, and the time is steps x (the latency of one step +
// the instructions one warp issues in it). The design keeps both short:
//   * slot s belongs to lane s % 32, at position q = s / 32, and each lane
//     keeps the least (key, position) of its own slots in two registers;
//     a step's argmin is two warp reductions (`redux.sync.min.u32`) over
//     order-preserving u32 keys of the times: the least key, then the
//     least slot index holding it;
//   * a lane's positions are split into groups of b = 2^lb >= 16 (16 when
//     K <= 512; else the power of two at or above sqrt(K / 32)), padded
//     with empty slots, with each group's least (key, position) cached, so
//     the update after a step rescans one group and, when there are
//     several, the group minima: 16 reads at fixed offsets at a time,
//     their minimum taken as a tree;
//   * every lane does the owner's update, reading the owner's slots as a
//     broadcast and writing the same values to the same addresses, so the
//     warp never diverges and each lane reads only what it wrote itself
//     (after one barrier past the set-up); the owner keeps the result;
//   * the pool's keys live in shared memory while the padded pool and the
//     group minima fit in the 227 KB a block may use, else in device
//     memory (the f32 pool itself, keyed at each read; the group minima
//     stay in shared memory);
//   * the rows' release and hold are loaded 32 at a time, one row a lane,
//     off the chain, and passed to the step by a shuffle; each lane keeps
//     the start of its own row and the 32 starts are stored together.
// Blocks 1.. copy release to start for the rows past *count (grid-stride),
// so one launch does a whole pass and the host never reads *count.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // above every finite or infinite key
constexpr int kChunk = 16;               // reads an update takes together
constexpr int kThreads = 256;            // copy blocks; block 0 uses warp 0
constexpr int kMaxCopyBlocks = 528;      // four a streaming multiprocessor
constexpr size_t kSmemLimit = 232448;    // the dynamic shared memory of a block

// Order-preserving map of a float onto u32 (-0.0 taken as +0.0, so equal
// floats get equal keys); NaN is not expected.
__device__ __forceinline__ unsigned key_of(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The shape of the per-lane layout.
struct Layout {
  int K;    // slots
  int lb;   // log2 of the positions of a group (a multiple of kChunk)
  int nb;   // groups a lane
  int nbp;  // nb rounded up to kChunk (the group minima's rows)
};

// (ka, ia) = the lesser of (ka, ia) and (kb, ib); a tie keeps a, the
// operand with the lower index.
__device__ __forceinline__ void keep_min(unsigned& ka, unsigned& ia,
                                         unsigned kb, unsigned ib) {
  const bool b = kb < ka;
  ka = b ? kb : ka;
  ia = b ? ib : ia;
}

// The least (k, i) of a chunk into (k[0], i[0]), ties to the lower index
// (i must rise with j): a tree over adjacent blocks, so the left operand
// always holds the lower indices. Every index is known at compile time, so
// the chunk stays in registers.
static_assert(kChunk == 16, "chunk_min is written for 16 values");
__device__ __forceinline__ void chunk_min(unsigned (&k)[kChunk],
                                          unsigned (&i)[kChunk]) {
#pragma unroll
  for (int j = 0; j < 16; j += 2) keep_min(k[j], i[j], k[j + 1], i[j + 1]);
#pragma unroll
  for (int j = 0; j < 16; j += 4) keep_min(k[j], i[j], k[j + 2], i[j + 2]);
#pragma unroll
  for (int j = 0; j < 16; j += 8) keep_min(k[j], i[j], k[j + 4], i[j + 4]);
  keep_min(k[0], i[0], k[8], i[8]);
}

// The pool as one lane sees it: keys at [q * 32 + lane] (in shared memory,
// padded to nb << lb positions, or read from the f32 pool in device memory
// and bounded by K), group minima at [c * 32 + lane].
template <bool kShared>
struct Pool {
  Layout L;
  unsigned* keys;   // kShared
  float* pool;      // !kShared
  unsigned* gkey;   // the least key of each group
  unsigned* gpos;   // the position holding it

  __device__ __forceinline__ unsigned load(int lane, int q) const {
    const int s = q * 32 + lane;
    if constexpr (kShared) return keys[s];
    else return s < L.K ? key_of(pool[s]) : kNone;
  }

  // Rescan group c of `lane`: its least (key, position).
  __device__ __forceinline__ void group_min(int lane, int c, unsigned& k0,
                                            unsigned& q0) const {
    k0 = kNone;
    q0 = 0;
    for (int base = c << L.lb; base < (c + 1) << L.lb; base += kChunk) {
      unsigned k[kChunk], i[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        k[j] = load(lane, base + j);
        i[j] = base + j;
      }
      chunk_min(k, i);
      keep_min(k0, q0, k[0], i[0]);
    }
  }

  // After a store into group c of `lane`: the lane's least (key,
  // position), through the cached group minima when there are several.
  __device__ __forceinline__ void update(int lane, int c, unsigned& k0,
                                         unsigned& q0) const {
    group_min(lane, c, k0, q0);
    if (L.nb == 1) return;
    gkey[c * 32 + lane] = k0;
    gpos[c * 32 + lane] = q0;
    k0 = kNone;
    for (int base = 0; base < L.nbp; base += kChunk) {
      unsigned k[kChunk], i[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        k[j] = gkey[(base + j) * 32 + lane];
        i[j] = gpos[(base + j) * 32 + lane];
      }
      chunk_min(k, i);
      keep_min(k0, q0, k[0], i[0]);
    }
  }
};

// The recursion, by warp 0 of block 0.
template <bool kShared>
__device__ void recurse(const float* __restrict__ release,
                        const float* __restrict__ hold, int n_active,
                        float* pool, const Layout L,
                        float* __restrict__ start, unsigned* smem) {
  const int lane = threadIdx.x;
  const int positions = L.nb << L.lb;
  const Pool<kShared> P{L, smem + 2 * L.nbp * 32, pool, smem,
                        smem + L.nbp * 32};
  if constexpr (kShared) {
    for (int q = 0; q < positions; ++q) {
      const int s = q * 32 + lane;
      P.keys[s] = s < L.K ? key_of(pool[s]) : kNone;
    }
  }
  for (int c = 0; c < L.nbp; ++c) {  // padded rows hold no slot
    unsigned k = kNone, q = 0;
    if (c < L.nb) P.group_min(lane, c, k, q);
    P.gkey[c * 32 + lane] = k;
    P.gpos[c * 32 + lane] = q;
  }
  unsigned my_key, my_pos;
  P.update(lane, 0, my_key, my_pos);
  __syncwarp();  // from here on every lane writes what every lane reads

  for (int base = 0; base < n_active; base += 32) {
    const int row = base + lane;
    const float my_rel = row < n_active ? release[row] : 0.0f;
    const float my_hold = row < n_active ? hold[row] : 0.0f;
    float my_start = my_rel;
    const int steps = min(32, n_active - base);
    for (int k = 0; k < steps; ++k) {
      const float rel = __shfl_sync(kFull, my_rel, k);
      const float h = __shfl_sync(kFull, my_hold, k);
      const unsigned best = __reduce_min_sync(kFull, my_key);
      const unsigned slot = __reduce_min_sync(
          kFull, my_key == best ? my_pos * 32u + lane : kNone);
      const float st = fmaxf(rel, value_of(best));
      if (lane == k) my_start = st;
      const int owner = int(slot & 31u);
      const float freed = __fadd_rn(st, h);
      if constexpr (kShared) P.keys[slot] = key_of(freed);
      else pool[slot] = freed;
      unsigned nk, nq;
      P.update(owner, int(slot >> 5) >> L.lb, nk, nq);
      if (lane == owner) {
        my_key = nk;
        my_pos = nq;
      }
    }
    if (row < n_active) start[row] = my_start;
  }
  if constexpr (kShared) {
    __syncwarp();
    for (int q = 0; q < positions; ++q) {
      const int s = q * 32 + lane;
      if (s < L.K) pool[s] = value_of(P.keys[s]);
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    dispatch_scan_kernel(const float* __restrict__ release,
                         const float* __restrict__ hold,
                         const int* __restrict__ count, int n, float* pool,
                         Layout L, float* __restrict__ start) {
  extern __shared__ unsigned smem[];
  const int n_active = max(0, min(*count, n));
  if (blockIdx.x == 0) {
    if (threadIdx.x < 32)
      recurse<kShared>(release, hold, n_active, pool, L, start, smem);
    return;
  }
  const int stride = (gridDim.x - 1) * blockDim.x;
  for (int i = n_active + (blockIdx.x - 1) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    start[i] = release[i];
}

Layout layout_of(int K) {
  const int M = (K + 31) / 32;  // positions a lane
  int lb = 4;
  while ((1 << lb) * (1 << lb) < M) ++lb;
  Layout L;
  L.K = K;
  L.lb = lb;
  L.nb = (M + (1 << lb) - 1) >> lb;
  L.nbp = (L.nb + kChunk - 1) / kChunk * kChunk;
  return L;
}

size_t group_bytes(const Layout& L) {
  return size_t(2) * L.nbp * 32 * sizeof(unsigned);
}

size_t shared_pool_bytes(const Layout& L) {
  return group_bytes(L) + (size_t(L.nb) << L.lb) * 32 * sizeof(unsigned);
}

}  // namespace

// 1 if a pool of K slots lives in shared memory, else 0 (device memory).
extern "C" int dispatch_scan_pool_shared(int K) {
  return K >= 1 && shared_pool_bytes(layout_of(K)) <= kSmemLimit ? 1 : 0;
}

// Returns the cudaError_t of the launch (0 on success); 1 (invalid value)
// for K < 1 or group minima past the shared-memory limit.
extern "C" int dispatch_scan_launch(int device, const float* release,
                                    const float* hold, const int* count,
                                    int n, float* pool, int K, float* start,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (K < 1) return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const Layout L = layout_of(K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks =
      1 + min(kMaxCopyBlocks, max(1, (n + kThreads - 1) / kThreads));
  if (dispatch_scan_pool_shared(K)) {
    const size_t bytes = shared_pool_bytes(L);
    err = cudaFuncSetAttribute(dispatch_scan_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
    if (err != cudaSuccess) return int(err);
    dispatch_scan_kernel<true><<<blocks, kThreads, bytes, s>>>(
        release, hold, count, n, pool, L, start);
  } else {
    const size_t bytes = group_bytes(L);
    if (bytes > kSmemLimit) return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(dispatch_scan_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
    if (err != cudaSuccess) return int(err);
    dispatch_scan_kernel<false><<<blocks, kThreads, bytes, s>>>(
        release, hold, count, n, pool, L, start);
  }
  return int(cudaGetLastError());
}
