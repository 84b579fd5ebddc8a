// Slot-dispatch recursion of the finite-capacity replay, for Hopper (sm_90a).
//
// Replaces XLA's lowering of the reference's serial `lax.scan`
// (src/repro/cluster/events.py: `_pool_step` under `dispatch_scan` and
// `dispatch_prefix_scan`); the reference has no Pallas kernel for it.
//
// Semantics, for each of P independent segments (passes) p: rows are
// attempt-units already in dispatch order. Each of the first count[p] rows
// takes the earliest-idle slot si of the segment's pool of K slots (the
// lowest slot index among equal minima) and
//     start = fmaxf(release, free[si]);  free[si] = start + hold   (f32)
// Rows at or past count[p] report their release and touch no slot. The
// pool's initial state is read from `pool` and its final state written
// back there in slot order (the reference's SlotPool carry). Holds must be
// >= 0 (the engine's `predicted_holds` are, by construction): then a slot
// never becomes idle before it was taken, which the sorted design below
// relies on. Times are not NaN.
//
// What bounds it: neither bytes nor operations but the serial chain. Each
// step depends on the pool the previous step left, so a segment's rows go
// one at a time, and a step costs the latency of its chain or the
// instructions its warps issue in it, whichever is more. Segments are
// independent: block p < P walks segment p, so up to 132 segments each
// have a streaming multiprocessor of their own; blocks P.. copy release to
// start for the rows past count[p] (grid-stride), so one launch does a
// whole batch of passes and the host never reads count.
//
// Two designs, chosen by K (a fixed cutover, not a parameter):
// * K <= 512, the sorted pool (`SortedPool`): the pool is a sorted array
//   of entries (key, slot), ordered by the order-preserving u32 key of the
//   time, then the slot; padding entries hold kNone and sort last. The
//   head is the slot the reference pops. A step removes it and inserts
//   new = (key(st + h), head.slot) >= head, so the sorted result at each
//   position is the median n[p] = min(old[p + 1], max(old[p], new)), with
//   old[512] = +inf: no reduction, no search. The array lives in registers
//   of four warps, one on each of the SM's four sub-partitions, four
//   positions a lane (warp w, lane l: positions 128 w + 4 l ..): the
//   selects of a step run on the integer pipe, 16 lanes a sub-partition,
//   so one warp's 16 positions a lane cost 64 two-cycle SELs a step, and
//   four warps split them. An entry is key << 9 | slot, whose bits read as
//   a double are a positive subnormal, so a compare is one DSETP on the
//   FP64 pipe. The warps meet once a step at a named barrier and exchange
//   through shared memory, double-buffered, each lane's first position (a
//   lane's last position needs the next lane's) and position 3. Every lane
//   keeps copies of positions 0-2 and forms each step's start itself, on
//   floats: the next head is position 1 if its time is below start + hold
//   (or equal, with the lower slot), else the new entry. The initial pool
//   is sorted once per launch (each slot's rank counted by the whole
//   block) and the final one scattered back by slot.
// * K > 512, lane-private groups (`GroupPool`, one warp): slot s belongs to
//   lane s % 32, at position q = s / 32, and each lane keeps the least
//   (key, position) of its own slots in two registers; a step's argmin is
//   two warp reductions (`redux.sync.min.u32`): the least key, then the
//   least slot index holding it. A lane's positions are split into groups
//   of b = 2^lb >= 16 (the power of two at or above sqrt(K / 32)), padded
//   with empty slots, with each group's least (key, position) cached, so
//   the update after a step rescans one group and the group minima: 16
//   reads at fixed offsets at a time, their minimum taken as a tree. Every
//   lane does the owner's update, reading the owner's slots as a broadcast
//   and writing the same values to the same addresses, so the warp never
//   diverges and each lane reads only what it wrote itself; the owner
//   keeps the result. The keys live in shared memory while the padded pool
//   and the group minima fit in a block's shared memory (about 55,000
//   slots), else the f32 pool stays in device memory, keyed at each read.
// Both designs read the rows 32 at a time, one row a lane, with the next
// chunk's loads issued while this chunk runs; whole chunks go four steps at
// a time, with the four rows' release and hold shuffled into registers a
// group ahead, and the 32 starts of a chunk are stored together.

#include <cuda_runtime.h>

#include "device_scope.h"

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // above every finite or infinite key
constexpr int kChunk = 16;               // reads a group update takes together
constexpr int kThreads = 256;            // a block; 1 or 4 warps recurse
constexpr int kMaxCopyBlocks = 528;      // four a streaming multiprocessor
// the dynamic shared memory of a block: its 227 KB less room for the
// static (the walk's 128-byte chunk of starts)
constexpr size_t kSmemLimit = 232448 - 1024;
constexpr int kSortedSlots = 512;        // the cutover
// one a sub-partition of the SM; a build may set it (1, 2 or 4) to time
// the split, as chip_smoke.py does
#ifndef DISPATCH_SORTED_WARPS
#define DISPATCH_SORTED_WARPS 4
#endif
constexpr int kSortedWarps = DISPATCH_SORTED_WARPS;
constexpr int kLanePositions = kSortedSlots / (32 * kSortedWarps);  // 4

// How a launch keeps its pools (the C entry picks one by K).
enum Design { kSorted = 0, kGroupsShared = 1, kGroupsDevice = 2 };

// Order-preserving map of a float onto u32 (-0.0 taken as +0.0 by the
// rounded add, so equal floats get equal keys): negative floats inverted,
// the others' sign bit set. NaN is not expected.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.0f));
  return b ^ (unsigned(int(b) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float(k ^ (unsigned(int(~k) >> 31) | 0x80000000u));
}

// ---------------------------------------------------------------------------
// The walk over a segment's rows, for either design's `step`.
// ---------------------------------------------------------------------------

// Each `step` gets the row it dispatches and the row after it (`prime`
// gets the first), so a pool may form the next step's start before it
// finishes this step's update; it returns the row's start. Whole chunks
// go four steps at a time, every lane holding the four rows' release and
// hold in registers, shuffled a group ahead so no step waits on a shuffle.
template <class Pool>
__device__ __forceinline__ void walk(Pool& pool,
                                     const float* __restrict__ release,
                                     const float* __restrict__ hold,
                                     int n_active, float* __restrict__ start) {
  constexpr int kGroup = 4;
  // a chunk's starts, a row of 32 for each of the pool's warps: every lane
  // holds a step's start and stores it to the same word (no guard on the
  // lane, whose predicate the compiler would rebuild from the thread index
  // inside the loop); warp 0 writes them out
  __shared__ float chunk_starts[Pool::kWarps][32];
  const int lane = threadIdx.x & 31;
  float* starts = chunk_starts[threadIdx.x >> 5];
  const bool writer = threadIdx.x < 32;
  if (n_active <= 0) return;
  // holds are loaded as h + 0.0, which makes -0.0 +0.0 and keeps the rest
  float cur_rel = lane < n_active ? release[lane] : 0.0f;
  float cur_hold = lane < n_active ? __fadd_rn(hold[lane], 0.0f) : 0.0f;
  float rel[kGroup], hl[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    rel[i] = __shfl_sync(kFull, cur_rel, i);
    hl[i] = __shfl_sync(kFull, cur_hold, i);
  }
  pool.prime(rel[0], hl[0]);
  for (int base = 0; base < n_active; base += 32) {
    const int ahead = base + 32 + lane;  // the next chunk, loaded meanwhile
    const float next_rel = ahead < n_active ? release[ahead] : 0.0f;
    const float next_hold =
        ahead < n_active ? __fadd_rn(hold[ahead], 0.0f) : 0.0f;
    if (n_active - base >= 32) {
#pragma unroll 1
      for (int g = 0; g < 32; g += kGroup) {
        // the next group's rows: this chunk's, or the next chunk's first
        const bool last = g + kGroup == 32;
        float nrel[kGroup], nhl[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int src = (g + kGroup + i) & 31;
          nrel[i] = __shfl_sync(kFull, last ? next_rel : cur_rel, src);
          nhl[i] = __shfl_sync(kFull, last ? next_hold : cur_hold, src);
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float st = pool.step(rel[i], hl[i],
                                     i + 1 < kGroup ? rel[i + 1] : nrel[0],
                                     i + 1 < kGroup ? hl[i + 1] : nhl[0]);
          starts[g + i] = st;
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          rel[i] = nrel[i];
          hl[i] = nhl[i];
        }
      }
    } else {  // the last, partial chunk: a shuffle a step
      for (int k = 0; k < n_active - base; ++k) {
        const float st = pool.step(
            __shfl_sync(kFull, cur_rel, k), __shfl_sync(kFull, cur_hold, k),
            __shfl_sync(kFull, cur_rel, (k + 1) & 31),
            __shfl_sync(kFull, cur_hold, (k + 1) & 31));
        starts[k] = st;
      }
    }
    __syncwarp();
    if (writer && base + lane < n_active) start[base + lane] = starts[lane];
    __syncwarp();
    cur_rel = next_rel;
    cur_hold = next_hold;
  }
}

// ---------------------------------------------------------------------------
// K <= 512: the sorted pool in registers.
// ---------------------------------------------------------------------------

// An entry (key, slot) as key << 9 | slot: below 2^41, so its bits read as
// a double are a positive subnormal, and the doubles' order is the
// entries' lexicographic order (FP64 never flushes subnormals). sm_90 has
// no FP64 min or max (fmin expands to compares, selects and NaN fix-ups),
// so the selects stay integer SELs.
constexpr int kSlotBits = 9;
static_assert(kSortedSlots == 1 << kSlotBits, "a slot fills the low bits");

__device__ __forceinline__ u64 entry(unsigned key, unsigned slot) {
  return (u64(key) << kSlotBits) | slot;
}

__device__ __forceinline__ unsigned key_part(u64 e) {
  return unsigned(e >> kSlotBits);
}

__device__ __forceinline__ unsigned slot_part(u64 e) {
  return unsigned(e) & (kSortedSlots - 1);
}

__device__ __forceinline__ bool below(u64 a, u64 b) {
  return __longlong_as_double(a) < __longlong_as_double(b);
}

// key_of without the -0.0 fix, for the times the sorted walk forms: a
// start plus a hold that `walk` made +0.0 if it was -0.0 (a sum that is 0
// is then +0.0)
__device__ __forceinline__ unsigned key_bits(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ (unsigned(int(b) >> 31) | 0x80000000u);
}

// The pool's edges, exchanged between its warps once a step through shared
// memory, double-buffered: every lane's first position (a lane's last
// position needs the next lane's, across warps too; entry 128 is +inf) and
// every lane's fourth (lane 0 of warp 0 holds position 3, which refreshes
// the copies of positions 0-2).
static_assert(kLanePositions >= 4, "lane 0 of warp 0 holds position 3");
struct Edges {
  u64 first[32 * kSortedWarps + 1];
  u64 fourth[32 * kSortedWarps];
};

__device__ __forceinline__ void sorted_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kSortedWarps) : "memory");
}

struct SortedPool {
  static constexpr int kWarps = kSortedWarps;
  u64 r[kLanePositions];  // positions 128 warp + 4 lane .. + 3
  u64 h0, h1, h2;         // every lane's copy of positions 0, 1 and 2
  float t1;               // the time of position 1
  float st, freed;        // the pending row's start, and start + hold
  Edges* rd;              // the edges of the state this step starts from
  Edges* wr;              // the edges of the state it leaves
  int me;                 // 32 warp + lane

  // the median of lo <= hi and x: min(hi, max(lo, x)), each compare's
  // predicate used at once by its two selects
  static __device__ __forceinline__ u64 median(u64 lo, u64 x, u64 hi) {
    const u64 m = below(lo, x) ? x : lo;
    return below(hi, m) ? hi : m;
  }

  __device__ __forceinline__ void publish() {
    wr->first[me] = r[0];
    wr->fourth[me] = r[3];
  }

  __device__ __forceinline__ void prime(float rel, float hold) {
    st = fmaxf(rel, value_of(key_part(h0)));
    freed = __fadd_rn(st, hold);
    t1 = value_of(key_part(h1));
    publish();
    Edges* t = rd;
    rd = wr;
    wr = t;
  }

  // The chain from one row to the next is on floats alone: the entry the
  // row leaves, new = (freed, head's slot), is never below the head, so
  // the next head is position 1 if it lies below new, else new; the next
  // row's start is its release or that head's time, whichever is later.
  __device__ __forceinline__ float step(float, float, float rel_after,
                                       float hold_after) {
    sorted_barrier();  // every warp has published the state of this step
    const u64 next = rd->first[me + 1];
    const u64 p3 = rd->fourth[0];
    const float st_now = st;
    const float fr = freed;
    // bitwise, not short-circuit: the compiler made && and || a branch
    const bool one_first =
        (t1 < fr) | ((t1 == fr) & (slot_part(h1) < slot_part(h0)));
    st = fmaxf(rel_after, one_first ? t1 : fr);
    freed = __fadd_rn(st, hold_after);
    const u64 nw = entry(key_bits(fr), slot_part(h0));
    h0 = one_first ? h1 : nw;
    h1 = median(h1, nw, h2);
    t1 = value_of(key_part(h1));
    h2 = median(h2, nw, p3);
    // n[p] = min(old[p + 1], max(old[p], new)), old[512] above every entry
#pragma unroll
    for (int j = 0; j < kLanePositions; ++j)
      r[j] = median(r[j], nw, j + 1 < kLanePositions ? r[j + 1] : next);
    publish();
    Edges* t = rd;
    rd = wr;
    wr = t;
    return st_now;
  }
};

// One segment with the sorted pool: the whole block ranks the K slots
// (padded to 512 with kNone, whose slot indices keep them distinct), warps
// 0-3 walk the rows and scatter the final pool back by slot.
__device__ void sorted_recurse(const float* __restrict__ release,
                               const float* __restrict__ hold, int n_active,
                               float* pool, int K, float* __restrict__ start) {
  __shared__ u64 entries[kSortedSlots];
  __shared__ u64 sorted[kSortedSlots];
  __shared__ Edges edges[2];
  for (int s = threadIdx.x; s < kSortedSlots; s += blockDim.x)
    entries[s] = entry(s < K ? key_of(pool[s]) : kNone, unsigned(s));
  if (threadIdx.x < 2)  // +inf after the last position
    edges[threadIdx.x].first[32 * kSortedWarps] = 0x7ff0000000000000ull;
  __syncthreads();
  for (int s = threadIdx.x; s < kSortedSlots; s += blockDim.x) {
    const u64 e = entries[s];
    int rank = 0;
    for (int t = 0; t < kSortedSlots; ++t) rank += entries[t] < e;
    sorted[rank] = e;
  }
  __syncthreads();
  if (threadIdx.x >= 32 * kSortedWarps) return;
  SortedPool P;
  P.me = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kLanePositions; ++j)
    P.r[j] = sorted[P.me * kLanePositions + j];
  P.h0 = sorted[0];
  P.h1 = sorted[1];
  P.h2 = sorted[2];
  P.rd = &edges[1];  // prime publishes the first state into edges[0]
  P.wr = &edges[0];
  walk(P, release, hold, n_active, start);
#pragma unroll
  for (int j = 0; j < kLanePositions; ++j) {
    const unsigned slot = slot_part(P.r[j]);
    if (slot < unsigned(K)) pool[slot] = value_of(key_part(P.r[j]));
  }
}

// ---------------------------------------------------------------------------
// K > 512: lane-private groups.
// ---------------------------------------------------------------------------

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
struct GroupPool {
  static constexpr int kWarps = 1;
  Layout L;
  unsigned* keys;   // kShared
  float* pool;      // !kShared
  unsigned* gkey;   // the least key of each group
  unsigned* gpos;   // the position holding it
  int lane;
  unsigned my_key, my_pos;  // the least (key, position) of the lane's slots

  __device__ __forceinline__ unsigned load(int owner, int q) const {
    const int s = q * 32 + owner;
    if constexpr (kShared) return keys[s];
    else return s < L.K ? key_of(pool[s]) : kNone;
  }

  // Rescan group c of `owner`: its least (key, position).
  __device__ __forceinline__ void group_min(int owner, int c, unsigned& k0,
                                            unsigned& q0) const {
    k0 = kNone;
    q0 = 0;
    for (int base = c << L.lb; base < (c + 1) << L.lb; base += kChunk) {
      unsigned k[kChunk], i[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        k[j] = load(owner, base + j);
        i[j] = base + j;
      }
      chunk_min(k, i);
      keep_min(k0, q0, k[0], i[0]);
    }
  }

  // After a store into group c of `owner`: the owner's least (key,
  // position), through the cached group minima when there are several.
  __device__ __forceinline__ void update(int owner, int c, unsigned& k0,
                                         unsigned& q0) const {
    group_min(owner, c, k0, q0);
    if (L.nb == 1) return;
    gkey[c * 32 + owner] = k0;
    gpos[c * 32 + owner] = q0;
    k0 = kNone;
    for (int base = 0; base < L.nbp; base += kChunk) {
      unsigned k[kChunk], i[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        k[j] = gkey[(base + j) * 32 + owner];
        i[j] = gpos[(base + j) * 32 + owner];
      }
      chunk_min(k, i);
      keep_min(k0, q0, k[0], i[0]);
    }
  }

  __device__ __forceinline__ void prime(float, float) {}

  __device__ __forceinline__ float step(float rel, float h, float, float) {
    const unsigned best = __reduce_min_sync(kFull, my_key);
    const unsigned slot = __reduce_min_sync(
        kFull, my_key == best ? my_pos * 32u + lane : kNone);
    const float st = fmaxf(rel, value_of(best));
    const int owner = int(slot & 31u);
    const float freed = __fadd_rn(st, h);
    if constexpr (kShared) keys[slot] = key_of(freed);
    else pool[slot] = freed;
    unsigned nk, nq;
    update(owner, int(slot >> 5) >> L.lb, nk, nq);
    if (lane == owner) {
      my_key = nk;
      my_pos = nq;
    }
    return st;
  }
};

// One segment with lane-private groups, by warp 0.
template <bool kShared>
__device__ void group_recurse(const float* __restrict__ release,
                              const float* __restrict__ hold, int n_active,
                              float* pool, const Layout L,
                              float* __restrict__ start, unsigned* smem) {
  const int lane = threadIdx.x;
  const int positions = L.nb << L.lb;
  GroupPool<kShared> P{L, smem + 2 * L.nbp * 32, pool, smem,
                       smem + L.nbp * 32, lane, 0u, 0u};
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
  P.update(lane, 0, P.my_key, P.my_pos);
  __syncwarp();  // from here on every lane writes what every lane reads
  walk(P, release, hold, n_active, start);
  if constexpr (kShared) {
    __syncwarp();
    for (int q = 0; q < positions; ++q) {
      const int s = q * 32 + lane;
      if (s < L.K) pool[s] = value_of(P.keys[s]);
    }
  }
}

// ---------------------------------------------------------------------------
// The launch: blocks 0..P-1 walk segment blockIdx.x, the rest copy.
// ---------------------------------------------------------------------------

template <int kDesign>
__global__ void __launch_bounds__(kThreads)
    dispatch_scan_kernel(const float* __restrict__ release,
                         const float* __restrict__ hold,
                         const int* __restrict__ count, int P, int n,
                         float* pool, Layout L, float* __restrict__ start) {
  extern __shared__ unsigned smem[];
  if (blockIdx.x < unsigned(P)) {
    const size_t rows = size_t(blockIdx.x) * n;
    const int n_active = max(0, min(count[blockIdx.x], n));
    float* seg_pool = pool + size_t(blockIdx.x) * L.K;
    if constexpr (kDesign == kSorted) {
      sorted_recurse(release + rows, hold + rows, n_active, seg_pool, L.K,
                     start + rows);
    } else if (threadIdx.x < 32) {
      group_recurse<kDesign == kGroupsShared>(release + rows, hold + rows,
                                              n_active, seg_pool, L,
                                              start + rows, smem);
    }
    return;
  }
  const int stride = (gridDim.x - P) * blockDim.x;
  for (int p = 0; p < P; ++p) {
    const size_t rows = size_t(p) * n;
    for (int i = max(0, min(count[p], n)) + (blockIdx.x - P) * blockDim.x +
                 threadIdx.x;
         i < n; i += stride)
      start[rows + i] = release[rows + i];
  }
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

// The dynamic shared memory a design needs for K slots, or -1 where it
// cannot serve K.
long design_bytes(int design, int K) {
  if (K < 1) return -1;
  const Layout L = layout_of(K);
  switch (design) {
    case kSorted: return K <= kSortedSlots ? 0 : -1;
    case kGroupsShared: {
      const size_t b = shared_pool_bytes(L);
      return b <= kSmemLimit ? long(b) : -1;
    }
    case kGroupsDevice: {
      const size_t b = group_bytes(L);
      return b <= kSmemLimit ? long(b) : -1;
    }
  }
  return -1;
}

template <int kDesign>
cudaError_t launch_design(const float* release, const float* hold,
                          const int* count, int P, int n, float* pool,
                          const Layout& L, float* start, size_t bytes,
                          cudaStream_t s) {
  if (bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        dispatch_scan_kernel<kDesign>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  const int blocks = P + min(kMaxCopyBlocks, max(1, (n + kThreads - 1) /
                                                        kThreads));
  dispatch_scan_kernel<kDesign><<<blocks, kThreads, bytes, s>>>(
      release, hold, count, P, n, pool, L, start);
  return cudaGetLastError();
}

}  // namespace

// The design that serves a pool of K slots: 0 the sorted pool in registers
// (K <= 512), 1 lane-private groups in shared memory, 2 lane-private groups
// with the pool in device memory; -1 for K < 1 or a pool whose group minima
// pass the shared-memory limit.
extern "C" int dispatch_scan_design(int K) {
  for (int d = kSorted; d <= kGroupsDevice; ++d)
    if (design_bytes(d, K) >= 0) return d;
  return -1;
}

// One launch with the given design for P segments of n rows and K slots:
// release, hold and start (P, n), count (P,), pool (P, K), all contiguous.
// Returns the cudaError_t of the launch (0 on success); 1 (invalid value)
// for a design that cannot serve K, P < 1 or K < 1.
extern "C" int dispatch_scan_launch_as(int design, int device,
                                       const float* release,
                                       const float* hold, const int* count,
                                       int P, int n, float* pool, int K,
                                       float* start, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  const long bytes = design_bytes(design, K);
  if (bytes < 0 || P < 1) return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const Layout L = layout_of(K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case kSorted:
      return int(launch_design<kSorted>(release, hold, count, P, n, pool, L,
                                        start, size_t(bytes), s));
    case kGroupsShared:
      return int(launch_design<kGroupsShared>(release, hold, count, P, n,
                                              pool, L, start, size_t(bytes),
                                              s));
    default:
      return int(launch_design<kGroupsDevice>(release, hold, count, P, n,
                                              pool, L, start, size_t(bytes),
                                              s));
  }
}

// The launch with the design dispatch_scan_design(K) chooses.
extern "C" int dispatch_scan_launch(int device, const float* release,
                                    const float* hold, const int* count,
                                    int P, int n, float* pool, int K,
                                    float* start, void* stream) {
  return dispatch_scan_launch_as(dispatch_scan_design(K), device, release,
                                 hold, count, P, n, pool, K, start, stream);
}
