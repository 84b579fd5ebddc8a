// Monte-Carlo PoCD / machine time of the Chronos strategies for Hopper
// (sm_90a): one warp per job, one attempt time per slot range.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/pocd_mc.py:
//   * pocd_mc_pallas     (body _kernel):     one mode per launch;
//   * pocd_mc_all_pallas (body _kernel_all): clone, srestart and sresume in
//     one pass over one shared Pareto transform.
// Both are the same template here: kModes is a bit set of the modes to
// evaluate (one bit for pocd_mc, all three for pocd_mc_all).
//
// For job j with N tasks and R attempt slots per task:
//   att[n][k]  = t_min * exp(-log(u[j][n][k]) / beta)    (Pareto draws)
//   (completion, machine)[n] = the mode's body (strategies/chronos.py,
//                              tile_clone / tile_srestart / tile_sresume)
//   met[j]  = 1 if every task's completion <= D, else 0
//   cost[j] = sum over tasks of machine
// with tau_est = tau_est_frac * t_min and
// tau_kill = tau_est + tau_kill_gap_frac * t_min.
//
// Bound: bytes, J*N*R f32 uniforms read once; at R = 5 every 32-byte
// sector holds some task's slot 0, so every byte is read. But an attempt
// time costs an IEEE logf, a division and an expf, about forty
// instructions, and forming all J*N*R of them keeps the issue slots
// busier than the memory. Design:
//   * every mode reads attempt times only through a minimum over a range
//     of slots: clone over slots 0..r, srestart over 1..r and sresume over
//     1..r+1, the last two for a straggler (T1 > D) only, each cut at
//     R - 1. att(u) is non-increasing in u: logf and expf are
//     non-decreasing over the inputs they get here, and the IEEE division
//     by beta > 0 and product by t_min > 0 are monotone. So the minimum of
//     att over a range is att of the range's largest u, bit for bit, and
//     the kernel forms one attempt time per range (T1, clone's best, and
//     for a straggler one or two more), not R per task.
//     `monotone_violations` below checks the premise over every
//     f32 input (chip_smoke.py phase 7). sresume's max(t_min, (1 - phi) a)
//     is monotone in a, so its minimum follows the same way;
//   * one warp per job, four jobs per block; a warp past J leaves as a
//     whole, so every shuffle sees 32 lanes. Lane l takes tasks l, l + 32,
//     ... and reads a task's slots with loads at stride R: a warp's load
//     of one slot spans 32 R contiguous floats, so L1 serves the other
//     slots. Clone's outcome is folded at once;
//   * a straggler's reactive outcome needs one or two more attempt times,
//     and only about 5% of tasks straggle at the path's job, so forming
//     them at once would hold the warp for one or two lanes in most
//     rounds. Instead a straggler puts T1 and its range maxima into the
//     warp's ring in shared memory; each time 32 are waiting, every lane
//     forms one straggler's attempt times and folds its outcome (the last
//     ones at the job's end). The order of a lane's cost sum so depends
//     only on where the stragglers are, which no mode changes, so the
//     fused launch's row m still equals the single-mode launch of mode m
//     bit for bit; met is an AND and keeps its bits;
//   * per lane a running met (AND) and cost (sum); __all_sync and a
//     butterfly of shuffles reduce them, and lane 0 writes the job's row;
//   * occupancy decides the time here (the kernel waits on loads and
//     transcendentals), so the fused instance is held to 40 registers and
//     the single-mode ones to 32. Two tasks a lane at a time, and a ring
//     of TMA bulk copies into shared memory, were both slower: each cost
//     registers or shared memory, hence resident warps.
//
// Arithmetic follows the plain PyTorch version (kernels/pocd_mc.py) in
// the same order, but for the order of the cost sum (above). Build
// without --use_fast_math (IEEE logf, expf and division); products that
// feed a sum use __fmul_rn / __fadd_rn so nvcc does not contract them
// into an fma. The uniforms must lie in (0, 1]
// (the range maxima use `>`; a NaN would not propagate as torch.amin
// propagates it). An r at or past the slots activates every slot.

#include <cuda_runtime.h>
#include <math.h>

#include "device_scope.h"

namespace {

constexpr int kWarps = 4;  // jobs per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClone = 1, kSrestart = 2, kSresume = 4;  // mode bits

// per mode, in the order clone, srestart, sresume; unused entries are null
struct Rows {
  const int* r[3];
  float* met[3];
  float* cost[3];
};

struct Params {
  int n_jobs, n_tasks, n_slots;
  float tau_est_frac, tau_kill_gap_frac, one_minus_phi;
};

// one job's constants
struct Job {
  float t_min, beta, D, tau_est, tau_kill, gap, one_minus_phi;
  int rc, rr, rm;  // r per mode
  int kc, kr, km;  // last slot of the clone, restart and resume ranges
};

__device__ __forceinline__ float pareto(float u, float t_min, float beta) {
  return __fmul_rn(t_min, expf(__fdiv_rn(-logf(u), beta)));
}

// the largest of m and the uniforms of slots lo..hi of a task
__device__ __forceinline__ float range_max(const float* un, int lo, int hi,
                                           float m) {
  for (int k = lo; k <= hi; ++k) {
    const float v = __ldg(un + k);
    m = v > m ? v : m;
  }
  return m;
}

// tau_est + r (tau_kill - tau_est) + w, left to right as the plain version
__device__ __forceinline__ float reactive_bill(float tau_est, int r, float gap,
                                               float w) {
  return __fadd_rn(__fadd_rn(tau_est, __fmul_rn(float(r), gap)), w);
}

// a straggler's restart minimum (slots 1..kr) and resume minimum (slots
// 1..km) from the largest uniforms of slots 1..lo and 1..hi, lo = min(kr,
// km), hi = max(kr, km): (extra_r, w_m)
template <int kModes>
__device__ __forceinline__ float2 straggler_minima(float m_lo, float m_hi,
                                                   const Job& b) {
  const int kr = (kModes & kSrestart) ? b.kr : 0;
  const int km = (kModes & kSresume) ? b.km : 0;
  const int lo = min(kr, km), hi = max(kr, km);
  const float a_lo = lo > 0 ? pareto(m_lo, b.t_min, b.beta) : INFINITY;
  const float a_hi = hi > lo ? pareto(m_hi, b.t_min, b.beta) : a_lo;
  float w_m = INFINITY;
  if (kModes & kSresume) {
    const float a = km == hi ? a_hi : a_lo;
    if (a < INFINITY) w_m = fmaxf(b.t_min, __fmul_rn(b.one_minus_phi, a));
  }
  return make_float2(kr == hi ? a_hi : a_lo, w_m);
}

template <int kModes>
__global__ void __launch_bounds__(kWarps * 32, kModes == 7 ? 12 : 16)
pocd_mc_kernel(const float* __restrict__ u, const float* __restrict__ t_min_g,
               const float* __restrict__ beta_g, const float* __restrict__ D_g,
               Rows rows, Params p) {
  constexpr bool kReactive = (kModes & (kSrestart | kSresume)) != 0;
  // per warp, a ring of stragglers whose reactive outcome waits: T1 and
  // the largest uniforms of slots 1..lo and 1..hi
  __shared__ float queue[kWarps][3][64];
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= p.n_jobs) return;  // the ragged last block: whole warps leave

  const int R = p.n_slots;
  Job b;
  b.t_min = t_min_g[j];
  b.beta = beta_g[j];
  b.D = D_g[j];
  b.tau_est = __fmul_rn(p.tau_est_frac, b.t_min);
  b.tau_kill = __fadd_rn(b.tau_est, __fmul_rn(p.tau_kill_gap_frac, b.t_min));
  b.gap = b.tau_kill - b.tau_est;
  b.one_minus_phi = p.one_minus_phi;
  b.rc = (kModes & kClone) ? rows.r[0][j] : 0;
  b.rr = (kModes & kSrestart) ? rows.r[1][j] : 0;
  b.rm = (kModes & kSresume) ? rows.r[2][j] : 0;
  b.kc = min(b.rc, R - 1);                // clone: slots k <= r
  b.kr = max(0, min(b.rr, R - 1));        // srestart: k - 1 < r, k >= 1
  b.km = max(0, min(b.rm + 1, R - 1));    // sresume: k - 1 <= r, k >= 1

  bool met_c = true, met_r = true, met_m = true;
  float cost_c = 0.0f, cost_r = 0.0f, cost_m = 0.0f;
  // the reactive modes' outcome of one task; (extra_r, w_m) matter only
  // for a straggler
  auto fold_reactive = [&](float T1, bool strag, float2 mins) {
    if (kModes & kSrestart) {
      const float w_all = fminf(T1 - b.tau_est, mins.x);
      const bool use = strag && b.rr > 0;
      met_r &= (use ? b.tau_est + w_all : T1) <= b.D;
      cost_r += use ? reactive_bill(b.tau_est, b.rr, b.gap, w_all) : T1;
    }
    if (kModes & kSresume) {
      met_m &= (strag ? b.tau_est + mins.y : T1) <= b.D;
      cost_m += strag ? reactive_bill(b.tau_est, b.rm, b.gap, mins.y) : T1;
    }
  };
  const int lo = min((kModes & kSrestart) ? b.kr : 0,
                     (kModes & kSresume) ? b.km : 0);
  const int hi = max((kModes & kSrestart) ? b.kr : 0,
                     (kModes & kSresume) ? b.km : 0);
  float* q_t1 = queue[threadIdx.x >> 5][0];
  float* q_lo = queue[threadIdx.x >> 5][1];
  float* q_hi = queue[threadIdx.x >> 5][2];
  int head = 0, queued = 0;  // the warp's pending stragglers, a ring
  const float* uj = u + size_t(j) * p.n_tasks * R;
  for (int n0 = 0; n0 < p.n_tasks; n0 += 32) {
    const int n = n0 + lane;
    bool strag = false;
    float T1 = 0.0f, m_lo = 0.0f, m_hi = 0.0f;
    if (n < p.n_tasks) {
      const float* un = uj + size_t(n) * R;
      const float u0 = __ldg(un);
      T1 = pareto(u0, b.t_min, b.beta);
      strag = T1 > b.D;
      if (kModes & kClone) {  // min over slots 0..r; r < 0 races nothing
        float best = INFINITY;
        if (b.rc >= 0)
          best = b.kc > 0 ? pareto(range_max(un, 1, b.kc, u0), b.t_min, b.beta)
                          : T1;
        met_c &= best <= b.D;
        cost_c += __fadd_rn(__fmul_rn(float(b.rc), b.tau_kill), best);
      }
      if (kReactive) {
        if (strag) {
          m_lo = range_max(un, 1, lo, 0.0f);
          m_hi = range_max(un, lo + 1, hi, m_lo);
        } else {
          fold_reactive(T1, false, make_float2(INFINITY, INFINITY));
        }
      }
    }
    if (kReactive) {
      // stragglers wait in the ring; 32 of them make one round of the
      // warp, each lane forming one straggler's attempt times
      const unsigned mask = __ballot_sync(kFull, strag);
      if (strag) {
        const int at = (head + queued + __popc(mask & ((1u << lane) - 1u))) & 63;
        q_t1[at] = T1;
        q_lo[at] = m_lo;
        q_hi[at] = m_hi;
      }
      queued += __popc(mask);
      if (queued >= 32) {
        __syncwarp();
        const int at = (head + lane) & 63;
        fold_reactive(q_t1[at], true,
                      straggler_minima<kModes>(q_lo[at], q_hi[at], b));
        head = (head + 32) & 63;
        queued -= 32;
        __syncwarp();
      }
    }
  }
  if (kReactive && queued > 0) {  // the last stragglers
    __syncwarp();
    const int at = (head + lane) & 63;
    if (lane < queued)
      fold_reactive(q_t1[at], true, straggler_minima<kModes>(q_lo[at], q_hi[at], b));
  }

  const bool all_c = __all_sync(kFull, met_c);
  const bool all_r = __all_sync(kFull, met_r);
  const bool all_m = __all_sync(kFull, met_m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cost_c += __shfl_xor_sync(kFull, cost_c, off);
    cost_r += __shfl_xor_sync(kFull, cost_r, off);
    cost_m += __shfl_xor_sync(kFull, cost_m, off);
  }
  if (lane != 0) return;
  if (kModes & kClone) {
    rows.met[0][j] = all_c ? 1.0f : 0.0f;
    rows.cost[0][j] = cost_c;
  }
  if (kModes & kSrestart) {
    rows.met[1][j] = all_r ? 1.0f : 0.0f;
    rows.cost[1][j] = cost_r;
  }
  if (kModes & kSresume) {
    rows.met[2][j] = all_m ? 1.0f : 0.0f;
    rows.cost[2][j] = cost_m;
  }
}

template <int kModes>
cudaError_t launch(const float* u, const float* t_min, const float* beta,
                   const float* D, const Rows& rows, const Params& p,
                   cudaStream_t stream) {
  const int blocks = (p.n_jobs + kWarps - 1) / kWarps;
  pocd_mc_kernel<kModes><<<blocks, kWarps * 32, 0, stream>>>(u, t_min, beta, D,
                                                             rows, p);
  return cudaGetLastError();
}

// counts the f32 inputs x (as bits, in [lo, hi)) where f of the next float
// up is below f(x): logf over the uniforms' range (0, 1], expf over [0, 89)
// (above 88.73 it is inf)
__global__ void monotone_kernel(unsigned lo, unsigned hi, int use_exp,
                                unsigned long long* violations) {
  unsigned long long local = 0;
  for (unsigned i = lo + blockIdx.x * blockDim.x + threadIdx.x; i < hi;
       i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(i), y = __uint_as_float(i + 1);
    const float fx = use_exp ? expf(x) : logf(x);
    const float fy = use_exp ? expf(y) : logf(y);
    local += fy < fx;
  }
  if (local) atomicAdd(violations, local);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); 1 for a mode set
// other than one mode or all three. `modes` has bit m set for each mode
// m (0 clone, 1 srestart, 2 sresume); r_m, met_m and cost_m are that
// mode's (J,) rows and may be null for a mode not asked for.
extern "C" int pocd_mc_launch(int device, int modes, const float* u,
                              const float* t_min, const float* beta,
                              const float* D, const int* r_clone,
                              const int* r_srestart, const int* r_sresume,
                              float* met_clone, float* met_srestart,
                              float* met_sresume, float* cost_clone,
                              float* cost_srestart, float* cost_sresume,
                              int n_jobs, int n_tasks, int n_slots,
                              float tau_est_frac, float tau_kill_gap_frac,
                              float one_minus_phi, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  if (n_jobs <= 0) return 0;
  const Rows rows{{r_clone, r_srestart, r_sresume},
                  {met_clone, met_srestart, met_sresume},
                  {cost_clone, cost_srestart, cost_sresume}};
  const Params p{n_jobs, n_tasks, n_slots, tau_est_frac, tau_kill_gap_frac,
                 one_minus_phi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (modes) {
    case kClone: return int(launch<kClone>(u, t_min, beta, D, rows, p, s));
    case kSrestart: return int(launch<kSrestart>(u, t_min, beta, D, rows, p, s));
    case kSresume: return int(launch<kSresume>(u, t_min, beta, D, rows, p, s));
    case kClone | kSrestart | kSresume:
      return int(launch<kClone | kSrestart | kSresume>(u, t_min, beta, D, rows, p, s));
    default: return 1;
  }
}

// The premise of the range minima, with this build's logf and expf:
// out[0] counts the f32 u in (0, 1] where logf decreases from u to the
// next float, out[1] the x in [0, 89) where expf does. Both must be 0.
// out must hold two zeroed counters.
extern "C" int pocd_mc_monotone_violations(int device,
                                           unsigned long long* out,
                                           void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  cudaError_t err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // logf: u from the smallest subnormal up to the float below 1.0
  monotone_kernel<<<1024, 256, 0, s>>>(0x00000001u, 0x3f800000u, 0, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // expf: x from +0 up to the float below 89.0
  monotone_kernel<<<1024, 256, 0, s>>>(0x00000000u, 0x42b20000u, 1, out + 1);
  return int(cudaGetLastError());
}
