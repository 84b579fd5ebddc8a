// Monte-Carlo PoCD / machine time of the Chronos strategies for Hopper
// (sm_90a): one warp per job.
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
// Bound: bytes. The kernel reads J*N*R f32 uniforms once and does about
// ten f32 operations per attempt (one logf, one expf), far below the
// card's operations-per-byte balance. Design:
//   * one warp per job, eight jobs per block; a warp past J leaves as a
//     whole, so every shuffle sees 32 lanes and nothing needs the TPU's
//     masked partial tile;
//   * a lane takes tasks lane, lane + 32, ...; it forms the R attempt
//     times of a task one slot at a time and folds each into a running
//     minimum per mode, so no (N, R) block is kept anywhere: the slot
//     count R is a runtime argument and costs no registers;
//   * with several modes, each attempt time is formed once and feeds all
//     of them, so the fused launch reads the uniforms once where three
//     single-mode launches read them three times;
//   * per lane a running met (AND) and cost (sum); __all_sync and a
//     butterfly of shuffles reduce them, and lane 0 writes the job's row.
//
// Arithmetic follows the plain PyTorch version (kernels/pocd_mc.py) in
// the same order. Build without --use_fast_math (IEEE logf, expf and
// division); products that feed a sum use __fmul_rn / __fadd_rn so nvcc
// does not contract them into an fma. Slot minima use `<`, so the
// uniforms must lie in (0, 1] (a NaN would not propagate as torch.amin
// propagates it). An r at or past the slots activates every slot.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // jobs per block
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

__device__ __forceinline__ float fmin_lt(float a, float b) { return b < a ? b : a; }

__device__ __forceinline__ float pareto(float u, float t_min, float beta) {
  return __fmul_rn(t_min, expf(__fdiv_rn(-logf(u), beta)));
}

// tau_est + r (tau_kill - tau_est) + w, left to right as the plain version
__device__ __forceinline__ float reactive_bill(float tau_est, int r, float gap,
                                               float w) {
  return __fadd_rn(__fadd_rn(tau_est, __fmul_rn(float(r), gap)), w);
}

template <int kModes>
__global__ void __launch_bounds__(kWarps * 32)
pocd_mc_kernel(const float* __restrict__ u, const float* __restrict__ t_min_g,
               const float* __restrict__ beta_g, const float* __restrict__ D_g,
               Rows rows, Params p) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j >= p.n_jobs) return;  // the ragged last block: whole warps leave

  const float t_min = t_min_g[j], beta = beta_g[j], D = D_g[j];
  const float tau_est = __fmul_rn(p.tau_est_frac, t_min);
  const float tau_kill = __fadd_rn(tau_est, __fmul_rn(p.tau_kill_gap_frac, t_min));
  const float gap = tau_kill - tau_est;
  const int rc = (kModes & kClone) ? rows.r[0][j] : 0;
  const int rr = (kModes & kSrestart) ? rows.r[1][j] : 0;
  const int rm = (kModes & kSresume) ? rows.r[2][j] : 0;

  bool met_c = true, met_r = true, met_m = true;
  float cost_c = 0.0f, cost_r = 0.0f, cost_m = 0.0f;
  const float* uj = u + size_t(j) * p.n_tasks * p.n_slots;
  for (int n = lane; n < p.n_tasks; n += 32) {
    const float* un = uj + size_t(n) * p.n_slots;
    const float T1 = pareto(__ldg(un), t_min, beta);
    const bool strag = T1 > D;
    float best_c = rc >= 0 ? T1 : INFINITY;  // clone: slots k <= r
    float extra_r = INFINITY;                // srestart: slots 1..R-1, k-1 < r
    float w_m = INFINITY;                    // sresume: slots 1..R-1, k-1 <= r
    for (int k = 1; k < p.n_slots; ++k) {
      const float a = pareto(__ldg(un + k), t_min, beta);
      if ((kModes & kClone) && k <= rc) best_c = fmin_lt(best_c, a);
      if ((kModes & kSrestart) && strag && k - 1 < rr) extra_r = fmin_lt(extra_r, a);
      if ((kModes & kSresume) && strag && k - 1 <= rm) {
        const float resumed = fmaxf(t_min, __fmul_rn(p.one_minus_phi, a));
        w_m = fmin_lt(w_m, resumed);
      }
    }
    if (kModes & kClone) {
      met_c &= best_c <= D;
      cost_c += __fadd_rn(__fmul_rn(float(rc), tau_kill), best_c);
    }
    if (kModes & kSrestart) {
      const float w_all = fminf(T1 - tau_est, extra_r);
      const bool use = strag && rr > 0;
      met_r &= (use ? tau_est + w_all : T1) <= D;
      cost_r += use ? reactive_bill(tau_est, rr, gap, w_all) : T1;
    }
    if (kModes & kSresume) {
      met_m &= (strag ? tau_est + w_m : T1) <= D;
      cost_m += strag ? reactive_bill(tau_est, rm, gap, w_m) : T1;
    }
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
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
