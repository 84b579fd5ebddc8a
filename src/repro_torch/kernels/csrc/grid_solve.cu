// Algorithm-1 grid solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/grid_solve.py
// (grid_solve_pallas, body _kernel / _solve_tile). For each job it builds
// U(r) = lg(R(r) - R_min) - theta C E[T](r) for r = 0..r_max-1 from the
// paper's closed forms (the max over sub-strategies for a composite), takes
// the first argmax r*, re-evaluates PoCD and E[T] at r*, and for a composite
// picks the sub-strategy with the best U at r*.
//
// Bound: operations, not bytes. A job is 40 bytes in and 24 out, while
// S-Restart's cost (Thm 4) needs a 128-node Gauss-Legendre quadrature at
// every (job, r): I(r) = sum_k A_k (t_min / w_k)^(beta r) q_k g_k with
// w_k = Dm / u_k, A_k = (D / (w_k + tau_est))^beta and q_k = Dm / u_k^2.
// The terms of U(r) that do not depend on r (the log-miss heads, the
// straggler probability, E[T | T <= D], S-Restart's log terms) are formed
// once per job (load_job), with the expressions the closed forms use, so
// every U(r) keeps its bits. Two kernels, by the forms asked for:
//   * without S-Restart (clone, S-Resume and their composites): one warp
//     per job, four jobs per block; lane = r (+32, ...) evaluates U(r) in
//     registers and a shuffle reduction gives the first argmax, so the
//     (J, r_max) grid never reaches device memory;
//   * with S-Restart (srestart, adaptive): a block of eight warps holds a
//     few jobs (about 32 / r_max, at most eight) and walks r in tiles of
//     64. First the block computes the quadrature factors that do not
//     depend on r, A_k, t_min / w_k and q_k, once per (job, node) into
//     shared memory. Then warps take the (job, r) integrals in parallel,
//     each with one IEEE powf per node (none at r = 0, where powf is 1);
//     lane l sums nodes l, l + 32, l + 64, l + 96 in that order, then a
//     butterfly, the order in which r* was checked against the plain
//     version (tests/test_torch_grid_solve.py emulates it);
//     then one thread per (family, job, r) evaluates U_f(r); then warp b
//     takes job b's first argmax over the tile from shared memory and
//     keeps the running best (U, r*, I(r*)), so I(r*) is not recomputed;
//     at the end lane q of that warp re-evaluates family q at r*.
//   * What bounds it now: the 128 r_max IEEE powf per job (PERF.md gives
//     the rate). Eight blocks of eight warps an SM (32 registers) hide
//     the latency of the per-block phases.
//
// The arithmetic repeats src/repro_torch/core/{pocd,cost,pareto}.py line by
// line, in the same order. Build without --use_fast_math: powf, logf,
// log1pf, log10f and expf stay IEEE so that r* matches the plain version.
// Rules shared with jnp.argmax / torch.argmax: the first maximum wins, NaN
// beats every number, and a row of -inf gives r* = 0. min/max propagate NaN
// as jnp.minimum / jnp.maximum do.

#include <cuda_runtime.h>
#include <math.h>

#include "device_scope.h"

namespace {

constexpr int kWarps = 4;        // jobs per block of the warp kernel
constexpr int kNodes = 128;      // Gauss-Legendre nodes
constexpr int kBlockWarps = 8;   // warps per block of the S-Restart kernel
constexpr int kMaxJobs = 8;      // its jobs per block, at most
constexpr int kRTile = 64;       // its grid points per pass
static_assert(kMaxJobs <= kBlockWarps, "warp b takes job b's argmax");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClone = 0, kSrestart = 1, kSresume = 2;  // FORMS ids

struct Cols {
  const float *t_min, *beta, *D, *N, *tau_est, *tau_kill, *phi_est, *C,
      *theta, *R_min;
};

struct Outs {
  int* r;
  int* choice;
  float *u, *pocd, *cost;
  int* sat;
};

struct Job {
  float t_min, beta, D, N, tau_est, tau_kill, phi_est, C, theta, R_min;
  // the parts of U(r) that do not depend on r, formed once per job by
  // load_job with the expressions the closed forms use
  float head;      // min0(log t_min - log D)
  float head_r;    // S-Restart: min0(log t_min - log(D - tau_est))
  float resid;     // S-Resume: the resumed attempt's log-miss term
  float p_s;       // (t_min / D)^beta
  float e_fast;    // E[T | T <= D]
  float Dm;        // S-Restart: max(D - tau_est, t_min)
  float log_tm_Dm; // S-Restart: log(t_min / Dm)
  float log_Dm;    // S-Restart: log(Dm)
};

__device__ __forceinline__ float min0(float x) { return x > 0.0f ? 0.0f : x; }

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float log_ratio(float t_min, float d) {
  return logf(t_min) - logf(d);
}

// (u1, r1) beats (u2, r2) under first-argmax rules
__device__ __forceinline__ bool better(float u1, int r1, float u2, int r2) {
  const bool n1 = isnan(u1), n2 = isnan(u2);
  if (n1 || n2) return n1 && (!n2 || r1 < r2);
  return u1 > u2 || (u1 == u2 && r1 < r2);
}

// Thms 1 / 3 / 5: log P(one task misses D)
__device__ float log_task_fail(int form, float r, const Job& j) {
  if (form == kClone) return j.beta * (r + 1.0f) * j.head;
  if (form == kSrestart) return j.beta * j.head + j.beta * r * j.head_r;
  return j.beta * j.head + j.beta * (r + 1.0f) * j.resid;
}

// R = exp(N log1p(-min(P_fail, 1))). The reference clips at 1.0 - 1e-12,
// which is 1.0f in f32: P_fail == 1 gives R == 0.
__device__ float job_pocd(float log_p_fail, float N) {
  float p = expf(min0(log_p_fail));
  p = p > 1.0f ? 1.0f : p;
  return expf(N * log1pf(-p));
}

__device__ float truncated_mean_below(float t_min, float beta, float D) {
  const float q = powf(t_min / D, beta);
  const float general = beta / (beta - 1.0f) * (t_min - D * q) / (1.0f - q);
  const float at_one = t_min * logf(D / t_min) / (1.0f - t_min / D);
  return fabsf(beta - 1.0f) < 1e-6f ? at_one : general;
}

// Thms 2 / 4 / 6: expected machine time; `integral` is Thm 4's I(r)
__device__ float expected_cost(int form, float r, const Job& j, float integral) {
  if (form == kClone) {
    const float nb = j.beta * (r + 1.0f);
    const float e_win = j.t_min * nb / (nb - 1.0f);
    return j.N * (r * j.tau_kill + e_win);
  }
  float e_slow;
  if (form == kSrestart) {
    const float br = j.beta * r;
    const float head = j.tau_est + r * (j.tau_kill - j.tau_est);
    const float ratio = expf(br * j.log_tm_Dm + j.log_Dm);
    const float part1 = (j.t_min - ratio) / (br - 1.0f);
    e_slow = head + part1 + integral + j.t_min;
  } else {
    const float nb = j.beta * (r + 1.0f);
    const float e_win = j.t_min + j.t_min * powf(1.0f - j.phi_est, nb) / (nb - 1.0f);
    e_slow = j.tau_est + r * (j.tau_kill - j.tau_est) + e_win;
  }
  return j.N * (j.e_fast * (1.0f - j.p_s) + e_slow * j.p_s);
}

// job i's columns and the terms of `forms`' closed forms that do not
// depend on r
__device__ Job load_job(const Cols& c, int i, int forms) {
  Job j;
  j.t_min = c.t_min[i];
  j.beta = c.beta[i];
  j.D = c.D[i];
  j.N = c.N[i];
  j.tau_est = c.tau_est[i];
  j.tau_kill = c.tau_kill[i];
  j.phi_est = c.phi_est[i];
  j.C = c.C[i];
  j.theta = c.theta[i];
  j.R_min = c.R_min[i];
  j.head = min0(log_ratio(j.t_min, j.D));
  j.head_r = j.resid = j.p_s = j.e_fast = j.Dm = j.log_tm_Dm = j.log_Dm = 0.0f;
  if (forms & ((1 << kSrestart) | (1 << kSresume))) {
    j.p_s = powf(j.t_min / j.D, j.beta);
    j.e_fast = truncated_mean_below(j.t_min, j.beta, j.D);
  }
  if (forms & (1 << kSrestart)) {
    j.head_r = min0(log_ratio(j.t_min, j.D - j.tau_est));
    j.Dm = nan_max(j.D - j.tau_est, j.t_min);
    j.log_tm_Dm = logf(j.t_min / j.Dm);
    j.log_Dm = logf(j.Dm);
  }
  if (forms & (1 << kSresume)) {
    const float window = j.D - j.tau_est;
    const float resid = log1pf(-j.phi_est) + log_ratio(j.t_min, window);
    j.resid = window >= j.t_min ? min0(resid) : 0.0f;
  }
  return j;
}

struct Eval {
  float u, pocd, cost;
};

__device__ Eval evaluate(int form, float r, const Job& j, float integral) {
  Eval e;
  e.pocd = job_pocd(log_task_fail(form, r, j), j.N);
  e.cost = expected_cost(form, r, j, integral);
  const float gap = e.pocd - j.R_min;
  const float log_term = gap > 0.0f ? log10f(nan_max(gap, 1e-30f)) : -INFINITY;
  e.u = log_term - j.theta * j.C * e.cost;
  return e;
}

// the q-th family of `forms` in FORMS order (its choice id), or -1
__device__ __forceinline__ int nth_form(int forms, int q) {
  for (int f = kClone; f <= kSresume; ++f)
    if ((forms & (1 << f)) && q-- == 0) return f;
  return -1;
}

// called by a whole warp: re-evaluate at r* (lane q the q-th family) and
// write job i's row from lane 0; `integral` is I(r*)
__device__ void finish(int i, const Job& j, int forms, int r_max, float best_u,
                       int best_r, float integral, const Outs& outs, int lane) {
  const int f = nth_form(forms, lane);
  Eval e{0.0f, 0.0f, 0.0f};
  if (f >= 0) e = evaluate(f, float(best_r), j, integral);
  // the families in choice order: the first best U wins, NaN beats all
  int choice = 0;
  Eval pick{__shfl_sync(kFull, e.u, 0), __shfl_sync(kFull, e.pocd, 0),
            __shfl_sync(kFull, e.cost, 0)};
  for (int rank = 1; rank < __popc(forms & 7); ++rank) {
    const Eval o{__shfl_sync(kFull, e.u, rank), __shfl_sync(kFull, e.pocd, rank),
                 __shfl_sync(kFull, e.cost, rank)};
    if (better(o.u, rank, pick.u, choice)) {
      pick = o;
      choice = rank;
    }
  }
  if (lane != 0) return;
  outs.r[i] = best_r;
  outs.choice[i] = choice;
  outs.u[i] = best_u;
  outs.pocd[i] = pick.pocd;
  outs.cost[i] = pick.cost;
  outs.sat[i] = best_r >= r_max - 1 ? 1 : 0;
}

// S-Restart absent: one warp per job
__global__ void __launch_bounds__(kWarps * 32)
grid_solve_kernel(Cols cols, int n_jobs, int r_max, int forms, Outs outs) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_jobs) return;  // the ragged last block: whole warps leave
  const Job j = load_job(cols, i, forms);

  // per lane: the best (U, r) among its r = lane, lane + 32, ...; the
  // sentinel r_max loses every tie against a real grid point
  float best_u = -INFINITY;
  int best_r = r_max;
  for (int r = lane; r < r_max; r += 32) {
    float u = 0.0f;
    bool first = true;
    for (int f = kClone; f <= kSresume; ++f) {
      if (!(forms & (1 << f))) continue;
      const float uf = evaluate(f, float(r), j, 0.0f).u;
      u = first ? uf : nan_max(u, uf);  // U(r) = max_s U_s(r)
      first = false;
    }
    if (better(u, r, best_u, best_r)) {
      best_u = u;
      best_r = r;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ou = __shfl_xor_sync(kFull, best_u, off);
    const int orr = __shfl_xor_sync(kFull, best_r, off);
    if (better(ou, orr, best_u, best_r)) {
      best_u = ou;
      best_r = orr;
    }
  }
  finish(i, j, forms, r_max, best_u, best_r, 0.0f, outs, lane);
}

// S-Restart present: a block of kBlockWarps warps solves `per_block` jobs
__global__ void __launch_bounds__(kBlockWarps * 32, 8)
grid_solve_restart_kernel(Cols cols, int n_jobs, int r_max, int forms,
                          int per_block, const float* __restrict__ gl_u_g,
                          const float* __restrict__ gl_w_g, Outs outs) {
  __shared__ float gl_w[kNodes];
  // per (job, node): A = (D / (w + tau_est))^beta, t_min / w, Dm / u^2
  __shared__ float fac_a[kMaxJobs][kNodes], fac_t[kMaxJobs][kNodes],
      fac_q[kMaxJobs][kNodes];
  // per (job, r) of the current tile: I(r), and U_f(r) per family rank
  __shared__ float integ[kMaxJobs][kRTile], util[3][kMaxJobs][kRTile];
  __shared__ Job jobs[kMaxJobs];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * per_block;
  const int nj = min(per_block, n_jobs - j0);
  if (tid < nj) {
    const int i = j0 + tid;
    jobs[tid] = load_job(cols, i, forms);
  }
  for (int k = tid; k < kNodes; k += blockDim.x) gl_w[k] = gl_w_g[k];
  __syncthreads();

  for (int t = tid; t < nj * kNodes; t += blockDim.x) {
    const int b = t / kNodes, k = t % kNodes;
    const Job& j = jobs[b];
    const float u = gl_u_g[k];
    const float w = j.Dm / u;
    fac_a[b][k] = powf(j.D / (w + j.tau_est), j.beta);
    fac_t[b][k] = j.t_min / w;
    fac_q[b][k] = j.Dm / (u * u);
  }
  __syncthreads();

  // warp b < nj keeps job b's running first argmax and I at it
  float best_u = -INFINITY, best_i = 0.0f;
  int best_r = r_max;
  for (int r0 = 0; r0 < r_max; r0 += kRTile) {
    const int nr = min(kRTile, r_max - r0);
    for (int t = warp; t < nj * nr; t += kBlockWarps) {
      const int b = t / nr, rr = t % nr;
      const float br = jobs[b].beta * float(r0 + rr);
      float acc = 0.0f;
      if (br == 0.0f) {  // powf(x, 0) is 1 for every x
#pragma unroll
        for (int k = lane; k < kNodes; k += 32) {
          const float f = fac_a[b][k] * 1.0f;
          acc += f * fac_q[b][k] * gl_w[k];
        }
      } else {
#pragma unroll
        for (int k = lane; k < kNodes; k += 32) {
          const float f = fac_a[b][k] * powf(fac_t[b][k], br);
          acc += f * fac_q[b][k] * gl_w[k];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (lane == 0) integ[b][rr] = acc;
    }
    __syncthreads();
    // U_f(r) at every (family, job, r) of the tile, one thread each; the
    // family varies slowest, so a warp mostly runs one family's code
    const int n_forms = __popc(forms & 7);
    for (int t = tid; t < n_forms * nj * nr; t += blockDim.x) {
      const int q = t / (nj * nr), b = t % (nj * nr) / nr, rr = t % nr;
      util[q][b][rr] = evaluate(nth_form(forms, q), float(r0 + rr), jobs[b],
                                integ[b][rr]).u;
    }
    __syncthreads();
    if (warp < nj) {
      float tu = -INFINITY;
      int tr = r_max;
      for (int rr = lane; rr < nr; rr += 32) {
        float u = util[0][warp][rr];
        for (int q = 1; q < n_forms; ++q)
          u = nan_max(u, util[q][warp][rr]);  // U(r) = max_s U_s(r)
        if (better(u, r0 + rr, tu, tr)) {
          tu = u;
          tr = r0 + rr;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ou = __shfl_xor_sync(kFull, tu, off);
        const int orr = __shfl_xor_sync(kFull, tr, off);
        if (better(ou, orr, tu, tr)) {
          tu = ou;
          tr = orr;
        }
      }
      if (better(tu, tr, best_u, best_r)) {
        best_u = tu;
        best_r = tr;
        best_i = integ[warp][tr - r0];
      }
    }
    __syncthreads();  // the tile's integ and util are read; reuse them
  }
  if (warp < nj)
    finish(j0 + warp, jobs[warp], forms, r_max, best_u, best_r, best_i, outs,
           lane);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `forms` has bit f
// set for each closed-form family f to evaluate; a composite's choice is
// the rank of the winning family's bit.
extern "C" int grid_solve_launch(
    int device, const float* t_min, const float* beta, const float* D,
    const float* N, const float* tau_est, const float* tau_kill,
    const float* phi_est, const float* C, const float* theta,
    const float* R_min, const float* gl_u, const float* gl_w, int n_jobs,
    int r_max, int forms, int* r_out, int* choice_out, float* u_out,
    float* pocd_out, float* cost_out, int* sat_out, void* stream) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return int(scope.err);
  if (n_jobs <= 0) return 0;
  const Cols cols{t_min, beta, D, N, tau_est, tau_kill, phi_est, C, theta, R_min};
  const Outs outs{r_out, choice_out, u_out, pocd_out, cost_out, sat_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(forms & (1 << kSrestart))) {
    const int blocks = (n_jobs + kWarps - 1) / kWarps;
    grid_solve_kernel<<<blocks, kWarps * 32, 0, s>>>(cols, n_jobs, r_max,
                                                     forms, outs);
  } else {
    // enough jobs that a block's first tile holds about 32 integrals
    const int per_block = min(kMaxJobs, max(1, (32 + r_max - 1) / r_max));
    const int blocks = (n_jobs + per_block - 1) / per_block;
    grid_solve_restart_kernel<<<blocks, kBlockWarps * 32, 0, s>>>(
        cols, n_jobs, r_max, forms, per_block, gl_u, gl_w, outs);
  }
  return int(cudaGetLastError());
}
