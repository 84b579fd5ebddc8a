// Algorithm-1 grid solve for Hopper (sm_90a): one warp per job.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grid_solve.py
// (grid_solve_pallas, body _kernel / _solve_tile). For each job it builds
// U(r) = lg(R(r) - R_min) - theta C E[T](r) for r = 0..r_max-1 from the
// paper's closed forms (the max over sub-strategies for a composite), takes
// the first argmax r*, re-evaluates PoCD and E[T] at r*, and for a composite
// picks the sub-strategy with the best U at r*.
//
// Bound: operations, not bytes. A job is 40 bytes in and 24 out, while
// S-Restart's cost (Thm 4) needs a 128-node Gauss-Legendre quadrature, two
// powf per node, at every (job, r). Design:
//   * one warp per job, four jobs per block; a job's warp exits as a whole,
//     so every shuffle sees all 32 lanes;
//   * the quadrature nodes and weights sit in shared memory; for each r the
//     32 lanes take four nodes each and a butterfly of shuffles sums them;
//   * lanes then take r = lane (+32, ...) and evaluate U(r) in registers;
//   * a shuffle reduction gives the first argmax, so the (J, r_max) grid
//     never reaches device memory.
//
// The arithmetic repeats src/repro_torch/core/{pocd,cost,pareto}.py line by
// line, in the same order. Build without --use_fast_math: powf, logf,
// log1pf, log10f and expf stay IEEE so that r* matches the plain version.
// Rules shared with jnp.argmax / torch.argmax: the first maximum wins, NaN
// beats every number, and a row of -inf gives r* = 0. min/max propagate NaN
// as jnp.minimum / jnp.maximum do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;        // jobs per block
constexpr int kNodes = 128;      // Gauss-Legendre nodes
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
  const float head = min0(log_ratio(j.t_min, j.D));
  if (form == kClone) return j.beta * (r + 1.0f) * head;
  if (form == kSrestart)
    return j.beta * head + j.beta * r * min0(log_ratio(j.t_min, j.D - j.tau_est));
  const float window = j.D - j.tau_est;
  float resid = log1pf(-j.phi_est) + log_ratio(j.t_min, window);
  resid = window >= j.t_min ? min0(resid) : 0.0f;
  return j.beta * head + j.beta * (r + 1.0f) * resid;
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

// Thm 4's integral at one r, summed by the whole warp; every lane returns it
__device__ float srestart_integral(float r, const Job& j, const float* gl_u,
                                   const float* gl_w, int lane) {
  const float Dm = nan_max(j.D - j.tau_est, j.t_min);
  const float br = j.beta * r;
  float acc = 0.0f;
#pragma unroll
  for (int k = lane; k < kNodes; k += 32) {
    const float u = gl_u[k];
    const float w = Dm / u;
    const float f = powf(j.D / (w + j.tau_est), j.beta) * powf(j.t_min / w, br);
    acc += f * (Dm / (u * u)) * gl_w[k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// Thms 2 / 4 / 6: expected machine time; `integral` is Thm 4's I(r)
__device__ float expected_cost(int form, float r, const Job& j, float integral) {
  if (form == kClone) {
    const float nb = j.beta * (r + 1.0f);
    const float e_win = j.t_min * nb / (nb - 1.0f);
    return j.N * (r * j.tau_kill + e_win);
  }
  const float p_s = powf(j.t_min / j.D, j.beta);
  const float e_fast = truncated_mean_below(j.t_min, j.beta, j.D);
  float e_slow;
  if (form == kSrestart) {
    const float br = j.beta * r;
    const float Dm = nan_max(j.D - j.tau_est, j.t_min);
    const float head = j.tau_est + r * (j.tau_kill - j.tau_est);
    const float ratio = expf(br * logf(j.t_min / Dm) + logf(Dm));
    const float part1 = (j.t_min - ratio) / (br - 1.0f);
    e_slow = head + part1 + integral + j.t_min;
  } else {
    const float nb = j.beta * (r + 1.0f);
    const float e_win = j.t_min + j.t_min * powf(1.0f - j.phi_est, nb) / (nb - 1.0f);
    e_slow = j.tau_est + r * (j.tau_kill - j.tau_est) + e_win;
  }
  return j.N * (e_fast * (1.0f - p_s) + e_slow * p_s);
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

__global__ void __launch_bounds__(kWarps * 32)
grid_solve_kernel(Cols cols, int n_jobs, int r_max, int forms,
                  const float* __restrict__ gl_u_g,
                  const float* __restrict__ gl_w_g, Outs outs) {
  __shared__ float gl_u[kNodes], gl_w[kNodes];
  for (int k = threadIdx.x; k < kNodes; k += blockDim.x) {
    gl_u[k] = gl_u_g[k];
    gl_w[k] = gl_w_g[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_jobs) return;  // the ragged last block: whole warps leave
  const Job j{cols.t_min[i], cols.beta[i], cols.D[i], cols.N[i],
              cols.tau_est[i], cols.tau_kill[i], cols.phi_est[i], cols.C[i],
              cols.theta[i], cols.R_min[i]};
  const bool restart = forms & (1 << kSrestart);

  // per lane: the best (U, r) among its r = lane, lane + 32, ...; the
  // sentinel r_max loses every tie against a real grid point
  float best_u = -INFINITY;
  int best_r = r_max;
  for (int base = 0; base < r_max; base += 32) {
    float integral = 0.0f;
    if (restart) {
      const int n = min(32, r_max - base);
      for (int k = 0; k < n; ++k) {
        const float s = srestart_integral(float(base + k), j, gl_u, gl_w, lane);
        if (lane == k) integral = s;
      }
    }
    const int r = base + lane;
    if (r < r_max) {
      float u = 0.0f;
      bool first = true;
      for (int f = kClone; f <= kSresume; ++f) {
        if (!(forms & (1 << f))) continue;
        const float uf = evaluate(f, float(r), j, integral).u;
        u = first ? uf : nan_max(u, uf);  // U(r) = max_s U_s(r)
        first = false;
      }
      if (better(u, r, best_u, best_r)) {
        best_u = u;
        best_r = r;
      }
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

  // every lane now holds (U*, r*); re-evaluate at r*
  const float rs = float(best_r);
  const float integral = restart ? srestart_integral(rs, j, gl_u, gl_w, lane) : 0.0f;
  if (lane != 0) return;
  int choice = 0, rank = 0;
  Eval pick{0.0f, 0.0f, 0.0f};
  for (int f = kClone; f <= kSresume; ++f) {
    if (!(forms & (1 << f))) continue;
    const Eval e = evaluate(f, rs, j, integral);
    if (rank == 0 || better(e.u, rank, pick.u, choice)) {
      pick = e;
      choice = rank;
    }
    ++rank;
  }
  outs.r[i] = best_r;
  outs.choice[i] = choice;
  outs.u[i] = best_u;
  outs.pocd[i] = pick.pocd;
  outs.cost[i] = pick.cost;
  outs.sat[i] = best_r >= r_max - 1 ? 1 : 0;
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (n_jobs <= 0) return 0;
  const Cols cols{t_min, beta, D, N, tau_est, tau_kill, phi_est, C, theta, R_min};
  const Outs outs{r_out, choice_out, u_out, pocd_out, cost_out, sat_out};
  const int blocks = (n_jobs + kWarps - 1) / kWarps;
  grid_solve_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      cols, n_jobs, r_max, forms, gl_u, gl_w, outs);
  return int(cudaGetLastError());
}
