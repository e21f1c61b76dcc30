// K5: the whole SQP solve -- every iteration -- in one cooperative launch.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/sqp_megakernel.py
// (sqp_solve_mega_pcg / _solve_kernel_pcg -> _iteration_pcg,
// _line_search, _ls_contrib, _rho_schedule).  It computes what that kernel
// computes; the layout is knot-major, not the TPU's lanes.  Per SQP
// iteration, with a grid barrier after each stage:
//   1. per knot: the step accepted by the previous iteration, then K3's
//      per-knot KKT stage (kkt_schur.cuh);
//   2. per knot: theta, phi, SU, gamma and PD = theta^-1;
//   3. per knot: the stair bands PL, PU;
//   4. block 0 alone: K4's warm-started CG to |eta| <= tol or the cap, and
//      dz (pcg_common.cuh), while the other blocks wait at the barrier;
//   5. every (candidate, knot) pair: K2's merit contribution (merit.cuh)
//      for alpha = 1/2^a, a < num_alphas -- the incumbent merit is carried,
//      so there is no alpha = 0 candidate;
//   6. in every block alike: each candidate's merit summed in knot order,
//      the first minimum, the accept test and the rho / drho schedule
//      (pcg/sqp.cuh:373-408), the bail, and the stats slots (pcg iters,
//      hit, accepted; -1 / 0 / 0 where an iteration did not run).
// The caller supplies merit0 (K2) and drho starts at 1.
//
// The model is the original's (include/pcg/sqp.cuh:275): one persistent
// cooperative kernel, stages separated by cooperative_groups grid syncs.
// One 128-thread block per knot, grid = min(N, co-resident blocks), each
// block walking knots k = blockIdx.x, k + gridDim.x, ...; the host build
// launches one block that walks them all.  Every block derives each
// decision -- the CG exit (block 0 only), the argmin, accept, bail and the
// loop's end -- from the same data summed in the same order, so all blocks
// reach the same grid barriers; a block that left the loop early would
// hang the card.  A bail ends the loop in every block at once, which
// leaves state and stats as the TPU kernel's masked iterations do.
//
// Bound on the H100: latency.  The dual solve is a chain of dependent CG
// iterations in one block; the other stages are short per-knot chains.
// The shared memory of block 0's CG (S's bands and 4 vectors) is asked of
// every block, so it bounds N (mpc_mega_max_knots) and the grid
// (mpc_mega_grid: blocks per SM from the occupancy API times the SM
// count); the wrapper raises past either.
#include "kkt_schur.cuh"
#include "merit.cuh"
#include "pcg_common.cuh"

namespace {

constexpr int S = ld::NX, NU = ld::NU, SS = S * S;
constexpr int THREADS = 128;
constexpr int MAX_ALPHAS = 16;

struct MegaParams {
  // inputs
  const float* tab;
  int N, gstride, max_iter, n_sqp, num_alphas;
  const float *X0, *U0, *goals, *xs, *lam0, *rho0, *merit0;
  float drho0, tol, dt, qd_cost, r_cost, grav, mu;
  float rho_factor, rho_min, rho_max, rho_reset;
  // outputs
  float *X, *U, *lam, *scal;  // scal: rho, drho, merit
  int *ints, *st_iters, *st_hit, *st_acc;  // ints: sqp_iters, bailed
  // scratch
  float *SL, *SD, *SU, *PL, *PD, *PU, *Qinv, *A, *AQi, *T, *B, *Rinv;
  float *gamma, *q, *tvec, *Qiq, *fpred, *dX, *r, *dU, *contrib;
  int* cg_it;
  bool* cg_hit;
};

size_t mega_smem_floats(int N) { return pcgc::cg_smem_floats(N, 4); }

size_t mega_scratch_floats(int N, int num_alphas) {
  return (size_t)N * (10 * SS + S * NU + NU * NU + 6 * S + 2 * NU
                      + num_alphas);
}

// X[k] += step dX[k], U[k] += step dU[k]
LD_DEV void apply_step(const MegaParams& p, int k, float step) {
  for (int e = LD_TID; e < S; e += LD_NTID) p.X[S * k + e] += step * p.dX[S * k + e];
  if (k < p.N - 1)
    for (int e = LD_TID; e < NU; e += LD_NTID) p.U[NU * k + e] += step * p.dU[NU * k + e];
}

enum { RHO, DRHO, MERIT, STEP, N_SCAL };

LD_GLOBAL void sqp_mega_kernel(MegaParams p) {
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_SHARED float merits[MAX_ALPHAS];
  LD_SHARED float st[N_SCAL];
  LD_SHARED int done, itc;
  LD_DYN_SMEM(smem);
  const int N = p.N, t = LD_TID, nt = LD_NTID, bid = LD_BID, nb = LD_NBID;

  for (int k = bid; k < N; k += nb) {
    for (int e = t; e < S; e += nt) {
      p.X[S * k + e] = p.X0[S * k + e];
      p.lam[S * k + e] = p.lam0[S * k + e];
    }
    if (k < N - 1)
      for (int e = t; e < NU; e += nt) p.U[NU * k + e] = p.U0[NU * k + e];
  }
  if (bid == 0)
    for (int i = t; i < p.n_sqp; i += nt) {
      p.st_iters[i] = -1;
      p.st_hit[i] = 0;
      p.st_acc[i] = 0;
    }
  if (t == 0) {
    st[RHO] = p.rho0[0];
    st[DRHO] = p.drho0;
    st[MERIT] = p.merit0[0];
    st[STEP] = 0.0f;
    done = 0;
    itc = 0;
  }
  ld::load_tables(tab, p.tab);  // ends in a barrier

  for (int it = 0; it < p.n_sqp && !done; ++it) {
    // 1. the previous step, then the per-knot KKT stage
    const float step = st[STEP];
    for (int k = bid; k < N; k += nb) {
      if (step != 0.0f) apply_step(p, k, step);
      LD_SYNC();
      k3::perknot(tab, k, N, p.X, p.U, p.goals, p.gstride, &st[RHO], p.dt,
                  p.qd_cost, p.r_cost, p.grav, p.A, p.B, p.Qinv, p.Rinv,
                  p.q, p.r, p.AQi, p.T, p.tvec, p.Qiq, p.fpred);
    }
    LD_GRID_SYNC();
    // 2-3. cross-knot Schur bands, then the stair preconditioner
    for (int k = bid; k < N; k += nb)
      k3::schur_bands(k, N, p.X, p.Qinv, p.AQi, p.T, p.tvec, p.Qiq, p.fpred,
                      1, p.SL, p.SD, p.SU, p.PD, p.gamma);
    LD_GRID_SYNC();
    for (int k = bid; k < N; k += nb)
      k3::stair(k, N, p.SL, p.SU, p.PD, 1, p.PL, p.PU);
    LD_GRID_SYNC();
    // 4. the warm-started CG and dz, in block 0
    if (bid == 0)
      pcgc::pcg_dz_body(smem, N, p.SL, p.SD, p.SU, p.PL, p.PD, p.PU, p.gamma,
                        p.lam, p.A, p.B, p.q, p.r, p.Qinv, p.Rinv, p.max_iter,
                        p.tol, p.lam, p.dX, p.dU, p.cg_it, p.cg_hit);
    LD_GRID_SYNC();
    // 5. merit contributions of every (candidate, knot) pair, spread over
    // the blocks
    for (int pp = t * nb + bid; pp < p.num_alphas * N; pp += nb * nt) {
      const int a = pp / N, k = pp % N;
      const float alpha = 1.0f / (float)(1 << a);
      const bool has_u = k < N - 1;
      float x[S], xn[S], u[NU];
      for (int i = 0; i < S; ++i) {
        x[i] = p.X[S * k + i] + alpha * p.dX[S * k + i];
        xn[i] = has_u ? p.X[S * (k + 1) + i] + alpha * p.dX[S * (k + 1) + i] : 0.0f;
      }
      for (int i = 0; i < NU; ++i)
        u[i] = has_u ? p.U[NU * k + i] + alpha * p.dU[NU * k + i] : 0.0f;
      p.contrib[pp] = k2::merit_contrib(
          tab, x, xn, u, has_u, k == 0, p.goals + p.gstride * k, p.xs, p.dt,
          p.mu, p.qd_cost, p.r_cost, p.grav);
    }
    LD_GRID_SYNC();
    // 6. the decision, the same in every block
    for (int a = t; a < p.num_alphas; a += nt) {
      float m = 0.0f;
      for (int k = 0; k < N; ++k) m += p.contrib[a * N + k];
      merits[a] = m;
    }
    LD_SYNC();
    if (t == 0) {
      int best_a = 0;
      float best = merits[0];
      for (int a = 1; a < p.num_alphas; ++a)
        if (merits[a] < best) {
          best = merits[a];
          best_a = a;
        }
      const bool accept = best < st[MERIT];
      const float f = p.rho_factor, rho = st[RHO], drho = st[DRHO];
      const float drho_rej = fmaxf(drho * f, f);
      const float rho_rej = fmaxf(rho * drho_rej, p.rho_min);
      const float drho_acc = fminf(drho / f, 1.0f / f);
      const float rho_acc = fmaxf(rho * drho_acc, p.rho_min);
      float rho_n = accept ? rho_acc : rho_rej;
      const bool bail = !accept && rho_n > p.rho_max;
      if (bail) rho_n = p.rho_reset;
      st[RHO] = rho_n;
      st[DRHO] = accept ? drho_acc : drho_rej;
      st[MERIT] = accept ? best : st[MERIT];
      st[STEP] = accept ? 1.0f / (float)(1 << best_a) : 0.0f;
      done = bail;
      ++itc;
      if (bid == 0) {
        p.st_iters[it] = p.cg_it[0];
        p.st_hit[it] = p.cg_hit[0] ? 1 : 0;
        p.st_acc[it] = accept ? 1 : 0;
      }
    }
    LD_SYNC();
  }

  const float step = st[STEP];
  if (step != 0.0f)
    for (int k = bid; k < N; k += nb) apply_step(p, k, step);
  if (bid == 0 && t == 0) {
    p.scal[0] = st[RHO];
    p.scal[1] = st[DRHO];
    p.scal[2] = st[MERIT];
    p.ints[0] = itc;
    p.ints[1] = done;
  }
}

#ifdef __CUDACC__
// Static shared bytes of the kernel, or -1.
long long mega_static_smem() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, sqp_mega_kernel) != cudaSuccess) return -1;
  return (long long)attr.sharedSizeBytes;
}
#endif

}  // namespace

// Largest horizon for which every block's shared memory (block 0's CG
// system plus the stages' static arrays) fits on this device; 0 if the
// attributes cannot be read.
extern "C" int mpc_mega_max_knots(void) {
#ifdef __CUDACC__
  const long long stat = mega_static_smem();
  if (stat < 0) return 0;
  return pcgc::max_knots_for(mega_smem_floats, (size_t)stat);
#else
  return pcgc::max_knots_for(mega_smem_floats, 0);
#endif
}

// The grid a solve of N knots launches: min(N, blocks that can be resident
// at once), from the occupancy API at this kernel's block size and shared
// memory (the counterpart of the reference's checkPcgOccupancy); 0 if not
// one block fits or the device has no cooperative launch.
extern "C" int mpc_mega_grid(int N) {
#ifdef __CUDACC__
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const size_t smem = mega_smem_floats(N) * sizeof(float);
  if (cudaFuncSetAttribute(sqp_mega_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sqp_mega_kernel,
                                                    THREADS, smem) != cudaSuccess)
    return 0;
  const long long resident = (long long)per_sm * sms;
  return (int)(resident < N ? resident : N);
#else
  (void)N;
  return 1;  // the host build walks every knot in one block
#endif
}

// Floats of global scratch one solve takes.
extern "C" long long mpc_sqp_mega_scratch_floats(int N, int num_alphas) {
  return (long long)mega_scratch_floats(N, num_alphas);
}

extern "C" int mpc_sqp_mega(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* lam0,
    const float* rho0, const float* merit0, float drho0, int max_iter,
    float tol, int n_sqp, float dt, float qd_cost, float r_cost, float grav,
    float mu, int num_alphas, float rho_factor, float rho_min, float rho_max,
    float rho_reset, float* X, float* U, float* lam, float* scal, int* ints,
    int* stats, float* scratch, int* iscratch, int grid, void* stream) {
  if (num_alphas < 1 || num_alphas > MAX_ALPHAS || N < 2 || grid < 1)
    return 1;  // cudaErrorInvalidValue
  MegaParams p;
  p.tab = tab; p.N = N; p.gstride = gstride; p.max_iter = max_iter;
  p.n_sqp = n_sqp; p.num_alphas = num_alphas;
  p.X0 = X0; p.U0 = U0; p.goals = goals; p.xs = xs; p.lam0 = lam0;
  p.rho0 = rho0; p.merit0 = merit0;
  p.drho0 = drho0; p.tol = tol; p.dt = dt; p.qd_cost = qd_cost;
  p.r_cost = r_cost; p.grav = grav; p.mu = mu; p.rho_factor = rho_factor;
  p.rho_min = rho_min; p.rho_max = rho_max; p.rho_reset = rho_reset;
  p.X = X; p.U = U; p.lam = lam; p.scal = scal; p.ints = ints;
  p.st_iters = stats; p.st_hit = stats + n_sqp; p.st_acc = stats + 2 * n_sqp;
  float* f = scratch;
  const size_t nb = (size_t)N * SS, nv = (size_t)N * S, nu = (size_t)N * NU;
  float** bands[] = {&p.SL, &p.SD, &p.SU, &p.PL, &p.PD, &p.PU,
                     &p.Qinv, &p.A, &p.AQi, &p.T};
  for (float** b : bands) { *b = f; f += nb; }
  p.B = f; f += (size_t)N * S * NU;
  p.Rinv = f; f += (size_t)N * NU * NU;
  float** vecs[] = {&p.gamma, &p.q, &p.tvec, &p.Qiq, &p.fpred, &p.dX};
  for (float** v : vecs) { *v = f; f += nv; }
  p.r = f; f += nu;
  p.dU = f; f += nu;
  p.contrib = f;
  p.cg_it = iscratch;
  p.cg_hit = reinterpret_cast<bool*>(iscratch + 1);

  const size_t smem = mega_smem_floats(N) * sizeof(float);
#ifdef __CUDACC__
  // the wrapper takes `grid` from mpc_mega_grid, which also sets the
  // kernel's dynamic shared memory limit; never launch past co-residency
  if (grid > mpc_mega_grid(N)) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)sqp_mega_kernel, dim3(grid), dim3(THREADS), args, smem,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  LD_LAUNCH(sqp_mega_kernel, 1, THREADS, smem, stream, p);
  return 0;
#endif
}
