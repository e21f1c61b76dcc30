// K5: the whole SQP solve -- every iteration -- in one cooperative launch;
// K9p and K9b: ONE SQP iteration per cooperative launch, with the stair-PCG
// and the refined block cyclic reduction (BCR) dual solve.
//
// Replaces the TPU kernels mpcgpu_tpu/ops/pallas/sqp_megakernel.py
// sqp_solve_mega_pcg (_solve_kernel_pcg -> _iteration_pcg, _line_search,
// _ls_contrib, _rho_schedule), sqp_iter_mega_pcg (_mega_kernel_pcg) and
// sqp_iter_mega (_mega_kernel).  They compute what those kernels compute;
// the layout is knot-major, not the TPU's lanes.  Per SQP iteration, with
// a grid barrier after each stage:
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
// The caller supplies merit0 (K2) and drho starts at 1 (K5); K9p and K9b
// take drho and the incumbent merit from device memory, so the caller's
// loop of single iterations reads nothing on the host.  K9b skips stage 3
// and runs stage 4 as bcr_common.cuh's refined BCR solve and dz in block 0,
// reading S from global memory (L2); it has no warm start and reports 0
// CG iterations.  One templated body serves the three kernels.
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
// The shared memory of block 0's dual solve (S's bands and 4 vectors for
// the CG; 4 vectors and the inverse scratch for the BCR) is asked of every
// block, so it bounds N (mpc_mega_max_knots) and the grid (mpc_mega_grid:
// blocks per SM from the occupancy API times the SM count); the wrapper
// raises past either.  K9b's block 0 factors and applies the BCR with 128
// threads (4 warps for the 14x14 inverses) while the other blocks wait at
// the barrier: the simplest right design, not a fast one.
#include "bcr_common.cuh"
#include "kkt_schur.cuh"
#include "merit.cuh"

namespace {

constexpr int S = ld::NX, NU = ld::NU, SS = S * S;
constexpr int THREADS = 128;
constexpr int MAX_ALPHAS = 16;

struct MegaParams {
  // inputs
  const float* tab;
  int N, gstride, max_iter, n_sqp, num_alphas;
  const float *X0, *U0, *goals, *xs, *lam0, *rho0, *merit0;
  const float* drho0_p;  // K9p, K9b: drho in device memory (else drho0)
  float drho0, tol, dt, qd_cost, r_cost, grav, mu;
  float rho_factor, rho_min, rho_max, rho_reset;
  // outputs
  float *X, *U, *lam, *scal;  // scal: rho, drho, merit
  int *ints, *st_iters, *st_hit, *st_acc;  // ints: sqp_iters, bailed
  // scratch
  float *SL, *SD, *SU, *PL, *PD, *PU, *Qinv, *A, *AQi, *T, *B, *Rinv;
  float *gamma, *q, *tvec, *Qiq, *fpred, *dX, *r, *dU, *contrib;
  float* fac;  // K9b: the BCR factors
  int* cg_it;
  bool* cg_hit;
};

// The three kernels of this file (the `kind` of the C entries below).
enum Kind { SOLVE_PCG = 0, ITER_PCG = 1, ITER_BCR = 2 };

size_t mega_smem_floats(int N, int kind) {
  return kind == ITER_BCR ? bcr::dz_vec_floats(N) : pcgc::cg_smem_floats(N, 4);
}

size_t mega_scratch_floats(int N, int num_alphas, int kind) {
  return (size_t)N * (10 * SS + S * NU + NU * NU + 6 * S + 2 * NU
                      + num_alphas)
         + (kind == ITER_BCR ? bcr::factor_floats(N) : 0);
}

// X[k] += step dX[k], U[k] += step dU[k]
LD_DEV void apply_step(const MegaParams& p, int k, float step) {
  for (int e = LD_TID; e < S; e += LD_NTID) p.X[S * k + e] += step * p.dX[S * k + e];
  if (k < p.N - 1)
    for (int e = LD_TID; e < NU; e += LD_NTID) p.U[NU * k + e] += step * p.dU[NU * k + e];
}

enum { RHO, DRHO, MERIT, STEP, N_SCAL };

// Inlined into each kernel, so that p stays the kernel's own parameter.
#ifdef __CUDACC__
#define MEGA_INLINE __device__ __forceinline__
#else
#define MEGA_INLINE inline
#endif

template <bool BCR>
MEGA_INLINE void mega_body(const MegaParams& p) {
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_SHARED float merits[MAX_ALPHAS];
  LD_SHARED float st[N_SCAL];
  LD_SHARED int done, itc;
  LD_DYN_SMEM(smem);
  const int N = p.N, t = LD_TID, nt = LD_NTID, bid = LD_BID, nb = LD_NBID;

  for (int k = bid; k < N; k += nb) {
    for (int e = t; e < S; e += nt) {
      p.X[S * k + e] = p.X0[S * k + e];
      if constexpr (!BCR) p.lam[S * k + e] = p.lam0[S * k + e];
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
    st[DRHO] = p.drho0_p ? p.drho0_p[0] : p.drho0;
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
    // 2-3. cross-knot Schur bands, then the stair preconditioner (PCG)
    for (int k = bid; k < N; k += nb)
      k3::schur_bands(k, N, p.X, p.Qinv, p.AQi, p.T, p.tvec, p.Qiq, p.fpred,
                      BCR ? 0 : 1, p.SL, p.SD, p.SU, p.PD, p.gamma);
    LD_GRID_SYNC();
    if constexpr (!BCR) {
      for (int k = bid; k < N; k += nb)
        k3::stair(k, N, p.SL, p.SU, p.PD, 1, p.PL, p.PU);
      LD_GRID_SYNC();
    }
    // 4. the dual solve and dz, in block 0: the warm-started CG, or the
    // refined BCR (0 CG iterations, no hit)
    if (bid == 0) {
      if constexpr (BCR) {
        bcr::bcr_dz_body(N, p.SL, p.SD, p.SU, p.gamma, p.A, p.B, p.q, p.r,
                         p.Qinv, p.Rinv, p.fac, smem, p.lam, p.dX, p.dU);
        if (t == 0) {
          p.cg_it[0] = 0;
          p.cg_hit[0] = false;
        }
      } else {
        pcgc::pcg_dz_body(smem, N, p.SL, p.SD, p.SU, p.PL, p.PD, p.PU,
                          p.gamma, p.lam, p.A, p.B, p.q, p.r, p.Qinv, p.Rinv,
                          p.max_iter, p.tol, p.lam, p.dX, p.dU, p.cg_it,
                          p.cg_hit);
      }
    }
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

LD_GLOBAL void sqp_mega_kernel(MegaParams p) { mega_body<false>(p); }
LD_GLOBAL void sqp_iter_mega_pcg_kernel(MegaParams p) { mega_body<false>(p); }
LD_GLOBAL void sqp_iter_mega_bcr_kernel(MegaParams p) { mega_body<true>(p); }

using MegaKernel = void (*)(MegaParams);

MegaKernel kernel_of(int kind) {
  return kind == ITER_BCR   ? sqp_iter_mega_bcr_kernel
         : kind == ITER_PCG ? sqp_iter_mega_pcg_kernel
                            : sqp_mega_kernel;
}

#ifdef __CUDACC__
// Static shared bytes of a kernel, or -1.
long long mega_static_smem(int kind) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, (const void*)kernel_of(kind)) != cudaSuccess)
    return -1;
  return (long long)attr.sharedSizeBytes;
}
#endif

int check_kind(int kind) {
  return kind == SOLVE_PCG || kind == ITER_PCG || kind == ITER_BCR;
}

// The parameters of one launch.  drho0_p (device memory) overrides drho0
// when it is not null; lam0 is not read by K9b.
MegaParams make_params(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* lam0,
    const float* rho0, const float* merit0, const float* drho0_p,
    float drho0, int max_iter, float tol, int n_sqp, float dt, float qd_cost,
    float r_cost, float grav, float mu, int num_alphas, float rho_factor,
    float rho_min, float rho_max, float rho_reset, float* X, float* U,
    float* lam, float* scal, int* ints, int* stats, float* scratch,
    int* iscratch, int kind) {
  MegaParams p;
  p.tab = tab; p.N = N; p.gstride = gstride; p.max_iter = max_iter;
  p.n_sqp = n_sqp; p.num_alphas = num_alphas;
  p.X0 = X0; p.U0 = U0; p.goals = goals; p.xs = xs; p.lam0 = lam0;
  p.rho0 = rho0; p.merit0 = merit0; p.drho0_p = drho0_p;
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
  p.contrib = f; f += (size_t)N * num_alphas;
  p.fac = kind == ITER_BCR ? f : nullptr;
  p.cg_it = iscratch;
  p.cg_hit = reinterpret_cast<bool*>(iscratch + 1);
  return p;
}

}  // namespace

// Largest horizon for which every block's shared memory (block 0's dual
// solve plus the stages' static arrays) fits kernel `kind` (0 K5, 1 K9p,
// 2 K9b) on this device; 0 if the attributes cannot be read.
extern "C" int mpc_mega_max_knots(int kind) {
  if (!check_kind(kind)) return 0;
  auto floats = [kind](int n) { return mega_smem_floats(n, kind); };
#ifdef __CUDACC__
  const long long stat = mega_static_smem(kind);
  if (stat < 0) return 0;
  return pcgc::max_knots_for(floats, (size_t)stat);
#else
  return pcgc::max_knots_for(floats, 0);
#endif
}

// The grid a launch of kernel `kind` over N knots uses: min(N, blocks that
// can be resident at once), from the occupancy API at the kernel's block
// size and shared memory (the counterpart of the reference's
// checkPcgOccupancy); 0 if not one block fits or the device has no
// cooperative launch.
extern "C" int mpc_mega_grid(int N, int kind) {
  if (!check_kind(kind)) return 0;
#ifdef __CUDACC__
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const size_t smem = mega_smem_floats(N, kind) * sizeof(float);
  const void* fn = (const void*)kernel_of(kind);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                    smem) != cudaSuccess)
    return 0;
  const long long resident = (long long)per_sm * sms;
  return (int)(resident < N ? resident : N);
#else
  (void)N;
  return 1;  // the host build walks every knot in one block
#endif
}

// Floats of global scratch one launch of kernel `kind` takes.
extern "C" long long mpc_sqp_mega_scratch_floats(int N, int num_alphas,
                                                 int kind) {
  return (long long)mega_scratch_floats(N, num_alphas, kind);
}

namespace {

int launch(const MegaParams& p, int kind, int grid, void* stream) {
  if (p.num_alphas < 1 || p.num_alphas > MAX_ALPHAS || p.N < 2 || grid < 1)
    return 1;  // cudaErrorInvalidValue
  const size_t smem = mega_smem_floats(p.N, kind) * sizeof(float);
#ifdef __CUDACC__
  // the wrapper takes `grid` from mpc_mega_grid, which also sets the
  // kernel's dynamic shared memory limit; never launch past co-residency
  if (grid > mpc_mega_grid(p.N, kind))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  MegaParams arg = p;
  void* args[] = {&arg};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernel_of(kind), dim3(grid), dim3(THREADS), args, smem,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  const MegaKernel kern = kernel_of(kind);
  LD_LAUNCH(kern, 1, THREADS, smem, stream, p);
  return 0;
#endif
}

}  // namespace

// K5: n_sqp iterations from drho0 = drho0 (a host number).
extern "C" int mpc_sqp_mega(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* lam0,
    const float* rho0, const float* merit0, float drho0, int max_iter,
    float tol, int n_sqp, float dt, float qd_cost, float r_cost, float grav,
    float mu, int num_alphas, float rho_factor, float rho_min, float rho_max,
    float rho_reset, float* X, float* U, float* lam, float* scal, int* ints,
    int* stats, float* scratch, int* iscratch, int grid, void* stream) {
  const MegaParams p = make_params(
      tab, N, X0, U0, goals, gstride, xs, lam0, rho0, merit0, nullptr, drho0,
      max_iter, tol, n_sqp, dt, qd_cost, r_cost, grav, mu, num_alphas,
      rho_factor, rho_min, rho_max, rho_reset, X, U, lam, scal, ints, stats,
      scratch, iscratch, SOLVE_PCG);
  return launch(p, SOLVE_PCG, grid, stream);
}

// K9p: one iteration, rho, drho and the incumbent merit in device memory.
// Outputs as K5's with n_sqp = 1: scal (rho, drho, merit), ints
// (iterations run, bail), stats (CG iterations, hit, accepted).
extern "C" int mpc_sqp_iter_mega_pcg(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* lam0,
    const float* rho0, const float* drho0, const float* merit0, int max_iter,
    float tol, float dt, float qd_cost, float r_cost, float grav, float mu,
    int num_alphas, float rho_factor, float rho_min, float rho_max,
    float rho_reset, float* X, float* U, float* lam, float* scal, int* ints,
    int* stats, float* scratch, int* iscratch, int grid, void* stream) {
  const MegaParams p = make_params(
      tab, N, X0, U0, goals, gstride, xs, lam0, rho0, merit0, drho0, 1.0f,
      max_iter, tol, 1, dt, qd_cost, r_cost, grav, mu, num_alphas,
      rho_factor, rho_min, rho_max, rho_reset, X, U, lam, scal, ints, stats,
      scratch, iscratch, ITER_PCG);
  return launch(p, ITER_PCG, grid, stream);
}

// K9b: one iteration with the refined BCR dual solve (power-of-2 N); no
// warm start, no CG.  Outputs as K9p's, stats' CG count 0.
extern "C" int mpc_sqp_iter_mega(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* rho0,
    const float* drho0, const float* merit0, float dt, float qd_cost,
    float r_cost, float grav, float mu, int num_alphas, float rho_factor,
    float rho_min, float rho_max, float rho_reset, float* X, float* U,
    float* lam, float* scal, int* ints, int* stats, float* scratch,
    int* iscratch, int grid, void* stream) {
  if (N & (N - 1)) return 1;  // cudaErrorInvalidValue
  const MegaParams p = make_params(
      tab, N, X0, U0, goals, gstride, xs, nullptr, rho0, merit0, drho0, 1.0f,
      0, 0.0f, 1, dt, qd_cost, r_cost, grav, mu, num_alphas, rho_factor,
      rho_min, rho_max, rho_reset, X, U, lam, scal, ints, stats, scratch,
      iscratch, ITER_BCR);
  return launch(p, ITER_BCR, grid, stream);
}
