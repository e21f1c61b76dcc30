// K5: the whole SQP solve -- every iteration -- in one cooperative launch;
// K9p and K9b: ONE SQP iteration per cooperative launch, with the stair-PCG
// and the refined block cyclic reduction (BCR) dual solve; K5g and K9pg:
// K5 and K9p with the grid-wide CG, past the cluster form's fit.
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
//   4. the dual solve and dz (below), while the other blocks wait at the
//      barrier;
//   5. every (candidate, knot) pair: K2's merit contribution (merit.cuh) on
//      a group of 8-32 lanes, the pairs spread over every block's groups,
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
// CG iterations.  One templated body serves the five kernels.
//
// The model is the original's (include/pcg/sqp.cuh:275): one persistent
// cooperative kernel, stages separated by cooperative_groups grid syncs.
// 128-thread blocks, each walking knots k = blockIdx.x, k + gridDim.x, ...;
// the host build launches one block that walks them all.  Every block
// derives each decision -- the CG exit, the argmin, accept, bail and the
// loop's end -- from the same data summed in the same order, so all blocks
// reach the same grid barriers; a block that left the loop early would
// hang the card.  A bail ends the loop in every block at once, which
// leaves state and stats as the TPU kernel's masked iterations do.
//
// Stage 4 of K5 and K9p is the cluster CG (pcg_common.cuh): the launch is
// a cluster launch (cudaLaunchKernelEx with a cluster dimension of C = 16
// where the card schedules it, else 8) that is also cooperative -- the
// runtime takes both attributes together on the H100 (a probe of
// cooperative_groups' grid sync inside a cluster launch, CUDA 12.9), so
// the other stages keep the grid barrier, and the grid is held to
// cudaOccupancyMaxActiveClusters x C.  The first cluster runs the
// stair-PCG: each of its blocks loads S's bands of the knots it owns from
// L2 at the start of stage 4, and the stair's when they go on chip
// (mega_plan: unless that shrinks the grid the stages run on), solves with
// the halo rows through DSMEM and the dots summed in rank order (two
// cluster barriers per CG step), then computes its knots' dz.  Every
// block asks for that shared memory, so it bounds N (mpc_mega_max_knots,
// about 670 on the H100) and the grid.
//
// K5g and K9pg (the grid dual) run stage 4 in EVERY block: the grid-wide
// stair-PCG of pcg_common.cuh (S, P and the CG vectors in global memory,
// per-knot dot slots summed alike by every block, four grid barriers per
// CG step), then dz per owned knot; they serve N past the cluster form's
// fit.  Their blocks ask for no N-sized shared memory, only the merit
// stage's groups' (as every kind does; merit.cuh): the grid is
// min(N, co-resident blocks).
//
// No sum of any stage depends on the grid (a cluster's CG depends on C
// alone), so four K9p launches equal one K5 launch bit for bit, as four
// K9pg launches equal one K5g launch.  K9b's block 0 factors and applies
// the BCR with 128 threads (4 warps for the 14x14 inverses) while the
// other blocks wait at the barrier: the simplest right design, not a fast
// one.
//
// Bound on the H100: latency.  The dual solve is a chain of dependent CG
// iterations; the other stages are short per-knot chains.
#include "bcr_common.cuh"
#include "kkt_schur.cuh"
#include "merit.cuh"

#ifdef __CUDACC__
#include <map>
#endif

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
  float* cg;   // K5g, K9pg: the grid CG's vectors and slots
  int stair_on_chip;  // K5, K9p: the stair bands in the cluster's shared memory
  int* cg_it;   // the CG iterations, then (K5, K9p) the cluster size read
  bool* cg_hit;
};

// The five kernels of this file (the `kind` of the C entries below).
enum Kind {
  SOLVE_PCG = 0, ITER_PCG = 1, ITER_BCR = 2, SOLVE_PCG_GRID = 3,
  ITER_PCG_GRID = 4
};

bool grid_cg(int kind) { return kind == SOLVE_PCG_GRID || kind == ITER_PCG_GRID; }
bool cluster_cg(int kind) { return kind == SOLVE_PCG || kind == ITER_PCG; }

// The grid kinds hold nothing N-sized in shared memory; this bound keeps
// the 32-bit offsets of their global scratch (about 2,200 floats a knot)
// far from overflow.
constexpr int GRID_MAX_KNOTS = 1 << 16;

// Dynamic shared floats of every block: the cluster CG's at cluster size C
// (K5, K9p) or K9b's BCR vectors, and no fewer than the merit stage's
// groups of 8 lanes take (the grid kinds hold only those).
size_t mega_smem_floats(int N, int kind, int C, bool stair_on_chip) {
  const size_t merit = k2::areas_floats(THREADS, 8);
  size_t dual = 0;
  if (cluster_cg(kind)) dual = pcgc::cluster_cg_floats(N, C, stair_on_chip, 0);
  else if (!grid_cg(kind)) dual = bcr::dz_vec_floats(N);
  return dual > merit ? dual : merit;
}

size_t mega_scratch_floats(int N, int num_alphas, int kind) {
  return (size_t)N * (10 * SS + S * NU + NU * NU + 6 * S + 2 * NU
                      + num_alphas)
         + (kind == ITER_BCR ? bcr::factor_floats(N) : 0)
         + (grid_cg(kind) ? pcgc::grid_cg_floats(N) : 0);
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

// The dual solve of stage 4: K9b's BCR in block 0, the cluster stair-PCG
// (K5, K9p) or the grid stair-PCG (K5g, K9pg).
enum Dual { DUAL_BCR, DUAL_CLUSTER, DUAL_GRID };

template <int DUAL>
MEGA_INLINE void mega_body(const MegaParams& p) {
  constexpr bool BCR = DUAL == DUAL_BCR;
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
    // 4. the dual solve and dz: the warm-started stair-PCG across the
    // first cluster (K5, K9p) or the whole grid (K5g, K9pg); or the refined
    // BCR in block 0 (0 CG iterations, no hit)
    if constexpr (DUAL == DUAL_CLUSTER) {
      if (bid < ld_cluster_size()) {
        const pcgc::ClusterCg a = pcgc::cluster_area(smem, N, p.stair_on_chip);
        pcgc::cluster_load_bands(a, p.SL, p.SD, p.SU, a.SL, a.SD, a.SU);
        const size_t o = (size_t)SS * a.k0;
        pcgc::ClusterStair pre{p.PL + o, p.PD + o, p.PU + o};
        if (p.stair_on_chip) {
          pcgc::cluster_load_bands(a, p.PL, p.PD, p.PU, a.PL, a.PD, a.PU);
          pre = pcgc::ClusterStair{a.PL, a.PD, a.PU};
        }
        float eta;
        const int its = pcgc::cluster_cg_solve(a, p.gamma, p.lam, pre,
                                               p.max_iter, p.tol, &eta);
        pcgc::cluster_dz(a, p.A, p.B, p.q, p.r, p.Qinv, p.Rinv, p.lam, p.dX,
                         p.dU);
        if (a.rank == 0 && t == 0) {
          p.cg_it[0] = its;
          p.cg_it[2] = a.C;
          p.cg_hit[0] = fabsf(eta) > p.tol;
        }
      }
    } else if constexpr (DUAL == DUAL_GRID) {
      float eta;
      const int its = pcgc::grid_cg_solve(
          N, p.SL, p.SD, p.SU, p.PL, p.PD, p.PU, p.gamma, p.lam, p.lam,
          pcgc::grid_cg_area(p.cg, N), p.max_iter, p.tol, &eta);
      pcgc::grid_dz(N, p.lam, p.A, p.B, p.q, p.r, p.Qinv, p.Rinv, nullptr,
                    p.dX, p.dU);
      if (bid == 0 && t == 0) {
        p.cg_it[0] = its;
        p.cg_hit[0] = fabsf(eta) > p.tol;
      }
    } else if (bid == 0) {
      bcr::bcr_dz_body(N, p.SL, p.SD, p.SU, p.gamma, p.A, p.B, p.q, p.r,
                       p.Qinv, p.Rinv, p.fac, smem, p.lam, p.dX, p.dU);
      if (t == 0) {
        p.cg_it[0] = 0;
        p.cg_hit[0] = false;
      }
    }
    LD_GRID_SYNC();
    LD_STAMP(40 + 3 * it);
    // 5. merit contributions of every (candidate, knot) pair, on groups
    // of lanes spread over the blocks (merit.cuh), in the dynamic shared
    // area, which the dual solve no longer needs
    k2::contribs_at(k2::group_for(p.num_alphas * N, nb, nt), tab, smem,
                    k2::Job{p.X, p.dX, p.U, p.dU, p.goals, p.xs, p.contrib, N,
                            1, p.num_alphas, p.num_alphas, p.gstride, 0, 0,
                            p.dt, p.mu, p.qd_cost, p.r_cost, p.grav});
    LD_GRID_SYNC();
    LD_STAMP(41 + 3 * it);
    // 6. the decision, the same in every block
    for (int a = t; a < p.num_alphas; a += nt) {
      float m = 0.0f;
      for (int k = 0; k < N; ++k) m += p.contrib[a * N + k];
      merits[a] = m;
    }
    LD_SYNC();
    LD_STAMP(42 + 3 * it);
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

// K5 and K9p held to 202 registers a thread, their count with K3's
// one-thread stage bodies inlined (the stages are calls now,
// kkt_schur.cuh; their call sites alone would take it to 207)
LD_GLOBAL void LD_MAXNREG(202) sqp_mega_kernel(MegaParams p) {
  mega_body<DUAL_CLUSTER>(p);
}
LD_GLOBAL void LD_MAXNREG(202) sqp_iter_mega_pcg_kernel(MegaParams p) {
  mega_body<DUAL_CLUSTER>(p);
}
LD_GLOBAL void sqp_iter_mega_bcr_kernel(MegaParams p) {
  mega_body<DUAL_BCR>(p);
}
LD_GLOBAL void sqp_mega_grid_kernel(MegaParams p) {
  mega_body<DUAL_GRID>(p);
}
LD_GLOBAL void sqp_iter_mega_pcg_grid_kernel(MegaParams p) {
  mega_body<DUAL_GRID>(p);
}

using MegaKernel = void (*)(MegaParams);

MegaKernel kernel_of(int kind) {
  switch (kind) {
    case ITER_BCR: return sqp_iter_mega_bcr_kernel;
    case ITER_PCG: return sqp_iter_mega_pcg_kernel;
    case SOLVE_PCG_GRID: return sqp_mega_grid_kernel;
    case ITER_PCG_GRID: return sqp_iter_mega_pcg_grid_kernel;
    default: return sqp_mega_kernel;
  }
}

#ifdef __CUDACC__
// Static shared bytes of a kernel, or -1.
long long mega_static_smem(int kind) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, (const void*)kernel_of(kind)) != cudaSuccess)
    return -1;
  return (long long)attr.sharedSizeBytes;
}

// Co-resident clusters of C blocks of kernel `kind` with `smem` dynamic
// shared bytes each (0 if none, or if the query is refused).
int active_clusters(int kind, int C, size_t smem) {
  const void* fn = (const void*)kernel_of(kind);
  int n = 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess)
    n = 0;
  cudaGetLastError();  // a refused query leaves no error behind
  return n;
}
#endif

// The launch of a cluster kind (K5, K9p) over N knots: the cluster size C
// (C_req where it is 8 or 16; else 16 where a cluster of 16 blocks holding
// S's and the stair's bands on chip is co-resident, else 8; 0 past the
// fit), where the stair bands go (stair_req 1 on chip, 0 in L2, -1 on chip
// unless that gives a smaller grid than L2 does) and the grid,
// C x min(co-resident clusters, ceil(N / C)).  The host build runs the cluster as one block: C = 1 where
// the card's arithmetic at 227 KB fits C = 16, the grid 1.
struct MegaPlan {
  int C = 0, stair = 0, grid = 0;
};

MegaPlan mega_plan(int N, int kind, int C_req, int stair_req) {
  MegaPlan pl;
  if (!cluster_cg(kind) || N < 2 || N > GRID_MAX_KNOTS ||
      (C_req != 0 && C_req != 8 && C_req != 16))
    return pl;
#ifdef __CUDACC__
  static std::map<long long, MegaPlan> known;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return pl;
  const long long key =
      ((((long long)dev * 8 + kind) * 32 + C_req) * 4 + (stair_req + 1))
          * (GRID_MAX_KNOTS + 1) + N;
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return pl;
  const long long stat = mega_static_smem(kind);
  for (int C : {16, 8}) {
    if (C_req > 0 && C != C_req) continue;
    const size_t on = mega_smem_floats(N, kind, C, true) * sizeof(float);
    const size_t off = mega_smem_floats(N, kind, C, false) * sizeof(float);
    if (stat < 0 || (long long)on + stat > optin) continue;
    const int n_on = active_clusters(kind, C, on);
    if (n_on < 1) continue;
    const int want = (N + C - 1) / C;
    const int g_on = C * (n_on < want ? n_on : want);
    const int n_off = active_clusters(kind, C, off);
    const int g_off = C * (n_off < want ? n_off : want);
    pl.C = C;
    pl.stair = stair_req >= 0 ? stair_req : g_on >= g_off;
    pl.grid = pl.stair ? g_on : g_off;
    break;
  }
  known[key] = pl;
#else
  if (mega_smem_floats(N, kind, 16, true) * sizeof(float) <= 232448) {
    pl.C = 1;
    pl.stair = stair_req != 0;
    pl.grid = 1;
  }
#endif
  return pl;
}

int check_kind(int kind) { return kind >= SOLVE_PCG && kind <= ITER_PCG_GRID; }

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
  if (kind == ITER_BCR) f += bcr::factor_floats(N);
  p.cg = grid_cg(kind) ? f : nullptr;
  p.stair_on_chip = 0;
  p.cg_it = iscratch;
  p.cg_hit = reinterpret_cast<bool*>(iscratch + 1);
  return p;
}

}  // namespace

// Largest horizon kernel `kind` serves on this device: for K5 and K9p
// (kinds 0, 1) the largest N whose cluster form fits (mega_plan: a cluster
// of 16 or 8 blocks, each holding its knots' S and stair bands, the CG
// vectors and the stages' static arrays); for K9b (2) the largest N whose
// block-0 BCR vectors fit every block; 0 if the attributes cannot be read.
// The grid kinds (3 K5g, 4 K9pg) answer GRID_MAX_KNOTS.
extern "C" int mpc_mega_max_knots(int kind) {
  if (!check_kind(kind)) return 0;
  if (grid_cg(kind)) return GRID_MAX_KNOTS;
  if (cluster_cg(kind)) {
    // the fit is monotone in N: bisect for the last N with a cluster
    int lo = 1, hi = GRID_MAX_KNOTS + 1;
    while (hi - lo > 1) {
      const int mid = lo + (hi - lo) / 2;
      (mega_plan(mid, kind, 0, 1).C > 0 ? lo : hi) = mid;
    }
    return lo < 2 ? 0 : lo;
  }
  auto floats = [kind](int n) { return mega_smem_floats(n, kind, 1, false); };
#ifdef __CUDACC__
  const long long stat = mega_static_smem(kind);
  if (stat < 0) return 0;
  return pcgc::max_knots_for(floats, (size_t)stat);
#else
  return pcgc::max_knots_for(floats, 0);
#endif
}

// The cluster launch of K5 or K9p (kind 0, 1) over N knots at the cluster
// size `cluster` asks (8, 16; 0 the plan's choice) with the stair bands as
// `stair` asks (1 on chip, 0 in L2, -1 the plan's choice): writes the
// cluster size, where the stair bands go (1 on chip) and the grid to
// out[0..2]; returns 0 where no such cluster fits, else 1.
extern "C" int mpc_mega_cluster_plan(int N, int kind, int cluster, int stair,
                                     int* out) {
  const MegaPlan pl = mega_plan(N, kind, cluster, stair);
  out[0] = pl.C;
  out[1] = pl.stair;
  out[2] = pl.grid;
  return pl.C > 0;
}

// The grid a launch of kernel `kind` over N knots uses.  K5, K9p: the
// cluster plan's (stair bands placed by the plan).  K5g, K9pg, K9b:
// min(N, blocks that can be resident at once), from the occupancy API at
// the kernel's block size and shared memory (the counterpart of the
// reference's checkPcgOccupancy).  0 if not one block (cluster) fits or
// the device has no cooperative launch.
extern "C" int mpc_mega_grid(int N, int kind) {
  if (!check_kind(kind)) return 0;
  if (cluster_cg(kind)) return mega_plan(N, kind, 0, -1).grid;
#ifdef __CUDACC__
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const size_t smem = mega_smem_floats(N, kind, 1, false) * sizeof(float);
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

// One launch of kernel `kind` on `grid` blocks; cluster and stair (K5,
// K9p) as mpc_mega_cluster_plan's.  Returns the launch's error: a grid past
// co-residency, a horizon past the cluster form's fit or a launch the
// runtime refuses is never made.
int launch(const MegaParams& p, int kind, int grid, int cluster, int stair,
           void* stream) {
  if (p.num_alphas < 1 || p.num_alphas > MAX_ALPHAS || p.N < 2 || grid < 1)
    return 1;  // cudaErrorInvalidValue
  MegaParams arg = p;
  int C = 1;
  if (cluster_cg(kind)) {
    const MegaPlan pl = mega_plan(p.N, kind, cluster, stair);
    if (pl.C < 1) return 1;  // past the fit
    if (grid > pl.grid || grid % pl.C) return 720;  // cudaErrorCooperativeLaunchTooLarge
    C = pl.C;
    arg.stair_on_chip = pl.stair;
  }
  const size_t smem =
      mega_smem_floats(p.N, kind, C, arg.stair_on_chip != 0) * sizeof(float);
#ifdef __CUDACC__
  const void* fn = (const void*)kernel_of(kind);
  cudaError_t err;
  if (cluster_cg(kind)) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute at[2];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    at[1].id = cudaLaunchAttributeCooperative;
    at[1].val.cooperative = 1;
    cfg.attrs = at;
    cfg.numAttrs = 2;
    err = cudaLaunchKernelEx(&cfg, kernel_of(kind), arg);
  } else {
    // mpc_mega_grid also sets the kernel's dynamic shared memory limit;
    // never launch past co-residency
    if (grid > mpc_mega_grid(p.N, kind))
      return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&arg};
    err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS), args,
                                      smem, (cudaStream_t)stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  (void)C;
  const MegaKernel kern = kernel_of(kind);
  LD_LAUNCH(kern, 1, THREADS, smem, stream, arg);
  return 0;
#endif
}

}  // namespace

// K5 (kind 0) or K5g (kind 3): n_sqp iterations from drho0 = drho0 (a host
// number).  iscratch holds 3 ints (K5 leaves the cluster size it read in
// the third); cluster and stair as mpc_mega_cluster_plan's (K5 only).
extern "C" int mpc_sqp_mega(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* lam0,
    const float* rho0, const float* merit0, float drho0, int max_iter,
    float tol, int n_sqp, float dt, float qd_cost, float r_cost, float grav,
    float mu, int num_alphas, float rho_factor, float rho_min, float rho_max,
    float rho_reset, float* X, float* U, float* lam, float* scal, int* ints,
    int* stats, float* scratch, int* iscratch, int kind, int grid,
    int cluster, int stair, void* stream) {
  if (kind != SOLVE_PCG && kind != SOLVE_PCG_GRID) return 1;
  const MegaParams p = make_params(
      tab, N, X0, U0, goals, gstride, xs, lam0, rho0, merit0, nullptr, drho0,
      max_iter, tol, n_sqp, dt, qd_cost, r_cost, grav, mu, num_alphas,
      rho_factor, rho_min, rho_max, rho_reset, X, U, lam, scal, ints, stats,
      scratch, iscratch, kind);
  return launch(p, kind, grid, cluster, stair, stream);
}

// K9p (kind 1) or K9pg (kind 4): one iteration, rho, drho and the
// incumbent merit in device memory.  Outputs as K5's with n_sqp = 1: scal
// (rho, drho, merit), ints (iterations run, bail), stats (CG iterations,
// hit, accepted).
extern "C" int mpc_sqp_iter_mega_pcg(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* lam0,
    const float* rho0, const float* drho0, const float* merit0, int max_iter,
    float tol, float dt, float qd_cost, float r_cost, float grav, float mu,
    int num_alphas, float rho_factor, float rho_min, float rho_max,
    float rho_reset, float* X, float* U, float* lam, float* scal, int* ints,
    int* stats, float* scratch, int* iscratch, int kind, int grid,
    int cluster, int stair, void* stream) {
  if (kind != ITER_PCG && kind != ITER_PCG_GRID) return 1;
  const MegaParams p = make_params(
      tab, N, X0, U0, goals, gstride, xs, lam0, rho0, merit0, drho0, 1.0f,
      max_iter, tol, 1, dt, qd_cost, r_cost, grav, mu, num_alphas,
      rho_factor, rho_min, rho_max, rho_reset, X, U, lam, scal, ints, stats,
      scratch, iscratch, kind);
  return launch(p, kind, grid, cluster, stair, stream);
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
  return launch(p, ITER_BCR, grid, 0, -1, stream);
}
