// K5: the whole SQP solve -- every iteration -- in one cooperative launch;
// K9p and K9b: ONE SQP iteration per cooperative launch, with the stair-PCG
// and the refined block cyclic reduction (BCR) dual solve; K5g and K9pg:
// K5 and K9p past the cluster form's fit, their CG joined across every
// cluster of the launch.
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
// and runs stage 4 as bcr_common.cuh's refined BCR solve and dz across the
// first cluster (cluster_bcr_dz); it has no warm start and reports 0 CG
// iterations.  One templated body serves the five kernels.
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
// Stage 4 of K5, K9p and K9b runs across the first cluster: the launch is
// a cluster launch (cudaLaunchKernelEx with a cluster dimension of C = 16
// where the card schedules it, else 8) that is also cooperative -- the
// runtime takes both attributes together on the H100 (a probe of
// cooperative_groups' grid sync inside a cluster launch, CUDA 12.9), so
// the other stages keep the grid barrier, and the grid is held to
// cudaOccupancyMaxActiveClusters x C.  Each block of the first cluster
// loads S's bands of the knots it owns from L2 at the start of stage 4.
// K5 and K9p run the stair-PCG there (pcg_common.cuh), with the stair's
// bands on chip too where they fit (mega_plan: unless that shrinks the
// grid the stages run on): the halo rows through DSMEM and the dots summed
// in rank order (two cluster barriers per CG step), then each block's
// knots' dz.  K9b factors the BCR over the cluster's 4 x C warps, applies
// it twice with the residual between and computes the owners' dz
// (bcr_common.cuh cluster_bcr_dz), its factors in global memory (L2).
// Every block asks for that shared memory, so it bounds N
// (mpc_mega_max_knots, about 670 on the H100 for K5 and K9p) and the grid.
//
// K5g and K9pg (the joined kinds) serve N past the cluster form's fit,
// and run stage 4 in EVERY block: the launch is a cooperative cluster
// launch of G clusters of C blocks (grid_plan: C = 16 where the card
// schedules it, unless a smaller C gives the stages fewer passes over the
// knots; G the co-resident clusters, at most N / C), and the
// stair-PCG is the cluster CG's body across all of them (pcg_common.cuh's
// joined form): each block owns about N / (G C) knots (3 at N = 1024 on
// the H100) with their bands and vector rows on chip where the plan fits
// them (else in L2), two cluster barriers a step, and no grid barrier --
// each dot's cluster sums and the rows at the clusters' edges cross as
// tagged words in global memory (JoinedExit), zeroed at the launch's
// start.  Then dz per owned knot (cluster_dz).  A block of these kinds
// keeps its decision state at the head of its dynamic shared memory.
//
// No sum of any stage depends on the grid; a cluster's CG depends on C
// alone and the joined CG on (C, G), which the plan takes from N and the
// device alone (K9pg launches K5g's plan), so four K9p launches equal one
// K5 launch bit for bit, as four K9pg launches equal one K5g launch.
// K9b's factor and solve equal the one-block bcr_dz_body's (K7's) bit for
// bit: each sum keeps its terms and their order.
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
  ld::Knobs kn;  // tracking, Hessian, integrator, wrap (kkt_schur.cuh)
  // outputs
  float *X, *U, *lam, *scal;  // scal: rho, drho, merit
  int *ints, *st_iters, *st_hit, *st_acc;  // ints: sqp_iters, bailed
  // scratch
  float *SL, *SD, *SU, *PL, *PD, *PU, *Qinv, *A, *AQi, *T, *B, *Rinv;
  float *gamma, *q, *tvec, *Qiq, *fpred, *dX, *r, *dU, *contrib;
  float* fac;  // K9b: the BCR factors
  unsigned long long* words;  // K5g, K9pg: the joined CG's tagged words
  float* vecs;  // K5g, K9pg at place 0: the blocks' CG vectors
  int stair_on_chip;  // K5, K9p: the stair bands in the cluster's shared memory
  int G, place;  // K5g, K9pg: clusters in the CG, where its area lies
  int* cg_it;   // the CG iterations, then (K5, K9p, K5g, K9pg) the cluster
                // size read
  bool* cg_hit;
};

// The five kernels of this file (the `kind` of the C entries below).
enum Kind {
  SOLVE_PCG = 0, ITER_PCG = 1, ITER_BCR = 2, SOLVE_PCG_GRID = 3,
  ITER_PCG_GRID = 4
};

bool joined_cg(int kind) {
  return kind == SOLVE_PCG_GRID || kind == ITER_PCG_GRID;
}
bool cluster_cg(int kind) { return kind == SOLVE_PCG || kind == ITER_PCG; }
// The kinds whose stage 4 runs across the first cluster (mega_plan)
bool first_cluster(int kind) { return cluster_cg(kind) || kind == ITER_BCR; }

// The longest horizon of the joined kinds, whose CG area may lie in global
// memory (place 0); this bound keeps the 32-bit offsets of their global
// scratch (about 2,900 floats a knot) far from overflow.
constexpr int GRID_MAX_KNOTS = 1 << 16;

// K9b and the joined kinds keep a block's decision state (rho, drho,
// merit, step; the candidates' merits; done, the iteration count) in the
// head of the dynamic area, K5 and K9p in static shared arrays: the host
// build's block emulation, which runs those kinds' blocks in turn, gives
// each block a dynamic area of its own but one static array a launch.
constexpr int HEAD_FLOATS = 32;  // N_SCAL + MAX_ALPHAS floats and 2 ints

// Dynamic shared floats of every block of K5, K9p or K9b: the cluster CG's
// area at cluster size C (K5, K9p), or the head and the cluster BCR's area
// with two 14x14 blocks of scratch a warp (K9b); no fewer than the merit
// stage's groups of 8 lanes take.
size_t mega_smem_floats(int N, int kind, int C, bool stair_on_chip) {
  const size_t merit = k2::areas_floats(THREADS, 8);
  if (kind == ITER_BCR) {
    const size_t dual = pcgc::cluster_cg_floats(N, C, false,
                                                bcr::scratch_floats(THREADS));
    return HEAD_FLOATS + (dual > merit ? dual : merit);
  }
  const size_t dual = pcgc::cluster_cg_floats(N, C, stair_on_chip, 0);
  return dual > merit ? dual : merit;
}

// Dynamic shared floats of every block of K5g or K9pg over nb blocks at
// `place`: the head, then the joined CG's area (pcgc::joined_area) or the
// merit stage's groups, whichever takes more.
size_t joined_smem_floats(int N, int nb, int place) {
  const size_t merit = k2::areas_floats(THREADS, 8);
  const size_t dual = pcgc::joined_cg_floats(N, nb, place);
  return HEAD_FLOATS + (dual > merit ? dual : merit);
}

// Global floats of the joined kinds' blocks' vectors at place 0 (nb
// joined_vec_floats(N, nb) <= 32 S N for any nb <= N), and of those with
// their tagged words (at most N clusters).
size_t joined_vecs_floats(int N) { return (size_t)32 * S * N; }
size_t joined_scratch_floats(int N) {
  return 2 * pcgc::joined_words(N) + joined_vecs_floats(N);
}

size_t mega_scratch_floats(int N, int num_alphas, int kind) {
  return (size_t)N * (10 * SS + S * NU + NU * NU + 6 * S + 2 * NU
                      + num_alphas)
         + (kind == ITER_BCR ? bcr::factor_floats(N) : 0)
         + (joined_cg(kind) ? joined_scratch_floats(N) : 0);
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

// Stage 4's inputs: the stages' bands, gamma, the warm start (the duals
// in place) and the blocks of the primal step.
MEGA_INLINE pcgc::DualIn dual_in(const MegaParams& p) {
  return pcgc::DualIn{p.SL, p.SD, p.SU, p.PL, p.PD, p.PU, p.gamma, p.lam,
                      p.A, p.B, p.q, p.r, p.Qinv, p.Rinv};
}

// The dual solve of stage 4: K9b's refined BCR across the first cluster,
// the cluster stair-PCG (K5, K9p) or the stair-PCG joined across every
// cluster (K5g, K9pg).
enum Dual { DUAL_BCR, DUAL_CLUSTER, DUAL_JOINED };

template <int DUAL>
MEGA_INLINE void mega_body(const MegaParams& p) {
  constexpr bool BCR = DUAL == DUAL_BCR, JOINED = DUAL == DUAL_JOINED;
  constexpr bool HEAD = DUAL != DUAL_CLUSTER;  // the state in the head
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_SHARED float merits_s[HEAD ? 1 : MAX_ALPHAS];
  LD_SHARED float st_s[HEAD ? 1 : N_SCAL];
  LD_SHARED int flags_s[HEAD ? 1 : 2];
  LD_DYN_SMEM(smem);
  // the decision state (HEAD_FLOATS), and the dynamic area past it
  float* const st = HEAD ? smem : st_s;
  float* const merits = HEAD ? smem + N_SCAL : merits_s;
  int* const flags =
      HEAD ? reinterpret_cast<int*>(smem + N_SCAL + MAX_ALPHAS) : flags_s;
  int& done = flags[0];
  int& itc = flags[1];
  float* const dyn = HEAD ? smem + HEAD_FLOATS : smem;
  const int N = p.N, t = LD_TID, nt = LD_NTID, bid = LD_BID, nb = LD_NBID;
  // K5g, K9pg: the joined CG's exchanges (their tags run over the launch)
  pcgc::JoinedExit ex{p.words, p.G, p.max_iter, p.tol};
  if constexpr (JOINED)
    for (size_t e = (size_t)bid * nt + t; e < pcgc::joined_words(p.G);
         e += (size_t)nb * nt)
      p.words[e] = 0;

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
                  p.qd_cost, p.r_cost, p.grav, p.kn, p.A, p.B, p.Qinv, p.Rinv,
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
    // first cluster (K5, K9p) or joined across every cluster (K5g, K9pg);
    // or the refined BCR across the first cluster (K9b: 0 CG iterations,
    // no hit)
    if constexpr (DUAL == DUAL_CLUSTER) {
      if (bid < ld_cluster_size()) {
        pcgc::ClusterCg a = pcgc::cluster_area(dyn, N, p.stair_on_chip);
        pcgc::LocalExit local{p.max_iter, p.tol};
        float eta;
        const int its = pcgc::stair_dual_solve<true>(
            a, p.stair_on_chip ? 3 : 2, dual_in(p), local, p.lam, p.dX, p.dU,
            &eta);
        if (a.rank == 0 && t == 0) {
          p.cg_it[0] = its;
          p.cg_it[2] = a.C;
          p.cg_hit[0] = fabsf(eta) > p.tol;
        }
      }
    } else if constexpr (JOINED) {
      // the bands on chip where the plan puts them (place 2: S's; 3: and
      // the stair's), else read from L2 at the block's first knot
      pcgc::ClusterCg a = pcgc::joined_area(dyn, p.vecs, N, p.G, p.place);
      float eta;
      const int its = pcgc::stair_dual_solve<true>(a, p.place, dual_in(p), ex,
                                                   p.lam, p.dX, p.dU, &eta);
      if (bid == 0 && t == 0) {
        p.cg_it[0] = its;
        p.cg_it[2] = a.C;
        p.cg_hit[0] = fabsf(eta) > p.tol;
      }
    } else if (bid < ld_cluster_size()) {
      const pcgc::ClusterCg a = pcgc::cluster_area(dyn, N, false);
      pcgc::cluster_load_bands(a, p.SL, p.SD, p.SU, a.SL, a.SD, a.SU);
      bcr::cluster_bcr_dz(a, bcr::BcrFactor(p.fac, N, bcr::levels_of(N)),
                          p.gamma, p.A, p.B, p.q, p.r, p.Qinv, p.Rinv, p.lam,
                          p.dX, p.dU);
      if (a.rank == 0 && t == 0) {
        p.cg_it[0] = 0;
        p.cg_it[2] = a.C;
        p.cg_hit[0] = false;
      }
    }
    LD_GRID_SYNC();
    LD_STAMP(40 + 3 * it);
    // 5. merit contributions of every (candidate, knot) pair, on groups
    // of lanes spread over the blocks (merit.cuh), in the dynamic shared
    // area, which the dual solve no longer needs
    k2::contribs_at(k2::group_for(p.num_alphas * N, nb, nt), tab, dyn,
                    k2::Job{p.X, p.dX, p.U, p.dU, p.goals, p.xs, p.contrib, N,
                            1, p.num_alphas, p.num_alphas, p.gstride, 0, 0,
                            p.dt, p.mu, p.qd_cost, p.r_cost, p.grav, p.kn});
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
  mega_body<DUAL_JOINED>(p);
}
LD_GLOBAL void sqp_iter_mega_pcg_grid_kernel(MegaParams p) {
  mega_body<DUAL_JOINED>(p);
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
  return pcgc::active_clusters((const void*)kernel_of(kind), C, THREADS, smem);
}
#endif

// The launch of a kind whose stage 4 runs across the first cluster (K5,
// K9p, K9b) over N knots: the cluster size C (C_req where it is 8 or 16;
// else 16 where a cluster of 16 blocks holding S's bands, and for K5 and
// K9p the stair's, on chip is co-resident, else 8; 0 past the fit), where
// the stair bands go (K5, K9p: stair_req 1 on chip, 0 in L2, -1 on chip
// unless that gives a smaller grid than L2 does; K9b has none, 0) and the
// grid, C x min(co-resident clusters, ceil(N / C)).  The host build runs
// the cluster as one block: C = 1 where the card's arithmetic at 227 KB
// fits C = 16, the grid 1.
struct MegaPlan {
  int C = 0, stair = 0, grid = 0;
};

MegaPlan mega_plan(int N, int kind, int C_req, int stair_req) {
  MegaPlan pl;
  if (!first_cluster(kind) || N < 2 || N > GRID_MAX_KNOTS ||
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
    pl.stair = kind == ITER_BCR ? 0
               : stair_req >= 0 ? stair_req : g_on >= g_off;
    pl.grid = pl.stair ? g_on : g_off;
    break;
  }
  known[key] = pl;
#else
  if (mega_smem_floats(N, kind, 16, true) * sizeof(float) <= 232448) {
    pl.C = 1;
    pl.stair = kind != ITER_BCR && stair_req != 0;
    pl.grid = 1;
  }
#endif
  return pl;
}

// The launch of the joined kinds (K5g's; K9pg launches it too, so that
// four K9pg launches equal one K5g launch bit for bit): C blocks a
// cluster, G clusters, where the CG's area lies (`place`, as
// pcgc::joined_area's: 3 S's and the stair's bands and the vectors on chip,
// 2 S's bands and the vectors, 1 the vectors, 0 none) and the grid C G.
// C: C_req where it is a power of 2 up to 16; else 16 where the card holds
// clusters of 16 of K5g, unless a smaller size (8, 4, 2, 1; C <= N) gives
// the stages fewer passes over the knots (ceil(N / (C G)): at N = 1024
// the H100 holds 21 clusters of 16, 336 blocks, a fourth pass that 45 of
// 8 avoid), and then the largest such size.  G: the most clusters that
// are co-resident at the shared memory their knots take (fewer clusters
// give a block more knots), at most N / C, so that every block owns a
// knot.  place: place_req where it is 0-3; else the most on chip of those
// with the most clusters.  The host build plans one block (C = G =
// 1) unless C_req asks for a size, and then N / C clusters of it (a test
// runs them under the block emulation); place 3 unless asked.
struct GridPlan {
  int C = 0, G = 0, place = 0, grid = 0;
};

GridPlan grid_plan(int N, int C_req, int place_req) {
  GridPlan pl;
  if (N < 2 || N > GRID_MAX_KNOTS || place_req < -1 || place_req > 3 ||
      C_req < 0 || C_req > 16 || (C_req & (C_req - 1)))
    return pl;
#ifdef __CUDACC__
  static std::map<long long, GridPlan> known;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return pl;
  const long long key =
      (((long long)dev * 32 + C_req) * 8 + (place_req + 1))
          * (GRID_MAX_KNOTS + 1) + N;
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return pl;
  const long long stat = mega_static_smem(SOLVE_PCG_GRID);
  if (stat < 0) return pl;
  int passes = 0;  // the best plan's passes of the stages over the knots
  for (int C : {16, 8, 4, 2, 1}) {
    if ((C_req > 0 && C != C_req) || C > N) continue;
    GridPlan at;  // the most clusters at size C, the most on chip
    for (int place = 3; place >= 0; --place) {
      if (place_req >= 0 && place != place_req) continue;
      // clusters co-resident at the shared memory of G clusters' knots
      auto resident = [&](int G) {
        const size_t bytes =
            joined_smem_floats(N, C * G, place) * sizeof(float);
        if ((long long)bytes + stat > optin) return 0;
        return active_clusters(SOLVE_PCG_GRID, C, bytes);
      };
      // the largest G <= resident(G): resident(G) falls with G, so
      // stepping G down to it from the most ends at that G (or 0)
      int G = N / C;
      while (G > 0) {
        const int r = resident(G);
        if (r >= G) break;
        G = r;
      }
      if (G > at.G) {
        at.C = C;
        at.G = G;
        at.place = place;
      }
    }
    if (at.G < 1) continue;
    const int p = (N + C * at.G - 1) / (C * at.G);
    if (pl.G == 0 || p < passes) {
      pl = at;
      passes = p;
    }
  }
  pl.grid = pl.C * pl.G;
  known[key] = pl;
#else
  pl.C = C_req > 0 ? C_req : 1;
  if (pl.C > N) return GridPlan{};
  pl.G = C_req > 0 ? N / pl.C : 1;
  pl.place = place_req >= 0 ? place_req : 3;
  pl.grid = pl.C * pl.G;
#endif
  return pl;
}

int check_kind(int kind) { return kind >= SOLVE_PCG && kind <= ITER_PCG_GRID; }

// The parameters of one launch.  drho0_p (device memory) overrides drho0
// when it is not null; lam0 is not read by K9b.
MegaParams make_params(const ld::Knobs& kn,
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* lam0,
    const float* rho0, const float* merit0, const float* drho0_p,
    float drho0, int max_iter, float tol, int n_sqp, float dt, float qd_cost,
    float r_cost, float grav, float mu, int num_alphas, float rho_factor,
    float rho_min, float rho_max, float rho_reset, float* X, float* U,
    float* lam, float* scal, int* ints, int* stats, float* scratch,
    int* iscratch, int kind) {
  MegaParams p;
  p.kn = kn;
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
  // the joined kinds' tagged words first (8-byte aligned), then their
  // blocks' vectors (place 0)
  p.words = nullptr;
  p.vecs = nullptr;
  if (joined_cg(kind)) {
    p.words = reinterpret_cast<unsigned long long*>(f);
    f += 2 * pcgc::joined_words(N);
    p.vecs = f;
    f += joined_vecs_floats(N);
  }
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
  p.stair_on_chip = 0;
  p.G = p.place = 0;
  p.cg_it = iscratch;
  p.cg_hit = reinterpret_cast<bool*>(iscratch + 1);
  return p;
}

}  // namespace

// Largest horizon kernel `kind` serves on this device: for K5, K9p and K9b
// (kinds 0-2) the largest N whose cluster form fits (mega_plan: a cluster
// of 16 or 8 blocks, each holding its knots' S bands (and for K5 and K9p
// the stair's), the dual solve's vectors and the stages' static arrays;
// K9b serves the powers of 2 up to it); 0 if the attributes cannot be
// read.  The joined kinds (3 K5g, 4 K9pg) answer GRID_MAX_KNOTS (their
// area goes to global memory where shared memory cannot hold it).
extern "C" int mpc_mega_max_knots(int kind) {
  if (!check_kind(kind)) return 0;
  if (joined_cg(kind)) return GRID_MAX_KNOTS;
  // the fit is monotone in N: bisect for the last N with a cluster
  int lo = 1, hi = GRID_MAX_KNOTS + 1;
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    (mega_plan(mid, kind, 0, 1).C > 0 ? lo : hi) = mid;
  }
  return lo < 2 ? 0 : lo;
}

// The cluster launch of K5, K9p or K9b (kind 0-2) over N knots at the
// cluster size `cluster` asks (8, 16; 0 the plan's choice) with the stair
// bands as `stair` asks (1 on chip, 0 in L2, -1 the plan's choice; K9b
// none): writes the cluster size, where the stair bands go (1 on chip) and
// the grid to out[0..2]; returns 0 where no such cluster fits, else 1.
extern "C" int mpc_mega_cluster_plan(int N, int kind, int cluster, int stair,
                                     int* out) {
  const MegaPlan pl = mega_plan(N, kind, cluster, stair);
  out[0] = pl.C;
  out[1] = pl.stair;
  out[2] = pl.grid;
  return pl.C > 0;
}

// The launch of K5g and K9pg over N knots (grid_plan) at the cluster size
// `cluster` asks (1-16; 0 the plan's choice) with the CG's area where
// `place` asks (0-3; -1 the plan's choice): writes the cluster size, the
// clusters, the place and the grid to out[0..3]; returns 0 where no such
// launch fits, else 1.
extern "C" int mpc_mega_grid_plan(int N, int cluster, int place, int* out) {
  const GridPlan pl = grid_plan(N, cluster, place);
  out[0] = pl.C;
  out[1] = pl.G;
  out[2] = pl.place;
  out[3] = pl.grid;
  return pl.grid > 0;
}

// The grid a launch of kernel `kind` over N knots uses.  K5, K9p, K9b: the
// cluster plan's (stair bands placed by the plan), held to the co-resident
// clusters (the counterpart of the reference's checkPcgOccupancy); K5g,
// K9pg: grid_plan's.  0 if not one cluster fits.
extern "C" int mpc_mega_grid(int N, int kind) {
  if (!check_kind(kind)) return 0;
  if (joined_cg(kind)) return grid_plan(N, 0, -1).grid;
  return mega_plan(N, kind, 0, -1).grid;
}

// Floats of global scratch one launch of kernel `kind` takes.
extern "C" long long mpc_sqp_mega_scratch_floats(int N, int num_alphas,
                                                 int kind) {
  return (long long)mega_scratch_floats(N, num_alphas, kind);
}

namespace {

// One launch of kernel `kind` on `grid` blocks; cluster and stair as
// mpc_mega_cluster_plan's (K5, K9p) or as mpc_mega_grid_plan's cluster and
// place (K5g, K9pg: grid / C clusters).  Returns the launch's error: a grid
// past co-residency, a horizon past the cluster form's fit or a launch the
// runtime refuses is never made.
int launch(const MegaParams& p, int kind, int grid, int cluster, int stair,
           void* stream) {
  if (p.num_alphas < 1 || p.num_alphas > MAX_ALPHAS || p.N < 2 || grid < 1)
    return 1;  // cudaErrorInvalidValue
  MegaParams arg = p;
  int C = 1;
  size_t smem;
  if (joined_cg(kind)) {
    const GridPlan pl = grid_plan(p.N, cluster, stair);
    if (pl.C < 1) return 1;  // no such plan
    if (grid > pl.grid || grid % pl.C) return 720;  // cudaErrorCooperativeLaunchTooLarge
    C = pl.C;
    arg.G = grid / C;
    arg.place = pl.place;
    smem = joined_smem_floats(p.N, grid, pl.place) * sizeof(float);
  } else {
    MegaPlan pl = mega_plan(p.N, kind, cluster, stair);
#ifndef __CUDACC__
    // the host build alone: K9b at a cluster size of 1-16 plans ceil(N / C)
    // clusters of it, which the block emulation runs (tests of its barriers)
    if (kind == ITER_BCR && cluster > 0 && cluster <= 16 &&
        mega_plan(p.N, kind, 0, stair).C > 0)
      pl = MegaPlan{cluster, 0, cluster * ((p.N + cluster - 1) / cluster)};
#endif
    if (pl.C < 1) return 1;  // past the fit
    if (grid > pl.grid || grid % pl.C) return 720;
    C = pl.C;
    arg.stair_on_chip = pl.stair;
    smem = mega_smem_floats(p.N, kind, C, arg.stair_on_chip != 0)
           * sizeof(float);
  }
#ifdef __CUDACC__
  const void* fn = (const void*)kernel_of(kind);
  cudaError_t err;
  // a K9pg launch takes K5g's plan: its own kernel must hold the clusters
  if (joined_cg(kind) && active_clusters(kind, C, smem) < arg.G)
    return (int)cudaErrorCooperativeLaunchTooLarge;
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
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  // the host build: one block walks every knot, or (the joined kinds and
  // K9b on more than one block) the block emulation runs the clusters
  const MegaKernel kern = kernel_of(kind);
  if ((joined_cg(kind) || kind == ITER_BCR) && grid > 1)
    ld_emu_blocks(grid, C, smem / sizeof(float), [&] { kern(arg); });
  else
    LD_LAUNCH(kern, 1, THREADS, smem, stream, arg);
  return 0;
#endif
}

}  // namespace

// K5 (kind 0) or K5g (kind 3): n_sqp iterations from drho0 = drho0 (a host
// number).  iscratch holds 3 ints (K5 and K5g leave the cluster size they
// read in the third); cluster and stair as launch's.  In each entry below,
// tracking, hessian, integrator, wrap and q_cost are the knobs, as
// mpc_kkt_schur's (goals nx wide under joint tracking).
extern "C" int mpc_sqp_mega(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* lam0,
    const float* rho0, const float* merit0, float drho0, int max_iter,
    float tol, int n_sqp, float dt, float qd_cost, float r_cost, float grav,
    float mu, int num_alphas, float rho_factor, float rho_min, float rho_max,
    float rho_reset, float* X, float* U, float* lam, float* scal, int* ints,
    int* stats, float* scratch, int* iscratch, int kind, int grid,
    int cluster, int stair, int tracking, int hessian, int integrator,
    int wrap, float q_cost, void* stream) {
  ld::Knobs kn;
  if ((kind != SOLVE_PCG && kind != SOLVE_PCG_GRID) ||
      !ld::make_knobs(tracking, hessian, integrator, wrap, q_cost, &kn))
    return 1;
  const MegaParams p = make_params(
      kn, tab, N, X0, U0, goals, gstride, xs, lam0, rho0, merit0, nullptr,
      drho0, max_iter, tol, n_sqp, dt, qd_cost, r_cost, grav, mu, num_alphas,
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
    int cluster, int stair, int tracking, int hessian, int integrator,
    int wrap, float q_cost, void* stream) {
  ld::Knobs kn;
  if ((kind != ITER_PCG && kind != ITER_PCG_GRID) ||
      !ld::make_knobs(tracking, hessian, integrator, wrap, q_cost, &kn))
    return 1;
  const MegaParams p = make_params(
      kn, tab, N, X0, U0, goals, gstride, xs, lam0, rho0, merit0, drho0,
      1.0f, max_iter, tol, 1, dt, qd_cost, r_cost, grav, mu, num_alphas,
      rho_factor, rho_min, rho_max, rho_reset, X, U, lam, scal, ints, stats,
      scratch, iscratch, kind);
  return launch(p, kind, grid, cluster, stair, stream);
}

// K9b: one iteration with the refined BCR dual solve (power-of-2 N); no
// warm start, no CG.  Outputs as K9p's, stats' CG count 0; iscratch's
// third int the cluster size read.  cluster as mpc_mega_cluster_plan's.
extern "C" int mpc_sqp_iter_mega(
    const float* tab, int N, const float* X0, const float* U0,
    const float* goals, int gstride, const float* xs, const float* rho0,
    const float* drho0, const float* merit0, float dt, float qd_cost,
    float r_cost, float grav, float mu, int num_alphas, float rho_factor,
    float rho_min, float rho_max, float rho_reset, float* X, float* U,
    float* lam, float* scal, int* ints, int* stats, float* scratch,
    int* iscratch, int grid, int cluster, int tracking, int hessian,
    int integrator, int wrap, float q_cost, void* stream) {
  ld::Knobs kn;
  if ((N & (N - 1)) ||
      !ld::make_knobs(tracking, hessian, integrator, wrap, q_cost, &kn))
    return 1;  // cudaErrorInvalidValue
  const MegaParams p = make_params(
      kn, tab, N, X0, U0, goals, gstride, xs, nullptr, rho0, merit0, drho0,
      1.0f, 0, 0.0f, 1, dt, qd_cost, r_cost, grav, mu, num_alphas, rho_factor,
      rho_min, rho_max, rho_reset, X, U, lam, scal, ints, stats, scratch,
      iscratch, ITER_BCR);
  return launch(p, ITER_BCR, grid, cluster, -1, stream);
}

#ifndef __CUDACC__
namespace {

// The joined CG's exit with one kind of rows never put by the last block of
// cluster 0 (drop: that kind; -1 none): a broken copy for the test below.
struct DroppedRows : pcgc::JoinedExit {
  int drop = -1;
  void put(const pcgc::ClusterCg& a, int kind, const float* x,
           const float* y) {
    if (kind == drop && a.cl == 0 && a.rank == a.C - 1) {
      ++puts[kind];
      return;
    }
    pcgc::JoinedExit::put(a, kind, x, y);
  }
};

}  // namespace

// Host build only: K5's or K5g's stage 4 alone, as the calls those
// kernels made before stage 4 became one body shared with K4 and K4b
// (pcgc::stair_dual_solve), under the block emulation: G = 0 K5's -- the
// cluster CG and dz of one cluster of C blocks, the stair's bands on chip
// at place 3 and read from L2 at place 2 -- else K5g's -- the joined
// stair-PCG over G clusters of C blocks, its area at `place`
// (pcgc::joined_area) -- from S's and the stair's bands ((N, 14, 14) each),
// gamma and lam0 ((N, 14)): writes the solution to lam, the CG count to
// iters, and with dz the primal step (cluster_dz) to dX and dU from A, B,
// q, r, Qinv and Rinv (as K3 lays them out).  With drop >= 0 (G >= 1) the
// last block of cluster 0 never puts its rows of that kind.  Returns 1
// where the emulation found a wait no block could end (the card would
// hang), 2 for arguments no launch takes, else 0.
extern "C" int mpc_stage4_host(int N, int G, int C, int place, int drop,
                               int dz, const float* SL, const float* SD,
                               const float* SU, const float* PL,
                               const float* PD, const float* PU,
                               const float* gamma, const float* lam0,
                               const float* A, const float* B,
                               const float* q, const float* r,
                               const float* Qinv, const float* Rinv,
                               int max_iter, float tol, float* lam,
                               float* dX, float* dU, int* iters) {
  const bool joined = G >= 1;
  if (N < 2 || G < 0 || C < 1 || C > 16 || place < 0 || place > 3 ||
      (joined ? G * C > N : place < 2 || drop >= 0))
    return 2;
  const int nb = joined ? G * C : C;
  std::vector<unsigned long long> words(pcgc::joined_words(G), 0);
  std::vector<float> vecs(joined && place == 0
                              ? nb * pcgc::joined_vec_floats(N, nb)
                              : 1);
  const size_t smem = joined ? pcgc::joined_cg_floats(N, nb, place)
                             : pcgc::cluster_cg_floats(N, C, place == 3, 0);
  ld_emu_failed = false;
  ld_emu_blocks(nb, C, smem, [&] {
    pcgc::ClusterCg a =
        joined ? pcgc::joined_area(ld_emu_dyn, vecs.data(), N, G, place)
               : pcgc::cluster_area(ld_emu_dyn, N, place == 3);
    const size_t o = (size_t)SS * a.k0;
    if (place >= 2) {
      pcgc::cluster_load_bands(a, SL, SD, SU, a.SL, a.SD, a.SU);
    } else {
      a.SL = const_cast<float*>(SL) + o;
      a.SD = const_cast<float*>(SD) + o;
      a.SU = const_cast<float*>(SU) + o;
    }
    pcgc::ClusterStair pre{PL + o, PD + o, PU + o};
    if (place == 3) {
      pcgc::cluster_load_bands(a, PL, PD, PU, a.PL, a.PD, a.PU);
      pre = pcgc::ClusterStair{a.PL, a.PD, a.PU};
    }
    auto solve = [&](auto& ex) {
      float eta;
      const int its = pcgc::cluster_cg_solve(a, gamma, lam0, pre, ex, &eta);
      if (dz)
        pcgc::cluster_dz(a, A, B, q, r, Qinv, Rinv, lam, dX, dU, ex);
      else
        for (int e = 0; e < S * a.own; ++e) lam[S * a.k0 + e] = a.lam[S + e];
      if (LD_BID == 0) *iters = its;
    };
    if (joined) {
      DroppedRows ex;
      ex.words = words.data();
      ex.G = G;
      ex.max_iter = max_iter;
      ex.tol = tol;
      ex.drop = drop;
      solve(ex);
    } else {
      pcgc::LocalExit ex{max_iter, tol};
      solve(ex);
    }
  });
  const bool failed = ld_emu_failed;
  ld_emu_failed = false;
  return failed ? 1 : 0;
}

// Host build only: K5g's dual solve alone (mpc_stage4_host on G >= 1
// clusters, no dz).
extern "C" int mpc_joined_cg_host(int N, int G, int C, int place, int drop,
                                  const float* SL, const float* SD,
                                  const float* SU, const float* PL,
                                  const float* PD, const float* PU,
                                  const float* gamma, const float* lam0,
                                  int max_iter, float tol, float* lam,
                                  int* iters) {
  if (G < 1) return 2;
  return mpc_stage4_host(N, G, C, place, drop, 0, SL, SD, SU, PL, PD, PU,
                         gamma, lam0, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, max_iter, tol, lam, nullptr,
                         nullptr, iters);
}
#endif
