// K10: the whole SQP solve of B independent arms in one cooperative launch.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/sqp_megakernel.py
// (sqp_solve_mega_pcg_packed / _solve_kernel_pcg_packed ->
// _iteration_pcg_packed, _pcg_loop_packed with _pdot and _safe_div,
// _line_search_packed, _rho_schedule).  The TPU kernel packs the arms into
// the 128 lanes with segment masks; here the arm is a grid dimension, and
// the layout is knot-major with a leading arm axis: X (B, N, 14), U (B,
// N-1, 7), lam (B, N, 14), goals (B, N, gstride) (arm stride garm, 0 when
// the arms share them), xs (B, 14), rho and drho (B,).
//
// It is K5 (sqp_mega.cu) with every stage strided over (arm, knot) pairs
// across the whole grid, and per-arm decisions:
//   0. the incumbent merit of every arm, in-kernel (the TPU kernel's
//      1-candidate line search at dX = dU = 0); drho starts at drho0;
// then exactly n_sqp iterations, each:
//   1-3. per (arm, knot): the arm's previous step, K3's per-knot stage at
//      the arm's rho, the Schur bands, the stair bands;
//   4. the arms' CGs with the SHARED exit of the TPU kernel: every arm
//      steps while some arm's |eta| > tol (and none is NaN) and the count
//      is under max_iter; the count is one number for all arms; cg_div's
//      0/0 -> 0 freezes an arm whose residual is exactly zero.  Then dz per
//      arm; a frozen (bailed) arm keeps its lam.  Two forms (below);
//   5. every (arm, candidate, knot) triple: K2's merit contribution on a
//      group of lanes (merit.cuh), the triples spread over every block's
//      groups, in the CG areas' shared memory;
//   6. in every block alike: per arm, each candidate's merit summed in knot
//      order, the first minimum, the accept test, the rho / drho schedule
//      and the bail.  A bailed arm is frozen -- its X, U, lam, rho, drho
//      and merit stay -- but keeps computing: its stages and CG run on from
//      the frozen state at rho_reset, and its |eta| still counts in the
//      shared exit.  sqp_iters counts an arm's live iterations; pcg_total
//      adds the shared CG count of every iteration in which some arm was
//      live.
//
// Stage 4, the cluster form (sqp_mega_packed_cluster_kernel): the launch is
// a cluster launch that is also cooperative, as K5's (C blocks a cluster,
// C = 16, 8, 4 or 2: the largest at which B clusters are co-resident), and
// arm a's CG runs on cluster a: pcg_common.cuh's cluster_cg_solve, K5's
// body, each block holding its knots' S bands (and the stair's, where the
// plan puts them on chip) and rows of the CG vectors, with the
// SharedExit: after each eta's cluster sum, rank 0 publishes it beside a
// tag in a 64-bit word of global memory, and every block of every arm
// cluster reads the B words of a step between the arrive and the wait of
// the next step's first cluster barrier (after w = S p, which changes
// neither lam nor r), so no step takes a third barrier and no grid
// barrier.  dz per owned knot is cluster_dz's.  The clusters past the
// B-th, and the blocks of every cluster in the other stages, stride over
// the (arm, knot) pairs; the grid is C x max(B, ceil(B N / C)) clusters,
// clamped to the co-resident ones.  Since a cluster CG's sums depend on C,
// lam differs from the one-block form's in the last places.
//
// Stage 4, the one-block form (sqp_mega_packed_kernel), past the cluster
// fit (more arms than co-resident clusters of 2): block b runs the CGs of
// arms b, b + grid, ... with the arm's whole S in its shared memory (N <=
// 83 at B = 2 on the H100), from pcg_common.cuh's cg_init / cg_step;
// after each step every block publishes its arms' eta, the grid meets at
// a barrier, and every block reads all B etas.  The grid is min(B N,
// co-resident blocks), at least B.  Its eta exchange is double-buffered
// in global memory: a block writes iteration i+1's etas while a slower one
// may still read iteration i's, and no block passes the next barrier
// before every read is done.  Etas are read past L1 (ld.global.cg).
//
// The form is chosen before the launch by the occupancy API (the plan,
// mpc_mega_packed_plan); a launch past the planned grid is never made.
//
// Bound on the H100: latency -- a chain of dependent CG steps, as in K5.
// The design's answer is one cluster (or one block) per arm, so the B
// arms' CGs run at once; the per-knot stages and the merits spread over
// the grid.  The host build launches the one-block form as one block that
// owns every arm's CG and walks every (arm, knot) pair (its grid barrier a
// no-op); a test may run the cluster form there under the block emulation
// (lanedyn.cuh's ld_emu_blocks: B clusters of C blocks, block after block
// between the barriers).
#include "kkt_schur.cuh"
#include "merit.cuh"
#include "pcg_common.cuh"

#ifdef __CUDACC__
#include <map>
#include <tuple>
#endif

namespace {

constexpr int S = ld::NX, NU = ld::NU, SS = S * S;
constexpr int THREADS = 128;
constexpr int MAX_ALPHAS = 16;

struct PackedParams {
  // inputs
  const float* tab;
  int B, N, gstride, garm, max_iter, n_sqp, num_alphas, arms_per_block;
  const float *X0, *U0, *goals, *xs, *lam0, *rho0, *drho0;
  float tol, dt, qd_cost, r_cost, grav, mu;
  float rho_factor, rho_min, rho_max, rho_reset;
  ld::Knobs kn;  // tracking, Hessian, integrator, wrap (kkt_schur.cuh)
  int stair_on_chip;  // the cluster form: the stair bands in shared memory
  // outputs
  float *X, *U, *lam, *rho, *merit;
  int* ints;  // sqp_iters (B), bailed (B), pcg_total, the cluster size read
  // scratch, arm-major
  unsigned long long* words;  // the cluster form's published etas (2 B)
  float *SL, *SD, *SU, *PL, *PD, *PU, *Qinv, *A, *AQi, *T, *Bm, *Rinv;
  float *gamma, *q, *tvec, *Qiq, *fpred, *dX, *r, *dU, *contrib, *eta;
};

// Dynamic shared memory: per-arm rho, drho, merit, step (floats), the B x
// num_alphas merits, done, itc (ints), pcg_total and the exit flag, each
// owned arm's eta (the one-block form), rounded up to 4 floats; then the
// CG area -- one per owned arm (the one-block form) or this block's part
// of its cluster's (cluster_cg_floats at C) -- or, in the merit stages,
// the groups' areas (merit.cuh), at least as many floats as groups of 8
// lanes take.
LD_HD size_t head_floats(int B, int num_alphas, int arms_per_block) {
  return ((size_t)6 * B + (size_t)B * num_alphas + 2 + arms_per_block + 3)
         / 4 * 4;
}

size_t packed_smem_floats(int N, int B, int num_alphas, int arms_per_block,
                          int C, bool stair_on_chip) {
  const size_t dual =
      C > 0 ? pcgc::cluster_cg_floats(N, C, stair_on_chip, 0)
            : (size_t)arms_per_block * pcgc::cg_smem_floats(N, 4);
  const size_t merit = k2::areas_floats(THREADS, 8);
  return head_floats(B, num_alphas, arms_per_block)
         + (dual > merit ? dual : merit);
}

size_t packed_scratch_floats(int N, int B, int num_alphas) {
  return (size_t)4 * B
         + (size_t)B * N * (10 * SS + S * NU + NU * NU + 6 * S + 2 * NU
                            + num_alphas) + 2 * B;
}

// The one-block form's exit test over the B published etas: go on while
// some |eta| > tol and none is NaN (jnp.max(|eta|) > tol).
LD_DEV bool cg_goes_on(const float* eta, int B, float tol) {
  bool go = false, nan = false;
  for (int a = 0; a < B; ++a) {
    const float v = fabsf(pcgc::load_cg(eta + a));
    nan = nan || v != v;
    go = go || v > tol;
  }
  return go && !nan;
}

// X[a, k] += step dX[a, k], U[a, k] += step dU[a, k]
LD_DEV void apply_step(const PackedParams& p, int a, int k, float step) {
  const int N = p.N;
  float* X = p.X + (size_t)S * N * a;
  const float* dX = p.dX + (size_t)S * N * a;
  for (int e = LD_TID; e < S; e += LD_NTID) X[S * k + e] += step * dX[S * k + e];
  if (k < N - 1) {
    float* U = p.U + (size_t)NU * (N - 1) * a;
    const float* dU = p.dU + (size_t)NU * N * a;
    for (int e = LD_TID; e < NU; e += LD_NTID) U[NU * k + e] += step * dU[NU * k + e];
  }
}

// Inlined into each kernel, so that p stays the kernel's own parameter.
#ifdef __CUDACC__
#define PACKED_INLINE __device__ __forceinline__
#else
#define PACKED_INLINE inline
#endif

template <bool CLUSTER>
PACKED_INLINE void packed_body(const PackedParams& p) {
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_DYN_SMEM(smem);
  const int B = p.B, N = p.N, NA = p.num_alphas;
  const int t = LD_TID, nt = LD_NTID, bid = LD_BID, nb = LD_NBID;
  float* rho = smem;
  float* drho = rho + B;
  float* merit = drho + B;
  float* step = merit + B;
  float* merits = step + B;
  int* done = reinterpret_cast<int*>(merits + B * NA);
  int* itc = done + B;
  int* pcg_total = itc + B;
  int* flag = pcg_total + 1;
  float* eta_own = reinterpret_cast<float*>(flag + 1);
  float* cg_mem = smem + head_floats(B, NA, p.arms_per_block);
  const size_t cg_floats = pcgc::cg_smem_floats(N, 4);
  const size_t nbnd = (size_t)N * SS, nvec = (size_t)N * S, nctl = (size_t)N * NU;
  const size_t nbu = (size_t)N * S * NU, nuu = (size_t)N * NU * NU;
  // the cluster form: this block's arm (its cluster's; B or more for the
  // clusters past the arms) and its CG's shared exit
  const int arm = CLUSTER ? bid / ld_cluster_size() : B;
  pcgc::SharedExit ex{p.words, B, arm, p.max_iter, p.tol, flag};

  for (int pk = bid; pk < B * N; pk += nb) {
    const int a = pk / N, k = pk % N;
    const size_t o = nvec * a + S * k;
    for (int e = t; e < S; e += nt) {
      p.X[o + e] = p.X0[o + e];
      p.lam[o + e] = p.lam0[o + e];
    }
    if (k < N - 1) {
      const size_t ou = (size_t)NU * ((N - 1) * a + k);
      for (int e = t; e < NU; e += nt) p.U[ou + e] = p.U0[ou + e];
    }
  }
  for (int a = t; a < B; a += nt) {
    rho[a] = p.rho0[a];
    drho[a] = p.drho0[a];
    step[a] = 0.0f;
    done[a] = 0;
    itc[a] = 0;
  }
  if (t == 0) *pcg_total = 0;
  if (CLUSTER && bid == 0)
    for (int e = t; e < 2 * B; e += nt) p.words[e] = 0;
  ld::load_tables(tab, p.tab);  // ends in a barrier
  LD_GRID_SYNC();

  // 0. the incumbent merit of every arm: one unstepped candidate, on
  // groups of lanes spread over the blocks (merit.cuh), in the CG areas
  k2::contribs_at(k2::group_for(B * N, nb, nt), tab, cg_mem,
                  k2::Job{p.X, nullptr, p.U, nullptr, p.goals, p.xs,
                          p.contrib, N, B, 1, 0, p.gstride, p.garm, NA * N,
                          p.dt, p.mu, p.qd_cost, p.r_cost, p.grav, p.kn});
  LD_GRID_SYNC();
  for (int a = t; a < B; a += nt) {
    float m = 0.0f;
    for (int k = 0; k < N; ++k) m += p.contrib[(size_t)NA * N * a + k];
    merit[a] = m;
  }
  LD_SYNC();

  for (int it = 0; it < p.n_sqp; ++it) {
    // 1. each arm's previous step, then the per-knot KKT stage
    for (int pk = bid; pk < B * N; pk += nb) {
      const int a = pk / N, k = pk % N;
      if (step[a] != 0.0f) apply_step(p, a, k, step[a]);
      LD_SYNC();
      k3::perknot(tab, k, N, p.X + nvec * a, p.U + (size_t)NU * (N - 1) * a,
                  p.goals + (size_t)p.garm * a, p.gstride, &rho[a], p.dt,
                  p.qd_cost, p.r_cost, p.grav, p.kn, p.A + nbnd * a,
                  p.Bm + (size_t)N * S * NU * a,
                  p.Qinv + nbnd * a, p.Rinv + (size_t)N * NU * NU * a,
                  p.q + nvec * a, p.r + nctl * a, p.AQi + nbnd * a,
                  p.T + nbnd * a, p.tvec + nvec * a, p.Qiq + nvec * a,
                  p.fpred + nvec * a);
    }
    LD_GRID_SYNC();
    // 2-3. cross-knot Schur bands, then the stair preconditioner
    for (int pk = bid; pk < B * N; pk += nb) {
      const int a = pk / N, k = pk % N;
      k3::schur_bands(k, N, p.X + nvec * a, p.Qinv + nbnd * a,
                      p.AQi + nbnd * a, p.T + nbnd * a, p.tvec + nvec * a,
                      p.Qiq + nvec * a, p.fpred + nvec * a, 1,
                      p.SL + nbnd * a, p.SD + nbnd * a, p.SU + nbnd * a,
                      p.PD + nbnd * a, p.gamma + nvec * a);
    }
    LD_GRID_SYNC();
    for (int pk = bid; pk < B * N; pk += nb) {
      const int a = pk / N, k = pk % N;
      k3::stair(k, N, p.SL + nbnd * a, p.SU + nbnd * a, p.PD + nbnd * a, 1,
                p.PL + nbnd * a, p.PU + nbnd * a);
    }
    LD_GRID_SYNC();

    // 4. the CGs with the shared exit, then dz; a frozen arm keeps its lam
    int cg_it = 0;
    if constexpr (CLUSTER) {
      if (arm < B) {
        const pcgc::ClusterCg c = pcgc::cluster_area(cg_mem, N, p.stair_on_chip);
        const size_t ob = nbnd * arm;
        pcgc::cluster_load_bands(c, p.SL + ob, p.SD + ob, p.SU + ob, c.SL,
                                 c.SD, c.SU);
        const size_t o = ob + (size_t)SS * c.k0;
        pcgc::ClusterStair pre{p.PL + o, p.PD + o, p.PU + o};
        if (p.stair_on_chip) {
          pcgc::cluster_load_bands(c, p.PL + ob, p.PD + ob, p.PU + ob, c.PL,
                                   c.PD, c.PU);
          pre = pcgc::ClusterStair{c.PL, c.PD, c.PU};
        }
        float eta;
        cg_it = pcgc::cluster_cg_solve(c, p.gamma + nvec * arm,
                                       p.lam + nvec * arm, pre, ex, &eta);
        pcgc::cluster_dz(c, p.A + ob, p.Bm + nbu * arm, p.q + nvec * arm,
                         p.r + nctl * arm, p.Qinv + ob, p.Rinv + nuu * arm,
                         done[arm] ? nullptr : p.lam + nvec * arm,
                         p.dX + nvec * arm, p.dU + nctl * arm);
      }
    } else {
      for (int a = bid, j = 0; a < B; a += nb, ++j) {
        const pcgc::CgArea c = pcgc::cg_area(cg_mem + cg_floats * j, N);
        pcgc::load_system(N, p.SL + nbnd * a, p.SD + nbnd * a, p.SU + nbnd * a,
                          p.lam + nvec * a, c.SL, c.SD, c.SU, c.lam);
        const float e = pcgc::cg_init(
            N, c.SL, c.SD, c.SU, p.gamma + nvec * a, c.lam, c.r, c.p, c.red,
            pcgc::StairPre{p.PL + nbnd * a, p.PD + nbnd * a, p.PU + nbnd * a, N});
        if (t == 0) {
          eta_own[j] = e;
          p.eta[a] = e;
        }
      }
      LD_GRID_SYNC();
      int buf = 0;
      while (cg_it < p.max_iter && cg_goes_on(p.eta + (size_t)B * buf, B, p.tol)) {
        for (int a = bid, j = 0; a < B; a += nb, ++j) {
          const pcgc::CgArea c = pcgc::cg_area(cg_mem + cg_floats * j, N);
          const float e = pcgc::cg_step(
              N, c.SL, c.SD, c.SU, c.lam, c.r, c.p, c.w, c.red,
              pcgc::StairPre{p.PL + nbnd * a, p.PD + nbnd * a, p.PU + nbnd * a, N},
              eta_own[j], true);
          if (t == 0) {
            eta_own[j] = e;
            p.eta[(size_t)B * (buf ^ 1) + a] = e;
          }
        }
        LD_GRID_SYNC();
        buf ^= 1;
        ++cg_it;
      }
      for (int a = bid, j = 0; a < B; a += nb, ++j) {
        const pcgc::CgArea c = pcgc::cg_area(cg_mem + cg_floats * j, N);
        pcgc::dz_epilogue(N, c.lam, p.A + nbnd * a, p.Bm + nbu * a,
                          p.q + nvec * a, p.r + nctl * a, p.Qinv + nbnd * a,
                          p.Rinv + nuu * a, c.r, c.p,
                          done[a] ? nullptr : p.lam + nvec * a,
                          p.dX + nvec * a, p.dU + nctl * a);
        LD_SYNC();
      }
    }
    // block 0 runs arm 0's CG in either form
    if (bid == 0 && t == 0) {
      bool any_live = false;
      for (int a = 0; a < B; ++a) any_live = any_live || !done[a];
      if (any_live) *pcg_total += cg_it;
    }
    LD_GRID_SYNC();

    // 5. merit contributions of every (arm, candidate, knot) triple, as in
    // stage 0 (the CG areas are free again)
    k2::contribs_at(k2::group_for(B * NA * N, nb, nt), tab, cg_mem,
                    k2::Job{p.X, p.dX, p.U, p.dU, p.goals, p.xs, p.contrib,
                            N, B, NA, NA, p.gstride, p.garm, NA * N, p.dt,
                            p.mu, p.qd_cost, p.r_cost, p.grav, p.kn});
    LD_GRID_SYNC();
    // 6. per arm, the decision, the same in every block
    for (int e = t; e < B * NA; e += nt) {
      float m = 0.0f;
      for (int k = 0; k < N; ++k) m += p.contrib[(size_t)N * e + k];
      merits[e] = m;
    }
    LD_SYNC();
    if (t == 0) {
      for (int a = 0; a < B; ++a) {
        step[a] = 0.0f;
        if (done[a]) continue;
        const float* ma = merits + NA * a;
        int best_c = 0;
        float best = ma[0];
        for (int c = 1; c < NA; ++c)
          if (ma[c] < best) {
            best = ma[c];
            best_c = c;
          }
        const bool accept = best < merit[a];
        const float f = p.rho_factor, r = rho[a], d = drho[a];
        const float drho_rej = fmaxf(d * f, f);
        const float rho_rej = fmaxf(r * drho_rej, p.rho_min);
        const float drho_acc = fminf(d / f, 1.0f / f);
        const float rho_acc = fmaxf(r * drho_acc, p.rho_min);
        float rho_n = accept ? rho_acc : rho_rej;
        const bool bail = !accept && rho_n > p.rho_max;
        if (bail) rho_n = p.rho_reset;
        rho[a] = rho_n;
        drho[a] = accept ? drho_acc : drho_rej;
        if (accept) merit[a] = best;
        step[a] = accept ? 1.0f / (float)(1 << best_c) : 0.0f;
        done[a] = bail;
        ++itc[a];
      }
    }
    LD_SYNC();
  }

  for (int pk = bid; pk < B * N; pk += nb) {
    const int a = pk / N, k = pk % N;
    if (step[a] != 0.0f) apply_step(p, a, k, step[a]);
  }
  if (bid == 0) {
    for (int a = t; a < B; a += nt) {
      p.rho[a] = rho[a];
      p.merit[a] = merit[a];
      p.ints[a] = itc[a];
      p.ints[B + a] = done[a];
    }
    if (t == 0) {
      p.ints[2 * B] = *pcg_total;
      p.ints[2 * B + 1] = CLUSTER ? ld_cluster_size() : 0;
    }
  }
}

// The one-block form past the cluster fit, and the cluster form.
LD_GLOBAL void sqp_mega_packed_kernel(PackedParams p) { packed_body<false>(p); }
LD_GLOBAL void sqp_mega_packed_cluster_kernel(PackedParams p) {
  packed_body<true>(p);
}

#ifdef __CUDACC__
// Static shared bytes of a kernel, or -1.
long long static_smem(const void* fn) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
  return (long long)attr.sharedSizeBytes;
}
#endif

// The launch of B arms of N knots: the form (C = 0 the one-block form, else
// the cluster form at C blocks a cluster), where the cluster form's stair
// bands go (1 on chip) and the grid; grid 0 where no form fits.
struct PackedPlan {
  int C = 0, stair = 0, grid = 0;
};

// C_req: 0 the plan's choice -- the largest C of 16, 8, 4, 2 at which B
// clusters holding their knots' S and stair bands on chip are co-resident
// (the stair in L2 where that gives a larger grid, as K5's mega_plan), else
// the one-block form where an arm's whole S fits a block and B blocks are
// co-resident; 2, 4, 8 or 16 that cluster size; -1 the one-block form.
// stair_req (the cluster form): 1 on chip, 0 in L2, -1 the plan's choice.
// The host build answers the one-block form on one block for C_req 0 or
// -1 (it runs that form alone), and for a cluster size the grid of the
// card's arithmetic without its occupancy (the block emulation runs it).
PackedPlan packed_plan(int N, int B, int num_alphas, int C_req,
                       int stair_req) {
  PackedPlan pl;
  if (N < 2 || B < 1 || num_alphas < 1 || num_alphas > MAX_ALPHAS ||
      (C_req != -1 && C_req != 0 && C_req != 2 && C_req != 4 && C_req != 8 &&
       C_req != 16) ||
      stair_req < -1 || stair_req > 1)
    return pl;
  const long long pairs = (long long)B * N;
#ifdef __CUDACC__
  static std::map<std::tuple<int, int, int, int, int, int>, PackedPlan> known;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return pl;
  const auto key = std::make_tuple(dev, N, B, num_alphas, C_req, stair_req);
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return pl;
  const void* cfn = (const void*)sqp_mega_packed_cluster_kernel;
  const long long cstat = static_smem(cfn);
  for (int C : {16, 8, 4, 2}) {
    if (C_req != 0 && C != C_req) continue;
    const size_t on =
        packed_smem_floats(N, B, num_alphas, 0, C, true) * sizeof(float);
    const size_t off =
        packed_smem_floats(N, B, num_alphas, 0, C, false) * sizeof(float);
    if (cstat < 0 || (long long)(stair_req == 0 ? off : on) + cstat > optin)
      continue;
    const long long need = (pairs + C - 1) / C;
    const long long want = need > B ? need : B;
    const int n_on = stair_req == 0 ? 0
        : pcgc::active_clusters(cfn, C, THREADS, on);
    const int n_off = stair_req == 1 ? 0
        : pcgc::active_clusters(cfn, C, THREADS, off);
    const long long g_on = n_on < B ? 0 : C * (n_on < want ? n_on : want);
    const long long g_off = n_off < B ? 0 : C * (n_off < want ? n_off : want);
    if (g_on == 0 && g_off == 0) continue;
    pl.C = C;
    pl.stair = stair_req >= 0 ? stair_req : g_on >= g_off;
    pl.grid = (int)(pl.stair ? g_on : g_off);
    break;
  }
  if (pl.C == 0 && C_req <= 0) {
    int coop = 0, sms = 0, per_sm = 0;
    const void* fn = (const void*)sqp_mega_packed_kernel;
    const long long stat = static_smem(fn);
    const size_t smem =
        packed_smem_floats(N, B, num_alphas, 1, 0, false) * sizeof(float);
    if (stat >= 0 && (long long)smem + stat <= optin &&
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) ==
            cudaSuccess && coop &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      smem) == cudaSuccess) {
      const long long resident = (long long)per_sm * sms;
      const long long grid = resident < pairs ? resident : pairs;
      if (grid >= B) pl.grid = (int)grid;
    }
    cudaGetLastError();  // a refused query leaves no error behind
  }
  known[key] = pl;
#else
  if (C_req > 0) {
    const long long need = (pairs + C_req - 1) / C_req;
    const long long want = need > B ? need : B;
    const int st = stair_req != 0;
    if (packed_smem_floats(N, B, num_alphas, 0, C_req, st) * sizeof(float)
        <= 232448) {
      pl.C = C_req;
      pl.stair = st;
      pl.grid = (int)(C_req * want);
    }
  } else if (packed_smem_floats(N, B, num_alphas, B, 0, false) * sizeof(float)
             <= 232448) {
    pl.grid = 1;  // one block owns every arm (module note)
  }
#endif
  return pl;
}

}  // namespace

// The plan of a launch of B arms of N knots (packed_plan: cluster 0 the
// plan's choice, 2-16 that cluster size, -1 the one-block form; stair 1 on
// chip, 0 in L2, -1 the plan's): writes the cluster size (0 the one-block
// form), the stair placement and the grid to out[0..2]; returns 0 where no
// such form fits, else 1.
extern "C" int mpc_mega_packed_plan(int N, int B, int num_alphas, int cluster,
                                    int stair, int* out) {
  const PackedPlan pl = packed_plan(N, B, num_alphas, cluster, stair);
  out[0] = pl.C;
  out[1] = pl.stair;
  out[2] = pl.grid;
  return pl.grid > 0;
}

// Largest horizon some form of K10 serves for B arms on this device (the
// plan's choice; the host build: the one-block form's); 0 if none.
extern "C" int mpc_mega_packed_max_knots(int B, int num_alphas) {
  // the fit is monotone in N: bisect for the last N with a plan
  int lo = 1, hi = 1 << 16;
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    (packed_plan(mid, B, num_alphas, 0, -1).grid > 0 ? lo : hi) = mid;
  }
  return lo < 2 ? 0 : lo;
}

// Floats of global scratch one solve takes.
extern "C" long long mpc_sqp_mega_packed_scratch_floats(int N, int B,
                                                        int num_alphas) {
  return (long long)packed_scratch_floats(N, B, num_alphas);
}

// One solve on `grid` blocks: cluster 0 the one-block form, 2-16 the
// cluster form at that size, with the stair bands as `stair` asks (as
// mpc_mega_packed_plan's).  A grid past the plan's, a form past its fit or
// a launch the runtime refuses is never made: its error is returned.
// tracking, hessian, integrator, wrap, q_cost: the knobs, one set for every
// arm (as mpc_kkt_schur's; goals nx wide under joint tracking).
extern "C" int mpc_sqp_mega_packed(
    const float* tab, int B, int N, const float* X0, const float* U0,
    const float* goals, int gstride, int garm, const float* xs,
    const float* lam0, const float* rho0, const float* drho0, int max_iter,
    float tol, int n_sqp, float dt, float qd_cost, float r_cost, float grav,
    float mu, int num_alphas, float rho_factor, float rho_min, float rho_max,
    float rho_reset, float* X, float* U, float* lam, float* rho, float* merit,
    int* ints, float* scratch, int grid, int cluster, int stair,
    int tracking, int hessian, int integrator, int wrap, float q_cost,
    void* stream) {
  ld::Knobs kn;
  if (num_alphas < 1 || num_alphas > MAX_ALPHAS || N < 2 || B < 1 ||
      grid < 1 ||
      !ld::make_knobs(tracking, hessian, integrator, wrap, q_cost, &kn))
    return 1;  // cudaErrorInvalidValue
  const PackedPlan pl =
      packed_plan(N, B, num_alphas, cluster > 0 ? cluster : -1, stair);
  if (pl.grid < 1) return 1;  // past the form's fit
  const int C = pl.C;
  PackedParams p;
  p.kn = kn;
  p.tab = tab; p.B = B; p.N = N; p.gstride = gstride; p.garm = garm;
  p.max_iter = max_iter; p.n_sqp = n_sqp; p.num_alphas = num_alphas;
#ifndef __CUDACC__
  if (C == 0) grid = 1;  // the host build: one block owns every arm
#endif
  if (grid > pl.grid || (C > 0 && (grid % C || grid < B * C)))
    return 720;  // cudaErrorCooperativeLaunchTooLarge
  p.arms_per_block = C > 0 ? 0 : (B + grid - 1) / grid;
  p.stair_on_chip = pl.stair;
  p.X0 = X0; p.U0 = U0; p.goals = goals; p.xs = xs; p.lam0 = lam0;
  p.rho0 = rho0; p.drho0 = drho0;
  p.tol = tol; p.dt = dt; p.qd_cost = qd_cost; p.r_cost = r_cost;
  p.grav = grav; p.mu = mu; p.rho_factor = rho_factor; p.rho_min = rho_min;
  p.rho_max = rho_max; p.rho_reset = rho_reset;
  p.X = X; p.U = U; p.lam = lam; p.rho = rho; p.merit = merit; p.ints = ints;
  p.words = reinterpret_cast<unsigned long long*>(scratch);
  float* f = scratch + 4 * B;
  const size_t nb = (size_t)B * N * SS, nv = (size_t)B * N * S,
               nu = (size_t)B * N * NU;
  float** bands[] = {&p.SL, &p.SD, &p.SU, &p.PL, &p.PD, &p.PU,
                     &p.Qinv, &p.A, &p.AQi, &p.T};
  for (float** b : bands) { *b = f; f += nb; }
  p.Bm = f; f += (size_t)B * N * S * NU;
  p.Rinv = f; f += (size_t)B * N * NU * NU;
  float** vecs[] = {&p.gamma, &p.q, &p.tvec, &p.Qiq, &p.fpred, &p.dX};
  for (float** v : vecs) { *v = f; f += nv; }
  p.r = f; f += nu;
  p.dU = f; f += nu;
  p.contrib = f; f += (size_t)B * N * num_alphas;
  p.eta = f;

  const size_t smem = packed_smem_floats(N, B, num_alphas, p.arms_per_block,
                                         C, pl.stair != 0) * sizeof(float);
#ifdef __CUDACC__
  cudaError_t err;
  if (C > 0) {
    err = cudaFuncSetAttribute(sqp_mega_packed_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
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
    err = cudaLaunchKernelEx(&cfg, sqp_mega_packed_cluster_kernel, p);
  } else {
    err = cudaFuncSetAttribute(sqp_mega_packed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel((void*)sqp_mega_packed_kernel,
                                      dim3(grid), dim3(THREADS), args, smem,
                                      (cudaStream_t)stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  if (C > 0)
    ld_emu_blocks(grid, C, smem / sizeof(float),
                  [&] { sqp_mega_packed_cluster_kernel(p); });
  else
    LD_LAUNCH(sqp_mega_packed_kernel, 1, THREADS, smem, stream, p);
  return 0;
#endif
}
