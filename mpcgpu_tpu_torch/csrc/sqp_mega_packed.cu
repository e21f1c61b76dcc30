// K10: the whole SQP solve of B independent arms in one cooperative launch.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/sqp_megakernel.py
// (sqp_solve_mega_pcg_packed / _solve_kernel_pcg_packed ->
// _iteration_pcg_packed, _pcg_loop_packed, _line_search_packed,
// _rho_schedule).  The TPU kernel packs the arms into the 128 lanes with
// segment masks; here the arm is a grid dimension, and the layout is
// knot-major with a leading arm axis: X (B, N, 14), U (B, N-1, 7), lam
// (B, N, 14), goals (B, N, gstride) (arm stride garm, 0 when the arms share
// them), xs (B, 14), rho and drho (B,).
//
// It is K5 (sqp_mega.cu) with every stage strided over (arm, knot) pairs
// across the whole grid, and per-arm decisions:
//   0. the incumbent merit of every arm, in-kernel (the TPU kernel's
//      1-candidate line search at dX = dU = 0); drho starts at drho0;
// then exactly n_sqp iterations, each:
//   1-3. per (arm, knot): the arm's previous step, K3's per-knot stage at
//      the arm's rho, the Schur bands, the stair bands;
//   4. the arms' CGs: block b runs the CG of arms b, b + grid, ... (one arm
//      per block on the card) with the arm's S in its shared memory, from
//      pcg_common.cuh's cg_init / cg_step.  The exit is SHARED: after each
//      step every block publishes its arms' eta and the grid meets at a
//      barrier; every block then reads all B etas in arm order and goes on
//      while some |eta| > tol (and none is NaN) and the count is under
//      max_iter.  A converged arm keeps stepping; cg_div's 0/0 -> 0
//      freezes one whose residual is exactly zero.  The count is one
//      number for all arms.  Then dz per arm;
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
// The eta exchange is double-buffered in global memory: a block writes
// iteration i+1's etas while a slower one may still read iteration i's,
// and no block passes the next barrier before every read is done.  Etas
// are read past L1 (ld.global.cg), since other SMs wrote them.
//
// Bound on the H100: latency -- a chain of dependent CG steps, as in K5,
// plus one grid barrier per CG step.  The design's answer is one CG block
// per arm, so the B arms' CGs run at once on B SMs instead of one after
// another; the per-knot stages and the merits spread over the grid
// (grid = min(B*N, co-resident blocks), at least B).  The host build
// launches one block that owns every arm's CG (shared memory for each) and
// walks every (arm, knot) pair; its grid barrier is a no-op.
#include "kkt_schur.cuh"
#include "merit.cuh"
#include "pcg_common.cuh"

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
  // outputs
  float *X, *U, *lam, *rho, *merit;
  int* ints;  // sqp_iters (B), bailed (B), pcg_total
  // scratch, arm-major
  float *SL, *SD, *SU, *PL, *PD, *PU, *Qinv, *A, *AQi, *T, *Bm, *Rinv;
  float *gamma, *q, *tvec, *Qiq, *fpred, *dX, *r, *dU, *contrib, *eta;
};

// Per-arm scalars and the CG areas in dynamic shared memory: rho, drho,
// merit, step (floats), done, itc (ints), the B x num_alphas merits, each
// owned arm's eta, then one CG area per owned arm -- or, in the merit
// stages, the groups' areas (merit.cuh), at least as many floats as
// groups of 8 lanes take.
size_t packed_smem_floats(int N, int B, int num_alphas, int arms_per_block) {
  const size_t cg = (size_t)arms_per_block * pcgc::cg_smem_floats(N, 4);
  const size_t merit = k2::areas_floats(THREADS, 8);
  return (size_t)6 * B + (size_t)B * num_alphas + arms_per_block
         + (cg > merit ? cg : merit);
}

size_t packed_scratch_floats(int N, int B, int num_alphas) {
  return (size_t)B * N * (10 * SS + S * NU + NU * NU + 6 * S + 2 * NU
                          + num_alphas) + 2 * B;
}

// The shared CG exit test over the B published etas, read in arm order:
// go on while some |eta| > tol and none is NaN (jnp.max(|eta|) > tol).
LD_DEV bool cg_goes_on(const float* eta, int B, float tol) {
  bool go = false;
  for (int a = 0; a < B; ++a) {
    const float v = fabsf(pcgc::load_cg(eta + a));
    if (v != v) return false;
    go = go || v > tol;
  }
  return go;
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

LD_GLOBAL void sqp_mega_packed_kernel(PackedParams p) {
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_SHARED int pcg_total;
  LD_DYN_SMEM(smem);
  const int B = p.B, N = p.N, NA = p.num_alphas;
  const int t = LD_TID, nt = LD_NTID, bid = LD_BID, nb = LD_NBID;
  float* rho = smem;
  float* drho = rho + B;
  float* merit = drho + B;
  float* step = merit + B;
  int* done = reinterpret_cast<int*>(step + B);
  int* itc = done + B;
  float* merits = reinterpret_cast<float*>(itc + B);
  float* eta_own = merits + B * NA;
  float* cg_mem = eta_own + p.arms_per_block;
  const size_t cg_floats = pcgc::cg_smem_floats(N, 4);
  const size_t nbnd = (size_t)N * SS, nvec = (size_t)N * S, nctl = (size_t)N * NU;

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
  if (t == 0) pcg_total = 0;
  ld::load_tables(tab, p.tab);  // ends in a barrier
  LD_GRID_SYNC();

  // 0. the incumbent merit of every arm: one unstepped candidate, on
  // groups of lanes spread over the blocks (merit.cuh), in the CG areas
  k2::contribs_at(k2::group_for(B * N, nb, nt), tab, cg_mem,
                  k2::Job{p.X, nullptr, p.U, nullptr, p.goals, p.xs,
                          p.contrib, N, B, 1, 0, p.gstride, p.garm, NA * N,
                          p.dt, p.mu, p.qd_cost, p.r_cost, p.grav});
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
                  p.qd_cost, p.r_cost, p.grav, p.A + nbnd * a,
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

    // 4. the CGs of this block's arms, with the shared exit
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
    int cg_it = 0, buf = 0;
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
    // dz; a frozen arm keeps its lam
    for (int a = bid, j = 0; a < B; a += nb, ++j) {
      const pcgc::CgArea c = pcgc::cg_area(cg_mem + cg_floats * j, N);
      pcgc::dz_epilogue(N, c.lam, p.A + nbnd * a, p.Bm + (size_t)N * S * NU * a,
                        p.q + nvec * a, p.r + nctl * a, p.Qinv + nbnd * a,
                        p.Rinv + (size_t)N * NU * NU * a, c.r, c.p,
                        done[a] ? nullptr : p.lam + nvec * a, p.dX + nvec * a,
                        p.dU + nctl * a);
      LD_SYNC();
    }
    if (t == 0) {
      bool any_live = false;
      for (int a = 0; a < B; ++a) any_live = any_live || !done[a];
      if (any_live) pcg_total += cg_it;
    }
    LD_GRID_SYNC();

    // 5. merit contributions of every (arm, candidate, knot) triple, as in
    // stage 0 (the CG areas are free again)
    k2::contribs_at(k2::group_for(B * NA * N, nb, nt), tab, cg_mem,
                    k2::Job{p.X, p.dX, p.U, p.dU, p.goals, p.xs, p.contrib,
                            N, B, NA, NA, p.gstride, p.garm, NA * N, p.dt,
                            p.mu, p.qd_cost, p.r_cost, p.grav});
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
    if (t == 0) p.ints[2 * B] = pcg_total;
  }
}

#ifdef __CUDACC__
// Static shared bytes of the kernel, or -1.
long long packed_static_smem() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, sqp_mega_packed_kernel) != cudaSuccess) return -1;
  return (long long)attr.sharedSizeBytes;
}
#endif

}  // namespace

// Largest horizon for which a block's shared memory (one arm's CG system,
// the per-arm scalars and the stages' static arrays) fits on this device
// for B arms; 0 if the attributes cannot be read.
extern "C" int mpc_mega_packed_max_knots(int B, int num_alphas) {
  auto floats_of = [B, num_alphas](int n) {
    return packed_smem_floats(n, B, num_alphas, 1);
  };
#ifdef __CUDACC__
  const long long stat = packed_static_smem();
  if (stat < 0) return 0;
  return pcgc::max_knots_for(floats_of, (size_t)stat);
#else
  return pcgc::max_knots_for(floats_of, 0);
#endif
}

// The grid a solve of B arms of N knots launches: min(B * N, blocks that
// can be resident at once), from the occupancy API; 0 if that is fewer
// than B (every arm needs a CG block of its own) or the device has no
// cooperative launch.  Also sets the kernel's dynamic shared memory limit.
extern "C" int mpc_mega_packed_grid(int N, int B, int num_alphas) {
#ifdef __CUDACC__
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const size_t smem = packed_smem_floats(N, B, num_alphas, 1) * sizeof(float);
  if (cudaFuncSetAttribute(sqp_mega_packed_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sqp_mega_packed_kernel,
                                                    THREADS, smem) != cudaSuccess)
    return 0;
  const long long resident = (long long)per_sm * sms;
  const long long pairs = (long long)B * N;
  const long long grid = resident < pairs ? resident : pairs;
  return grid < B ? 0 : (int)grid;
#else
  (void)N; (void)B; (void)num_alphas;
  return 1;  // the host build: one block owns every arm
#endif
}

// Floats of global scratch one solve takes.
extern "C" long long mpc_sqp_mega_packed_scratch_floats(int N, int B,
                                                        int num_alphas) {
  return (long long)packed_scratch_floats(N, B, num_alphas);
}

extern "C" int mpc_sqp_mega_packed(
    const float* tab, int B, int N, const float* X0, const float* U0,
    const float* goals, int gstride, int garm, const float* xs,
    const float* lam0, const float* rho0, const float* drho0, int max_iter,
    float tol, int n_sqp, float dt, float qd_cost, float r_cost, float grav,
    float mu, int num_alphas, float rho_factor, float rho_min, float rho_max,
    float rho_reset, float* X, float* U, float* lam, float* rho, float* merit,
    int* ints, float* scratch, int grid, void* stream) {
  if (num_alphas < 1 || num_alphas > MAX_ALPHAS || N < 2 || B < 1 || grid < 1)
    return 1;  // cudaErrorInvalidValue
#ifndef __CUDACC__
  grid = 1;  // the host build: one block owns every arm (module note)
#endif
  PackedParams p;
  p.tab = tab; p.B = B; p.N = N; p.gstride = gstride; p.garm = garm;
  p.max_iter = max_iter; p.n_sqp = n_sqp; p.num_alphas = num_alphas;
  p.arms_per_block = (B + grid - 1) / grid;
  p.X0 = X0; p.U0 = U0; p.goals = goals; p.xs = xs; p.lam0 = lam0;
  p.rho0 = rho0; p.drho0 = drho0;
  p.tol = tol; p.dt = dt; p.qd_cost = qd_cost; p.r_cost = r_cost;
  p.grav = grav; p.mu = mu; p.rho_factor = rho_factor; p.rho_min = rho_min;
  p.rho_max = rho_max; p.rho_reset = rho_reset;
  p.X = X; p.U = U; p.lam = lam; p.rho = rho; p.merit = merit; p.ints = ints;
  float* f = scratch;
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

  const size_t smem =
      packed_smem_floats(N, B, num_alphas, p.arms_per_block) * sizeof(float);
#ifdef __CUDACC__
  // never launch past co-residency (mpc_mega_packed_grid also sets the
  // dynamic shared memory limit)
  if (grid > mpc_mega_packed_grid(N, B, num_alphas))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)sqp_mega_packed_kernel, dim3(grid), dim3(THREADS), args, smem,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  LD_LAUNCH(sqp_mega_packed_kernel, 1, THREADS, smem, stream, p);
  return 0;
#endif
}
