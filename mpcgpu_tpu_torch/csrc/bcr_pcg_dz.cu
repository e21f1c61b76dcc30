// K6: warm-started CG on S lam = gamma preconditioned by an exact block
// cyclic reduction (BCR) solve, then dz, across one thread-block cluster.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/bcr_kernel.py
// (bcr_pcg_dz_pallas_lanes / _bcr_pcg_dz_kernel -> _pcg_loop_bcrM,
// _bcr_lanes).  The loop is MPCGPU algorithm 2 (cluster_cg_solve) with
// z = BCR(r), no refinement, in place of the stair apply: exit when
// |eta| = |r' z| <= tol or at max_iter, hit = |eta| > tol at exit.  The dz
// is K4's epilogue's arithmetic.
//
// Design: the whole kernel is one cluster of C blocks on neighbouring SMs
// (C = 16 where the card schedules it, else 8; no cooperative launch).
// Block r owns the knots [r nk, r nk + own), nk = ceil(N / C), and keeps
// their S bands and CG vectors in its shared memory (pcg_common.cuh's
// cluster CG: the halo rows of a band row through DSMEM, the dots summed in
// rank order, two cluster barriers per CG step besides the apply's).  The
// cyclic reduction is factored once per solve over the cluster, one warp
// per knot or (kept, eliminated) pair at each level, by all C x 16 warps;
// the factors stay in global memory (L2, bcr_common.cuh's layout) and equal
// the one-block factor of K7 bit for bit (K7s and K9b run it too).  Each
// apply is one forward and one back pass with g and z in the owners'
// shared memory: 2 log2(N) + 1 cluster barriers.  The owner of each knot computes its dz.
// This one kernel serves every power-of-2 N whose S fits the cluster's
// shared memory (mpc_bcr_max_knots: 1024 on the H100 at C = 16); the TPU
// runs this solve as one kernel up to N = 256 (bcr_kernel.py:232-233).
//
// Bound on the H100: latency -- log2(N) levels of dependent 14x14
// inverses and products, then per CG step a chain of 2 log2(N) + 3 cluster
// barriers; the work is far from either roof (bound_ms in chip_smoke.py).
#include "bcr_common.cuh"

namespace {

using bcr::MAX_THREADS;
constexpr int S = ld::NX, SS = S * S;

#define BCR_PCG_DZ_PARAMS                                                   \
  int N, int levels, const float *SLg, const float *SDg, const float *SUg, \
      const float *gamma, const float *lam0, const float *A, const float *B, \
      const float *q, const float *r_in, const float *Qinv,                \
      const float *Rinv, int max_iter, float tol, float *fac,              \
      float *lam_out, float *dX, float *dU, int *ints, bool *hit_out

// ints: the CG iteration count, then the cluster size the kernel read.
LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS)
    bcr_pcg_dz_kernel(BCR_PCG_DZ_PARAMS) {
  LD_DYN_SMEM(smem);
  const pcgc::ClusterCg a = pcgc::cluster_area(smem, N, false);
  pcgc::cluster_load_bands(a, SLg, SDg, SUg, a.SL, a.SD, a.SU);
  const bcr::BcrFactor f(fac, N, levels);
  bcr::cluster_factor(f, a, a.extra);
  float eta;
  const int it = pcgc::cluster_cg_solve(a, gamma, lam0, bcr::ClusterBcr{f},
                                        max_iter, tol, &eta);
  if (a.rank == 0 && LD_TID == 0) {
    ints[0] = it;
    ints[1] = a.C;
    hit_out[0] = fabsf(eta) > tol;
  }
  pcgc::cluster_dz(a, A, B, q, r_in, Qinv, Rinv, lam_out, dX, dU);
}

}  // namespace

// The cluster size a launch over N knots (a power of 2) uses: `cluster`
// where it is 8 or 16 and fits; for cluster 0, 16 where the card can
// schedule a cluster of 16 blocks of K6 (a non-portable size), else 8; 0 if
// none fits (bcr::plan_cluster).  Asked once per device, N and request.
// The host build answers 1 where the card's arithmetic at 227 KB fits
// C = 16 (it runs the cluster as one block).
extern "C" int mpc_bcr_cluster(int N, int cluster) {
#ifdef __CUDACC__
  static int known[16][17][3];
  return bcr::plan_cluster((const void*)bcr_pcg_dz_kernel, N, cluster, known);
#else
  return cluster == 0 || cluster == 8 || cluster == 16 ? bcr::host_cluster(N)
                                                       : 0;
#endif
}

// Largest power-of-2 horizon the cluster kernel serves on this device (0
// if none).
extern "C" int mpc_bcr_max_knots(void) {
  int n = 0;
  for (int m = 1; mpc_bcr_cluster(m, 0) > 0; m *= 2) n = m;  // cached
  return n;
}

// Floats of global scratch the factors of an N-knot solve take.
extern "C" long long mpc_bcr_scratch_floats(int N) {
  return (long long)bcr::factor_floats(N);
}

// K6; scratch holds mpc_bcr_scratch_floats(N) floats, ints 2 (the CG
// iteration count, the cluster size the kernel read); cluster as
// mpc_bcr_cluster's.  A launch that the runtime refuses, or a horizon no
// such cluster can hold, returns its error.
extern "C" int mpc_bcr_pcg_dz(int N, const float* SL, const float* SD,
                              const float* SU, const float* gamma,
                              const float* lam0, const float* A,
                              const float* B, const float* q, const float* r,
                              const float* Qinv, const float* Rinv,
                              int max_iter, float tol, float* scratch,
                              float* lam_out, float* dX, float* dU, int* ints,
                              bool* hit, int cluster, void* stream) {
  if (N < 1 || (N & (N - 1))) return 1;  // cudaErrorInvalidValue
  const int C = mpc_bcr_cluster(N, cluster);
  if (C < 1) return 1;
  const int levels = bcr::levels_of(N);
#ifdef __CUDACC__
  return bcr::launch_cluster(bcr_pcg_dz_kernel, N, C, stream, N, levels, SL,
                             SD, SU, gamma, lam0, A, B, q, r, Qinv, Rinv,
                             max_iter, tol, scratch, lam_out, dX, dU, ints,
                             hit);
#else
  LD_LAUNCH(bcr_pcg_dz_kernel, 1, MAX_THREADS,
            bcr::cluster_floats(N, 1) * sizeof(float), stream, N, levels, SL,
            SD, SU, gamma, lam0, A, B, q, r, Qinv, Rinv, max_iter, tol,
            scratch, lam_out, dX, dU, ints, hit);
  return 0;
#endif
}

#ifndef __CUDACC__
// Host build only: the cluster factor's schedule over C blocks of one warp
// each, run rank after rank between the barriers (each phase reads only what
// the phases before it wrote), from S's bands into fac; a test holds it
// against bcr_factor's, bit for bit, at C > 1.
extern "C" int mpc_bcr_cluster_factor_host(int N, int C, const float* SL,
                                           const float* SD, const float* SU,
                                           float* fac) {
  if (N < 1 || (N & (N - 1)) || C < 1) return 1;
  const bcr::BcrFactor f(fac, N, bcr::levels_of(N));
  for (int e = 0; e < N * SS; ++e) {
    f.D[e] = SD[e];
    f.L[e] = SL[e];
    f.U[e] = SU[e];
  }
  float x[SS], y[SS];
  for (int l = 0; l < f.levels; ++l) {
    for (int gw = 0; gw < C; ++gw)
      bcr::spread_inverses(f, 1 << l, 2 << l, gw, C, x, y);
    for (int gw = 0; gw < C; ++gw) bcr::spread_level(f, l, gw, C, x, y);
  }
  for (int gw = 0; gw < C; ++gw) bcr::spread_inverses(f, 0, N, gw, C, x, y);
  return 0;
}

// Host build only: K6's preconditioner apply z = BCR(r) over C emulated
// blocks, each with its own shared memory, the phases between its cluster
// barriers run rank after rank, from the factors in fac; a test holds it
// against the one-block apply (BcrPre), bit for bit.
extern "C" int mpc_bcr_cluster_apply_host(int N, int C, const float* fac,
                                          const float* r, float* z) {
  if (N < 1 || (N & (N - 1)) || C < 1) return 1;
  std::vector<std::vector<float>> smem(
      C, std::vector<float>(pcgc::cluster_cg_floats(N, C, false, 0)));
  ld_emu_cbase.clear();
  for (auto& m : smem) ld_emu_cbase.push_back(m.data());
  auto area = [&](int q) {
    ld_emu_crank = q;
    return pcgc::cluster_area(smem[q].data(), N, false);
  };
  const bcr::ClusterBcr pre{
      bcr::BcrFactor(const_cast<float*>(fac), N, bcr::levels_of(N))};
  for (int q = 0; q < C; ++q) {
    const pcgc::ClusterCg a = area(q);
    for (int e = 0; e < S * a.own; ++e) a.g[S + e] = r[S * a.k0 + e];
  }
  for (int l = 0; l < pre.f.levels; ++l)
    for (int q = 0; q < C; ++q) pre.forward(area(q), l);
  for (int q = 0; q < C; ++q) pre.root(area(q), area(q).z);
  for (int l = pre.f.levels - 1; l >= 0; --l)
    for (int q = 0; q < C; ++q) pre.back(area(q), l, area(q).z);
  for (int q = 0; q < C; ++q) {
    const pcgc::ClusterCg a = area(q);
    for (int e = 0; e < S * a.own; ++e) z[S * a.k0 + e] = a.z[S + e];
  }
  ld_emu_cbase.clear();
  ld_emu_crank = 0;
  return 0;
}

// Host build only: the cluster CG's dot product over C emulated blocks,
// each holding values[S k0 .. S (k0 + own)) of an (N, 14) vector: every
// block's partial (block_partial), then every block's rank-ordered sum
// (cluster_sum) into sums[q]; a test holds them equal to one another and
// to the sum of the partials in rank order.
extern "C" int mpc_cluster_dot_host(int N, int C, const float* values,
                                    float* partials, float* sums) {
  if (N < 1 || C < 1) return 1;
  std::vector<std::vector<float>> smem(
      C, std::vector<float>(pcgc::cluster_cg_floats(N, C, false, 0)));
  ld_emu_cbase.clear();
  for (auto& m : smem) ld_emu_cbase.push_back(m.data());
  auto area = [&](int q) {
    ld_emu_crank = q;
    return pcgc::cluster_area(smem[q].data(), N, false);
  };
  for (int q = 0; q < C; ++q) {
    const pcgc::ClusterCg a = area(q);
    float part = 0.0f;
    for (int e = 0; e < S * a.own; ++e) part += values[S * a.k0 + e];
    pcgc::block_partial(part, a.red, a.slots);
    partials[q] = a.slots[0];
  }
  for (int q = 0; q < C; ++q) sums[q] = pcgc::cluster_sum(area(q), area(q).slots);
  ld_emu_cbase.clear();
  ld_emu_crank = 0;
  return 0;
}
#endif
