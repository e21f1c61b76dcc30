// K7: the exact block cyclic reduction (BCR) solve of S lam = gamma with
// one refinement pass, then dz; and K7s: one unrefined BCR solve.
//
// Replaces the TPU kernels mpcgpu_tpu/ops/pallas/bcr_kernel.py
// bcr_dz_pallas_lanes (_bcr_dz_kernel -> _bcr_refined, _bcr_lanes) and
// bcr_solve_pallas_lanes (_bcr_solve_kernel).  K7 is lam = BCR(gamma),
// r = gamma - S lam, lam += BCR(r), then K4's dz epilogue; it reports no
// CG iterations (the "bcr" backend's iters 0, hit False).  K7s is
// lam = BCR(gamma) alone, what the split paths of ops/cuda/bcr_kernel.py
// call past K6's fit (and K7's, or when split=True forces them).
//
// Design: both run bcr_common.cuh's factor-once, apply-many code (shared
// with K6 and K9b): the elimination is factored once per launch into
// global scratch (L2-resident), and each solve is one forward and one back
// pass over it, so K7's refinement costs one more apply, not a second
// elimination as on the TPU.  Both are one thread-block cluster, as K6 is:
// C = 16 blocks of 512 threads where the card schedules them, else 8
// (bcr::plan_cluster); block r owns the knots [r nk, r nk + own) with their
// S bands, the factor's levels are spread one warp a knot or (kept,
// eliminated) pair over all C x 16 warps (bcr::cluster_factor), and the
// apply keeps g and z in the owners' shared memory, the rows at i +- h read
// through DSMEM (bcr::ClusterBcr).  K7's body is K9b's stage 4
// (bcr::cluster_bcr_dz): the factor, an apply, the residual over the own
// knots (the halo rows of lam through DSMEM), the second apply on the same
// factor, and the owners' dz (pcgc::cluster_dz).  Each sum keeps the
// one-block forms' terms and multiply-add pairing, so K7 equals the
// one-block refined solve (bcr_dz_body) and K7s the one-block factor and
// apply (bcr_factor, BcrPre) bit for bit.  S's bands bound N
// (mpc_bcr_dz_max_knots, mpc_bcr_solve_max_knots: 1024 on the H100 at
// C = 16).
//
// Bound on the H100: latency.  log2(N) levels of dependent 14x14 products
// and Gauss-Jordan inverses, 2 log2(N) + 2 cluster barriers per apply; at
// N = 64 the work is ~5 MFLOP over ~1 MB, far from either roof.
#include "bcr_common.cuh"

namespace {

using bcr::MAX_THREADS;
constexpr int S = ld::NX;

// K7: the refined solve and dz over the cluster (cluster_bcr_dz); ints: the
// cluster size read.
LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS) bcr_dz_kernel(
    int N, int levels, const float* SL, const float* SD, const float* SU,
    const float* gamma, const float* A, const float* B, const float* q,
    const float* r_in, const float* Qinv, const float* Rinv, float* fac,
    float* lam_out, float* dX, float* dU, int* ints) {
  LD_DYN_SMEM(smem);
  const pcgc::ClusterCg a = pcgc::cluster_area(smem, N, false);
  pcgc::cluster_load_bands(a, SL, SD, SU, a.SL, a.SD, a.SU);
  bcr::cluster_bcr_dz(a, bcr::BcrFactor(fac, N, levels), gamma, A, B, q,
                      r_in, Qinv, Rinv, lam_out, dX, dU);
  if (a.rank == 0 && LD_TID == 0) ints[0] = a.C;
}

// K7s: lam = BCR(gamma) over the cluster; ints: the cluster size read.
LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS) bcr_solve_kernel(
    int N, int levels, const float* SL, const float* SD, const float* SU,
    const float* gamma, float* fac, float* lam_out, int* ints) {
  LD_DYN_SMEM(smem);
  const pcgc::ClusterCg a = pcgc::cluster_area(smem, N, false);
  pcgc::cluster_load_bands(a, SL, SD, SU, a.SL, a.SD, a.SU);
  const bcr::BcrFactor f(fac, N, levels);
  bcr::cluster_factor(f, a, a.extra);
  for (int e = LD_TID; e < S * a.own; e += LD_NTID)
    a.r[0][S + e] = gamma[S * a.k0 + e];
  LD_SYNC();
  bcr::ClusterBcr{f}.apply(a, a.r[0], a.z);
  // the last back level read other blocks' z: no block leaves before all
  // have passed it
  LD_CLUSTER_ARRIVE();
  for (int e = LD_TID; e < S * a.own; e += LD_NTID)
    lam_out[S * a.k0 + e] = a.z[S + e];
  if (a.rank == 0 && LD_TID == 0) ints[0] = a.C;
  LD_CLUSTER_WAIT();
}

}  // namespace

// The cluster size of a K7 launch over N knots: as mpc_bcr_cluster's for
// K6 (bcr::plan_cluster).  The host build answers `cluster` where it is
// not 0 (a test's block emulation runs that many blocks), else 1, where
// the card's arithmetic at 227 KB fits C = 16.
extern "C" int mpc_bcr_dz_cluster(int N, int cluster) {
#ifdef __CUDACC__
  static int known[16][17][3];
  return bcr::plan_cluster((const void*)bcr_dz_kernel, N, cluster, known);
#else
  return bcr::host_cluster(N) && cluster >= 0 ? (cluster > 0 ? cluster : 1)
                                              : 0;
#endif
}

// Largest power-of-2 horizon K7 serves on this device (0 if none).
extern "C" int mpc_bcr_dz_max_knots(void) {
  int n = 0;
  for (int m = 1; mpc_bcr_dz_cluster(m, 0) > 0; m *= 2) n = m;  // cached
  return n;
}

// The cluster size of a K7s launch over N knots: as mpc_bcr_cluster's for
// K6 (bcr::plan_cluster).  The host build answers `cluster` where it is
// not 0 (a test's block emulation runs that many blocks), else 1, where
// the card's arithmetic at 227 KB fits C = 16.
extern "C" int mpc_bcr_solve_cluster(int N, int cluster) {
#ifdef __CUDACC__
  static int known[16][17][3];
  return bcr::plan_cluster((const void*)bcr_solve_kernel, N, cluster, known);
#else
  return bcr::host_cluster(N) && cluster >= 0 ? (cluster > 0 ? cluster : 1)
                                              : 0;
#endif
}

// Largest power-of-2 horizon K7s serves on this device (0 if none).
extern "C" int mpc_bcr_solve_max_knots(void) {
  int n = 0;
  for (int m = 1; mpc_bcr_solve_cluster(m, 0) > 0; m *= 2) n = m;  // cached
  return n;
}

// K7: lam, dX, dU from S, gamma and the dz blocks; scratch holds
// mpc_bcr_scratch_floats(N) floats, ints 1 (the cluster size the kernel
// read); cluster as mpc_bcr_dz_cluster's.  A launch that the runtime
// refuses, or a horizon no such cluster can hold, returns its error.
extern "C" int mpc_bcr_dz(int N, const float* SL, const float* SD,
                          const float* SU, const float* gamma, const float* A,
                          const float* B, const float* q, const float* r,
                          const float* Qinv, const float* Rinv,
                          float* scratch, float* lam_out, float* dX,
                          float* dU, int* ints, int cluster, void* stream) {
  const int C = mpc_bcr_dz_cluster(N, cluster);
  if (C < 1) return 1;  // cudaErrorInvalidValue
  const int levels = bcr::levels_of(N);
#ifdef __CUDACC__
  return bcr::launch_cluster(bcr_dz_kernel, N, C, stream, N, levels, SL, SD,
                             SU, gamma, A, B, q, r, Qinv, Rinv, scratch,
                             lam_out, dX, dU, ints);
#else
  const size_t smem = bcr::cluster_floats(N, C);
  auto run = [&] {
    bcr_dz_kernel(N, levels, SL, SD, SU, gamma, A, B, q, r, Qinv, Rinv,
                  scratch, lam_out, dX, dU, ints);
  };
  if (C > 1)  // the block emulation (lanedyn.cuh ld_emu_blocks)
    ld_emu_blocks(C, C, smem, run);
  else
    LD_LAUNCH(bcr_dz_kernel, 1, MAX_THREADS, smem * sizeof(float), stream,
              N, levels, SL, SD, SU, gamma, A, B, q, r, Qinv, Rinv, scratch,
              lam_out, dX, dU, ints);
  return 0;
#endif
}

// K7s: lam = BCR(gamma), unrefined; scratch as K7's, ints 1 (the cluster
// size the kernel read); cluster as mpc_bcr_solve_cluster's.  A launch that
// the runtime refuses, or a horizon no such cluster can hold, returns its
// error.
extern "C" int mpc_bcr_solve(int N, const float* SL, const float* SD,
                             const float* SU, const float* gamma,
                             float* scratch, float* lam_out, int* ints,
                             int cluster, void* stream) {
  const int C = mpc_bcr_solve_cluster(N, cluster);
  if (C < 1) return 1;  // cudaErrorInvalidValue
  const int levels = bcr::levels_of(N);
#ifdef __CUDACC__
  return bcr::launch_cluster(bcr_solve_kernel, N, C, stream, N, levels, SL,
                             SD, SU, gamma, scratch, lam_out, ints);
#else
  const size_t smem = bcr::cluster_floats(N, C);
  if (C > 1)  // the block emulation (lanedyn.cuh ld_emu_blocks)
    ld_emu_blocks(C, C, smem, [&] {
      bcr_solve_kernel(N, levels, SL, SD, SU, gamma, scratch, lam_out, ints);
    });
  else
    LD_LAUNCH(bcr_solve_kernel, 1, MAX_THREADS, smem * sizeof(float), stream,
              N, levels, SL, SD, SU, gamma, scratch, lam_out, ints);
  return 0;
#endif
}

#ifndef __CUDACC__
// Host build only: K7s's solve as one block ran it before the cluster form
// -- bcr_factor, then one BcrPre apply -- from S's bands into fac and lam;
// the tests' reference for the cluster factor and apply, bit for bit.
extern "C" int mpc_bcr_one_block_solve_host(int N, const float* SL,
                                            const float* SD, const float* SU,
                                            const float* gamma, float* fac,
                                            float* lam) {
  if (N < 1 || (N & (N - 1))) return 1;
  std::vector<float> g((size_t)S * N), inv(bcr::MAX_WARPS * bcr::INV_FLOATS);
  const bcr::BcrFactor f(fac, N, bcr::levels_of(N));
  bcr::bcr_factor(f, SL, SD, SU, inv.data());
  bcr::BcrPre{f, g.data()}.apply(gamma, lam);
  return 0;
}

// Host build only: the refined solve and dz in one block (bcr_dz_body:
// bcr_factor, a BcrPre apply, the residual, a second apply, dz_epilogue)
// from S's bands into fac, lam, dX and dU; the tests' reference for K7 and
// K9b's stage 4, bit for bit.
extern "C" int mpc_bcr_dz_one_block_host(int N, const float* SL,
                                         const float* SD, const float* SU,
                                         const float* gamma, const float* A,
                                         const float* B, const float* q,
                                         const float* r, const float* Qinv,
                                         const float* Rinv, float* fac,
                                         float* lam, float* dX, float* dU) {
  if (N < 1 || (N & (N - 1))) return 1;
  std::vector<float> vecs(bcr::dz_vec_floats(N));
  bcr::bcr_dz_body(N, SL, SD, SU, gamma, A, B, q, r, Qinv, Rinv, fac,
                   vecs.data(), lam, dX, dU);
  return 0;
}

// Host build only: K9b's stage 4 (bcr::cluster_bcr_dz) on one cluster of C
// emulated blocks of one thread (lanedyn.cuh ld_emu_blocks), S's bands
// loaded from global memory as K9b loads them; fac holds
// mpc_bcr_scratch_floats(N) floats.  Returns 1 where the emulation found a
// wait no block could end (the card would hang), 2 for arguments no launch
// takes, else 0.
extern "C" int mpc_bcr_cluster_dz_host(int N, int C, const float* SL,
                                       const float* SD, const float* SU,
                                       const float* gamma, const float* A,
                                       const float* B, const float* q,
                                       const float* r, const float* Qinv,
                                       const float* Rinv, float* fac,
                                       float* lam, float* dX, float* dU) {
  if (N < 1 || (N & (N - 1)) || C < 1) return 2;
  ld_emu_failed = false;
  ld_emu_blocks(C, C,
                pcgc::cluster_cg_floats(N, C, false, bcr::scratch_floats(1)),
                [&] {
                  const pcgc::ClusterCg a = pcgc::cluster_area(ld_emu_dyn, N,
                                                               false);
                  pcgc::cluster_load_bands(a, SL, SD, SU, a.SL, a.SD, a.SU);
                  bcr::cluster_bcr_dz(a, bcr::BcrFactor(fac, N,
                                                        bcr::levels_of(N)),
                                      gamma, A, B, q, r, Qinv, Rinv, lam, dX,
                                      dU);
                });
  const bool failed = ld_emu_failed;
  ld_emu_failed = false;
  return failed ? 1 : 0;
}
#endif
