// K7: the exact block cyclic reduction (BCR) solve of S lam = gamma with
// one refinement pass, then dz; and K7s: one unrefined BCR solve.
//
// Replaces the TPU kernels mpcgpu_tpu/ops/pallas/bcr_kernel.py
// bcr_dz_pallas_lanes (_bcr_dz_kernel -> _bcr_refined, _bcr_lanes) and
// bcr_solve_pallas_lanes (_bcr_solve_kernel).  K7 is lam = BCR(gamma),
// r = gamma - S lam, lam += BCR(r), then K4's dz epilogue; it reports no
// CG iterations (the "bcr" backend's iters 0, hit False).  K7s is
// lam = BCR(gamma) alone, what the split paths of ops/cuda/bcr_kernel.py
// call above K7's and K6's shared-memory fit.
//
// Design: both are one thread block over bcr_common.cuh's factor-once,
// apply-many code (shared with K6 and K9b): the elimination is factored
// once per launch into global scratch (L2-resident), and each solve is one
// forward and one back pass over it, so K7's refinement costs one more
// apply, not a second elimination as on the TPU.  K7 holds S's bands in
// shared memory, as K6 does, for the factor's copy and the residual; that
// bounds N (mpc_bcr_dz_max_knots: power-of-2 N).  K7s reads S from global
// memory (L2) and keeps only the apply's two vectors and the per-warp
// inverse scratch in shared memory, so its N is bounded by those
// (mpc_bcr_solve_max_knots).  On an NVIDIA H100 80GB HBM3 (700 W, 227 KB
// of shared memory a block) the two fits are 64 and 1024.
//
// Bound on the H100: latency.  log2(N) levels of dependent 14x14 products
// and warp Gauss-Jordan inverses in one block, 2 log2(N) + 2 barriers per
// apply; at N = 64 the work is ~5 MFLOP over ~1 MB, far from either roof.
#include "bcr_common.cuh"

namespace {

using bcr::MAX_THREADS;
constexpr int S = ld::NX, SS = S * S;

// K7's shared floats: S's three bands and bcr_dz_body's vectors
size_t dz_smem_floats(int N) {
  return (size_t)3 * N * SS + bcr::dz_vec_floats(N);
}

// K7s's shared floats: the apply's g and z and the per-warp inverse scratch
size_t solve_smem_floats(int N) {
  return (size_t)2 * N * S + (size_t)bcr::MAX_WARPS * SS;
}

LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS) bcr_dz_kernel(
    int N, const float* SLg, const float* SDg, const float* SUg,
    const float* gamma, const float* A, const float* B, const float* q,
    const float* r_in, const float* Qinv, const float* Rinv, float* fac,
    float* lam_out, float* dX, float* dU) {
  LD_DYN_SMEM(smem);
  const int nb = SS * N;
  float* SL = smem;
  float* SD = SL + nb;
  float* SU = SD + nb;
  for (int e = LD_TID; e < nb; e += LD_NTID) {
    SL[e] = SLg[e];
    SD[e] = SDg[e];
    SU[e] = SUg[e];
  }
  LD_SYNC();
  bcr::bcr_dz_body(N, SL, SD, SU, gamma, A, B, q, r_in, Qinv, Rinv, fac,
                   SU + nb, lam_out, dX, dU);
}

LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS) bcr_solve_kernel(
    int N, const float* SL, const float* SD, const float* SU,
    const float* gamma, float* fac, float* lam_out) {
  LD_DYN_SMEM(smem);
  float* g = smem;
  float* z = g + S * N;
  float* inv = z + S * N;
  const bcr::BcrFactor f(fac, N, bcr::levels_of(N));
  bcr::bcr_factor(f, SL, SD, SU, inv);
  bcr::BcrPre{f, g}.apply(gamma, z);
  for (int e = LD_TID; e < S * N; e += LD_NTID) lam_out[e] = z[e];
}

}  // namespace

// Largest power-of-2 horizon K7 (S in shared memory) serves on this
// device; 0 if the attribute cannot be read.
extern "C" int mpc_bcr_dz_max_knots(void) {
  return bcr::pow2_max_knots(dz_smem_floats);
}

// Largest power-of-2 horizon K7s (S read from global memory) serves.
extern "C" int mpc_bcr_solve_max_knots(void) {
  return bcr::pow2_max_knots(solve_smem_floats);
}

// K7: lam, dX, dU from S, gamma and the dz blocks; scratch holds
// mpc_bcr_scratch_floats(N) floats.
extern "C" int mpc_bcr_dz(int N, const float* SL, const float* SD,
                          const float* SU, const float* gamma, const float* A,
                          const float* B, const float* q, const float* r,
                          const float* Qinv, const float* Rinv,
                          float* scratch, float* lam_out, float* dX,
                          float* dU, void* stream) {
  if (N < 1 || (N & (N - 1))) return 1;  // cudaErrorInvalidValue
  const size_t smem = dz_smem_floats(N) * sizeof(float);
#ifdef __CUDACC__
  cudaError_t err = cudaFuncSetAttribute(
      bcr_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  LD_LAUNCH(bcr_dz_kernel, 1, bcr::threads_for(N), smem, stream, N, SL, SD,
            SU, gamma, A, B, q, r, Qinv, Rinv, scratch, lam_out, dX, dU);
  return LD_LAST_ERROR();
}

// K7s: lam = BCR(gamma), unrefined; scratch as K7's.
extern "C" int mpc_bcr_solve(int N, const float* SL, const float* SD,
                             const float* SU, const float* gamma,
                             float* scratch, float* lam_out, void* stream) {
  if (N < 1 || (N & (N - 1))) return 1;  // cudaErrorInvalidValue
  const size_t smem = solve_smem_floats(N) * sizeof(float);
#ifdef __CUDACC__
  cudaError_t err = cudaFuncSetAttribute(
      bcr_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  LD_LAUNCH(bcr_solve_kernel, 1, bcr::threads_for(N), smem, stream, N, SL,
            SD, SU, gamma, scratch, lam_out);
  return LD_LAST_ERROR();
}
