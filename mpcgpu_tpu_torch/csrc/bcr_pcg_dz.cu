// K6: warm-started CG on S lam = gamma preconditioned by an exact block
// cyclic reduction (BCR) solve, then dz.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/bcr_kernel.py
// (bcr_pcg_dz_pallas_lanes / _bcr_pcg_dz_kernel -> _pcg_loop_bcrM,
// _bcr_lanes).  The loop is K4's (pcg_common.cuh) with z = BCR(r), no
// refinement, in place of the stair apply: exit when |eta| = |r' z| <= tol
// or at max_iter, hit = |eta| > tol at exit.  The dz epilogue is K4's.
//
// Design: the cyclic reduction is factored once per solve and each
// preconditioner apply is one forward and one back pass over the stored
// factors (bcr_common.cuh, shared with K7, K7s and K9b).
//
// Bound on the H100: latency, as K4 -- one block, S's bands and the CG
// vectors in shared memory, which bounds N (mpc_bcr_max_knots; power-of-2
// N only, the wrapper raises otherwise).
#include "bcr_common.cuh"

namespace {

using bcr::MAX_THREADS;
using bcr::MAX_WARPS;
constexpr int S = ld::NX, SS = S * S;

// shared floats: S's bands, 5 CG vectors, the reduction slots and one
// 14x14 inverse scratch per warp
size_t bcr_smem_floats(int N) {
  return pcgc::cg_smem_floats(N, 5) + (size_t)MAX_WARPS * SS;
}

LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS) bcr_pcg_dz_kernel(
    int N, int levels, const float* SLg, const float* SDg, const float* SUg,
    const float* gamma, const float* lam0, const float* A, const float* B,
    const float* q, const float* r_in, const float* Qinv, const float* Rinv,
    int max_iter, float tol, float* fac, float* lam_out, float* dX,
    float* dU, int* iters_out, bool* hit_out) {
  LD_DYN_SMEM(smem);
  const int nb = SS * N, n = S * N;
  float* SL = smem;
  float* SD = SL + nb;
  float* SU = SD + nb;
  float* lam = SU + nb;
  float* r = lam + n;
  float* p = r + n;
  float* w = p + n;
  float* g = w + n;
  float* red = g + n;
  float* inv = red + 33;
  pcgc::load_system(N, SLg, SDg, SUg, lam0, SL, SD, SU, lam);
  const bcr::BcrFactor f(fac, N, levels);
  bcr::bcr_factor(f, SL, SD, SU, inv);
  float eta;
  const int it = pcgc::cg_solve(N, SL, SD, SU, gamma, lam, r, p, w, red,
                                bcr::BcrPre{f, g}, max_iter, tol, &eta);
  if (LD_TID == 0) {
    iters_out[0] = it;
    hit_out[0] = fabsf(eta) > tol;
  }
  pcgc::dz_epilogue(N, lam, A, B, q, r_in, Qinv, Rinv, r, p, lam_out, dX,
                    dU);
}

}  // namespace

// Largest power-of-2 horizon whose S bands, CG vectors and inverse scratch
// fit one block's shared memory on this device; 0 if it cannot be read.
extern "C" int mpc_bcr_max_knots(void) {
  return bcr::pow2_max_knots(bcr_smem_floats);
}

// Floats of global scratch the factors of an N-knot solve take.
extern "C" long long mpc_bcr_scratch_floats(int N) {
  return (long long)bcr::factor_floats(N);
}

extern "C" int mpc_bcr_pcg_dz(int N, const float* SL, const float* SD,
                              const float* SU, const float* gamma,
                              const float* lam0, const float* A,
                              const float* B, const float* q, const float* r,
                              const float* Qinv, const float* Rinv,
                              int max_iter, float tol, float* scratch,
                              float* lam_out, float* dX, float* dU,
                              int* iters, bool* hit, void* stream) {
  if (N < 1 || (N & (N - 1))) return 1;  // cudaErrorInvalidValue
  const size_t smem = bcr_smem_floats(N) * sizeof(float);
#ifdef __CUDACC__
  cudaError_t err = cudaFuncSetAttribute(
      bcr_pcg_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  LD_LAUNCH(bcr_pcg_dz_kernel, 1, bcr::threads_for(N), smem, stream, N,
            bcr::levels_of(N), SL, SD, SU, gamma, lam0, A, B, q, r, Qinv,
            Rinv, max_iter, tol, scratch, lam_out, dX, dU, iters, hit);
  return LD_LAST_ERROR();
}
