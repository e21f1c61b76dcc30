// K6: warm-started CG on S lam = gamma preconditioned by an exact block
// cyclic reduction (BCR) solve, then dz; and K6l: the same kernel with S
// read from global memory, for horizons whose S does not fit shared memory.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/bcr_kernel.py
// (bcr_pcg_dz_pallas_lanes / _bcr_pcg_dz_kernel -> _pcg_loop_bcrM,
// _bcr_lanes).  The loop is K4's (pcg_common.cuh) with z = BCR(r), no
// refinement, in place of the stair apply: exit when |eta| = |r' z| <= tol
// or at max_iter, hit = |eta| > tol at exit.  The dz epilogue is K4's.
//
// Design: the cyclic reduction is factored once per solve and each
// preconditioner apply is one forward and one back pass over the stored
// factors (bcr_common.cuh, shared with K7, K7s and K9b).  One body serves
// both kernels: K6 copies S's bands into shared memory first, K6l reads
// them where they lie (L2-resident: 2.4 MB at N = 512) and keeps only the
// five CG vectors and the inverse scratch in shared memory.  The TPU runs
// this solve as one kernel up to N = 256 (bcr_kernel.py:232-233); K6l is
// what serves that horizon here.
//
// Bound on the H100: latency, as K4 -- one block; shared memory bounds N
// (mpc_bcr_max_knots, mpc_bcr_l2_max_knots; power-of-2 N only, the
// wrapper raises otherwise).
#include "bcr_common.cuh"

namespace {

using bcr::MAX_THREADS;
using bcr::MAX_WARPS;
constexpr int S = ld::NX, SS = S * S;

// K6's shared floats: S's bands, 5 CG vectors, the reduction slots and one
// 14x14 inverse scratch per warp
size_t bcr_smem_floats(int N) {
  return pcgc::cg_smem_floats(N, 5) + (size_t)MAX_WARPS * SS;
}

// K6l's: the same without S's bands
size_t bcr_l2_smem_floats(int N) {
  return (size_t)5 * N * S + 33 + (size_t)MAX_WARPS * SS;
}

// S_SHARED: K6 (S copied into shared memory) or K6l (S read from global
// memory); smem holds bcr_smem_floats(N) or bcr_l2_smem_floats(N).
template <bool S_SHARED>
LD_DEV void bcr_pcg_dz_body(
    float* smem, int N, int levels, const float* SLg, const float* SDg,
    const float* SUg, const float* gamma, const float* lam0, const float* A,
    const float* B, const float* q, const float* r_in, const float* Qinv,
    const float* Rinv, int max_iter, float tol, float* fac, float* lam_out,
    float* dX, float* dU, int* iters_out, bool* hit_out) {
  const int nb = S_SHARED ? SS * N : 0, n = S * N;
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
  if (S_SHARED) {
    pcgc::load_system(N, SLg, SDg, SUg, lam0, SL, SD, SU, lam);
  } else {
    for (int e = LD_TID; e < n; e += LD_NTID) lam[e] = lam0[e];
    LD_SYNC();
  }
  const float* sl = S_SHARED ? SL : SLg;
  const float* sd = S_SHARED ? SD : SDg;
  const float* su = S_SHARED ? SU : SUg;
  const bcr::BcrFactor f(fac, N, levels);
  bcr::bcr_factor(f, sl, sd, su, inv);
  float eta;
  const int it = pcgc::cg_solve(N, sl, sd, su, gamma, lam, r, p, w, red,
                                bcr::BcrPre{f, g}, max_iter, tol, &eta);
  if (LD_TID == 0) {
    iters_out[0] = it;
    hit_out[0] = fabsf(eta) > tol;
  }
  pcgc::dz_epilogue(N, lam, A, B, q, r_in, Qinv, Rinv, r, p, lam_out, dX,
                    dU);
}

#define BCR_PCG_DZ_PARAMS                                                   \
  int N, int levels, const float *SLg, const float *SDg, const float *SUg, \
      const float *gamma, const float *lam0, const float *A, const float *B, \
      const float *q, const float *r_in, const float *Qinv,                \
      const float *Rinv, int max_iter, float tol, float *fac,              \
      float *lam_out, float *dX, float *dU, int *iters_out, bool *hit_out
#define BCR_PCG_DZ_ARGS                                                     \
  N, levels, SLg, SDg, SUg, gamma, lam0, A, B, q, r_in, Qinv, Rinv,        \
      max_iter, tol, fac, lam_out, dX, dU, iters_out, hit_out

LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS)
    bcr_pcg_dz_kernel(BCR_PCG_DZ_PARAMS) {
  LD_DYN_SMEM(smem);
  bcr_pcg_dz_body<true>(smem, BCR_PCG_DZ_ARGS);
}

LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS)
    bcr_pcg_dz_l2_kernel(BCR_PCG_DZ_PARAMS) {
  LD_DYN_SMEM(smem);
  bcr_pcg_dz_body<false>(smem, BCR_PCG_DZ_ARGS);
}

}  // namespace

// Largest power-of-2 horizon whose S bands, CG vectors and inverse scratch
// fit one block's shared memory on this device (K6); 0 if it cannot be read.
extern "C" int mpc_bcr_max_knots(void) {
  return bcr::pow2_max_knots(bcr_smem_floats);
}

// The same for K6l (CG vectors and inverse scratch; S in global memory).
extern "C" int mpc_bcr_l2_max_knots(void) {
  return bcr::pow2_max_knots(bcr_l2_smem_floats);
}

// Floats of global scratch the factors of an N-knot solve take.
extern "C" long long mpc_bcr_scratch_floats(int N) {
  return (long long)bcr::factor_floats(N);
}

namespace {

using BcrPcgKernel = void (*)(BCR_PCG_DZ_PARAMS);

int launch_bcr_pcg_dz(BcrPcgKernel kern, size_t smem_floats, int N,
                      const float* SL, const float* SD, const float* SU,
                      const float* gamma, const float* lam0, const float* A,
                      const float* B, const float* q, const float* r,
                      const float* Qinv, const float* Rinv, int max_iter,
                      float tol, float* scratch, float* lam_out, float* dX,
                      float* dU, int* iters, bool* hit, void* stream) {
  if (N < 1 || (N & (N - 1))) return 1;  // cudaErrorInvalidValue
  const size_t smem = smem_floats * sizeof(float);
#ifdef __CUDACC__
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  LD_LAUNCH(kern, 1, bcr::threads_for(N), smem, stream, N, bcr::levels_of(N),
            SL, SD, SU, gamma, lam0, A, B, q, r, Qinv, Rinv, max_iter, tol,
            scratch, lam_out, dX, dU, iters, hit);
  return LD_LAST_ERROR();
}

}  // namespace

// K6 (S in shared memory); scratch holds mpc_bcr_scratch_floats(N) floats.
extern "C" int mpc_bcr_pcg_dz(int N, const float* SL, const float* SD,
                              const float* SU, const float* gamma,
                              const float* lam0, const float* A,
                              const float* B, const float* q, const float* r,
                              const float* Qinv, const float* Rinv,
                              int max_iter, float tol, float* scratch,
                              float* lam_out, float* dX, float* dU,
                              int* iters, bool* hit, void* stream) {
  return launch_bcr_pcg_dz(bcr_pcg_dz_kernel, bcr_smem_floats(N), N, SL, SD,
                           SU, gamma, lam0, A, B, q, r, Qinv, Rinv, max_iter,
                           tol, scratch, lam_out, dX, dU, iters, hit, stream);
}

// K6l (S read from global memory); arguments as K6's.
extern "C" int mpc_bcr_pcg_dz_l2(int N, const float* SL, const float* SD,
                                 const float* SU, const float* gamma,
                                 const float* lam0, const float* A,
                                 const float* B, const float* q,
                                 const float* r, const float* Qinv,
                                 const float* Rinv, int max_iter, float tol,
                                 float* scratch, float* lam_out, float* dX,
                                 float* dU, int* iters, bool* hit,
                                 void* stream) {
  return launch_bcr_pcg_dz(bcr_pcg_dz_l2_kernel, bcr_l2_smem_floats(N), N,
                           SL, SD, SU, gamma, lam0, A, B, q, r, Qinv, Rinv,
                           max_iter, tol, scratch, lam_out, dX, dU, iters,
                           hit, stream);
}
