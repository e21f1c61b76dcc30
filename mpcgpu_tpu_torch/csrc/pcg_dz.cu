// K4: warm-started stair-preconditioned CG on S lam = gamma, then dz; and
// K4b: the same CG without the dz.
//
// Replaces the TPU kernels mpcgpu_tpu/ops/pallas/pcg_kernel.py
// (pcg_dz_pallas_lanes / _pcg_dz_kernel -> _pcg_loop) and
// (pcg_pallas_lanes / _pcg_kernel, the "pcg_pallas" backend's solve).  The loop is the
// reference's (MPCGPU alg. 2): exit when |eta| = |r' Pinv r| <= tol or at
// max_iter, hit = |eta| > tol at exit.  Then the primal step
//   dx_k = -Qinv_k (q_k - lam_k + A_k' lam_{k+1})   (no A term at k = N-1)
//   du_k = -Rinv_k (r_k + B_k' lam_{k+1}).
//
// Bound on the H100: latency.  At N = 64 one CG iteration is ~0.5 MFLOP
// over a 300 KB working set, and the 40 iterations are a dependent chain
// with two global reductions each.  So the whole solve runs in ONE block
// (pcg_common.cuh): every barrier is a __syncthreads (tens of ns) instead
// of a grid-wide sync, and S's three bands (150,528 B at N = 64) stay in
// shared memory for the whole solve while the preconditioner bands are
// read from global memory, where they stay L2-resident.  One thread per
// (knot, row) entry.  The shared memory of one block bounds N
// (mpc_pcg_max_knots; the wrapper raises beyond it).
#include "pcg_common.cuh"

namespace {

constexpr int S = ld::NX;

LD_GLOBAL void pcg_dz_kernel(
    int N, const float* SLg, const float* SDg, const float* SUg,
    const float* PL, const float* PD, const float* PU, const float* gamma,
    const float* lam0, const float* A, const float* B, const float* q,
    const float* r_in, const float* Qinv, const float* Rinv, int max_iter,
    float tol, float* lam_out, float* dX, float* dU, int* iters_out,
    bool* hit_out) {
  LD_DYN_SMEM(smem);
  pcgc::pcg_dz_body(smem, N, SLg, SDg, SUg, PL, PD, PU, gamma, lam0, A, B, q,
                    r_in, Qinv, Rinv, max_iter, tol, lam_out, dX, dU,
                    iters_out, hit_out);
}

LD_GLOBAL void pcg_solve_kernel(
    int N, const float* SLg, const float* SDg, const float* SUg,
    const float* PL, const float* PD, const float* PU, const float* gamma,
    const float* lam0, int max_iter, float tol, float* lam_out,
    int* iters_out, bool* hit_out) {
  LD_DYN_SMEM(smem);
  const pcgc::CgArea a = pcgc::pcg_solve_body(
      smem, N, SLg, SDg, SUg, PL, PD, PU, gamma, lam0, max_iter, tol,
      iters_out, hit_out);
  for (int e = LD_TID; e < S * N; e += LD_NTID) lam_out[e] = a.lam[e];
}

size_t pcg_smem_floats(int N) { return pcgc::cg_smem_floats(N, 4); }

int pcg_threads(int N) {
  const int threads = ((S * N + 31) / 32) * 32;
  return threads < 1024 ? threads : 1024;
}

}  // namespace

// Largest horizon whose S bands and CG vectors fit one block's shared
// memory on this device (the counterpart of the reference's
// checkPcgOccupancy); 0 if the attribute cannot be read.
extern "C" int mpc_pcg_max_knots(void) {
  return pcgc::max_knots_for(pcg_smem_floats, 0);
}

extern "C" int mpc_pcg_dz(int N, const float* SL, const float* SD,
                          const float* SU, const float* PL, const float* PD,
                          const float* PU, const float* gamma,
                          const float* lam0, const float* A, const float* B,
                          const float* q, const float* r, const float* Qinv,
                          const float* Rinv, int max_iter, float tol,
                          float* lam_out, float* dX, float* dU, int* iters,
                          bool* hit, void* stream) {
  const size_t smem = pcg_smem_floats(N) * sizeof(float);
#ifdef __CUDACC__
  cudaError_t err = cudaFuncSetAttribute(
      pcg_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  LD_LAUNCH(pcg_dz_kernel, 1, pcg_threads(N), smem, stream, N, SL, SD, SU, PL, PD,
            PU, gamma, lam0, A, B, q, r, Qinv, Rinv, max_iter, tol, lam_out,
            dX, dU, iters, hit);
  return LD_LAST_ERROR();
}

// K4b: lam, iters and hit of the stair-PCG solve, no dz.
extern "C" int mpc_pcg_solve(int N, const float* SL, const float* SD,
                             const float* SU, const float* PL, const float* PD,
                             const float* PU, const float* gamma,
                             const float* lam0, int max_iter, float tol,
                             float* lam_out, int* iters, bool* hit,
                             void* stream) {
  const size_t smem = pcg_smem_floats(N) * sizeof(float);
#ifdef __CUDACC__
  cudaError_t err = cudaFuncSetAttribute(
      pcg_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  LD_LAUNCH(pcg_solve_kernel, 1, pcg_threads(N), smem, stream, N, SL, SD, SU,
            PL, PD, PU, gamma, lam0, max_iter, tol, lam_out, iters, hit);
  return LD_LAST_ERROR();
}
