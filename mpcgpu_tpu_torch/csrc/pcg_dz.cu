// K4: warm-started stair-preconditioned CG on S lam = gamma, then dz; and
// K4b: the same CG without the dz; K4g and K4bg: their grid-wide forms,
// past the one-block fit.
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
// (mpc_pcg_max_knots, 90 on the H100).
//
// Past that fit, K4g and K4bg run the same CG over the whole grid
// (pcg_common.cuh grid_cg_solve): one cooperative launch of 128-thread
// blocks, grid = min(N, co-resident blocks) (mpc_pcg_grid), each block
// walking knots b, b + grid, ...; S, P, gamma and the CG vectors stay in
// global memory (L2), the dots go through per-knot slots that every block
// sums alike, and four grid barriers separate the stages of a CG step.
// Then dz per owned knot (K4g).  The barriers (a few us each) set the
// pace of a step whatever N is, so N <= 90 keeps the one-block form.
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

// K4g (dz) and K4bg (no dz): the grid-wide CG; scratch holds
// pcgc::grid_cg_floats(N).
template <bool DZ>
LD_DEV void pcg_grid_body(
    int N, const float* SL, const float* SD, const float* SU, const float* PL,
    const float* PD, const float* PU, const float* gamma, const float* lam0,
    const float* A, const float* B, const float* q, const float* r_in,
    const float* Qinv, const float* Rinv, int max_iter, float tol,
    float* lam_out, float* dX, float* dU, int* iters_out, bool* hit_out,
    float* scratch) {
  const pcgc::GridCg g = pcgc::grid_cg_area(scratch, N);
  float eta;
  const int it = pcgc::grid_cg_solve(N, SL, SD, SU, PL, PD, PU, gamma, lam0,
                                     lam_out, g, max_iter, tol, &eta);
  if (LD_BID == 0 && LD_TID == 0) {
    iters_out[0] = it;
    hit_out[0] = fabsf(eta) > tol;
  }
  if constexpr (DZ)
    pcgc::grid_dz(N, lam_out, A, B, q, r_in, Qinv, Rinv, nullptr, dX, dU);
}

LD_GLOBAL void pcg_dz_grid_kernel(
    int N, const float* SL, const float* SD, const float* SU,
    const float* PL, const float* PD, const float* PU, const float* gamma,
    const float* lam0, const float* A, const float* B, const float* q,
    const float* r_in, const float* Qinv, const float* Rinv, int max_iter,
    float tol, float* lam_out, float* dX, float* dU, int* iters_out,
    bool* hit_out, float* scratch) {
  pcg_grid_body<true>(N, SL, SD, SU, PL, PD, PU, gamma, lam0, A, B, q, r_in,
                      Qinv, Rinv, max_iter, tol, lam_out, dX, dU, iters_out,
                      hit_out, scratch);
}

LD_GLOBAL void pcg_solve_grid_kernel(
    int N, const float* SL, const float* SD, const float* SU,
    const float* PL, const float* PD, const float* PU, const float* gamma,
    const float* lam0, const float* A, const float* B, const float* q,
    const float* r_in, const float* Qinv, const float* Rinv, int max_iter,
    float tol, float* lam_out, float* dX, float* dU, int* iters_out,
    bool* hit_out, float* scratch) {
  pcg_grid_body<false>(N, SL, SD, SU, PL, PD, PU, gamma, lam0, A, B, q,
                       r_in, Qinv, Rinv, max_iter, tol, lam_out, dX, dU,
                       iters_out, hit_out, scratch);
}

using GridKernel = void (*)(int, const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, int, float, float*,
                            float*, float*, int*, bool*, float*);

constexpr int GRID_THREADS = 128;

GridKernel grid_kernel(int dz) {
  return dz ? pcg_dz_grid_kernel : pcg_solve_grid_kernel;
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

// The grid of a K4g (dz != 0) or K4bg launch over N knots: min(N, blocks
// that can be resident at once) from the occupancy API; 0 if not one block
// fits or the device has no cooperative launch.  The host build walks
// every knot in one block.
extern "C" int mpc_pcg_grid(int N, int dz) {
#ifdef __CUDACC__
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) != cudaSuccess || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, (const void*)grid_kernel(dz), GRID_THREADS, 0) != cudaSuccess)
    return 0;
  const long long resident = (long long)per_sm * sms;
  return (int)(resident < N ? resident : N);
#else
  (void)N;
  (void)dz;
  return 1;
#endif
}

// Floats of global scratch a K4g or K4bg launch takes.
extern "C" long long mpc_pcg_grid_scratch_floats(int N) {
  return (long long)pcgc::grid_cg_floats(N);
}

// K4g (dz != 0): the grid-wide CG from lam0, then dz; K4bg (dz == 0): the
// CG alone (A, B, q, r, Qinv, Rinv, dX and dU are then not read and may be
// null).  grid from mpc_pcg_grid; scratch of mpc_pcg_grid_scratch_floats.
extern "C" int mpc_pcg_grid_solve(int dz, int N, const float* SL,
                                  const float* SD, const float* SU,
                                  const float* PL, const float* PD,
                                  const float* PU, const float* gamma,
                                  const float* lam0, const float* A,
                                  const float* B, const float* q,
                                  const float* r, const float* Qinv,
                                  const float* Rinv, int max_iter, float tol,
                                  float* lam_out, float* dX, float* dU,
                                  int* iters, bool* hit, float* scratch,
                                  int grid, void* stream) {
  if (N < 2 || grid < 1) return 1;  // cudaErrorInvalidValue
#ifdef __CUDACC__
  // a grid larger than the resident one makes the launch fail with
  // cudaErrorCooperativeLaunchTooLarge (the wrapper checks it first)
  void* args[] = {&N, &SL, &SD, &SU, &PL, &PD, &PU, &gamma, &lam0, &A, &B,
                  &q, &r, &Qinv, &Rinv, &max_iter, &tol, &lam_out, &dX, &dU,
                  &iters, &hit, &scratch};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)grid_kernel(dz), dim3(grid), dim3(GRID_THREADS), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  const GridKernel kern = grid_kernel(dz);
  LD_LAUNCH(kern, 1, GRID_THREADS, 0, stream, N, SL, SD, SU, PL, PD, PU,
            gamma, lam0, A, B, q, r, Qinv, Rinv, max_iter, tol, lam_out, dX,
            dU, iters, hit, scratch);
  (void)grid;
  return 0;
#endif
}
