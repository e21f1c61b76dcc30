// K2: line-search merits, one launch for all step sizes.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/merit_kernel.py
// (line_search_merits_pallas / _merit_kernel).  Block a evaluates the
// merit of (X + alpha_a dX, U + alpha_a dU) with alpha_a = 1/2^a for
// a < num_alphas and alpha = 0 (the unstepped point) for the last block:
//
//   merit = sum_k J_k + mu * (sum_{k<N-1} ||x_{k+1} - f(x_k, u_k)||_1
//                              + ||x_0 - xs||_1)
//
// with the eepos tracking cost J_k and explicit-Euler ABA dynamics f.
//
// Bound on the H100: latency of one ABA + FK chain per thread (one thread
// per knot up to MAX_THREADS threads per block, strided past it; 9 blocks
// on 9 SMs); the data are a few KB.  The chain takes about 160 registers a
// thread, so a block of more than 384 threads could not launch
// (cudaError 701): MAX_THREADS = 256 serves N <= 1024 in strides.  The candidate iterate is formed in the kernel, x_{k+1} reaches
// thread k through shared memory, and each block sums its knots in a
// fixed order, so the merits are the same from run to run.  The per-knot
// contribution lives in merit.cuh, shared with K5.
#include "merit.cuh"

namespace {

constexpr int MAX_THREADS = 256;

LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS) merit_kernel(const float* __restrict__ tab_g,
                            const float* __restrict__ X,
                            const float* __restrict__ U,
                            const float* __restrict__ dX,
                            const float* __restrict__ dU,
                            const float* __restrict__ goals, int gstride,
                            const float* __restrict__ xs, int N,
                            int num_alphas, float dt, float mu,
                            float qd_cost, float r_cost, float grav,
                            float* __restrict__ out) {
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_DYN_SMEM(smem);
  float* xsh = smem;                 // (N, NX) candidate states
  float* contrib = smem + N * ld::NX;  // (N,)
  ld::load_tables(tab, tab_g);

  const int a = LD_BID;
  const float alpha = a < num_alphas ? 1.0f / (float)(1 << a) : 0.0f;

  for (int k = LD_TID; k < N; k += LD_NTID)
    for (int i = 0; i < ld::NX; ++i)
      xsh[ld::NX * k + i] = X[ld::NX * k + i] + alpha * dX[ld::NX * k + i];
  LD_SYNC();

  for (int k = LD_TID; k < N; k += LD_NTID) {
    const bool has_u = k < N - 1;
    float u[ld::NU];
    for (int i = 0; i < ld::NU; ++i)
      u[i] = has_u ? U[ld::NU * k + i] + alpha * dU[ld::NU * k + i] : 0.0f;
    contrib[k] = k2::merit_contrib(
        tab, xsh + ld::NX * k, xsh + ld::NX * (k + 1), u, has_u, k == 0,
        goals + gstride * k, xs, dt, mu, qd_cost, r_cost, grav);
  }
  LD_SYNC();

  if (LD_TID == 0) {
    float acc = 0.0f;
    for (int k = 0; k < N; ++k) acc += contrib[k];
    out[a] = acc;
  }
}

}  // namespace

extern "C" int mpc_merits(const float* tab, const float* X, const float* U,
                          const float* dX, const float* dU,
                          const float* goals, int gstride, const float* xs,
                          int N, int num_alphas, float dt, float mu,
                          float qd_cost, float r_cost, float grav,
                          float* out, void* stream) {
  const int warps = (N + 31) / 32;
  const int threads = warps * 32 > MAX_THREADS ? MAX_THREADS : warps * 32;
  const size_t smem = sizeof(float) * (size_t)N * (ld::NX + 1);
#ifdef __CUDACC__
  // past 48 KB (N > 819) only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      merit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  LD_LAUNCH(merit_kernel, num_alphas + 1, threads, smem, stream, tab, X, U,
            dX, dU, goals, gstride, xs, N, num_alphas, dt, mu, qd_cost,
            r_cost, grav, out);
  return LD_LAST_ERROR();
}
