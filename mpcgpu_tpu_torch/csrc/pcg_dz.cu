// K4: warm-started stair-preconditioned CG on S lam = gamma, then dz.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/pcg_kernel.py
// (pcg_dz_pallas_lanes / _pcg_dz_kernel -> _pcg_loop).  The loop is the
// reference's (MPCGPU alg. 2): exit when |eta| = |r' Pinv r| <= tol or at
// max_iter, hit = |eta| > tol at exit.  Then the primal step
//   dx_k = -Qinv_k (q_k - lam_k + A_k' lam_{k+1})   (no A term at k = N-1)
//   du_k = -Rinv_k (r_k + B_k' lam_{k+1}).
//
// Bound on the H100: latency.  At N = 64 one CG iteration is ~0.5 MFLOP
// over a 300 KB working set, and the 40 iterations are a dependent chain
// with two global reductions each.  So the whole solve runs in ONE block:
// every barrier is a __syncthreads (tens of ns) instead of a grid-wide
// sync, and S's three bands (150,528 B at N = 64) stay in shared memory
// for the whole solve while the preconditioner bands are read from global
// memory, where they stay L2-resident.  One thread per (knot, row) entry of
// the (N, 14) vectors computes its 3x14-FMA band row.  The shared memory
// of one block bounds N (mpc_pcg_max_knots; the wrapper raises beyond it).
// The dot products reduce in a fixed order (warp shuffles, then warp 0),
// and every thread reads the one shared result, so all threads take the
// same exit decision.
#include "lanedyn.cuh"

namespace {

constexpr int S = ld::NX, NU = ld::NU;

// shared floats: the three S bands, 4 CG vectors and the reduction slots
inline size_t pcg_smem_floats(int N) {
  return (size_t)3 * N * S * S + (size_t)4 * N * S + 33;
}

// Block-wide sum in a fixed order; every thread returns the same value.
LD_DEV float block_sum(float v, float* red) {
#ifdef __CUDACC__
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) w += __shfl_down_sync(0xffffffffu, w, off);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  return red[32];
#else
  (void)red;
  return v;
#endif
}

// y[e] for e = k*S + i: row i of band-row k of (L, D, U) times x.
// D and the band pointers may be shared or global memory.
LD_DEV float band_row(const float* L, const float* D, const float* U,
                      const float* x, int N, int e) {
  const int k = e / S, i = e % S;
  const int o = S * S * k + S * i;
  float acc = 0.0f;
  for (int j = 0; j < S; ++j) acc += D[o + j] * x[S * k + j];
  if (k > 0)
    for (int j = 0; j < S; ++j) acc += L[o + j] * x[S * (k - 1) + j];
  if (k < N - 1)
    for (int j = 0; j < S; ++j) acc += U[o + j] * x[S * (k + 1) + j];
  return acc;
}

LD_GLOBAL void pcg_dz_kernel(
    int N, const float* __restrict__ SLg, const float* __restrict__ SDg,
    const float* __restrict__ SUg, const float* __restrict__ PL,
    const float* __restrict__ PD, const float* __restrict__ PU,
    const float* __restrict__ gamma, const float* __restrict__ lam0,
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ q, const float* __restrict__ r_in,
    const float* __restrict__ Qinv, const float* __restrict__ Rinv,
    int max_iter, float tol, float* __restrict__ lam_out,
    float* __restrict__ dX, float* __restrict__ dU, int* __restrict__ iters_out,
    bool* __restrict__ hit_out) {
  LD_DYN_SMEM(smem);
  const int nb = S * S * N, n = S * N;
  float* SL = smem;
  float* SD = SL + nb;
  float* SU = SD + nb;
  float* lam = SU + nb;
  float* r = lam + n;
  float* p = r + n;
  float* w = p + n;
  float* red = w + n;
  const int tid = LD_TID, nt = LD_NTID;

  for (int e = tid; e < nb; e += nt) {
    SL[e] = SLg[e];
    SD[e] = SDg[e];
    SU[e] = SUg[e];
  }
  for (int e = tid; e < n; e += nt) lam[e] = lam0[e];
  LD_SYNC();

  // r = gamma - S lam
  for (int e = tid; e < n; e += nt) r[e] = gamma[e] - band_row(SL, SD, SU, lam, N, e);
  LD_SYNC();
  // p = Pinv r, eta = r . p
  float part = 0.0f;
  for (int e = tid; e < n; e += nt) {
    const float z = band_row(PL, PD, PU, r, N, e);
    p[e] = z;
    part += r[e] * z;
  }
  float eta = block_sum(part, red);

  int it = 0;
  while (it < max_iter && fabsf(eta) > tol) {
    // w = S p, alpha = eta / p.w
    part = 0.0f;
    for (int e = tid; e < n; e += nt) {
      const float z = band_row(SL, SD, SU, p, N, e);
      w[e] = z;
      part += p[e] * z;
    }
    const float alpha = eta / block_sum(part, red);
    for (int e = tid; e < n; e += nt) {
      lam[e] += alpha * p[e];
      r[e] -= alpha * w[e];
    }
    LD_SYNC();
    // w = Pinv r, eta' = r . w
    part = 0.0f;
    for (int e = tid; e < n; e += nt) {
      const float z = band_row(PL, PD, PU, r, N, e);
      w[e] = z;
      part += r[e] * z;
    }
    const float eta_new = block_sum(part, red);
    const float beta = eta_new / eta;
    for (int e = tid; e < n; e += nt) p[e] = w[e] + beta * p[e];
    LD_SYNC();
    eta = eta_new;
    ++it;
  }
  if (tid == 0) {
    iters_out[0] = it;
    hit_out[0] = fabsf(eta) > tol;
  }

  // ---- primal step recovery (dz.cuh:5-121)
  for (int e = tid; e < n; e += nt) {
    const int k = e / S, i = e % S;
    float acc = q[e] - lam[e];
    if (k < N - 1)
      for (int m = 0; m < S; ++m) acc += A[S * S * k + S * m + i] * lam[S * (k + 1) + m];
    r[e] = acc;
    lam_out[e] = lam[e];
  }
  for (int e = tid; e < (N - 1) * NU; e += nt) {
    const int k = e / NU, i = e % NU;
    float acc = r_in[NU * k + i];
    for (int m = 0; m < S; ++m) acc += B[S * NU * k + NU * m + i] * lam[S * (k + 1) + m];
    p[e] = acc;
  }
  LD_SYNC();
  for (int e = tid; e < n; e += nt) {
    const int k = e / S, i = e % S;
    float acc = 0.0f;
    for (int j = 0; j < S; ++j) acc += Qinv[S * S * k + S * i + j] * r[S * k + j];
    dX[e] = -acc;
  }
  for (int e = tid; e < (N - 1) * NU; e += nt) {
    const int k = e / NU, i = e % NU;
    float acc = 0.0f;
    for (int j = 0; j < NU; ++j) acc += Rinv[NU * NU * k + NU * i + j] * p[NU * k + j];
    dU[e] = -acc;
  }
}

}  // namespace

// Largest horizon whose S bands and CG vectors fit one block's shared
// memory on this device (the counterpart of the reference's
// checkPcgOccupancy); 0 if the attribute cannot be read.
extern "C" int mpc_pcg_max_knots(void) {
#ifdef __CUDACC__
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
#else
  const int bytes = 232448;
#endif
  int n = 1;
  while (pcg_smem_floats(n + 1) * sizeof(float) <= (size_t)bytes) ++n;
  return n;
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
  int threads = ((S * N + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  LD_LAUNCH(pcg_dz_kernel, 1, threads, smem, stream, N, SL, SD, SU, PL, PD,
            PU, gamma, lam0, A, B, q, r, Qinv, Rinv, max_iter, tol, lam_out,
            dX, dU, iters, hit);
  return LD_LAST_ERROR();
}
